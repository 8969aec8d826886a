// Input row maps shared by the block kernel's launches (prefetch_block.cu,
// mat_high.cu).
//
// A block's first launch may read its input through one pending map:
//   steered (scal mode 1): flat bit 7 exchanged with a cross-tile row bit;
//   folded relayout (scal mode 5): row r reads row fold_row(r), where the
//     row-block index i = r / Tr maps to src(i) with bit a of src(i) equal
//     to bit sigma[a] of i (the relayout kernel's addressing, relayout.cu).
// The two are exclusive: the planner never folds a relayout into a
// steered block.
#pragma once

constexpr int FOLD_MAX_SLOTS = 24;   // RELAYOUT_SLOTS of the planner

struct Fold {
  int s[FOLD_MAX_SLOTS];   // sigma over the row-block bits
  int m;                   // number of row-block bits; 0 = no fold
  int log_tr;              // log2 of the relayout block rows Tr
};

// Source row of row r under the folded relayout (computed per row: the
// kernels' row tiles need not align with Tr-row blocks).  The loop runs
// over all FOLD_MAX_SLOTS, unrolled, so every s[a] is a constant offset
// into the kernel's parameters: indexing s at run time would make every
// thread of every launch copy the struct to local memory first, folded
// or not.
__device__ __forceinline__ long long fold_row(long long r, const Fold& f) {
  const long long i = r >> f.log_tr;
  long long j = 0;
#pragma unroll
  for (int a = 0; a < FOLD_MAX_SLOTS; ++a)
    if (a < f.m) j |= ((i >> f.s[a]) & 1LL) << a;
  return (j << f.log_tr) | (r & ((1LL << f.log_tr) - 1));
}

// Host side: the Fold argument from m sigma ints (m = 0: no fold).
// Returns false if m is out of range or Tr is not a power of two.
inline bool make_fold(Fold* f, const int* sigma, int m, int tr) {
  if (m < 0 || m > FOLD_MAX_SLOTS || tr <= 0 || (tr & (tr - 1))) return false;
  *f = Fold{};
  for (int a = 0; a < m; ++a) f->s[a] = sigma[a];
  f->m = m;
  int lt = 0;
  while ((1 << lt) < tr) ++lt;
  f->log_tr = lt;
  return true;
}
