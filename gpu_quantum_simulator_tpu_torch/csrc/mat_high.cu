// The "high" precision rung's mat step, for Hopper (sm_90a) tensor cores.
//
// Replaces: the mat step of gpu_quantum_simulator_tpu/engine/prefetch.py
// get_block_kernel / get_stream_block_kernel at precision "high", whose
// product is _make_dot("high"): XLA's 3-pass bf16 decomposition.  Each real
// product x.m is computed as xh.mh + xl.mh + xh.ml, where h = x rounded to
// bf16 (round to nearest even) and l = the bf16 of the residual x - h, with
// float32 accumulation.  Every bf16 x bf16 product is exact in float32, so
// the rung differs from fp32 only by the dropped xl.ml term and the
// rounding of the residuals (about 2^-17 relative per product).
//
// Complex form: SCHOOLBOOK, four real products per complex product (the
// JAX default is Karatsuba, three products on combined operands):
//   out_re = xr.A - xi.B,  out_im = xr.B + xi.A,
// A = M_re^T, B = M_im^T (the block kernel's tables).  Schoolbook splits the
// raw state, not sums of its parts, so it is the more accurate of the two,
// and needs no operand adds.
//
// The kernel is wgmma_high.cuh's device body (shared with the in-place
// step of split_block.cu, bit for bit): bf16 wgmma, each persistent CTA
// keeping its column block of the tables resident in shared memory, the
// state rows staged by cp.async through the input map, the hi.hi partials
// summed in fp32 on the CUDA cores.  That header says what bounds it and
// where its sums are kept.  The tables are split once per circuit on the
// host side of the call (kernels/block.py split_tables) into the
// shared-memory image the kernel copies.  A row block's four column-block
// CTAs are neighbours in the grid and run at once, so its rows come from
// device memory once and then from L2.
//
// Input maps as in prefetch_block.cu: steered (column bit 7 <-> a row bit)
// or folded relayout (rowmap.cuh), first launch of a block only.
//
// The "default" rung's mat step (the one bf16 pass of _make_dot("default"),
// xh.mh alone) is mat_high_kernel<false>: the same header's "default"
// k-loop (two partial pairs in flight across the chunks) with the "high"
// arm's sums, on the same tables (it reads their hi words).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"
#include "rowmap.cuh"
#include "wgmma_high.cuh"

namespace {

using wgh::DVIEW;
using wgh::HALF;

// (rows, 256) state pairs in and out; the input through the pending map
struct FlatMap {
  const float* in_re;
  const float* in_im;
  float* out_re;
  float* out_im;
  long long rows;
  int steer_row;   // row bit exchanged with column bit 7 on input, or -1
  Fold fold;

  __device__ long long row(long long rb, int s) const {
    return rb * wgh::BM + s;
  }
  __device__ uint32_t code(long long r, int hf) const {
    long long sr = fold.m > 0 ? fold_row(r, fold) : r;
    int sh = hf;
    if (steer_row >= 0 && ((hf ^ (int)(r >> steer_row)) & 1)) {
      sr = r ^ (1LL << steer_row);
      sh ^= 1;
    }
    return (uint32_t)(2 * sr + sh);
  }
  __device__ const float* src(int comp, uint32_t code) const {
    return (comp ? in_im : in_re) + (long long)code * HALF;
  }
  __device__ float* out(int comp, long long r, int col) const {
    return (comp ? out_im : out_re) + r * DVIEW + col;
  }
};

// LO: the "high" rung; false: the "default" rung (wgmma_high.cuh)
template <bool LO>
__global__ void __launch_bounds__(wgh::THREADS, 1)
mat_high_kernel(FlatMap map, const uint8_t* __restrict__ w) {
  wgh::mat_step<LO>(map, w);
}

template <bool LO>
cudaError_t launch(const FlatMap& map, const void* w, cudaStream_t stream) {
  static unsigned smem_set = 0;
  static int slots = 0;   // CTAs of the kernel that fit on the card at once
  cudaError_t e = async::allow_smem(mat_high_kernel<LO>, wgh::SMEM,
                                    &smem_set);
  if (e == cudaSuccess && slots == 0)
    e = async::persistent_slots(mat_high_kernel<LO>, wgh::THREADS, wgh::SMEM,
                                &slots);
  if (e != cudaSuccess) return e;
  // persistent: CTA groups of the four column blocks, one row block each
  // at a time
  const long long blocks = (map.rows + wgh::BM - 1) / wgh::BM;
  const long long groups =
      std::min<long long>(blocks, slots / wgh::COL_BLOCKS);
  mat_high_kernel<LO><<<(unsigned)(groups * wgh::COL_BLOCKS), wgh::THREADS,
                        wgh::SMEM, stream>>>(map,
                                             static_cast<const uint8_t*>(w));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One "high"-rung (lo = 1) or "default"-rung (lo = 0) mat step on an
// (rows, 256) state pair.  w: the slot's tables as kernels/block.py
// split_tables lays them out (512 KB; "default" reads the hi words);
// steer_bit: flat bit (>= 8) exchanged with bit 7 on input, or -1;
// sigma/m/tr: the folded relayout on input (m = 0: none).  Rows below
// 2^31: a half-row's source code (2 x row + half) is 32 bits and never the
// past-the-state mark, and every offset is 64-bit, so a shard of 2^32
// amplitudes (2^24 rows) runs as the flat state does.
int qsim_mat_step_high(const float* in_re, const float* in_im, float* out_re,
                       float* out_im, const void* w, long long rows,
                       int steer_bit, const int* sigma, int m, int tr, int lo,
                       void* stream) {
  FlatMap map{in_re, in_im, out_re, out_im, rows,
              steer_bit >= 0 ? steer_bit - 8 : -1, Fold{}};
  if (rows < 1 || rows >= (1LL << 31) ||
      !make_fold(&map.fold, sigma, m, tr) || (m > 0 && steer_bit >= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(lo ? launch<true>(map, w, s)
                             : launch<false>(map, w, s));
}

}  // extern "C"
