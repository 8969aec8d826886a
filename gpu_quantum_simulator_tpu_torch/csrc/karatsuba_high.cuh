// The Karatsuba "high" product's k-chunk on Hopper (sm_90a) wgmma: the
// arithmetic of the two kernels that run it, mxu's mm step (mm_high.cu,
// D = 128 << kh, through the row map) and kernel 7's "high" chain
// (wide_chain.cu, D = 128, the row tile on chip).  Both run this one chunk
// body on the same table image, so a one-product chain equals the D = 128
// mm step bit for bit.
//
// What it computes: on the (M, D) view x of the state,
//     t1 = (xr + xi).m1,  t2 = xr.m2,  t3 = xi.m3
//     out_re = t1 - t3,   out_im = t1 + t2
// with m1 = M_re^T, m2 = (M_im - M_re)^T, m3 = (M_re + M_im)^T, each real
// product x.m = xh.mh + xl.mh + xh.ml (h = bf16 of x, l = bf16 of x - h);
// s = xr + xi is formed in fp32 before its split, as the JAX package adds
// re_m + im_m (gpu_quantum_simulator_tpu/engine/wide.py
// _apply_wide_karatsuba and get_kh0_kernel's "high" _dot).
//
// Where the sums are kept, in this order.  A tensor core's fp32 adds
// truncate, so a sum that stays in its accumulator across many passes
// shrinks the norm a little every step.  For each output (m, n) and real
// product P (t1, t2, t3):
//   * hi.hi: for every k-chunk c of 16 in order and half h = 0, 1 of it, a
//     bf16 wgmma from zero (scale-d = 0) with the other half of its A
//     fragment zero, so eight of the chunk's k (wgmma positions 8 h ..
//     8 h + 7): the exact products summed by the tensor core into an
//     8-term partial H(c, h), added in fp32 on the CUDA cores, which round
//     to nearest:  T_P = (T_P + H(c, 0)) + H(c, 1);
//   * corrections: xl.mh and then xh.ml of every chunk in order, bf16
//     wgmmas accumulating over all k in the tensor core (C_P); they are
//     2^-8 the size of the hi.hi terms, so their truncation is too;
//   * t_P = T_P + C_P; out_re = t1 - t3, out_im = t1 + t2, IEEE fp32.
// chip_smoke.py's drift phases hold these sums to the plain version's
// drift over 200 products and six seeds (the mm step at D = 512 and 256,
// the chain at D = 128).  4-term partials (quarter-masked passes, twice
// the passes and adds) drift a third as much and ran 28% slower an mm
// step (PERF.md section 6).
//
// The tables are split once per program (kernels/wide.py split_mm_tables)
// into the image the kernels copy into shared memory: per 32-column block
// cb and k-chunk c, six parts [m1_hi, m1_lo, m2_hi, m2_lo, m3_hi, m3_lo],
// each the wgmma B operand K-major and unswizzled: 16-byte core matrices
// [kc 2][n 32][8], stride 512 bytes along k and 128 along n.  k is
// permuted inside every 16 (position p holds k 4 ((p % 8) / 2) + 2 (p / 8)
// + p % 2, as csrc/wgmma_high.cuh's tables), so that one float4 of a state
// row (k 4t .. 4t + 3) is lane t's A-fragment values.
//
// The "default" rung: one bf16 pass a real product, xh.mh, as the JAX
// package's jnp.dot at Precision.DEFAULT on the TPU: the hi.hi partials
// summed as above, in the same order, no lo split, no correction wgmma,
// t_P = T_P.  On bf16-exact operands (s = xr + xi included) the "high"
// arm's corrections are exact zeros, and the two arms agree bit for bit.
// Both kernels run it on a k-loop of their own from the pieces below, on
// a hi-only table image (kernels/wide.py split_mm_tables_hi: per 32-column
// block and k-chunk [m1_hi, m2_hi, m3_hi]): mxu's mm step (mm_high.cu) on
// three partial pairs, one a product, two groups queued while a third is
// added, across a run of chunks; kernel 7's chain (wide_chain.cu) a chunk
// at a time on two partial pairs, its fragments rounded once a product
// and kept in shared memory (hi_frag).
//
// Shape: a warpgroup's 64 rows (wgmma's M) by 32 output columns
// (m64n32k16), per thread three fp32 sums T_P, three correction
// accumulators C_P and four partials of 16 floats ("high").  A chunk is
// three groups of wgmmas, one a product: two hi.hi passes into a pair of
// partials and two corrections; a group's partials are added while the
// next group runs on the tensor core.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_split.cuh"

namespace kh {

constexpr int BN = 32;                      // output columns of a block
constexpr int PART = 2 * BN * 16;           // bytes: one table's k-chunk
constexpr int CHUNK_BYTES = 6 * PART;       // the six tables' k-chunk
constexpr int HI_CHUNK_BYTES = 3 * PART;    // the three hi tables' k-chunk
constexpr int CORE_K = BN * 16;             // core-matrix stride along k
constexpr int CORE_N = 128;                 // and along n

using bfround::hi2;
using bfround::split2;

// rows g (r0) and g + 8 (r1), k 4t .. 4t + 3: the A fragment, hi and lo
__device__ __forceinline__ void split_frag(float4 r0, float4 r1,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(r0.x, r0.y, hi[0], lo[0]);
  split2(r1.x, r1.y, hi[1], lo[1]);
  split2(r0.z, r0.w, hi[2], lo[2]);
  split2(r1.z, r1.w, hi[3], lo[3]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// the three products' A fragments of rows (r0, r1) of re (r) and im (i):
// [product: s, xr, xi][hi, lo][fragment register]
__device__ __forceinline__ void split_rows(float4 r0, float4 r1, float4 i0,
                                           float4 i1,
                                           uint32_t (&a)[3][2][4]) {
  split_frag(add4(r0, i0), add4(r1, i1), a[0][0], a[0][1]);
  split_frag(r0, r1, a[1][0], a[1][1]);
  split_frag(i0, i1, a[2][0], a[2][1]);
}

// half h of a fragment, the other half zero: registers 2 h and 2 h + 1,
// wgmma positions 8 h .. 8 h + 7 of the chunk
__device__ __forceinline__ void half(uint32_t (&o)[4], const uint32_t (&a)[4],
                                     int h) {
  o[0] = h ? 0u : a[0];
  o[1] = h ? 0u : a[1];
  o[2] = h ? a[2] : 0u;
  o[3] = h ? a[3] : 0u;
}

// K-major, unswizzled shared-memory matrix descriptor at byte address a
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return (uint64_t)((a & 0x3ffff) >> 4) | ((uint64_t)(CORE_K >> 4) << 16) |
         ((uint64_t)(CORE_N >> 4) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of an accumulator above a wait
__device__ __forceinline__ void pin(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a.b + (acc ? d : 0) over k = 16: bf16, m64n32, a from registers (the
// m16n8k16 A fragment of the warp's 16 rows), b a descriptor
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                    uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// sum += x, element by element, after the wait that ends the pass
// writing x
__device__ __forceinline__ void add1(float (&sum)[16], float (&x)[16]) {
  pin(x);
#pragma unroll
  for (int e = 0; e < 16; ++e) sum[e] += x[e];
}

// One k-chunk of the three products for the warpgroup's 64 rows and one
// 32-column block: a, the chunk's A fragments (split_rows); d, the
// descriptor of the block's six table parts of the chunk (they differ
// only in the address).  Three groups, one a product P: its two hi.hi
// passes (halves 0 and 1) into the partial pair X[2 (P % 2)],
// X[2 (P % 2) + 1], then its corrections xl.mh and xh.ml into C[P]; a
// group's partials are added once the next group is queued.  Returns
// after every pass of the chunk has completed (its fragments and table
// parts are free again).
__device__ __forceinline__ void chunk(float (&T)[3][16], float (&C)[3][16],
                                      float (&X)[4][16],
                                      const uint32_t (&a)[3][2][4],
                                      uint64_t d) {
#pragma unroll
  for (int P = 0; P < 3; ++P) {
    const int b = P % 2;
    uint32_t x0[4], x1[4];
    half(x0, a[P][0], 0);
    half(x1, a[P][0], 1);
    const uint64_t mh = d + (2 * P * PART >> 4);
    const uint64_t ml = d + ((2 * P + 1) * PART >> 4);
    fence();
    mma(X[2 * b], x0, mh, 0);
    mma(X[2 * b + 1], x1, mh, 0);
    mma(C[P], a[P][1], mh, 1);
    mma(C[P], a[P][0], ml, 1);
    commit();
    if (P > 0) {
      wait<1>();
      add1(T[P - 1], X[2 * (1 - b)]);
      add1(T[P - 1], X[2 * (1 - b) + 1]);
    }
  }
  wait<0>();                 // the chunk's passes read its fragments
  add1(T[2], X[0]);
  add1(T[2], X[1]);
}

// output element x of the D fragment (re, im) from the sums: t_P = T_P +
// C_P (LO false: T_P), out_re = t1 - t3, out_im = t1 + t2
template <bool LO>
__device__ __forceinline__ float2 result(const float (&T)[3][16],
                                         const float (&C)[3][16], int x) {
  const float t1 = LO ? T[0][x] + C[0][x] : T[0][x];
  const float t2 = LO ? T[1][x] + C[1][x] : T[1][x];
  const float t3 = LO ? T[2][x] + C[2][x] : T[2][x];
  return make_float2(t1 - t3, t1 + t2);
}

// ------------------------------------------- the "default" k-loops' pieces
// rows g (r0) and g + 8 (r1), k 4t .. 4t + 3, rounded to bf16: the whole A
// fragment (the chain keeps it in shared memory)
__device__ __forceinline__ uint4 hi_frag(float4 r0, float4 r1) {
  return make_uint4(hi2(r0.x, r0.y), hi2(r1.x, r1.y), hi2(r0.z, r0.w),
                    hi2(r1.z, r1.w));
}

// the same rounded into the two half-zero fragments: h0 for wgmma
// positions 0..7 (registers 0, 1), h1 for 8..15 (registers 2, 3); the zero
// registers are not written
__device__ __forceinline__ void split_hi(float4 r0, float4 r1,
                                         uint32_t (&h0)[4],
                                         uint32_t (&h1)[4]) {
  h0[0] = hi2(r0.x, r0.y);
  h0[1] = hi2(r1.x, r1.y);
  h1[2] = hi2(r0.z, r0.w);
  h1[3] = hi2(r1.z, r1.w);
}

// one product's two hi.hi passes from zero into its partial pair x: one
// wgmma group
__device__ __forceinline__ void hi_group(float (&x)[2][16],
                                         const uint32_t (&h0)[4],
                                         const uint32_t (&h1)[4],
                                         uint64_t mh) {
  fence();
  mma(x[0], h0, mh, 0);
  mma(x[1], h1, mh, 0);
  commit();
}

// keep the compiler from moving reads of the corrections above the last
// wait
__device__ __forceinline__ void pin_corrections(float (&C)[3][16]) {
  pin(C[0]);
  pin(C[1]);
  pin(C[2]);
}

}  // namespace kh
