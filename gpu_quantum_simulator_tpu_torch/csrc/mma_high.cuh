// The "high" rung's arithmetic on Hopper tensor cores, shared by the flat
// mat step (mat_high.cu) and the in-place one (split_block.cu).
//
// Each real product x.m is XLA's 3-pass bf16 decomposition
// xh.mh + xl.mh + xh.ml (h = x rounded to bf16, l = the bf16 of the
// residual), as the JAX package's _make_dot("high")
// (gpu_quantum_simulator_tpu/engine/prefetch.py:914).  The complex product
// is schoolbook: out_re = xr.A - xi.B, out_im = xr.B + xi.A: per output
// tile and k-chunk of 16, four hi.hi products (each four tf32 m16n8k4
// passes) and eight correction passes (bf16 m16n8k16).
//
// Where the sums are kept.  The JAX package adds three dots, each
// accumulated in fp32 and the three added with IEEE rounding.  An mma's
// fp32 sum is not rounded to nearest: it truncates, toward zero, so every
// pass fed into one accumulator that stays inside the tensor core shrinks
// each output by part of an ulp of the running sum, 96 times per output.
// The norm of the state fell by ~1.5e-6 per step on random states (and
// 5.7e-5 over the 692 steps of the n = 30 benchmark run).  Here:
//   * every hi.hi product is four m16n8k4 passes (4 terms each) from a
//     zeroed fragment, added to an fp32 sum on the CUDA cores, which
//     rounds to nearest: the tensor core truncates only 4-term partials,
//     whose sum is the output, not a running sum 16 times over.  The
//     operands are the same bf16 values, exact in tf32 (bf16's 8-bit
//     significand fits tf32's 11), and so are their products.  On an H100
//     the truncation's loss grew with the terms per pass (16, 8 and 4
//     were tried); chip_smoke.py's "high" drift phase holds this form to
//     the drift of the plain fp32 version over six seeds;
//   * the four correction passes (xl.mh, xh.ml) of a k-chunk, 2^-8 the
//     size of the hi.hi terms, run from a zeroed fragment of their own and
//     are added to the same fp32 sum, so their truncation is 2^-8 smaller
//     again and nothing stays in a tensor-core accumulator across chunks.
//
// The other places for the sums that were measured beside this one (one
// tensor-core accumulator for all passes; hi.hi and corrections in
// accumulators of their own; each k-chunk from a zeroed fragment) drift
// 16x to 180x more over 200 steps: PERF.md section 6 holds the readings.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace high {

constexpr int DVIEW = 256;
constexpr int TAB = DVIEW * DVIEW / 2;     // 32-bit words per bf16 table
constexpr uint32_t SIGN = 0x80008000u;     // flips two bf16 signs: -B, exact

// (x0, x1) -> bf16x2 hi and bf16x2 lo (x0 in the low 16 bits)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a.b for one 16 x 8 tile over k = 4, tf32 operands, c from zero
__device__ __forceinline__ void mma_k4(float* c, float a0, float a1,
                                      float b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(b)), "f"(0.f));
}

// the low / high bf16 of a bf16x2 word, as a float (exact)
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// sum += a.b over one k-chunk of 16, as four 4-term products each from a
// zeroed fragment, added in fp32 (see the header note).  The m16n8k16
// fragments split as they are: a[0] (row g), a[1] (row g + 8) and b0 hold
// k = 2t, 2t + 1 in their low and high halves, a[2], a[3] and b1 k = 2t + 8,
// 2t + 9.  Pass j gives thread t one k each (the m16n8k4 layout), so the
// four passes cover the chunk's k once.
__device__ __forceinline__ void mma_rn(float* sum, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  float t[4];
  mma_k4(t, bf_lo(a[0]), bf_lo(a[1]), bf_lo(b0));
#pragma unroll
  for (int e = 0; e < 4; ++e) sum[e] += t[e];
  mma_k4(t, bf_hi(a[0]), bf_hi(a[1]), bf_hi(b0));
#pragma unroll
  for (int e = 0; e < 4; ++e) sum[e] += t[e];
  mma_k4(t, bf_lo(a[2]), bf_lo(a[3]), bf_lo(b1));
#pragma unroll
  for (int e = 0; e < 4; ++e) sum[e] += t[e];
  mma_k4(t, bf_hi(a[2]), bf_hi(a[3]), bf_hi(b1));
#pragma unroll
  for (int e = 0; e < 4; ++e) sum[e] += t[e];
}

// A warp's MT x NT tile of m16n8 fragments, both output components' sums.
template <int MT, int NT>
struct Acc {
  float r[MT][NT][4], i[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int b = 0; b < NT; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) r[a][b][e] = i[a][b][e] = 0.f;
  }
};

// One k-chunk of 16 for the warp tile: A fragments of the state (split as
// loaded), B fragments from the four [n][k] bf16 tables w = [A_hi, A_lo,
// B_hi, B_lo] at column n0 + 8 nt of the n8 tile and 32-bit word kw of k.
template <int MT, int NT>
__device__ __forceinline__ void chunk(Acc<MT, NT>& acc,
                                      const uint32_t (&xrh)[MT][4],
                                      const uint32_t (&xrl)[MT][4],
                                      const uint32_t (&xih)[MT][4],
                                      const uint32_t (&xil)[MT][4],
                                      const uint32_t* __restrict__ w, int n0,
                                      int kw) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    // B fragments (col-major 16 x 8): b0 = k 2t, 2t + 1; b1 = k + 8
    const uint32_t* wn = w + (long long)(n0 + nt * 8) * (DVIEW / 2) + kw;
    const uint32_t ah0 = __ldg(wn), ah1 = __ldg(wn + 4);
    const uint32_t al0 = __ldg(wn + TAB), al1 = __ldg(wn + TAB + 4);
    const uint32_t bh0 = __ldg(wn + 2 * TAB), bh1 = __ldg(wn + 2 * TAB + 4);
    const uint32_t bl0 = __ldg(wn + 3 * TAB), bl1 = __ldg(wn + 3 * TAB + 4);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_rn(acc.r[mt][nt], xrh[mt], ah0, ah1);
      mma_rn(acc.r[mt][nt], xih[mt], bh0 ^ SIGN, bh1 ^ SIGN);
      mma_rn(acc.i[mt][nt], xrh[mt], bh0, bh1);
      mma_rn(acc.i[mt][nt], xih[mt], ah0, ah1);
      float cr[4] = {0.f, 0.f, 0.f, 0.f}, ci[4] = {0.f, 0.f, 0.f, 0.f};
      mma(cr, xrl[mt], ah0, ah1);
      mma(cr, xrh[mt], al0, al1);
      mma(cr, xil[mt], bh0 ^ SIGN, bh1 ^ SIGN);
      mma(cr, xih[mt], bl0 ^ SIGN, bl1 ^ SIGN);
      mma(ci, xrl[mt], bh0, bh1);
      mma(ci, xrh[mt], bl0, bl1);
      mma(ci, xil[mt], ah0, ah1);
      mma(ci, xih[mt], al0, al1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc.r[mt][nt][e] += cr[e];
        acc.i[mt][nt][e] += ci[e];
      }
    }
  }
}

}  // namespace high
