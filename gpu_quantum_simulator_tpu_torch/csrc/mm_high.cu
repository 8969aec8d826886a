// The mxu engine's mm step at the "high" rung, for Hopper (sm_90a) tensor
// cores: one launch per step.
//
// Replaces: the "high" product of gpu_quantum_simulator_tpu/engine/wide.py
// _apply_wide_karatsuba (:183-198), which XLA computes outside any Pallas
// kernel: three jnp.matmul(..., precision=HIGH), each XLA's 3-pass bf16
// product summed in fp32.  On the shuffled state x (M, D), D = 128 << kh:
//     t1 = (xr + xi).m1,  t2 = xr.m2,  t3 = xi.m3
//     out_re = t1 - t3,   out_im = t1 + t2
// with m1 = M_re^T, m2 = (M_im - M_re)^T, m3 = (M_re + M_im)^T, each real
// product x.m = xh.mh + xl.mh + xh.ml (h = bf16 of x, l = bf16 of x - h).
// The port first ran it as three cuBLAS bf16 GEMMs a product; their fp32
// sums stay in the tensor core, whose adds truncate, and |psi|^2 fell by
// ~7.7e-5 over 200 steps at n = 24.  Here every sum is kept as
// mma_high.cuh keeps it (real_product: hi.hi as 4-term tf32 passes from a
// zeroed fragment, the corrections from a zeroed fragment of their own,
// every partial added in fp32 on the CUDA cores), and the Karatsuba
// combine is IEEE fp32.
//
// Operands: x is read as fp32 and split to bf16 (hi, lo) in registers, s =
// xr + xi formed in fp32 first (as the JAX package adds re_m + im_m); no
// bf16 copy of the state is written.  The tables are split once per
// program (kernels/wide.py split_mm_tables): six bf16 tables [m1_hi,
// m1_lo, m2_hi, m2_lo, m3_hi, m3_lo], each [n][k], the col-major B
// fragment of mma.m16n8k16.
//
// What bounds it on the card: at n = 24, D = 512 a step is 9 bf16
// products of (32768 x 512) @ (512 x 512), 154.6 GFLOP, 0.156 ms at 989
// TFLOP/s, against 268 MB of state moved (0.080 ms at 3.35 TB/s): the
// tensor cores.  This first form is mat_high.cu's: mma.sync, no shared
// memory, a 32 x 32 warp tile of the three sums, fragments loaded from
// global memory (the tables stay in L2, the rows are shared through L1 by
// the CTA's four column warps, and through L2 by the row block's column
// tiles, which run as neighbouring CTAs: on an H100 this ran faster than
// column tiles a grid apart, and five other warp and CTA tilings slower;
// PERF.md section 6).  Shared-memory staging of the tables, wgmma, TMA,
// and reading the state through the row map (no shuffle copies) are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_high.cuh"

namespace {

constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int WM = 32, WN = 32;            // warp tile
constexpr int BM = WM * WARPS_M;           // 64 rows per CTA
constexpr int BN = WN * WARPS_N;           // 128 columns per CTA
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = WM / 16;                // m16 tiles per warp
constexpr int NT = WN / 8;                 // n8 tiles per warp

template <int D>
__global__ void __launch_bounds__(THREADS)
mm_high_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ out_re, float* __restrict__ out_im,
               const uint32_t* __restrict__ w, long long rows) {
  constexpr int TAB = D * D / 2;           // 32-bit words per bf16 table
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  // the D / BN column tiles of a row block are neighbouring CTAs, so the
  // block's rows are read from device memory once and then hit in L2
  constexpr int CT = D / BN;
  const long long row0 =
      (long long)(blockIdx.x / CT) * BM + (warp / WARPS_N) * WM;
  const int col0 = (blockIdx.x % CT) * BN + (warp % WARPS_N) * WN;

  float t1[MT][NT][4], t2[MT][NT][4], t3[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        t1[a][b][e] = t2[a][b][e] = t3[a][b][e] = 0.f;

  bool valid[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      valid[mt][h] = row0 + mt * 16 + g + 8 * h < rows;

#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 16) {
    // A fragments (row-major 16 x 16): reg q holds row g + 8 (q & 1),
    // columns 2t, 2t + 1 (+ 8 for q >= 2)
    uint32_t sh[MT][4], sl[MT][4], rh[MT][4], rl[MT][4], ih[MT][4], il[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1;
        float2 vr = make_float2(0.f, 0.f), vi = vr;
        if (valid[mt][h]) {
          const long long o = (row0 + mt * 16 + g + 8 * h) * D + k0 + 2 * t +
                              (q >> 1) * 8;
          vr = *reinterpret_cast<const float2*>(xr + o);
          vi = *reinterpret_cast<const float2*>(xi + o);
        }
        high::split2(vr.x + vi.x, vr.y + vi.y, sh[mt][q], sl[mt][q]);
        high::split2(vr.x, vr.y, rh[mt][q], rl[mt][q]);
        high::split2(vi.x, vi.y, ih[mt][q], il[mt][q]);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // B fragments (col-major 16 x 8) of column n = col0 + 8 nt + g:
      // b0 = k 2t, 2t + 1; b1 = k + 8
      const uint32_t* wn =
          w + (long long)(col0 + nt * 8 + g) * (D / 2) + k0 / 2 + t;
      uint32_t b[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b[c][0] = __ldg(wn + 2 * c * TAB);
        b[c][1] = __ldg(wn + 2 * c * TAB + 4);
        b[c][2] = __ldg(wn + (2 * c + 1) * TAB);
        b[c][3] = __ldg(wn + (2 * c + 1) * TAB + 4);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        high::real_product(t1[mt][nt], sh[mt], sl[mt], b[0]);
        high::real_product(t2[mt][nt], rh[mt], rl[mt], b[1]);
        high::real_product(t3[mt][nt], ih[mt], il[mt], b[2]);
      }
    }
  }

  // C fragments: e = 0, 1 row g, columns 2t, 2t + 1; e = 2, 3 row g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[mt][h]) continue;
      const long long r = row0 + mt * 16 + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const long long o = r * D + col0 + nt * 8 + 2 * t;
        const float* a = t1[mt][nt] + 2 * h;
        const float* b2 = t2[mt][nt] + 2 * h;
        const float* b3 = t3[mt][nt] + 2 * h;
        *reinterpret_cast<float2*>(out_re + o) =
            make_float2(a[0] - b3[0], a[1] - b3[1]);
        *reinterpret_cast<float2*>(out_im + o) =
            make_float2(a[0] + b2[0], a[1] + b2[1]);
      }
    }
}

template <int D>
cudaError_t launch(const float* xr, const float* xi, float* out_re,
                   float* out_im, const void* w16, long long rows,
                   cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + BM - 1) / BM) * (D / BN);
  mm_high_kernel<D><<<grid, THREADS, 0, stream>>>(
      xr, xi, out_re, out_im, static_cast<const uint32_t*>(w16), rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One "high" mm step: (xr + i xi) (rows, D) times the Karatsuba tables w16
// (six bf16 (D, D) tables [m1_hi, m1_lo, m2_hi, m2_lo, m3_hi, m3_lo], each
// [n][k]) into (out_re, out_im) (rows, D); D = 128, 256 or 512.
int qsim_mm_step_high(const float* xr, const float* xi, float* out_re,
                      float* out_im, const void* w16, long long rows, int D,
                      void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 128) e = launch<128>(xr, xi, out_re, out_im, w16, rows, s);
  if (D == 256) e = launch<256>(xr, xi, out_re, out_im, w16, rows, s);
  if (D == 512) e = launch<512>(xr, xi, out_re, out_im, w16, rows, s);
  return static_cast<int>(e);
}

}  // extern "C"
