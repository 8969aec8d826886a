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
// and needs no operand adds.  The passes and where their sums are kept
// (every partial product summed in fp32 on the CUDA cores, so that the
// tensor core's truncating adds do not shrink the norm) are mma_high.cuh.
//
// Operands: the state is split as it is loaded, in registers, into the
// mma.sync A fragments (fp32 -> bf16 hi + bf16 lo).  The tables are split
// once per circuit on the host side of the call (kernels/block.py
// split_tables): four bf16 tables [A_hi, A_lo, B_hi, B_lo], each stored
// transposed, [n][k] with k contiguous, which is the col-major B fragment
// of mma.m16n8k16 (two k-adjacent bf16 per 32-bit register).  -B is
// formed by flipping the bf16 sign bits in registers (exact).
//
// What bounds it on the card: at n = 24 one step is 12 real products of
// (2^16 x 256) @ (256 x 256), 103 GFLOP of bf16 MMA, against 256 MB of
// state moved, ~400 FLOP/B: bound by tensor-core throughput (989 TFLOP/s
// dense bf16 published at 700 W).  This first form is simple: mma.sync
// (not wgmma), no shared memory, each warp computes a 32 x 32 tile of both
// outputs from fragments loaded straight from global memory (the tables
// are 512 KB per slot and stay in L2; the state rows are reused through
// L1 by the CTA's four column warps).  wgmma, TMA staging and a tile
// resident across steps are later work.
//
// Input maps as in prefetch_block.cu: steered (column bit 7 <-> a row bit)
// or folded relayout (rowmap.cuh), first launch of a block only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_high.cuh"
#include "rowmap.cuh"

namespace {

using high::DVIEW;
constexpr int HALF = 128;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int WM = 32, WN = 32;            // warp tile
constexpr int BM = WM * WARPS_M;           // 64 rows per CTA
constexpr int BN = WN * WARPS_N;           // 128 columns per CTA
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = WM / 16;                // m16 tiles per warp
constexpr int NT = WN / 8;                 // n8 tiles per warp

// out = map(in) @ (A + iB) on an (rows, 256) state at the "high" rung.
// w: the slot's four bf16 tables as 32-bit words, [A_hi, A_lo, B_hi, B_lo].
__global__ void __launch_bounds__(THREADS)
mat_high_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                float* __restrict__ out_re, float* __restrict__ out_im,
                const uint32_t* __restrict__ w, long long rows, int steer_row,
                Fold fold) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  const long long row0 = (long long)blockIdx.x * BM + (warp / WARPS_N) * WM;
  const int col0 = blockIdx.y * BN + (warp % WARPS_N) * WN;

  high::Acc<MT, NT> acc;
  acc.zero();

  // this thread's A-fragment rows: row0 + 16 mt + g + 8 h
  bool valid[MT][2];
  long long frow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = row0 + mt * 16 + g + 8 * h;
      valid[mt][h] = r < rows;
      frow[mt][h] = fold.m > 0 ? fold_row(r, fold) : r;
    }

  for (int half = 0; half < 2; ++half) {     // column half of the k index
    // element offset of (row, k = 128 * half) through the input map
    long long off[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + mt * 16 + g + 8 * h;
        long long sr = frow[mt][h];
        int sh = half;
        if (steer_row >= 0 && ((half ^ (int)(r >> steer_row)) & 1)) {
          sr = r ^ (1LL << steer_row);
          sh ^= 1;
        }
        off[mt][h] = sr * DVIEW + sh * HALF;
      }

#pragma unroll 2
    for (int kk = 0; kk < HALF; kk += 16) {
      // A fragments (row-major 16 x 16): reg q holds row g + 8 (q & 1),
      // columns 2t, 2t + 1 (+ 8 for q >= 2)
      uint32_t xrh[MT][4], xrl[MT][4], xih[MT][4], xil[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q & 1;
          float2 vr = make_float2(0.f, 0.f), vi = vr;
          if (valid[mt][h]) {
            const long long o = off[mt][h] + kk + 2 * t + (q >> 1) * 8;
            vr = *reinterpret_cast<const float2*>(in_re + o);
            vi = *reinterpret_cast<const float2*>(in_im + o);
          }
          high::split2(vr.x, vr.y, xrh[mt][q], xrl[mt][q]);
          high::split2(vi.x, vi.y, xih[mt][q], xil[mt][q]);
        }
      // B fragments (col-major 16 x 8) of column n = col0 + 8 nt + g
      high::chunk(acc, xrh, xrl, xih, xil, w, col0 + g,
                  (half * HALF + kk) / 2 + t);
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
        const long long o = r * DVIEW + col0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out_re + o) =
            make_float2(acc.r[mt][nt][2 * h], acc.r[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(out_im + o) =
            make_float2(acc.i[mt][nt][2 * h], acc.i[mt][nt][2 * h + 1]);
      }
    }
}

}  // namespace

extern "C" {

// One "high"-rung mat step on an (rows, 256) state pair.  w16: the slot's
// [A_hi, A_lo, B_hi, B_lo] bf16 tables, each (256, 256) as [n][k];
// steer_bit: flat bit (>= 8) exchanged with bit 7 on input, or -1;
// sigma/m/tr: the folded relayout on input (m = 0: none).
int qsim_mat_step_high(const float* in_re, const float* in_im, float* out_re,
                       float* out_im, const void* w16, long long rows,
                       int steer_bit, const int* sigma, int m, int tr,
                       void* stream) {
  Fold fold;
  if (!make_fold(&fold, sigma, m, tr) || (m > 0 && steer_bit >= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((unsigned)((rows + BM - 1) / BM), DVIEW / BN);
  mat_high_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, static_cast<const uint32_t*>(w16), rows,
      steer_bit >= 0 ? steer_bit - 8 : -1, fold);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
