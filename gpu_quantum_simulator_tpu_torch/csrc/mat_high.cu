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
// A = M_re^T, B = M_im^T (the block kernel's tables), so 12 bf16 MMA passes
// per complex product.  Schoolbook splits the raw state, not sums of its
// parts, so it is the more accurate of the two, and needs no operand adds.
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

#include "rowmap.cuh"

namespace {

constexpr int DVIEW = 256;
constexpr int HALF = 128;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int WM = 32, WN = 32;            // warp tile
constexpr int BM = WM * WARPS_M;           // 64 rows per CTA
constexpr int BN = WN * WARPS_N;           // 128 columns per CTA
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = WM / 16;                // m16 tiles per warp
constexpr int NT = WN / 8;                 // n8 tiles per warp
constexpr int TAB = DVIEW * DVIEW / 2;     // 32-bit words per bf16 table

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

  float acc_r[MT][NT][4], acc_i[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_r[i][j][e] = acc_i[i][j][e] = 0.f;

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
          split2(vr.x, vr.y, xrh[mt][q], xrl[mt][q]);
          split2(vi.x, vi.y, xih[mt][q], xil[mt][q]);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // B fragments (col-major 16 x 8): b0 = k 2t, 2t + 1; b1 = k + 8;
        // column n = g of the n8 tile; tables are [n][k] bf16
        const int n = col0 + nt * 8 + g;
        const int kw = (half * HALF + kk) / 2 + t;
        const uint32_t* wn = w + (long long)n * (DVIEW / 2) + kw;
        const uint32_t ah0 = __ldg(wn), ah1 = __ldg(wn + 4);
        const uint32_t al0 = __ldg(wn + TAB), al1 = __ldg(wn + TAB + 4);
        const uint32_t bh0 = __ldg(wn + 2 * TAB), bh1 = __ldg(wn + 2 * TAB + 4);
        const uint32_t bl0 = __ldg(wn + 3 * TAB), bl1 = __ldg(wn + 3 * TAB + 4);
        const uint32_t sign = 0x80008000u;   // -B, exact
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* cr = acc_r[mt][nt];
          float* ci = acc_i[mt][nt];
          mma(cr, xrh[mt], ah0, ah1);
          mma(cr, xrl[mt], ah0, ah1);
          mma(cr, xrh[mt], al0, al1);
          mma(cr, xih[mt], bh0 ^ sign, bh1 ^ sign);
          mma(cr, xil[mt], bh0 ^ sign, bh1 ^ sign);
          mma(cr, xih[mt], bl0 ^ sign, bl1 ^ sign);
          mma(ci, xrh[mt], bh0, bh1);
          mma(ci, xrl[mt], bh0, bh1);
          mma(ci, xrh[mt], bl0, bl1);
          mma(ci, xih[mt], ah0, ah1);
          mma(ci, xil[mt], ah0, ah1);
          mma(ci, xih[mt], al0, al1);
        }
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
        const long long o = r * DVIEW + col0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out_re + o) =
            make_float2(acc_r[mt][nt][2 * h], acc_r[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(out_im + o) =
            make_float2(acc_i[mt][nt][2 * h], acc_i[mt][nt][2 * h + 1]);
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
