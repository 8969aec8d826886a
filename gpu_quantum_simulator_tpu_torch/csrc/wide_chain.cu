// Chains of 128 x 128 complex right-products on the lane-layout state, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
//   gpu_quantum_simulator_tpu/engine/wide.py get_kh0_kernel (kernel 7): up
//     to KH0_BATCH = 8 consecutive kh = 0 blocks applied while a (512, 128)
//     row tile stays in VMEM, at precision "highest" or "high";
//   gpu_quantum_simulator_tpu/ops/pallas_kernels.py apply_block128
//     (kernel 9): one such product at "highest", the pallas engine's only
//     matrix step.
// Kernel 9 is kernel 7 with one matrix, so both are this one kernel.
//
// The state is an (R, 128) float32 re/im pair, R = 2^(n-7), the low 7
// qubits on the columns.  For each row tile the kernel applies
//   x <- x . M_j^T      (complex; j = 0 .. nmats-1)
// and the tile crosses device memory once per chain instead of once per
// product.  The identity pads that make a run's length a power of two in
// the JAX package's step list are not passed in: nmats is the run's true
// length.
//
// Complex form: SCHOOLBOOK, four real products per complex product,
//   out_re = xr.Mr^T - xi.Mi^T,  out_im = xr.Mi^T + xi.Mr^T,
// where the JAX package uses Karatsuba (three products on combined
// operands).  Schoolbook rounds the raw state and tables, not sums of them,
// and at "high" splits only raw values into bf16 parts (as mat_high.cu).
// Tables are M itself, [n][k] with k contiguous: float32 [M_re, M_im] at
// "highest"; at "high" the four bf16 tables [Mre_hi, Mre_lo, Mim_hi,
// Mim_lo] split once per program on the host side (kernels/wide.py
// split_wide_tables), which is the col-major B fragment of mma.m16n8k16.
//
// Design (simple, right first): one CTA of 256 threads per 64-row tile.
// The tile lives in shared memory, double-buffered between products (row
// stride 136 floats: the bf16 path's float2 fragments are conflict-free);
// two buffers x (re, im) x 64 x 136 x 4 B = 139 KB, so dynamic shared
// memory above 48 KB (cudaFuncSetAttribute).  The matrices are read from
// global memory (128 KB per product, L2-resident across CTAs).
//   "highest": IEEE fp32 FMA on the CUDA cores.  Each warp owns 8 rows,
//     each lane 4 columns (32 complex accumulators); M is staged 16 k at a
//     time into shared memory as [k][n] (16 KB more); the tile's values are
//     broadcast reads.
//   "high": the 3-pass bf16 product xh.mh + xl.mh + xh.ml with fp32
//     accumulation on the tensor cores (mma.sync m16n8k16, 12 per k-slice
//     per output tile), the state split to bf16 hi/lo in registers as it is
//     read, -Mi as a sign flip of the bf16 words; 2 x 4 warps of 32 x 32.
// A CTA reads its whole tile before it writes any of it and touches no
// other rows, so the output may be the input pair (the engines run in
// place).  No wgmma, TMA or tuning yet.
//
// What bounds it on the card: at n = 24 one product is 4 real products of
// (2^17 x 128) @ (128 x 128), 17.2 GFLOP, ~0.26 ms at 67 TFLOP/s fp32,
// against 256 MB of state moved per chain (~0.08 ms at 3.35 TB/s): at
// "highest" it is bound by fp32 throughput even at one product, so
// chaining saves traffic the CUDA cores do not need.  At "high" one
// product is 51.5 GFLOP of bf16 MMA (0.05 ms at 989 TFLOP/s): one product
// is bound by memory, a chain of 8 by the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int TILE = 64;                     // state rows per CTA
constexpr int THREADS = 256;
constexpr int LD = LANES + 8;                // shared row stride (floats)
constexpr int BUF = TILE * LD;               // floats per component buffer
constexpr int BK = 16;                       // k-slice staged ("highest")
constexpr size_t STATE_SMEM = 4 * BUF * sizeof(float);
constexpr size_t F32_SMEM = STATE_SMEM + 2 * BK * LANES * sizeof(float);
constexpr int TAB = LANES * LANES / 2;       // 32-bit words per bf16 table
constexpr int WARPS_N = 4, WM = 32, WN = 32; // "high" warp grid and tile
constexpr int MT = WM / 16, NT = WN / 8;

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The CTA's rows [row0, row0 + TILE) into shared memory; zeros past rows.
__device__ void load_tile(const float* in_re, const float* in_im, float* s_re,
                          float* s_im, long long row0, long long rows) {
  for (int i = threadIdx.x; i < TILE * (LANES / 4); i += THREADS) {
    const int r = i / (LANES / 4), c = (i % (LANES / 4)) * 4;
    float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
    if (row0 + r < rows) {
      const long long o = (row0 + r) * LANES + c;
      vr = *reinterpret_cast<const float4*>(in_re + o);
      vi = *reinterpret_cast<const float4*>(in_im + o);
    }
    *reinterpret_cast<float4*>(s_re + r * LD + c) = vr;
    *reinterpret_cast<float4*>(s_im + r * LD + c) = vi;
  }
}

// o = x . M^T at "highest" for the CTA's tile x (shared, stride LD); o has
// row stride ldo and `valid` rows are stored.
__device__ void product_f32(const float* x_re, const float* x_im,
                            const float* __restrict__ m_re,
                            const float* __restrict__ m_im, float* a_re,
                            float* a_im, float* o_re, float* o_im, int ldo,
                            long long valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 8, c0 = lane * 4;
  const int sn = threadIdx.x & (LANES - 1), sk = (threadIdx.x >> 7) * 8;
  float acc_r[8][4], acc_i[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  for (int k0 = 0; k0 < LANES; k0 += BK) {
    __syncthreads();          // the tile is written, the last slice consumed
    // stage a[k][n] = M[n][k0 + k] for k < BK: 8 k of one n per thread
    const float* gr = m_re + sn * LANES + k0 + sk;
    const float* gi = m_im + sn * LANES + k0 + sk;
    const float4 r0v = __ldg(reinterpret_cast<const float4*>(gr));
    const float4 r1v = __ldg(reinterpret_cast<const float4*>(gr + 4));
    const float4 i0v = __ldg(reinterpret_cast<const float4*>(gi));
    const float4 i1v = __ldg(reinterpret_cast<const float4*>(gi + 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a_re[(sk + e) * LANES + sn] = lane_of(r0v, e);
      a_re[(sk + 4 + e) * LANES + sn] = lane_of(r1v, e);
      a_im[(sk + e) * LANES + sn] = lane_of(i0v, e);
      a_im[(sk + 4 + e) * LANES + sn] = lane_of(i1v, e);
    }
    __syncthreads();

#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 xr4[8], xi4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int o = (r0 + i) * LD + k0 + kq;
        xr4[i] = *reinterpret_cast<const float4*>(x_re + o);
        xi4[i] = *reinterpret_cast<const float4*>(x_im + o);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 ar4 = *reinterpret_cast<const float4*>(a_re + (kq + e) * LANES + c0);
        const float4 ai4 = *reinterpret_cast<const float4*>(a_im + (kq + e) * LANES + c0);
        const float ar[4] = {ar4.x, ar4.y, ar4.z, ar4.w};
        const float ai[4] = {ai4.x, ai4.y, ai4.z, ai4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xr = lane_of(xr4[i], e), xi = lane_of(xi4[i], e);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_r[i][j] = fmaf(xr, ar[j], acc_r[i][j]);
            acc_r[i][j] = fmaf(-xi, ai[j], acc_r[i][j]);
            acc_i[i][j] = fmaf(xr, ai[j], acc_i[i][j]);
            acc_i[i][j] = fmaf(xi, ar[j], acc_i[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (r0 + i >= valid) continue;
    const long long o = (long long)(r0 + i) * ldo + c0;
    *reinterpret_cast<float4*>(o_re + o) =
        make_float4(acc_r[i][0], acc_r[i][1], acc_r[i][2], acc_r[i][3]);
    *reinterpret_cast<float4*>(o_im + o) =
        make_float4(acc_i[i][0], acc_i[i][1], acc_i[i][2], acc_i[i][3]);
  }
}

// (x0, x1) -> bf16x2 hi and bf16x2 lo (x0 in the low 16 bits), as in
// mat_high.cu
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

// o = x . M^T at "high" for the CTA's tile x (shared, stride LD); w: the
// product's four bf16 tables as 32-bit words.
__device__ void product_high(const float* x_re, const float* x_im,
                             const uint32_t* __restrict__ w, float* o_re,
                             float* o_im, int ldo, long long valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  const int row0 = (warp / WARPS_N) * WM, col0 = (warp % WARPS_N) * WN;
  float acc_r[MT][NT][4], acc_i[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_r[i][j][e] = acc_i[i][j][e] = 0.f;

#pragma unroll 2
  for (int kk = 0; kk < LANES; kk += 16) {
    // A fragments (row-major 16 x 16): reg q holds row g + 8 (q & 1),
    // columns 2t, 2t + 1 (+ 8 for q >= 2)
    uint32_t xrh[MT][4], xrl[MT][4], xih[MT][4], xil[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = (row0 + mt * 16 + g + 8 * (q & 1)) * LD + kk + 2 * t +
                      (q >> 1) * 8;
        const float2 vr = *reinterpret_cast<const float2*>(x_re + o);
        const float2 vi = *reinterpret_cast<const float2*>(x_im + o);
        split2(vr.x, vr.y, xrh[mt][q], xrl[mt][q]);
        split2(vi.x, vi.y, xih[mt][q], xil[mt][q]);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // B fragments (col-major 16 x 8): b0 = k 2t, 2t + 1; b1 = k + 8;
      // column n = g of the n8 tile; tables are [n][k] bf16
      const int n = col0 + nt * 8 + g;
      const uint32_t* wn = w + n * (LANES / 2) + kk / 2 + t;
      const uint32_t ah0 = __ldg(wn), ah1 = __ldg(wn + 4);
      const uint32_t al0 = __ldg(wn + TAB), al1 = __ldg(wn + TAB + 4);
      const uint32_t bh0 = __ldg(wn + 2 * TAB), bh1 = __ldg(wn + 2 * TAB + 4);
      const uint32_t bl0 = __ldg(wn + 3 * TAB), bl1 = __ldg(wn + 3 * TAB + 4);
      const uint32_t sign = 0x80008000u;   // -Mi, exact
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

  // C fragments: e = 0, 1 row g, columns 2t, 2t + 1; e = 2, 3 row g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mt * 16 + g + 8 * h;
      if (r >= valid) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const long long o = (long long)r * ldo + col0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(o_re + o) =
            make_float2(acc_r[mt][nt][2 * h], acc_r[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(o_im + o) =
            make_float2(acc_i[mt][nt][2 * h], acc_i[mt][nt][2 * h + 1]);
      }
    }
}

// in/out are not __restrict__: the engines pass the same pair for both.
__global__ void __launch_bounds__(THREADS, 1)
chain_f32_kernel(const float* in_re, const float* in_im, float* out_re,
                 float* out_im, const float* __restrict__ m_re,
                 const float* __restrict__ m_im, long long mat_stride,
                 int nmats, long long rows) {
  extern __shared__ __align__(16) float smem[];
  float* a_re = smem + 4 * BUF;
  float* a_im = a_re + BK * LANES;
  const long long row0 = (long long)blockIdx.x * TILE;
  const long long valid = rows - row0 < TILE ? rows - row0 : TILE;
  load_tile(in_re, in_im, smem, smem + BUF, row0, rows);
  int cur = 0;
  for (int j = 0; j < nmats; ++j) {
    const float* x = smem + 2 * BUF * cur;
    const float* mr = m_re + j * mat_stride;
    const float* mi = m_im + j * mat_stride;
    if (j == nmats - 1) {
      product_f32(x, x + BUF, mr, mi, a_re, a_im, out_re + row0 * LANES,
                  out_im + row0 * LANES, LANES, valid);
    } else {
      float* y = smem + 2 * BUF * (cur ^ 1);
      product_f32(x, x + BUF, mr, mi, a_re, a_im, y, y + BUF, LD, TILE);
      cur ^= 1;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
chain_high_kernel(const float* in_re, const float* in_im, float* out_re,
                  float* out_im, const uint32_t* __restrict__ w, int nmats,
                  long long rows) {
  extern __shared__ __align__(16) float smem[];
  const long long row0 = (long long)blockIdx.x * TILE;
  const long long valid = rows - row0 < TILE ? rows - row0 : TILE;
  load_tile(in_re, in_im, smem, smem + BUF, row0, rows);
  int cur = 0;
  for (int j = 0; j < nmats; ++j) {
    __syncthreads();          // the tile (or the last product) is written
    const float* x = smem + 2 * BUF * cur;
    const uint32_t* wj = w + (long long)j * 4 * TAB;
    if (j == nmats - 1) {
      product_high(x, x + BUF, wj, out_re + row0 * LANES,
                   out_im + row0 * LANES, LANES, valid);
    } else {
      float* y = smem + 2 * BUF * (cur ^ 1);
      product_high(x, x + BUF, wj, y, y + BUF, LD, TILE);
      cur ^= 1;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *done = e == cudaSuccess;
  return e;
}

}  // namespace

extern "C" {

// The "highest" chain on an (rows, 128) state pair: nmats products with
// tables M_j at m_re + j * mat_stride and m_im + j * mat_stride (float32,
// [n][k]; mat_stride 0 with nmats 1 is one product).  out may be in.
int qsim_wide_chain(const float* in_re, const float* in_im, float* out_re,
                    float* out_im, const float* m_re, const float* m_im,
                    long long mat_stride, int nmats, long long rows,
                    void* stream) {
  static bool attr = false;
  if (nmats < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(chain_f32_kernel, F32_SMEM, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = (unsigned)((rows + TILE - 1) / TILE);
  chain_f32_kernel<<<grid, THREADS, F32_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, m_re, m_im, mat_stride, nmats, rows);
  return static_cast<int>(cudaGetLastError());
}

// The "high" chain: w16 holds nmats x [Mre_hi, Mre_lo, Mim_hi, Mim_lo]
// bf16 tables, each (128, 128) as [n][k].  out may be in.
int qsim_wide_chain_high(const float* in_re, const float* in_im,
                         float* out_re, float* out_im, const void* w16,
                         int nmats, long long rows, void* stream) {
  static bool attr = false;
  if (nmats < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(chain_high_kernel, STATE_SMEM, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = (unsigned)((rows + TILE - 1) / TILE);
  chain_high_kernel<<<grid, THREADS, STATE_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, static_cast<const uint32_t*>(w16), nmats,
      rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
