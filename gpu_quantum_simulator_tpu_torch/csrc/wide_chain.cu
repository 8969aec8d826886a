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
// length.  Tables are M itself, [n][k] with k contiguous: float32 [M_re,
// M_im] at "highest"; at "high" the four bf16 tables [Mre_hi, Mre_lo,
// Mim_hi, Mim_lo], split once per program (kernels/wide.py
// split_wide_tables), the col-major B fragment of mma.m16n8k16.
//
// On the TPU both kernels compute Karatsuba: t1 = (r + i).m1, t2 = r.m2,
// t3 = i.m3 with m1 = Mr^T, m2 = (Mi - Mr)^T, m3 = (Mr + Mi)^T, and
// re = t1 - t3, im = t1 + t2: three real products per complex one on the
// MXU, the tile resident in VMEM, tables in VMEM for the whole grid.
//
// What bounds it on the H100.  "highest" is IEEE fp32, so the CUDA cores:
// at n = 24 one product is 3 x 2^17 x 128 x 128 FMAs, 0.192 ms at the
// 67 TFLOP/s fp32 peak, against 0.08 ms to read and write the state once
// at 3.35 TB/s; a chain of 8 is further from memory still.  The CUDA
// cores have to be kept busy: an SM has 227 KB of shared memory (a TPU
// tile is 1 MB), registers hold the sums, and every table byte comes from
// L2 again for each row tile.
//
// "highest" design (chain_f32_kernel): Karatsuba, as the TPU kernels, 25%
// fewer FMAs than the four-product form.
//   * A persistent grid, one CTA of 256 threads per SM (220 KB of shared
//     memory), walks over 64-row tiles.  The tile lives in shared memory
//     once, as x_re, x_im and s = x_re + x_im (s formed once per element);
//     each product keeps its results in registers, and after one CTA
//     barrier writes them back into the tile it read (a chain) or to the
//     output rows (the last product).  The next tile's rows are already in
//     flight: a TMA bulk copy into a staging buffer, issued as soon as the
//     current tile has left it, completing on an mbarrier.
//   * The tables stream through a ring of two k-slices of 16: each thread
//     copies its 32 bytes of M_re and of M_im straight into the stage's m1
//     and m2 with cp.async one slice ahead, then forms m2 and m3 from its
//     own copies; one CTA barrier per slice (slices of 8 ran slower on an
//     H100).  Stages are [n][k] with a row stride of 20 floats,
//     conflict-free for the float4 reads below.
//   * Each warp owns 8 rows, each lane the columns lane + 32 c (c < 4):
//     96 fp32 sums a thread (t1, t2, t3 of 32 outputs), k summed in
//     ascending order by FMA.  Row values are float4 broadcasts along k;
//     table values float4 along k.
// What still holds it back: Karatsuba's extra operands.  A thread loads
// s, x_re, x_im and m1, m2, m3 where the four-product form loads two of
// each, and a warp's 16-byte shared-memory load seems to cost the pipe the
// same four cycles whether or not its lanes share the address; the FMAs
// saved do not pay for the loads.  Other forms tried on an H100 (k-major
// tiles and 4 x 4 thread tiles with 512 threads or two CTAs an SM; m2, m3
// and s formed in registers) were slower than this one (PERF.md section
// 6, PR 8).
// The output may be the input pair (the engines run in place): a tile is
// read whole, into shared memory, before any of its rows is written, and
// no CTA touches another's rows.  Ragged and tiny R (R = 2 at n = 8) work:
// rows past R are zeros in shared memory and are not stored.
//
// "high" (chain_high_kernel): the 3-pass bf16 product xh.mh + xl.mh +
// xh.ml on the tensor cores (mma.sync), schoolbook, the state split to
// bf16 hi/lo in registers as it is read; one CTA per 64-row tile, the tile
// double-buffered in shared memory between products.  Its sums are
// mma_high.cuh's: hi.hi products as 4-term tf32 passes from a zeroed
// fragment, every partial added in fp32 on the CUDA cores.  (One tensor-
// core accumulator for all passes, the first form, shrank |psi|^2 by
// 3.0e-4 over 200 products at n = 24: PERF.md section 6.)  At n = 24 one
// product is 51.5 GFLOP of bf16 MMA (0.05 ms at 989 TFLOP/s): one product
// is bound by memory, a chain of 8 by the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma_high.cuh"

namespace {

constexpr int LANES = 128;
constexpr int TILE = 64;                     // state rows per tile
constexpr int THREADS = 256;

// ------------------------------------------------------------ "highest"
constexpr int BK = 16;                       // k per table slice
constexpr int SLICES = LANES / BK;           // slices per product
constexpr int CK = BK + 4;                   // stage row stride ([n][CK])
constexpr int CHUNKS = LANES * BK / 4 / THREADS;  // 16-byte pieces a thread
constexpr int TILE_F = TILE * LANES;         // floats per tile component
constexpr int STAGE_F = 3 * LANES * CK;      // floats per stage: m1, m2, m3
// tile x_re, x_im, s | staging re, im | two stages
constexpr size_t F32_SMEM = (5 * TILE_F + 2 * STAGE_F) * sizeof(float);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// A thread's 8 rows x 4 columns of Karatsuba sums: t1 = s.m1, t2 =
// x_re.m2, t3 = x_im.m3; out_re = t1 - t3, out_im = t1 + t2.
struct Acc {
  float t1[8][4], t2[8][4], t3[8][4];     // [row][column]

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) t1[i][c] = t2[i][c] = t3[i][c] = 0.f;
  }
  __device__ __forceinline__ float re(int i, int c) const {
    return t1[i][c] - t3[i][c];
  }
  __device__ __forceinline__ float im(int i, int c) const {
    return t1[i][c] + t2[i][c];
  }
};

// m1, m2, m3 at 4 consecutive k (e) for the thread's 4 columns (c)
struct Cols {
  float m1[4][4], m2[4][4], m3[4][4];     // [k][column]
};

// The sums of 4 consecutive k for 8 rows: s, x_re, x_im of row i at
// xs + i * LANES, ... (4 floats, k ascending; every lane the same rows).
__device__ __forceinline__ void rows8(Acc& acc, const float* xs,
                                      const float* xr, const float* xi,
                                      const Cols& m) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 s4 = ld4(xs + i * LANES), r4 = ld4(xr + i * LANES),
                 x4 = ld4(xi + i * LANES);
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    const float r[4] = {r4.x, r4.y, r4.z, r4.w};
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc.t1[i][c] = fmaf(s[e], m.m1[e][c], acc.t1[i][c]);
        acc.t2[i][c] = fmaf(r[e], m.m2[e][c], acc.t2[i][c]);
        acc.t3[i][c] = fmaf(x[e], m.m3[e][c], acc.t3[i][c]);
      }
  }
}

// in/out are not __restrict__: the engines pass the same pair for both.
__global__ void __launch_bounds__(THREADS, 1)
chain_f32_kernel(const float* in_re, const float* in_im, float* out_re,
                 float* out_im, const float* __restrict__ m_re,
                 const float* __restrict__ m_im, long long mat_stride,
                 int nmats, long long rows) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t landed;   // the staged tile's barrier
  float* xr = smem;                          // row-major [TILE][LANES]
  float* xi = xr + TILE_F;
  float* xs = xi + TILE_F;
  float* nr = xs + TILE_F;                   // staging: the next tile
  float* ni = nr + TILE_F;
  float* stages = ni + TILE_F;

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 8;
  const long long tiles = (rows + TILE - 1) / TILE;
  const long long mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long total = mine * nmats * SLICES;    // slices of this CTA

  // the tile's rows from device memory into the staging buffer (thread 0)
  auto stage_tile = [&](long long it) {
    const long long row0 = (blockIdx.x + it * gridDim.x) * TILE;
    const long long valid = rows - row0 < TILE ? rows - row0 : TILE;
    const uint32_t bytes = (uint32_t)valid * LANES * sizeof(float);
    async::fence_async();
    async::bar_expect(&landed, 2 * bytes);
    async::bulk_copy(nr, in_re + row0 * LANES, bytes, &landed);
    async::bulk_copy(ni, in_im + row0 * LANES, bytes, &landed);
  };
  // staging -> tile (x_re, x_im, s); rows past R become zeros
  auto take_tile = [&](long long it) {
    const long long row0 = (blockIdx.x + it * gridDim.x) * TILE;
#pragma unroll
    for (int u = 0; u < TILE_F / 4 / THREADS; ++u) {
      const int q = (tid + u * THREADS) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (row0 + q / LANES < rows) {
        a = ld4(nr + q);
        b = ld4(ni + q);
      }
      st4(xr + q, a);
      st4(xi + q, b);
      st4(xs + q, make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w));
    }
  };
  // table slice g: this thread's 16-byte pieces j of M_re (into stage g's
  // m1) and of M_im (into its m2), column j / 4, k-quad j % 4
  auto issue_slice = [&](long long g) {
    if (g >= total) return;
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const int j = tid + u * THREADS, cn = j >> 2, cq = (j & 3) * 4;
      const long long o = (g / SLICES % nmats) * mat_stride + cn * LANES +
                          (g % SLICES) * BK + cq;
      float* st = stages + (g & 1) * STAGE_F + cn * CK + cq;
      async::cp16(st, m_re + o);
      async::cp16(st + LANES * CK, m_im + o);
    }
  };
  // m2 = M_im - M_re (in place of M_im), m3 = M_re + M_im, from this
  // thread's own copies
  auto form_slice = [&](long long g) {
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const int j = tid + u * THREADS, cn = j >> 2, cq = (j & 3) * 4;
      float* st = stages + (g & 1) * STAGE_F + cn * CK + cq;
      const float4 a = ld4(st), b = ld4(st + LANES * CK);
      st4(st + LANES * CK, make_float4(b.x - a.x, b.y - a.y, b.z - a.z,
                                       b.w - a.w));
      st4(st + 2 * LANES * CK, make_float4(a.x + b.x, a.y + b.y, a.z + b.z,
                                           a.w + b.w));
    }
  };

  if (tid == 0) {
    async::bar_init(&landed);
    async::bar_init_fence();
  }
  __syncthreads();
  uint32_t phase = 0;
  if (tid == 0) stage_tile(0);
  issue_slice(0);
  async::commit();
  async::bar_wait(&landed, phase);
  phase ^= 1;
  async::wait_groups<0>();
  take_tile(0);
  form_slice(0);
  __syncthreads();                           // staging read out; tile, stage 0
  if (tid == 0 && mine > 1) stage_tile(1);

  Acc acc;
  long long g = 0;
  for (long long it = 0; it < mine; ++it) {
    const long long row0 = (blockIdx.x + it * gridDim.x) * TILE;
    for (int j = 0; j < nmats; ++j) {
      acc.zero();
      for (int q = 0; q < SLICES; ++q, ++g) {
        issue_slice(g + 1);
        async::commit();
        const float* st = stages + (g & 1) * STAGE_F;
#pragma unroll
        for (int kq = 0; kq < BK; kq += 4) {
          Cols m;                            // columns lane + 32 c
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int o = (lane + 32 * c) * CK + kq;
            const float4 a1 = ld4(st + o), a2 = ld4(st + LANES * CK + o),
                         a3 = ld4(st + 2 * LANES * CK + o);
            m.m1[0][c] = a1.x; m.m1[1][c] = a1.y; m.m1[2][c] = a1.z; m.m1[3][c] = a1.w;
            m.m2[0][c] = a2.x; m.m2[1][c] = a2.y; m.m2[2][c] = a2.z; m.m2[3][c] = a2.w;
            m.m3[0][c] = a3.x; m.m3[1][c] = a3.y; m.m3[2][c] = a3.z; m.m3[3][c] = a3.w;
          }
          const int o = r0 * LANES + q * BK + kq;
          rows8(acc, xs + o, xr + o, xi + o, m);
        }
        async::wait_groups<0>();
        if (g + 1 < total) form_slice(g + 1);
        if (q + 1 < SLICES) __syncthreads();    // stage g + 1 formed
      }
      __syncthreads();          // every read of the tile (and stage) done
      if (j + 1 < nmats) {
        // the next product's input: the results, back into the tile
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int o = (r0 + i) * LANES + lane + 32 * c;
            const float re = acc.re(i, c), im = acc.im(i, c);
            xr[o] = re;
            xi[o] = im;
            xs[o] = re + im;
          }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (row0 + r0 + i >= rows) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const long long o = (row0 + r0 + i) * LANES + lane + 32 * c;
            out_re[o] = acc.re(i, c);
            out_im[o] = acc.im(i, c);
          }
        }
        if (it + 1 < mine) {
          async::bar_wait(&landed, phase);
          phase ^= 1;
          take_tile(it + 1);
        }
      }
      __syncthreads();          // the tile (re)written, stage g formed
      if (j + 1 == nmats && tid == 0 && it + 2 < mine) stage_tile(it + 2);
    }
  }
}

// ---------------------------------------------------------------- "high"
constexpr int LD = LANES + 8;                // shared row stride (floats)
constexpr int BUF = TILE * LD;               // floats per component buffer
constexpr size_t STATE_SMEM = 4 * BUF * sizeof(float);
constexpr int WARPS_N = 4, WM = 32, WN = 32; // warp grid and tile
constexpr int MT = WM / 16, NT = WN / 8;

// The CTA's rows [row0, row0 + TILE) into shared memory; zeros past rows.
__device__ void load_tile(const float* in_re, const float* in_im, float* s_re,
                          float* s_im, long long row0, long long rows) {
  for (int i = threadIdx.x; i < TILE * (LANES / 4); i += THREADS) {
    const int r = i / (LANES / 4), c = (i % (LANES / 4)) * 4;
    float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
    if (row0 + r < rows) {
      const long long o = (row0 + r) * LANES + c;
      vr = ld4(in_re + o);
      vi = ld4(in_im + o);
    }
    st4(s_re + r * LD + c, vr);
    st4(s_im + r * LD + c, vi);
  }
}

// o = x . M^T at "high" for the CTA's tile x (shared, stride LD); w: the
// product's four bf16 tables as 32-bit words.  The sums are mma_high.cuh's.
__device__ void product_high(const float* x_re, const float* x_im,
                             const uint32_t* __restrict__ w, float* o_re,
                             float* o_im, int ldo, long long valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group / thread in group
  const int row0 = (warp / WARPS_N) * WM, col0 = (warp % WARPS_N) * WN;
  high::Acc<MT, NT> acc;
  acc.zero();

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
        high::split2(vr.x, vr.y, xrh[mt][q], xrl[mt][q]);
        high::split2(vi.x, vi.y, xih[mt][q], xil[mt][q]);
      }
    high::chunk<MT, NT, LANES>(acc, xrh, xrl, xih, xil, w, col0 + g,
                               kk / 2 + t);
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
            make_float2(acc.r[mt][nt][2 * h], acc.r[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(o_im + o) =
            make_float2(acc.i[mt][nt][2 * h], acc.i[mt][nt][2 * h + 1]);
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
chain_high_kernel(const float* in_re, const float* in_im, float* out_re,
                  float* out_im, const uint32_t* __restrict__ w, int nmats,
                  long long rows) {
  extern __shared__ __align__(128) float smem[];
  const long long row0 = (long long)blockIdx.x * TILE;
  const long long valid = rows - row0 < TILE ? rows - row0 : TILE;
  load_tile(in_re, in_im, smem, smem + BUF, row0, rows);
  int cur = 0;
  for (int j = 0; j < nmats; ++j) {
    __syncthreads();          // the tile (or the last product) is written
    const float* x = smem + 2 * BUF * cur;
    const uint32_t* wj = w + (long long)j * 2 * LANES * LANES;
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

}  // namespace

extern "C" {

// The "highest" chain on an (rows, 128) state pair: nmats products with
// tables M_j at m_re + j * mat_stride and m_im + j * mat_stride (float32,
// [n][k]; mat_stride 0 with nmats 1 is one product).  out may be in.
// Every pointer 16-byte aligned.  The grid is persistent: as many CTAs as
// fit on the device, at most one per tile.
int qsim_wide_chain(const float* in_re, const float* in_im, float* out_re,
                    float* out_im, const float* m_re, const float* m_im,
                    long long mat_stride, int nmats, long long rows,
                    void* stream) {
  static bool attr = false;
  static int slots = 0;
  if (nmats < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = async::allow_smem(chain_f32_kernel, F32_SMEM, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (slots == 0 &&
      (e = async::persistent_slots(chain_f32_kernel, THREADS, F32_SMEM,
                                   &slots)) != cudaSuccess)
    return static_cast<int>(e);
  const long long tiles = (rows + TILE - 1) / TILE;
  const unsigned grid = (unsigned)(tiles < slots ? tiles : slots);
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
  const cudaError_t e =
      async::allow_smem(chain_high_kernel, STATE_SMEM, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = (unsigned)((rows + TILE - 1) / TILE);
  chain_high_kernel<<<grid, THREADS, STATE_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, static_cast<const uint32_t*>(w16), nmats,
      rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
