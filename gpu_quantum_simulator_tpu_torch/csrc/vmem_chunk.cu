// A chunk of up to 96 fused ops in one cooperative launch, for Hopper
// (sm_90a): the vmem strategy's kernel.
//
// Replaces: gpu_quantum_simulator_tpu/engine/vmem.py:62 _build_vmem_chunk
// (kernel 8), one pallas_call that applies a chunk's ops in order with the
// whole state (n <= 19) resident in VMEM, the op matrices streamed in by
// DMA, and no HBM round trip or launch between ops.
//
// The state is an (R, 128) float32 re/im pair, R = 2^(n-7), the low 7
// qubits on the columns.  An op over the lanes plus kh <= 2 row qubits
// (row bits b1 < b2) acts on the shuffled view A (2^n / D, D), D = 128 <<
// kh, whose column j reads state row row_of(p, j >> 7) at lane j & 127:
// the view's row index p fills the row bits other than b1, b2 in order, and
// bit 7 + j of the D index is row bit b_j (engine/vmem.py:132-153, the port's
// engine/wide.py row_shuffles).  The op is
//     out[p, i] = sum_j A[p, j] * M[i, j]      (complex),
// written back through the same map.  Tables hold Mt = M^T (D x D, row j)
// for re and im, as the JAX package stores them; the complex product is
// schoolbook, four real products, as the JAX kernel's four dots at
// Precision.HIGHEST (engine/vmem.py:155-161): IEEE fp32 FMA, no TF32.
//
// Design.  The state pair ping-pongs between the caller's pair (op 0's
// input) and a scratch pair: op t reads pair t & 1 and writes the other,
// so the result lies in the input pair after an even number of ops and in
// the scratch pair after an odd one.  At n <= 19 both pairs (8 MiB) stay
// in the 50 MB L2, which stands in for VMEM; state loads bypass L1
// (__ldcg), since other CTAs rewrite those lines between ops.  For each op
// the CTAs split the output tiles (32 view rows x 64 columns) among
// themselves; a CTA stages its A rows, read through the row map with no
// copy, and its Mt columns, 32 k at a time, in shared memory, its two
// 128-thread halves each take 16 of the 32 k (4 x 4 complex outputs per
// thread) and are summed through shared memory at the end.  A grid-wide
// barrier (cooperative_groups grid sync, the launch being cooperative)
// separates consecutive ops.  Each op's descriptor (kh, b1, b2, offset of
// its tables) is read by every block from a small device table.
//
// Grid fill: a tile is 2048 complex outputs and every op has 2^n outputs,
// so once an op has >= 32 view rows there are 2^n / 2048 tiles whatever D
// is: 128 at n = 18, 256 at n = 19.  The grid is the smaller of the most
// tiles of the chunk's ops and the co-resident blocks (occupancy x SMs),
// so at n = 18 each of 128 SMs holds one tile per op.
//
// What bounds it on the card: an op is 2^n x D complex multiply-adds, at
// least three real products (Karatsuba) = 6 * 2^n * D FLOP, 1.07 GFLOP
// for D = 512 at n = 18 (16 us at 67 TFLOP/s fp32), against 2 MiB of its
// matrices read once from device memory (0.6 us at 3.35 TB/s): fp32
// throughput, not bytes.  The design keeps the state out of device memory
// (L2) and the operands in registers (16 FMA per shared-memory load); it
// spends a fourth real product for the schoolbook form.  wgmma, TMA and
// 3xTF32 are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int BM = 32;                 // view rows per tile
constexpr int BN = 64;                 // output columns per tile
constexpr int BK = 32;                 // k staged per round
constexpr int KG = BK / 2;             // k per thread half per round
constexpr int LDA = BK + 4;            // A tile row stride (floats)
constexpr int A_FLOATS = BM * LDA;     // per component
constexpr int B_FLOATS = BK * BN;      // per component
constexpr int SMEM_FLOATS = 2 * A_FLOATS + 2 * B_FLOATS;
static_assert(2 * BM * BN <= SMEM_FLOATS, "the reduction buffer must fit");
static_assert(LANES % BK == 0 && LANES % BN == 0, "a round stays in a row");

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// State row of view row p for D-index high part h (bit 0 -> row bit b1,
// bit 1 -> row bit b2): p's bits fill the other row bits in order.
__device__ __forceinline__ int row_of(int p, int h, int kh, int b1, int b2) {
  if (kh == 0) return p;
  int r = ((p >> b1) << (b1 + 1)) | (p & ((1 << b1) - 1)) | ((h & 1) << b1);
  if (kh == 2)
    r = ((r >> b2) << (b2 + 1)) | (r & ((1 << b2) - 1)) | ((h >> 1) << b2);
  return r;
}

// One 32 x 64 output tile of one op: view rows [p0, p0 + BM) (< P valid),
// columns [i0, i0 + BN).
__device__ void tile_product(const float* src_re, const float* src_im,
                             float* dst_re, float* dst_im,
                             const float* __restrict__ mre,
                             const float* __restrict__ mim, int D, int P,
                             int kh, int b1, int b2, int p0, int i0,
                             float* smem) {
  float* as_re = smem;
  float* as_im = smem + A_FLOATS;
  float* bs_re = smem + 2 * A_FLOATS;
  float* bs_im = bs_re + B_FLOATS;
  const int tid = threadIdx.x;
  const int half = tid >> 7, lt = tid & 127, ty = lt >> 4, tx = lt & 15;
  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  const int a_row = tid >> 3, a_k = (tid & 7) * 4;
  const int ap = p0 + a_row;
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();     // the last round (or the last tile's sums) is read
    // A: one float4 of one view row per thread and component
    float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
    if (ap < P) {
      const long long o = (long long)row_of(ap, k0 >> 7, kh, b1, b2) * LANES +
                          (k0 & (LANES - 1)) + a_k;
      vr = __ldcg(reinterpret_cast<const float4*>(src_re + o));
      vi = __ldcg(reinterpret_cast<const float4*>(src_im + o));
    }
    *reinterpret_cast<float4*>(as_re + a_row * LDA + a_k) = vr;
    *reinterpret_cast<float4*>(as_im + a_row * LDA + a_k) = vi;
    // Mt rows k0 .. k0 + BK, columns i0 .. i0 + BN: two float4 each
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = tid + s * THREADS;
      const int kk = idx >> 4, iq = (idx & 15) * 4;
      const long long o = (long long)(k0 + kk) * D + i0 + iq;
      *reinterpret_cast<float4*>(bs_re + kk * BN + iq) =
          __ldg(reinterpret_cast<const float4*>(mre + o));
      *reinterpret_cast<float4*>(bs_im + kk * BN + iq) =
          __ldg(reinterpret_cast<const float4*>(mim + o));
    }
    __syncthreads();

#pragma unroll
    for (int kq = 0; kq < KG; kq += 4) {
      const int k = half * KG + kq;
      float4 ar[4], ai[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ar[i] = *reinterpret_cast<const float4*>(as_re + (ty * 4 + i) * LDA + k);
        ai[i] = *reinterpret_cast<const float4*>(as_im + (ty * 4 + i) * LDA + k);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 br4 = *reinterpret_cast<const float4*>(bs_re + (k + e) * BN + tx * 4);
        const float4 bi4 = *reinterpret_cast<const float4*>(bs_im + (k + e) * BN + tx * 4);
        const float br[4] = {br4.x, br4.y, br4.z, br4.w};
        const float bi[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xr = lane_of(ar[i], e), xi = lane_of(ai[i], e);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_r[i][j] = fmaf(xr, br[j], acc_r[i][j]);
            acc_r[i][j] = fmaf(-xi, bi[j], acc_r[i][j]);
            acc_i[i][j] = fmaf(xr, bi[j], acc_i[i][j]);
            acc_i[i][j] = fmaf(xi, br[j], acc_i[i][j]);
          }
        }
      }
    }
  }

  // the two halves' sums meet in shared memory; half 0 writes the tile
  __syncthreads();
  float* red_re = smem;
  float* red_im = smem + BM * BN;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = (ty * 4 + i) * BN + tx * 4;
      *reinterpret_cast<float4*>(red_re + o) =
          make_float4(acc_r[i][0], acc_r[i][1], acc_r[i][2], acc_r[i][3]);
      *reinterpret_cast<float4*>(red_im + o) =
          make_float4(acc_i[i][0], acc_i[i][1], acc_i[i][2], acc_i[i][3]);
    }
  }
  __syncthreads();
  if (half == 0) {
    const int lane0 = (i0 & (LANES - 1)) + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      if (p >= P) continue;
      const int o = (ty * 4 + i) * BN + tx * 4;
      const float4 rr = *reinterpret_cast<const float4*>(red_re + o);
      const float4 ri = *reinterpret_cast<const float4*>(red_im + o);
      const long long g =
          (long long)row_of(p, i0 >> 7, kh, b1, b2) * LANES + lane0;
      *reinterpret_cast<float4*>(dst_re + g) =
          make_float4(acc_r[i][0] + rr.x, acc_r[i][1] + rr.y,
                      acc_r[i][2] + rr.z, acc_r[i][3] + rr.w);
      *reinterpret_cast<float4*>(dst_im + g) =
          make_float4(acc_i[i][0] + ri.x, acc_i[i][1] + ri.y,
                      acc_i[i][2] + ri.z, acc_i[i][3] + ri.w);
    }
  }
}

// desc[t] = (kh, b1, b2, offset of op t's Mt_re in mats; Mt_im follows).
__global__ void __launch_bounds__(THREADS, 2)
vmem_chunk_kernel(float* re0, float* im0, float* re1, float* im1,
                  const float* __restrict__ mats,
                  const int4* __restrict__ desc, int nops, int num_qubits) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  cg::grid_group grid = cg::this_grid();
  const int amps = 1 << num_qubits;
  for (int t = 0; t < nops; ++t) {
    const int4 d = desc[t];
    const int kh = d.x, D = LANES << kh, P = amps / D;
    const int itiles = D / BN, ntiles = ((P + BM - 1) / BM) * itiles;
    const float* mre = mats + d.w;
    const float* mim = mre + (long long)D * D;
    const bool odd = t & 1;
    const float* src_re = odd ? re1 : re0;
    const float* src_im = odd ? im1 : im0;
    float* dst_re = odd ? re0 : re1;
    float* dst_im = odd ? im0 : im1;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int pt = tile / itiles;
      tile_product(src_re, src_im, dst_re, dst_im, mre, mim, D, P, kh, d.y,
                   d.z, pt * BM, (tile - pt * itiles) * BN, smem);
    }
    if (t + 1 < nops) grid.sync();   // op t's writes before op t + 1 reads
  }
}

}  // namespace

extern "C" {

// Apply nops ops to the (2^(num_qubits-7), 128) pair (re0, im0), with
// (re1, im1) as the scratch pair: the result lands in (re0, im0) when nops
// is even, in (re1, im1) when it is odd.  max_tiles: the most output tiles
// any op of the chunk has (the grid never exceeds it).  The grid size used
// is stored in *grid_out.  A cooperative launch that cannot be resident is
// refused and its error returned.
int qsim_vmem_chunk(float* re0, float* im0, float* re1, float* im1,
                    const float* mats, const int* desc, int nops,
                    int num_qubits, int max_tiles, int* grid_out,
                    void* stream) {
  if (nops < 1 || num_qubits < 8 || num_qubits > 30 || max_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vmem_chunk_kernel, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = per_sm * sms;
  if (grid > max_tiles) grid = max_tiles;
  *grid_out = grid;
  const int4* d4 = reinterpret_cast<const int4*>(desc);
  void* args[] = {&re0, &im0, &re1, &im1, &mats, &d4, &nops, &num_qubits};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(vmem_chunk_kernel),
                                  dim3(grid), dim3(THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
