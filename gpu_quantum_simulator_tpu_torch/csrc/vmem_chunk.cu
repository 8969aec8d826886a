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
// in the 50 MB L2, which stands in for VMEM; state reads bypass L1
// (cp.async.cg), since other CTAs rewrite those lines between ops.  A
// grid-wide barrier (cooperative_groups grid sync, the launch being
// cooperative) separates consecutive ops; each op's descriptor (kh, b1,
// b2, offset of its tables) is read by every block from a small device
// table.  For each op the CTAs split the output tiles (32 view rows x 64
// columns) among themselves:
//   * a CTA of 256 threads is four k-groups of 64; group g sums the
//     tile's products over k in [g D / 4, (g + 1) D / 4), a thread 4 x 8
//     complex outputs (rows 8 apart, two runs of four columns), so six
//     16-byte shared loads feed 128 FMAs a k (7 FMAs a float loaded);
//   * each group stages its own k-slices of 16 (the A rows, read through
//     the row map with no copy, row-major; the Mt slices) with
//     cp.async in a three-slice ring two slices ahead, across the tiles of
//     an op, with one 64-thread named barrier a slice;
//   * at a tile's end the four groups' sums meet in shared memory, added
//     in group order, and the CTA writes the tile through the row map;
//   * the table slices of the next op's first two slices are copied
//     before the grid barrier (the tables do not depend on the state), its
//     rows after it.
//
// Grid fill: a tile is 2048 complex outputs and every op has 2^n outputs,
// so once an op has >= 32 view rows there are 2^n / 2048 tiles whatever D
// is: 128 at n = 18, 256 at n = 19.  The grid is the smaller of the most
// tiles of the chunk's ops and the co-resident blocks (one an SM, for its
// 220 KB of shared memory and 256 threads of many registers), so at n = 18
// each of 128 SMs holds one tile per op, with eight warps.
//
// What bounds it on the card: an op is 2^n x D complex multiply-adds, at
// least three real products (Karatsuba) = 6 * 2^n * D FLOP, 1.07 GFLOP
// for D = 512 at n = 18 (16 us at 67 TFLOP/s fp32), against 2 MiB of its
// matrices read once from device memory (0.6 us at 3.35 TB/s): fp32
// throughput, not bytes.  A Karatsuba form (three products, two more
// tables of combinations, 96 FMAs a k) ran barely faster on an H100 for
// twice the tables.  wgmma, TMA and 3xTF32 are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int GROUPS = 4;                      // k-groups of 64 threads
constexpr int GT = THREADS / GROUPS;
constexpr int BM = 32;                         // view rows per tile
constexpr int BN = 64;                         // output columns per tile
constexpr int BK = 16;                         // k per slice
constexpr int STAGES = 3;                      // a group's slice ring
constexpr int LDA = BK + 4;                    // A row stride (floats)
constexpr int A_F = BM * LDA;                  // A, one component
constexpr int M_F = BK * BN;                   // Mt slice, one component
constexpr int SLOT = 2 * A_F + 2 * M_F;        // one slice of one group
constexpr int RING = GROUPS * STAGES * SLOT;
constexpr int RED = GROUPS * 2 * BM * BN;      // the groups' partial tiles
constexpr size_t SMEM = (size_t)(RING + RED) * sizeof(float);
static_assert(LANES % BN == 0 && LANES % BK == 0, "a slice stays in a row");

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

// One op as the CTAs see it.
struct OpView {
  int kh, b1, b2, D, P, itiles, ntiles, nsl, mine;
  const float* mre;
  const float* src_re;
  const float* src_im;
  float* dst_re;
  float* dst_im;
};

__device__ __forceinline__ OpView op_view(const int4* __restrict__ desc,
                                          const float* mats, int t, int amps,
                                          float* re0, float* im0, float* re1,
                                          float* im1) {
  const int4 d = desc[t];
  OpView v;
  v.kh = d.x;
  v.b1 = d.y;
  v.b2 = d.z;
  v.D = LANES << v.kh;
  v.P = amps / v.D;
  v.itiles = v.D / BN;
  v.ntiles = ((v.P + BM - 1) / BM) * v.itiles;
  v.nsl = v.D / (GROUPS * BK);
  v.mine = (int)blockIdx.x < v.ntiles
               ? (v.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
               : 0;
  v.mre = mats + d.w;
  const bool odd = t & 1;
  v.src_re = odd ? re1 : re0;
  v.src_im = odd ? im1 : im0;
  v.dst_re = odd ? re0 : re1;
  v.dst_im = odd ? im0 : im1;
  return v;
}

__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(GT) : "memory");
}

// desc[t] = (kh, b1, b2, offset of op t's Mt_re in mats; Mt_im follows).
__global__ void __launch_bounds__(THREADS, 1)
vmem_chunk_kernel(float* re0, float* im0, float* re1, float* im1,
                  const float* __restrict__ mats,
                  const int4* __restrict__ desc, int nops, int num_qubits) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int amps = 1 << num_qubits;
  const int tid = threadIdx.x, g = tid / GT, gt = tid % GT;
  const int tx = gt & 7, ty = gt >> 3;     // 8 column runs x 8 row groups
  float* ring = smem + g * STAGES * SLOT;
  float* red = smem + RING;

  // item i of the op: slice i % nsl of this CTA's tile i / nsl, this
  // group's k range; the Mt part and the A part copied separately
  auto tile_of = [&](const OpView& v, int i) {
    return (int)blockIdx.x + (i / v.nsl) * (int)gridDim.x;
  };
  auto k_of = [&](const OpView& v, int i) {
    return g * (v.D / GROUPS) + (i % v.nsl) * BK;
  };
  auto issue_m = [&](const OpView& v, int i) {
    if (i >= v.mine * v.nsl) return;
    const int tile = tile_of(v, i), k0 = k_of(v, i);
    const int i0 = (tile % v.itiles) * BN;
    float* mr = ring + (i % STAGES) * SLOT + 2 * A_F;
    const float* mim = v.mre + (long long)v.D * v.D;
#pragma unroll
    for (int u = 0; u < M_F / 4 / GT; ++u) {
      const int p = gt + GT * u, kk = p >> 4, nq = (p & 15) * 4;
      const long long o = (long long)(k0 + kk) * v.D + i0 + nq;
      async::cp16(mr + kk * BN + nq, v.mre + o);
      async::cp16(mr + M_F + kk * BN + nq, mim + o);
    }
  };
  auto issue_a = [&](const OpView& v, int i) {
    if (i >= v.mine * v.nsl) return;
    const int tile = tile_of(v, i), k0 = k_of(v, i);
    const int p0 = (tile / v.itiles) * BM;
    float* ar = ring + (i % STAGES) * SLOT;
#pragma unroll
    for (int u = 0; u < BM * BK / 4 / GT; ++u) {
      const int p = gt + GT * u, row = p / (BK / 4), kq = p % (BK / 4) * 4;
      const bool ok = p0 + row < v.P;
      const int k = k0 + kq;
      const long long o =
          ok ? (long long)row_of(p0 + row, k >> 7, v.kh, v.b1, v.b2) * LANES +
                   (k & (LANES - 1))
             : 0;
      async::cp16(ar + row * LDA + kq, v.src_re + o, ok);
      async::cp16(ar + A_F + row * LDA + kq, v.src_im + o, ok);
    }
  };

  float acc_r[4][8], acc_i[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  OpView v = op_view(desc, mats, 0, amps, re0, im0, re1, im1);
  issue_m(v, 0);
  async::commit();
  issue_m(v, 1);
  async::commit();
  for (int t = 0; t < nops; ++t) {
    issue_a(v, 0);
    async::commit();
    issue_a(v, 1);
    async::commit();
    const int items = v.mine * v.nsl;
    for (int i = 0; i < items; ++i) {
      async::wait_groups<1>();
      group_sync(g);       // slice i landed; the group is done with i - 1
      issue_m(v, i + 2);
      issue_a(v, i + 2);
      async::commit();
      const float* ar = ring + (i % STAGES) * SLOT;
      const float* ai = ar + A_F;
      const float* mr = ai + A_F;
      const float* mi = mr + M_F;
#pragma unroll
      for (int kq = 0; kq < BK; kq += 4) {
        float4 xr4[4], xi4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          xr4[r] = ld4(ar + (ty + 8 * r) * LDA + kq);
          xi4[r] = ld4(ai + (ty + 8 * r) * LDA + kq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float br[8], bi[8];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 a4 = ld4(mr + (kq + e) * BN + h * 32 + tx * 4);
            const float4 b4 = ld4(mi + (kq + e) * BN + h * 32 + tx * 4);
            br[4 * h] = a4.x; br[4 * h + 1] = a4.y;
            br[4 * h + 2] = a4.z; br[4 * h + 3] = a4.w;
            bi[4 * h] = b4.x; bi[4 * h + 1] = b4.y;
            bi[4 * h + 2] = b4.z; bi[4 * h + 3] = b4.w;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float xr = lane_of(xr4[r], e), xi = lane_of(xi4[r], e);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc_r[r][j] = fmaf(xr, br[j], acc_r[r][j]);
              acc_r[r][j] = fmaf(-xi, bi[j], acc_r[r][j]);
              acc_i[r][j] = fmaf(xr, bi[j], acc_i[r][j]);
              acc_i[r][j] = fmaf(xi, br[j], acc_i[r][j]);
            }
          }
        }
      }
      if (i % v.nsl != v.nsl - 1) continue;

      // the tile's end: the groups' sums meet in shared memory
      float* mine_re = red + g * 2 * BM * BN;
      float* mine_im = mine_re + BM * BN;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = (ty + 8 * r) * BN + h * 32 + tx * 4;
          *reinterpret_cast<float4*>(mine_re + o) =
              make_float4(acc_r[r][4 * h], acc_r[r][4 * h + 1],
                          acc_r[r][4 * h + 2], acc_r[r][4 * h + 3]);
          *reinterpret_cast<float4*>(mine_im + o) =
              make_float4(acc_i[r][4 * h], acc_i[r][4 * h + 1],
                          acc_i[r][4 * h + 2], acc_i[r][4 * h + 3]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc_r[r][4 * h + e] = acc_i[r][4 * h + e] = 0.f;
        }
      __syncthreads();
      const int tile = tile_of(v, i);
      const int p0 = (tile / v.itiles) * BM, i0 = (tile % v.itiles) * BN;
#pragma unroll
      for (int u = 0; u < 2 * BM * BN / 4 / THREADS; ++u) {
        const int p = tid + THREADS * u;      // float4 of the tile
        const int c = p / (BM * BN / 4), w = p % (BM * BN / 4);
        const int row = w / (BN / 4), q = (w % (BN / 4)) * 4;
        const float* part = red + c * BM * BN + row * BN + q;
        float4 sum = ld4(part);
#pragma unroll
        for (int h = 1; h < GROUPS; ++h) {
          const float4 x = ld4(part + h * 2 * BM * BN);
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        if (p0 + row < v.P) {
          const long long o =
              (long long)row_of(p0 + row, i0 >> 7, v.kh, v.b1, v.b2) * LANES +
              (i0 & (LANES - 1)) + q;
          *reinterpret_cast<float4*>((c ? v.dst_im : v.dst_re) + o) = sum;
        }
      }
      __syncthreads();     // the partial tiles are read before the next
    }
    if (t + 1 < nops) {
      // the next op's first Mt slices before the barrier, its rows after
      v = op_view(desc, mats, t + 1, amps, re0, im0, re1, im1);
      issue_m(v, 0);
      async::commit();
      issue_m(v, 1);
      async::commit();
      grid.sync();         // op t's writes before op t + 1 reads
    }
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
  static unsigned attr = 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = async::allow_smem(vmem_chunk_kernel, SMEM, &attr);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vmem_chunk_kernel, THREADS, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = per_sm * sms;
  if (grid > max_tiles) grid = max_tiles;
  *grid_out = grid;
  const int4* d4 = reinterpret_cast<const int4*>(desc);
  void* args[] = {&re0, &im0, &re1, &im1, &mats, &d4, &nops, &num_qubits};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(vmem_chunk_kernel),
                                  dim3(grid), dim3(THREADS), args, SMEM,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
