// Copy-bandwidth probes of device memory, for Hopper (sm_90a).
//
// Replaces: scripts/dma_probe.py, TPU kernel 11, its three Pallas copies of
// the state, HBM to HBM:
//   grid_copy  (:51)  Mosaic's auto-pipelined grid copy of 1, 2 or 4
//                     operands in (T, width) row tiles;
//   stream_copy (:82) a hand-pipelined stream, HBM -> VMEM (W slots) ->
//                     HBM, the skeleton of a streaming block kernel;
//   hbm_direct (:164) direct HBM -> HBM block DMAs, W in flight.
// Each is written again for the card, by hand, to read what a kernel of
// the port can copy per second at the port's tile shapes:
//   grid_copy_kernel    one CTA per T-row tile of one operand, 512
//                       threads; each loads GRID_BATCH 16-byte quads into
//                       registers before it stores them, so at T = 32 a
//                       whole 32 KB tile is in flight before its first
//                       store;
//   stream_copy_kernel  persistent CTAs; one thread keeps W-1 tiles in
//                       flight into a W-stage shared-memory ring with TMA
//                       bulk copies (cp.async.bulk, completion on an
//                       mbarrier), and all threads write each landed tile
//                       out with 128-bit stores, as a block kernel would
//                       after its compute;
//   hbm_direct_kernel   TMA both ways, global -> shared -> global, with no
//                       register bounce: bulk loads on mbarriers, bulk
//                       stores in bulk groups, W stages.  The card has no
//                       global-to-global DMA that a kernel can issue.
// What bounds them: bytes only (each byte read once and written once),
// 3.35 TB/s published at 700 W.  The probe's use is the measured rate, a
// second denominator for every bytes-bound kernel of the port.  Levers
// measured on an H100 (PERF.md section 6): a whole tile's loads in
// flight before its stores made the grid copy faster; non-coherent or
// L1::no_allocate loads, an L2 prefetch hint, streaming stores and other
// batch sizes did not.  For the staged routes no lever paid beyond the
// spread between calls: warps releasing their stage on "empty" mbarriers
// with a producer warp, streaming stores and evict-first loads (stream);
// more bulk stores in flight before a refill, L2 hints (direct).  Both
// keep their first design.
//
// A tile of stream_copy / hbm_direct is `unit` bytes of one operand,
// contiguous; tiles of both operands are dealt round robin to the CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"

namespace {

using async::bar_init;
using async::bar_wait;
using async::bulk_load;
using async::smem_u32;

constexpr int MAX_OPS = 4;
constexpr int MAX_STAGES = 16;
constexpr int GRID_THREADS = 512;
constexpr int GRID_BATCH = 4;           // quads a thread loads before storing
constexpr int STREAM_THREADS = 256;
constexpr int DIRECT_THREADS = 32;
constexpr int MAX_SMEM = 227 * 1024;

struct Ops {
  const char* src[MAX_OPS];
  char* dst[MAX_OPS];
};

// p[j] for a run-time j without indexing the parameter array (which would
// copy it to local memory)
template <typename T>
__device__ __forceinline__ T pick(T const (&p)[MAX_OPS], long long j) {
  return j == 0 ? p[0] : j == 1 ? p[1] : j == 2 ? p[2] : p[3];
}

// One CTA per tile of one operand: each thread loads GRID_BATCH quads
// (GRID_THREADS apart, so a warp's loads are contiguous) into registers,
// then stores them: at T = 32 rows the whole 32 KB tile is in flight
// before the first store.
__global__ void __launch_bounds__(GRID_THREADS)
grid_copy_kernel(Ops ops, long long quads, long long tile_quads) {
  const float4* __restrict__ s =
      reinterpret_cast<const float4*>(pick(ops.src, blockIdx.y));
  float4* __restrict__ d = reinterpret_cast<float4*>(pick(ops.dst, blockIdx.y));
  const long long base = (long long)blockIdx.x * tile_quads;
  const long long end = min(base + tile_quads, quads);
  long long i = base + threadIdx.x;
  for (; i + (GRID_BATCH - 1) * GRID_THREADS < end;
       i += GRID_BATCH * GRID_THREADS) {
    float4 v[GRID_BATCH];
#pragma unroll
    for (int k = 0; k < GRID_BATCH; ++k) v[k] = s[i + k * GRID_THREADS];
#pragma unroll
    for (int k = 0; k < GRID_BATCH; ++k) d[i + k * GRID_THREADS] = v[k];
  }
  for (; i < end; i += GRID_THREADS) d[i] = s[i];
}

// TMA bulk copy shared -> global, one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void init_stages(uint64_t* full, int stages) {
  for (int s = 0; s < stages; ++s) bar_init(&full[s]);
  async::bar_init_fence();
}

// Tile u of the concatenated operands: (operand, byte offset).
__device__ __forceinline__ const char* tile_src(const Ops& ops, long long u,
                                                long long per_op, int unit) {
  return pick(ops.src, u / per_op) + (u % per_op) * unit;
}
__device__ __forceinline__ char* tile_dst(const Ops& ops, long long u,
                                          long long per_op, int unit) {
  return pick(ops.dst, u / per_op) + (u % per_op) * unit;
}

__global__ void __launch_bounds__(STREAM_THREADS)
stream_copy_kernel(Ops ops, int nops, long long per_op, int unit,
                   int stages) {
  extern __shared__ __align__(128) char ring[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  const long long total = per_op * nops;
  const long long step = gridDim.x;
  if (threadIdx.x == 0) {
    init_stages(full, stages);
    for (int k = 0; k < stages; ++k) {
      const long long u = blockIdx.x + k * step;
      if (u < total)
        bulk_load(ring + k * unit, tile_src(ops, u, per_op, unit), unit,
                  &full[k]);
    }
  }
  __syncthreads();
  long long k = 0;
  for (long long u = blockIdx.x; u < total; u += step, ++k) {
    const int s = (int)(k % stages);
    bar_wait(&full[s], (uint32_t)((k / stages) & 1));
    const float4* st = reinterpret_cast<const float4*>(ring + s * unit);
    float4* d = reinterpret_cast<float4*>(tile_dst(ops, u, per_op, unit));
#pragma unroll 4
    for (int i = threadIdx.x; i < unit / 16; i += STREAM_THREADS) d[i] = st[i];
    __syncthreads();                       // stage s is read out
    if (threadIdx.x == 0) {
      const long long next = u + stages * step;
      if (next < total) {
        // order the threads' reads of the stage before the async refill
        async::fence_async();
        bulk_load(ring + s * unit, tile_src(ops, next, per_op, unit), unit,
                  &full[s]);
      }
    }
  }
}

// One thread a CTA: bulk loads into W stages on mbarriers, bulk stores out
// of them in bulk groups; a stage is refilled once the next tile's store
// is out, so W - 1 loads stay in flight.
__global__ void __launch_bounds__(DIRECT_THREADS)
hbm_direct_kernel(Ops ops, int nops, long long per_op, int unit,
                  int stages) {
  extern __shared__ __align__(128) char ring[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  if (threadIdx.x != 0) return;
  const long long total = per_op * nops;
  const long long step = gridDim.x;
  init_stages(full, stages);
  for (int k = 0; k < stages; ++k) {
    const long long u = blockIdx.x + k * step;
    if (u < total)
      bulk_load(ring + k * unit, tile_src(ops, u, per_op, unit), unit,
                &full[k]);
  }
  long long k = 0;
  for (long long u = blockIdx.x; u < total; u += step, ++k) {
    const int s = (int)(k % stages);
    bar_wait(&full[s], (uint32_t)((k / stages) & 1));
    bulk_store(tile_dst(ops, u, per_op, unit), ring + s * unit, unit);
    if (k >= 1) {
      // the previous tile's store has read its stage: refill that stage
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const long long next = u - step + stages * step;
      if (next < total)
        bulk_load(ring + ((k - 1) % stages) * unit,
                  tile_src(ops, next, per_op, unit), unit,
                  &full[(k - 1) % stages]);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

Ops make_ops(const void* const* src, void* const* dst, int nops) {
  Ops ops{};
  for (int j = 0; j < nops; ++j) {
    ops.src[j] = static_cast<const char*>(src[j]);
    ops.dst[j] = static_cast<char*>(dst[j]);
  }
  return ops;
}

template <typename P>
bool aligned16(P const* p, int nops) {
  for (int j = 0; j < nops; ++j)
    if (reinterpret_cast<uintptr_t>(p[j]) % 16) return false;
  return true;
}

// Persistent launch of a staged kernel: as many CTAs as fit on every SM
// with `smem` bytes of ring each.
template <typename K>
int launch_staged(K kernel, int threads, const Ops& ops, int nops,
                  long long bytes, int unit, int stages, cudaStream_t stream) {
  if (unit <= 0 || unit % 16 || bytes % unit || stages < 1 ||
      stages > MAX_STAGES || (long long)stages * unit > MAX_SMEM ||
      unit >= (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = stages * unit;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = bytes / unit * nops;
  const long long grid = std::min<long long>((long long)sms * per_sm, tiles);
  kernel<<<(unsigned)grid, threads, smem, stream>>>(ops, nops, bytes / unit,
                                                    unit, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dst[j] = src[j] for nops (1, 2 or 4) operands of `bytes` each, in tiles
// of `tile` bytes (T rows), one CTA per tile and operand.
int qsim_copy_grid(const void* const* src, void* const* dst, int nops,
                   long long bytes, long long tile, void* stream) {
  if (nops < 1 || nops > MAX_OPS || bytes % 16 || tile <= 0 || tile % 16 ||
      !aligned16(src, nops) || !aligned16(dst, nops))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (bytes + tile - 1) / tile;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((unsigned)tiles, nops);
  grid_copy_kernel<<<grid, GRID_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      make_ops(src, dst, nops), bytes / 16, tile / 16);
  return static_cast<int>(cudaGetLastError());
}

// dst[j] = src[j] for nops operands of `bytes` each through a `stages`-deep
// shared-memory ring of `unit`-byte tiles: TMA loads, register stores.
int qsim_copy_stream(const void* const* src, void* const* dst, int nops,
                     long long bytes, int unit, int stages, void* stream) {
  if (nops < 1 || nops > MAX_OPS || !aligned16(src, nops) ||
      !aligned16(dst, nops))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_staged(stream_copy_kernel, STREAM_THREADS,
                       make_ops(src, dst, nops), nops, bytes, unit, stages,
                       static_cast<cudaStream_t>(stream));
}

// The same with TMA bulk copies both ways (no register bounce); at least
// two stages, since a stage is refilled once the NEXT tile's store is out.
int qsim_copy_direct(const void* const* src, void* const* dst, int nops,
                     long long bytes, int unit, int stages, void* stream) {
  if (nops < 1 || nops > MAX_OPS || stages < 2 || !aligned16(src, nops) ||
      !aligned16(dst, nops))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_staged(hbm_direct_kernel, DIRECT_THREADS,
                       make_ops(src, dst, nops), nops, bytes, unit, stages,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
