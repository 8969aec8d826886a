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
// length.  Tables at "highest": M itself, [n][k] with k contiguous, float32
// [M_re, M_im]; at "high" and "default": the Karatsuba combinations m1 =
// Mr^T, m2 = (Mi - Mr)^T, m3 = (Mr + Mi)^T, formed on the host in float64
// and split once per program into the D = 128 image the mm step
// (mm_high.cu) reads at the rung (kernels/wide.py kh0_high_tables):
// split_mm_tables' at "high", split_mm_tables_hi's at "default".
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
// "high" design (chain_high_kernel): Karatsuba, as the TPU kernel, each
// real product the 3-pass bf16 split xh.mh + xl.mh + xh.ml on bf16 wgmma
// (m64n32k16), with the mm step's k-chunk body and sums
// (karatsuba_high.cuh: 8-term hi.hi partials from zero added in fp32 on
// the CUDA cores, corrections accumulating in the tensor core), so a
// one-product chain is the D = 128 mm step bit for bit.  At n = 24 a
// product issues 12 bf16 products' worth of passes, 51.5 GFLOP (0.052 ms
// at 989 TFLOP/s; the useful 9, 0.039 ms), and the partials' fp32 adds,
// 6 a k-chunk and output, have to keep up with them on the CUDA cores.
// The mm step spends a quarter of its CUDA-core issue splitting its rows
// to bf16, each row again in every one of its column-block CTAs.  Here:
//   * A persistent CTA, one an SM, walks over 64-row tiles with two
//     consumer warpgroups and a producer warpgroup.  Both consumers hold
//     the same 64 rows, and each takes two of the four 32-column blocks in
//     turn (T, C and the partials fill ~200 registers a thread: a block of
//     64 columns does not fit).  setmaxnreg gives the consumers 240
//     registers a thread and the producer 24.
//   * The row tile stays on chip for the whole chain, as its A fragments:
//     every row split to bf16 (hi, lo) once per product, for s, x_re and
//     x_im, into shared memory in fragment order (96 KB), so the k-loop
//     loads each fragment with one 16-byte load and splits nothing.  A
//     product's results go to an fp32 staging tile (68 KB, rows padded
//     to 136 floats); after a CTA barrier they become the next product's
//     fragments.  The last product writes device memory instead, and the
//     staging tile meanwhile takes the next tile's rows (cp.async), so a
//     tile's load overlaps a product and the state crosses device memory
//     once per chain.
//   * The tables stream from L2 through a ring per consumer, five stages
//     of one column block's k-chunk (6 KB, one bulk copy on an mbarrier).
//     One thread of the producer warpgroup fills both rings, each stage
//     once the consumer's four warps have released its last use (an
//     mbarrier of four arrivals).  A consumer that issued its own copies
//     stalled its warpgroup's wgmmas on that one thread: the producer
//     warpgroup took 17% off a P = 8 launch (PERF.md section 6).  A 64-row
//     tile reads a product's 192 KB of tables once: 1.5 MB a tile at
//     P = 8.
//   * Each consumer's k-loop is compiled once per warpgroup, so its ring,
//     barriers and table descriptors are warp-uniform (uniform registers,
//     no per-wgmma moves).
//   * What holds it back: the k-chunk is a chain of three dependent wgmma
//     groups with the partials' adds between them, and two consumer
//     warpgroups an SM do not hide it.  Running the groups on across
//     chunks (the next chunk's first group queued before the last one's
//     adds) needs more registers than a thread has beside the correction
//     accumulators: ptxas then serializes every wgmma.
// "default" design (chain_high_kernel<false>, a body of its own): the JAX
// package's one bf16 pass (get_kh0_kernel's Precision.DEFAULT dot), the
// hi.hi sums alone in the "high" arm's order, no correction.  At n = 24 a
// P = 8 chain's three real products a product are 103 GFLOP of useful
// bf16 work (0.104 ms at 989 TFLOP/s) against 0.080 ms of state bytes, so
// it is bound by operations; the half-zero hi.hi passes issue twice that.
// The same CTA, tile and producer as "high", and:
//   * Hi-only tables (kernels/wide.py split_mm_tables_hi, 96 KB a product,
//     3 KB a ring stage): half the L2 reads of the full image, and a ring
//     of ten stages a consumer.
//   * A k-loop of its own: a k-chunk's three wgmma groups on two partial
//     pairs, added as they complete, the chunk drained before the next,
//     the next chunk's fragments loading (pre-split, from shared memory)
//     into a second set of A registers meanwhile.  The "default" mm step's
//     pipeline (three partial pairs, two groups queued across runs of
//     chunks) ran 4-12% slower here (PERF.md section 6).
//   * The tile held as hi fragments only, in two buffers (48 KB each): a
//     product reads one and writes its results straight into the other as
//     the next product's bf16 fragments (s = re + im formed in fp32 first,
//     as the plain version does), so no fp32 round trip, no re-split and
//     one consumer barrier a product; the fp32 staging tile takes the next
//     tile's rows.
// The output may be the input pair: a tile is read whole before the
// product that writes it, and no CTA touches another's rows.  Ragged and
// small R (R = 8 at n = 10, the smallest width that chains) work: rows
// past R are zeros on chip and are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "karatsuba_high.cuh"

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

// ------------------------------------------------- "high" and "default"
constexpr int HWGS = 2;                       // consumers, the same rows
constexpr int HBLOCKS = LANES / kh::BN;       // 32-column blocks
constexpr int ROUNDS = HBLOCKS / HWGS;        // blocks a warpgroup takes
constexpr int KCHUNKS = LANES / 16;           // k-chunks of a product
constexpr int LDX = LANES + 8;                // staged row stride (floats)
constexpr int XSTAGE = TILE * LDX;            // floats a staged component
static_assert(HWGS * 128 == THREADS, "two consumer warpgroups");
static_assert(KCHUNKS % 2 == 0, "a product is whole pairs of chunks");
constexpr int HTHREADS = THREADS + 128;       // and a producer warpgroup

// A rung's shared memory: the tile's A fragments (LO: one buffer of hi and
// lo fragments; "default": two buffers of hi fragments, one a product in
// turn), each fragment [k-chunk][product s, xr, xi][hi(, lo)][warp][lane],
// 16 bytes; a ring of table k-chunks per consumer (LO: the six-part image,
// "default": the three hi parts); the fp32 staging tile (re, im); the
// rings' barriers.
template <bool LO>
struct Chain {
  static constexpr int CHUNK = LO ? kh::CHUNK_BYTES : kh::HI_CHUNK_BYTES;
  static constexpr int MAT = HBLOCKS * KCHUNKS * CHUNK;   // a product's
  static constexpr int RING = LO ? 5 : 10;     // table stages a consumer
  static constexpr int FRAG = KCHUNKS * 3 * (LO ? 2 : 1) * 4 * 32 * 16;
  static constexpr int RING_OFF = (LO ? 1 : 2) * FRAG;
  static constexpr int X_OFF = RING_OFF + HWGS * RING * CHUNK;
  static constexpr int BAR_OFF = X_OFF + 2 * XSTAGE * (int)sizeof(float);
  static constexpr size_t SMEM =
      BAR_OFF + 2 * HWGS * RING * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "a CTA's shared memory");
};

// the consumer warpgroups' barrier
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Tile it's rows into the staging tile xs (re, then im), every consumer
// thread 16 pieces of 16 bytes (cp.async, one commit group); rows past R
// are zeros.
__device__ __forceinline__ void stage_tile(float* xs, const float* in_re,
                                           const float* in_im, int it,
                                           long long rows, int tid) {
  const long long row0 = (blockIdx.x + (long long)it * gridDim.x) * TILE;
#pragma unroll 1
  for (int u = 0; u < 2 * TILE * LANES / 4 / THREADS; ++u) {
    const int q = tid + u * THREADS;
    const int comp = q / (TILE * LANES / 4);
    const int r = q / (LANES / 4) % TILE, col = q % (LANES / 4) * 4;
    const bool ok = row0 + r < rows;
    const float* src = comp ? in_im : in_re;
    async::cp16(xs + comp * XSTAGE + r * LDX + col,
                src + (ok ? (row0 + r) * LANES + col : 0), ok);
  }
  async::commit();
}

// The producer warpgroup's one thread: it feeds both consumers' rings,
// chunk n of each (per tile and product j, its column blocks' k-chunks,
// one after the other in the image) into stage n % RING once the
// consumer's four warps have released that stage's last use.
template <bool LO>
__device__ __forceinline__ void feed_tables(uint8_t* smem, const uint8_t* w,
                                            uint64_t* landed, uint64_t* freed,
                                            int total, int nmats) {
  using S = Chain<LO>;
  for (int n = 0; n < total; ++n) {
    const int s = n % S::RING, q = n % (ROUNDS * KCHUNKS);
    const int j = n / (ROUNDS * KCHUNKS) % nmats;
    for (int W = 0; W < HWGS; ++W) {
      if (n >= S::RING)
        async::bar_wait(&freed[W * S::RING + s], (n / S::RING + 1) & 1);
      async::bulk_load(smem + S::RING_OFF + (W * S::RING + s) * S::CHUNK,
                       w + (long long)j * S::MAT +
                           (W * ROUNDS * KCHUNKS + q) * S::CHUNK,
                       S::CHUNK, &landed[W * S::RING + s]);
    }
  }
}

// The "high" chain (this primary template; "default" is the specialization
// below), persistent: CTA b takes the 64-row tiles b, b + grid, ...;
// warpgroups 0 and 1 compute, warpgroup 2 feeds them the tables.  w:
// nmats products' tables, each split_mm_tables' D = 128 image
// (Chain<true>::MAT bytes).  in/out are not __restrict__: the engine
// passes one pair.
template <bool LO>
__global__ void __launch_bounds__(HTHREADS, 1)
chain_high_kernel(const float* in_re, const float* in_im, float* out_re,
                  float* out_im, const uint8_t* __restrict__ w, int nmats,
                  long long rows) {
  static_assert(LO, "the 'default' chain is the specialization below");
  using S = Chain<true>;
  // the dynamic shared memory, under a name of its own (chain_f32_kernel
  // declares it as floats)
  extern __shared__ __align__(1024) uint8_t hsmem[];
  uint8_t* smem = hsmem;
  uint4* frags = reinterpret_cast<uint4*>(smem);
  float* xs = reinterpret_cast<float*>(smem + S::X_OFF);   // re, then im
  // [consumer][stage]: the stage's table chunk has landed; its four warps
  // have released it
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* freed = landed + HWGS * S::RING;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long tiles = (rows + TILE - 1) / TILE;
  const int mine = (int)((tiles - 1 - blockIdx.x) / gridDim.x + 1);
  const int per_tile = nmats * ROUNDS * KCHUNKS;   // a warpgroup's chunks
  const int total = mine * per_tile;

  // staged rows -> the next product's A fragments, split once: thread
  // (wg, warp, lane) forms k-chunks 4 wg .. 4 wg + 3 of its warp's rows
  auto take_tile = [&]() {
#pragma unroll
    for (int u = 0; u < KCHUNKS / HWGS; ++u) {
      const int c = wg * (KCHUNKS / HWGS) + u;
      const float* x = xs + (16 * warp + g) * LDX + 16 * c + 4 * t;
      uint32_t a[3][2][4];
      kh::split_rows(ld4(x), ld4(x + 8 * LDX), ld4(x + XSTAGE),
                     ld4(x + XSTAGE + 8 * LDX), a);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          frags[((c * 3 + p) * 2 + h) * 128 + warp * 32 + lane] =
              make_uint4(a[p][h][0], a[p][h][1], a[p][h][2], a[p][h][3]);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < HWGS * S::RING; ++s) {
      async::bar_init(&landed[s]);
      async::bar_init(&freed[s], 4);
    }
    async::bar_init_fence();
  }
  __syncthreads();
  if (wg == HWGS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == HWGS * 128)
      feed_tables<true>(smem, w, landed, freed, total, nmats);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  stage_tile(xs, in_re, in_im, 0, rows, tid);
  async::wait_groups<0>();
  consumers_sync();
  take_tile();
  consumers_sync();

  // A consumer's k-loop, compiled once for each warpgroup W: its ring,
  // barriers and table descriptors are then warp-uniform, so ptxas keeps
  // them in uniform registers and issues no per-wgmma moves (12% off a
  // P = 8 launch on an H100, PERF.md section 6).
  auto run = [&](auto wgc) {
    constexpr int W = decltype(wgc)::value;
    uint64_t* my_landed = landed + W * S::RING;
    uint64_t* my_freed = freed + W * S::RING;
    const uint64_t ring0 = kh::desc(
        async::smem_u32(smem + S::RING_OFF + W * S::RING * S::CHUNK));
    float T[3][16], C[3][16], X[4][16];
#pragma unroll
    for (int e = 0; e < 16; ++e) X[0][e] = X[1][e] = X[2][e] = X[3][e] = 0.f;
    int cs = 0;                       // the stage of the warpgroup's chunk
    uint32_t cphase = 0;              // and the phase it lands in
    // this warp's fragments [hi, lo] of product P, k-chunk c
    auto load = [&](uint32_t (&a)[2][4], int c, int P) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 v = frags[((c * 3 + P) * 2 + h) * 128 + warp * 32 + lane];
        a[h][0] = v.x;
        a[h][1] = v.y;
        a[h][2] = v.z;
        a[h][3] = v.w;
      }
    };
#pragma unroll 1
    for (int it = 0; it < mine; ++it) {
      const long long row0 = (blockIdx.x + (long long)it * gridDim.x) * TILE;
#pragma unroll 1
      for (int j = 0; j < nmats; ++j) {
        const bool last = j + 1 == nmats, more = it + 1 < mine;
        // the last product writes device memory: the staging buffer takes
        // the next tile meanwhile
        if (last && more) stage_tile(xs, in_re, in_im, it + 1, rows, tid);
#pragma unroll 1
        for (int r = 0; r < ROUNDS; ++r) {
          const int cb = W * ROUNDS + r;
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            T[0][e] = T[1][e] = T[2][e] = 0.f;
            C[0][e] = C[1][e] = C[2][e] = 0.f;
          }
#pragma unroll 1
          for (int c = 0; c < KCHUNKS; ++c) {
            async::bar_wait(&my_landed[cs], cphase);
            uint32_t a[3][2][4];
            load(a[0], c, 0);
            load(a[1], c, 1);
            load(a[2], c, 2);
            kh::chunk(T, C, X, a, ring0 + (uint64_t)(cs * (S::CHUNK >> 4)));
            if (lane == 0) async::bar_arrive(&my_freed[cs]);
            if (++cs == S::RING) {
              cs = 0;
              cphase ^= 1;
            }
          }
          kh::pin_corrections(C);
          // D fragment: element 4 jn + 2 hh + e is row 16 warp + g + 8 hh of
          // the tile, column 8 jn + 2 t + e of the column block
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = 16 * warp + g + 8 * hh;
            if (last && row0 + row >= rows) continue;
#pragma unroll
            for (int jn = 0; jn < kh::BN / 8; ++jn) {
              const int x = 4 * jn + 2 * hh;
              const int col = cb * kh::BN + 8 * jn + 2 * t;
              const float2 v0 = kh::result<true>(T, C, x);
              const float2 v1 = kh::result<true>(T, C, x + 1);
              const float2 vr = make_float2(v0.x, v1.x);
              const float2 vi = make_float2(v0.y, v1.y);
              if (last) {
                const long long o = (row0 + row) * LANES + col;
                *reinterpret_cast<float2*>(out_re + o) = vr;
                *reinterpret_cast<float2*>(out_im + o) = vi;
              } else {
                *reinterpret_cast<float2*>(xs + row * LDX + col) = vr;
                *reinterpret_cast<float2*>(xs + XSTAGE + row * LDX + col) = vi;
              }
            }
          }
        }
        if (last && more) async::wait_groups<0>();   // the next tile landed
        consumers_sync();         // every fragment read, every result staged
        if (!last || more) {
          take_tile();
          consumers_sync();
        }
      }
    }
  };
  if (wg == 0)
    run(std::integral_constant<int, 0>());
  else
    run(std::integral_constant<int, 1>());
}

// The "default" chain: the same CTA, tile and producer, for the JAX
// package's one bf16 pass (the hi.hi sums alone, no correction), on a
// k-loop of its own.  w: nmats products' tables, each split_mm_tables_hi's
// D = 128 image (Chain<false>::MAT bytes).
//   * The k-loop: a k-chunk is three wgmma groups, group P product P's two
//     hi.hi passes into the partial pair X[P % 2]; each pair is added into
//     T[P] once the next group is queued, in chunk order, so the sums are
//     the "high" arm's hi.hi sums, and the chunk drains before the next
//     (its table stage is then released).  Its fragments come pre-split
//     from shared memory into the half-zero registers of one of two A sets
//     (the zero halves set once): while chunk c's groups run, chunk c + 1's
//     three fragments load into the other set, so no group waits on a
//     shared-memory load.  Two chunks an iteration, so the set is known at
//     compile time.
//   * A product's results go straight into the next product's fragments:
//     each thread forms s = re + im in fp32 from its own outputs, as the
//     plain version does, rounds s, re and im to bf16 and stores them as
//     the 32-bit halves of A-fragment registers in the other fragment
//     buffer (no fp32 round trip, no re-split; one consumer barrier a
//     product).  The fp32 staging tile holds the next tile's rows.
template <>
__global__ void __launch_bounds__(HTHREADS, 1)
chain_high_kernel<false>(const float* in_re, const float* in_im,
                         float* out_re, float* out_im,
                         const uint8_t* __restrict__ w, int nmats,
                         long long rows) {
  using S = Chain<false>;
  extern __shared__ __align__(1024) uint8_t hsmem[];
  uint8_t* smem = hsmem;
  uint4* frags = reinterpret_cast<uint4*>(smem);      // two buffers
  float* xs = reinterpret_cast<float*>(smem + S::X_OFF);
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* freed = landed + HWGS * S::RING;
  constexpr int FRAG4 = S::FRAG / 16;                  // uint4 a buffer

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long tiles = (rows + TILE - 1) / TILE;
  const int mine = (int)((tiles - 1 - blockIdx.x) / gridDim.x + 1);
  const int total = mine * nmats * ROUNDS * KCHUNKS;

  // staged rows -> buffer b's fragments, rounded once: thread (wg, warp,
  // lane) forms k-chunks 4 wg .. 4 wg + 3 of its warp's rows
  auto take_tile = [&](int b) {
#pragma unroll
    for (int u = 0; u < KCHUNKS / HWGS; ++u) {
      const int c = wg * (KCHUNKS / HWGS) + u;
      const float* x = xs + (16 * warp + g) * LDX + 16 * c + 4 * t;
      const float4 r0 = ld4(x), r1 = ld4(x + 8 * LDX);
      const float4 i0 = ld4(x + XSTAGE), i1 = ld4(x + XSTAGE + 8 * LDX);
      uint4* f = frags + b * FRAG4 + c * 3 * 128 + warp * 32 + lane;
      f[0] = kh::hi_frag(kh::add4(r0, i0), kh::add4(r1, i1));
      f[128] = kh::hi_frag(r0, r1);
      f[256] = kh::hi_frag(i0, i1);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < HWGS * S::RING; ++s) {
      async::bar_init(&landed[s]);
      async::bar_init(&freed[s], 4);
    }
    async::bar_init_fence();
  }
  __syncthreads();
  if (wg == HWGS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == HWGS * 128)
      feed_tables<false>(smem, w, landed, freed, total, nmats);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  stage_tile(xs, in_re, in_im, 0, rows, tid);
  async::wait_groups<0>();
  consumers_sync();
  take_tile(0);
  consumers_sync();

  auto run = [&](auto wgc) {
    constexpr int W = decltype(wgc)::value;
    constexpr uint64_t part = kh::PART >> 4;
    uint64_t* my_landed = landed + W * S::RING;
    uint64_t* my_freed = freed + W * S::RING;
    const uint64_t ring0 = kh::desc(
        async::smem_u32(smem + S::RING_OFF + W * S::RING * S::CHUNK));
    float T[3][16], X[2][2][16];
    uint32_t h0[2][3][4], h1[2][3][4];    // [A set][product]
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int P = 0; P < 3; ++P)
        h0[q][P][2] = h0[q][P][3] = h1[q][P][0] = h1[q][P][1] = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      X[0][0][e] = X[0][1][e] = X[1][0][e] = X[1][1][e] = 0.f;
    int cs = 0;                       // the stage of the warpgroup's chunk
    uint32_t cphase = 0;              // and the phase it lands in
    int b = 0;                        // the fragment buffer a product reads
    const uint4* cur = frags + warp * 32 + lane;
    // k-chunk c's three fragments into A set q's half-zero pairs
    auto load = [&](int q, int c) {
#pragma unroll
      for (int P = 0; P < 3; ++P) {
        const uint4 v = cur[(c * 3 + P) * 128];
        h0[q][P][0] = v.x;
        h0[q][P][1] = v.y;
        h1[q][P][2] = v.z;
        h1[q][P][3] = v.w;
      }
    };
#pragma unroll 1
    for (int it = 0; it < mine; ++it) {
      const long long row0 = (blockIdx.x + (long long)it * gridDim.x) * TILE;
#pragma unroll 1
      for (int j = 0; j < nmats; ++j) {
        const bool last = j + 1 == nmats, more = it + 1 < mine;
        if (last && more) stage_tile(xs, in_re, in_im, it + 1, rows, tid);
        cur = frags + b * FRAG4 + warp * 32 + lane;
        uint32_t* next = reinterpret_cast<uint32_t*>(frags + (b ^ 1) * FRAG4);
#pragma unroll 1
        for (int r = 0; r < ROUNDS; ++r) {
          const int cb = W * ROUNDS + r;
#pragma unroll
          for (int e = 0; e < 16; ++e) T[0][e] = T[1][e] = T[2][e] = 0.f;
          load(0, 0);
          // k-chunks in pairs, A set u for the pair's chunk u
#pragma unroll 1
          for (int c0 = 0; c0 < KCHUNKS; c0 += 2) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int c = c0 + u;
              async::bar_wait(&my_landed[cs], cphase);
              const uint64_t d = ring0 + (uint64_t)(cs * (S::CHUNK >> 4));
#pragma unroll
              for (int P = 0; P < 3; ++P) {
                kh::hi_group(X[P % 2], h0[u][P], h1[u][P], d + P * part);
                // the other set is free: chunk c - 1 is done
                if (P == 2 && c + 1 < KCHUNKS) load(u ^ 1, c + 1);
                if (P > 0) {
                  kh::wait<1>();      // T_P = (T_P + H(c, 0)) + H(c, 1)
                  kh::add1(T[P - 1], X[1 - P % 2][0]);
                  kh::add1(T[P - 1], X[1 - P % 2][1]);
                }
              }
              kh::wait<0>();
              kh::add1(T[2], X[0][0]);
              kh::add1(T[2], X[0][1]);
              if (lane == 0) async::bar_arrive(&my_freed[cs]);
              if (++cs == S::RING) {
                cs = 0;
                cphase ^= 1;
              }
            }
          }
          // D fragment: element 4 jn + 2 hh + e is row 16 warp + g + 8 hh of
          // the tile, column n = 32 cb + 8 jn + 2 t + e, which is k of the
          // next product: k-chunk 2 cb + jn / 2, there A-fragment register
          // hh + 2 (t % 2) of lane 4 g + 2 (jn % 2) + t / 2, its bf16 pair
          // (e = 0, 1).  Registers hh = 0, 1 are one 8-byte store.
#pragma unroll
          for (int jn = 0; jn < kh::BN / 8; ++jn) {
            uint32_t hs[2], hr[2], hi[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int x = 4 * jn + 2 * hh;
              const float2 v0 = kh::result<false>(T, T, x);
              const float2 v1 = kh::result<false>(T, T, x + 1);
              if (last) {
                const int row = 16 * warp + g + 8 * hh;
                if (row0 + row < rows) {
                  const long long o = (row0 + row) * LANES + cb * kh::BN +
                                      8 * jn + 2 * t;
                  *reinterpret_cast<float2*>(out_re + o) =
                      make_float2(v0.x, v1.x);
                  *reinterpret_cast<float2*>(out_im + o) =
                      make_float2(v0.y, v1.y);
                }
              } else {
                hs[hh] = kh::hi2(v0.x + v0.y, v1.x + v1.y);
                hr[hh] = kh::hi2(v0.x, v1.x);
                hi[hh] = kh::hi2(v0.y, v1.y);
              }
            }
            if (!last) {
              const int c2 = 2 * cb + jn / 2;
              const int dst = warp * 32 + 4 * g + 2 * (jn % 2) + t / 2;
              uint32_t* o = next + ((c2 * 3) * 128 + dst) * 4 + 2 * (t % 2);
              *reinterpret_cast<uint2*>(o) = make_uint2(hs[0], hs[1]);
              *reinterpret_cast<uint2*>(o + 128 * 4) =
                  make_uint2(hr[0], hr[1]);
              *reinterpret_cast<uint2*>(o + 256 * 4) =
                  make_uint2(hi[0], hi[1]);
            }
          }
        }
        b ^= 1;
        if (last && more) async::wait_groups<0>();   // the next tile landed
        consumers_sync();   // every fragment read, the next one written
        if (last && more) {
          take_tile(b);
          consumers_sync();
        }
      }
    }
  };
  if (wg == 0)
    run(std::integral_constant<int, 0>());
  else
    run(std::integral_constant<int, 1>());
}

template <bool LO>
cudaError_t launch_high(const float* in_re, const float* in_im,
                        float* out_re, float* out_im, const void* w16,
                        int nmats, long long rows, cudaStream_t stream) {
  static unsigned attr = 0;
  static int slots = 0;
  constexpr size_t smem = Chain<LO>::SMEM;
  cudaError_t e = async::allow_smem(chain_high_kernel<LO>, smem, &attr);
  if (e != cudaSuccess) return e;
  if (slots == 0 &&
      (e = async::persistent_slots(chain_high_kernel<LO>, HTHREADS, smem,
                                   &slots)) != cudaSuccess)
    return e;
  const long long tiles = (rows + TILE - 1) / TILE;
  const unsigned grid = (unsigned)(tiles < slots ? tiles : slots);
  chain_high_kernel<LO><<<grid, HTHREADS, smem, stream>>>(
      in_re, in_im, out_re, out_im, static_cast<const uint8_t*>(w16), nmats,
      rows);
  return cudaGetLastError();
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
  static unsigned attr = 0;
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

// The "high" (lo = 1) or "default" (lo = 0) chain: w16 holds nmats
// products' tables, each the image of their Karatsuba combinations at
// D = 128: split_mm_tables' at "high", split_mm_tables_hi's at "default".
// out may be in.  Every pointer 16-byte aligned.  The grid is persistent,
// as qsim_wide_chain's.
int qsim_wide_chain_high(const float* in_re, const float* in_im,
                         float* out_re, float* out_im, const void* w16,
                         int nmats, long long rows, int lo, void* stream) {
  if (nmats < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      lo ? launch_high<true>(in_re, in_im, out_re, out_im, w16, nmats, rows, s)
         : launch_high<false>(in_re, in_im, out_re, out_im, w16, nmats, rows,
                              s));
}

}  // extern "C"
