// The "high" rung's mat step on Hopper (sm_90a) wgmma: the device body of
// the flat step (mat_high.cu, kernel 3') and the in-place one
// (split_block.cu, kernel 5's "high" step), which differ only in how a
// row is found and written (a Map policy), so the two give the same
// values bit for bit.
//
// What it computes: out = x @ (A + iB) on 256-wide rows, each real product
// XLA's 3-pass bf16 split xh.mh + xl.mh + xh.ml (h = bf16 of x, l = bf16
// of the residual), as the JAX package's _make_dot("high")
// (gpu_quantum_simulator_tpu/engine/prefetch.py:914), schoolbook:
// out_re = xr.A - xi.B, out_im = xr.B + xi.A.
//
// Where the sums are kept.  A tensor core's fp32 adds truncate, so a sum
// that stays in its accumulator across many passes shrinks the norm a
// little every step (PERF.md section 6 has the measurements).  Here:
//   * every hi.hi product is a bf16 wgmma of k = 16 started from zero
//     (scale-d = 0) with half of its A fragment zero: an 8-term partial,
//     added to an fp32 sum in registers on the CUDA cores, which round to
//     nearest.  bf16 x bf16 products are exact;
//   * the eight correction products (xl.mh, xh.ml of both components),
//     2^-8 the size of the hi.hi terms, are bf16 wgmmas of k = 16 that
//     accumulate in the tensor core over all 256 k, one accumulator for
//     each output component; the two sums are added once, at the end.
//     Their truncation is 2^-8 smaller and its sign is not the output's,
//     so it does not shrink the norm.
//   chip_smoke.py's drift phase holds this form to the plain version's
//   drift over 200 steps and six seeds (PERF.md section 6).
//
// Shapes.  A CTA is two warpgroups, a tile of 128 rows (64 each, wgmma's
// M) by 64 output columns of both components: per thread 32 + 32 fp32
// sums, two correction accumulators and two hi.hi partials of 32.  A
// row block's four column blocks are a group of four CTAs side by side in
// the grid; in place, no warp of the group writes a tile before every warp
// of the group has read it (a counter in device memory; the launch is
// cooperative, so the four are resident together).  The CTAs are
// persistent, one an SM: group cg takes row blocks cg, cg + G, ... and
// keeps its column block of the tables resident in shared memory (128 KB,
// sixteen bulk copies at the start, each counted on an mbarrier of its
// own), so the tables are read from L2 once per CTA and launch.  Each warp
// copies its own 16 rows with cp.async through the row map (a TMA tile
// cannot follow it), a k-chunk of 16 at a time, into a five-deep ring of
// its own that runs on across tiles, so the next tile's first rows load
// while a tile's results are written.  A chunk's four hi.hi passes each
// have two of the eight correction products queued behind them, so the
// tensor core has work while the CUDA cores add the partials.
//
// The wgmma B operand is K-major and unswizzled: 8 x 16-byte core
// matrices, stride 1024 bytes along k, 128 along n.  The host writes the
// tables in exactly that image (kernels/block.py split_tables), with k
// permuted inside every 16 so that a lane's four consecutive k (one float4
// of a row) are its A-fragment values: wgmma position p holds k
// 4 ((p % 8) / 2) + 2 (p / 8) + p % 2.
//
// The "default" rung (LO = false): one bf16 pass, the JAX package's
// jnp.dot at Precision.DEFAULT on the TPU.  x and the tables are rounded to
// bf16 and only the hi.hi partials are summed, in fp32 as above, in the
// same order (out_re: + xr.A_hi(c, 0) - xi.B_hi(c, 0) + xr.A_hi(c, 1) -
// xi.B_hi(c, 1) for every chunk c in turn; out_im alike): no lo split, no
// correction wgmma, out = the hi.hi sums.  On bf16-exact x and tables the
// "high" arm's corrections are exact zeros, so the two arms then agree bit
// for bit (chip_smoke.py phase 10).  Its own k-loop, not the "high" one
// without its corrections: nothing else would keep the tensor core busy
// while the CUDA cores add, so
//   * it holds two partial pairs (the registers of the "high" arm's
//     correction accumulators): pass q + 1 is queued before pass q is
//     waited on, and q's partials are added while q + 1 runs, across the
//     chunk boundary too (a chunk's four passes alternate the pairs);
//   * the next chunk's rows are loaded and rounded during the chunk's last
//     pass, positions 0..7 then (their passes are done) and 8..15 after the
//     chunk boundary, once the passes that read those registers are done:
//     no wait<0> inside a tile;
//   * the tables and the five-stage row ring are the "high" arm's: it reads
//     the hi parts of split_tables' image (A_hi, B_hi: parts 0 and 2 of a
//     chunk).  A hi-only image (64 KB a column block) with the room it
//     frees spent on an eight-stage ring was no faster on an H100 (PERF.md
//     section 6).
// At n = 24 its work is the 8 half-zero hi.hi passes (68.7 GFLOP issued,
// 0.069 ms), 2.1e9 fp32 adds of partials (~0.07 ms of the CUDA cores,
// which now run beside the passes) against 0.080 ms of state bytes.  What
// bounds it on an H100 is the CUDA cores' side: run alone (the wgmmas
// removed, chip_ab.py --strip wgmmas) it takes four fifths of the step,
// the tensor core's side alone (--strip adds) under half (PERF.md section
// 6), at about half the issue rate its ~394 instructions a k-chunk allow:
// likely the latency two warps a scheduler cannot hide, and more warps do
// not fit beside the four partials of 32 floats.
//
// What bounds the "high" arm on the card: at n = 24 a step is 16 bf16
// products of (2^16 x 256) @ (256 x 256) on the tensor cores, 8 of them the
// half-zero hi.hi passes (137 GFLOP at 989.4 TFLOP/s, 0.139 ms), 2.1e9 fp32
// adds of partials (~0.07 ms, overlapping the other warpgroup's wgmma) and
// 256 MB of state moved once (0.08 ms).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "bf16_split.cuh"

namespace wgh {

constexpr int DVIEW = 256;                  // a row: 256 k, 256 outputs
constexpr int HALF = 128;
constexpr int BN = 64;                      // output columns per CTA
constexpr int COL_BLOCKS = DVIEW / BN;      // CTAs of a row block
constexpr int WGS = 2;                      // warpgroups
constexpr int BM = 64 * WGS;                // rows per tile
constexpr int THREADS = 128 * WGS;
constexpr int WARPS = THREADS / 32;
constexpr int XROWS = 16;                   // rows a warp stages
constexpr int CHUNKS = DVIEW / 16;          // k-chunks of 16 a row
constexpr int PART = 2 * BN * 16;           // bytes: one table's chunk
// a chunk of the tables: [A_hi | A_lo | B_hi | B_lo], each [kc 2][n 64][8]
constexpr int CHUNK_BYTES = 4 * PART;
constexpr int BLOCK_BYTES = CHUNKS * CHUNK_BYTES;   // a column block's
constexpr int XSTAGES = 5;
constexpr int XSTAGE_F = 2 * XROWS * 16;    // floats: re, im of 16 rows
constexpr int CORE_K = 1024;                // core-matrix stride along k
constexpr int CORE_N = 128;                 // and along n
constexpr uint32_t NO_ROW = 0xffffffffu;    // a slot past the state
constexpr int KRUN = 4;                     // "default": chunks a run
constexpr size_t X_OFF = BLOCK_BYTES;
constexpr size_t SRC_OFF = X_OFF + (size_t)XSTAGES * WARPS * XSTAGE_F * 4;
constexpr size_t BAR_OFF = SRC_OFF + 3 * 2 * BM * sizeof(uint32_t);
constexpr size_t SMEM = BAR_OFF + CHUNKS * sizeof(uint64_t);
static_assert(THREADS == 2 * BM, "one thread per (row slot, k half)");
static_assert(WARPS * XROWS == BM, "each warp stages its own rows");
static_assert(CHUNKS % KRUN == 0, "a tile is whole runs of chunks");

using bfround::hi2;
using bfround::split2;

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// K-major, unswizzled shared-memory matrix descriptor at byte address a
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return (uint64_t)((a & 0x3ffff) >> 4) | ((uint64_t)(CORE_K >> 4) << 16) |
         ((uint64_t)(CORE_N >> 4) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of an accumulator above a wait
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGH_D "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"
#define WGH_OUT(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
  "+f"(d[31])

// d = s a.b + (acc ? d : 0) over k = 16: bf16, m64n64, a from registers
// (the m16n8k16 A fragment of the warp's 16 rows), b a descriptor, s = +1
// or -1 (exact)
template <int S>
__device__ __forceinline__ void bf16(float (&d)[32], const uint32_t (&a)[4],
                                     uint64_t b, int acc) {
  static_assert(S == 1 || S == -1, "scale is +1 or -1");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGH_D
      ", {%32, %33, %34, %35}, %36, p, %38, 1, 0;\n}\n"
      : WGH_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(S));
}

#undef WGH_D
#undef WGH_OUT

constexpr int GROUP_WARPS = COL_BLOCKS * WARPS;   // warps of a CTA group

// one arrival on a group's counter, after this warp's reads (release)
__device__ __forceinline__ void arrive(int* counter) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(counter)
               : "memory");
}

// until the counter reaches n (acquire): every arrival's reads are done.
// A counter that never gets there (one not zero at the launch) traps, and
// the launch fails, rather than spinning for ever.
__device__ __forceinline__ void wait_arrivals(const int* counter, int n) {
  int v;
  for (long long spins = 0;; ++spins) {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(counter)
                 : "memory");
    if (v >= n) return;
    if (spins > (1LL << 26)) asm volatile("trap;");
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The mat step, persistent.  blockIdx.x % 4 is the column block, the CTA
// group blockIdx.x / 4 of gridDim.x / 4 takes every G-th row block.  Map
// supplies
//   long long rows;                       rows of the state
//   long long row(long long rb, int s);   the row of slot s (< BM) of row
//                                         block rb
//   uint32_t code(long long r, int hf);   where row r's k-half hf is read:
//                                         2 x source row + source half
//   const float* src(int comp, uint32_t code);   that half-row of
//                                         component comp (0 re, 1 im)
//   float* out(int comp, long long r, int col);  where output (r, col) goes
// w: the slot's tables as split_tables lays them out (4 blocks of 128 KB;
// "default" reads the hi parts).
// sync (in place): two ints a CTA group, zero before the launch, which is
// cooperative (every CTA resident): no warp of a group writes a tile's rows
// before every warp of the group's four CTAs has read them.  Left zero.
// LO: the "high" rung (the lo splits and the corrections); false: the
// "default" rung, the hi.hi sums alone, on a k-loop of its own.
template <bool LO, class Map>
__device__ __forceinline__ void mat_step(const Map& map,
                                         const uint8_t* __restrict__ w,
                                         int* sync = nullptr) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* tab = smem;
  float* xs = reinterpret_cast<float*>(smem + X_OFF);
  uint32_t* srcs = reinterpret_cast<uint32_t*>(smem + SRC_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;      // fragment row / column group
  const int cb = blockIdx.x % COL_BLOCKS;
  const long long cg = blockIdx.x / COL_BLOCKS;
  const long long groups = gridDim.x / COL_BLOCKS;
  const long long blocks = (map.rows + BM - 1) / BM;
  if (cg >= blocks) return;                   // the whole group: no tile
  const int tiles = (int)((blocks - 1 - cg) / groups + 1);
  int* arrived = sync == nullptr ? nullptr : sync + 2 * cg;

  // where each (row slot, k half) of tile i is read from, in buffer i % 3:
  // written two tiles ahead, after the barrier that ends every read of
  // the buffer's last tile, read after the next tile's barrier
  auto fill_src = [&](int i) {
    const int s = tid % BM, hf = tid / BM;
    const long long r = map.row(cg + i * groups, s);
    srcs[((i % 3) * 2 + hf) * BM + s] =
        r < map.rows ? map.code(r, hf) : NO_ROW;
  };
  if (tid == 0) {
    for (int c = 0; c < CHUNKS; ++c) async::bar_init(&full[c]);
    async::bar_init_fence();
  }
  fill_src(0);
  if (tiles > 1) fill_src(1);
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < CHUNKS; ++c)
      async::bulk_load(tab + c * CHUNK_BYTES,
                       w + ((long long)cb * CHUNKS + c) * CHUNK_BYTES,
                       CHUNK_BYTES, &full[c]);

  // this warp's 16 rows of global chunk G (tile G / 16, k-chunk G % 16):
  // lane (r0, c4) copies 16 bytes of rows r0 and r0 + 8 of re and im
  float* xw = xs + warp * XSTAGES * XSTAGE_F;
  const int c4 = lane & 3, r0 = lane >> 2;
  const int total = tiles * CHUNKS;
  auto stage_x = [&](int G) {
    if (G < total) {
      const int i = G / CHUNKS, c = G % CHUNKS;
      const uint32_t* sp = srcs + ((i % 3) * 2 + c / (CHUNKS / 2)) * BM
                           + warp * XROWS;
      const int k = (c % (CHUNKS / 2)) * 16 + c4 * 4;
      float* st = xw + (G % XSTAGES) * XSTAGE_F;
#pragma unroll
      for (int m = 0; m < XROWS / 8; ++m) {
        const int rr = r0 + 8 * m;
        const uint32_t code = sp[rr];
#pragma unroll
        for (int comp = 0; comp < 2; ++comp)
          async::cp16(st + (comp * XROWS + rr) * 16 + c4 * 4,
                      code != NO_ROW ? map.src(comp, code) + k
                                     : reinterpret_cast<const float*>(w),
                      code != NO_ROW);
      }
    }
    async::commit();
  };
#pragma unroll
  for (int G = 0; G < XSTAGES - 1; ++G) stage_x(G);

  const uint32_t tab_s = async::smem_u32(tab);
  if constexpr (LO) {
    float sre[32], sim[32], cre[32], cim[32], p0[32], p1[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) p0[e] = p1[e] = 0.f;

#pragma unroll 1
    for (int i = 0; i < tiles; ++i) {
      const long long rb = cg + i * groups;
      if (i > 0) __syncthreads();
      if (i + 2 < tiles) fill_src(i + 2);
#pragma unroll
      for (int e = 0; e < 32; ++e) sre[e] = sim[e] = cre[e] = cim[e] = 0.f;

#pragma unroll 1
      for (int c = 0; c < CHUNKS; ++c) {
        const int G = i * CHUNKS + c;
        __syncwarp();              // every lane is done with stage G - 1
        stage_x(G + XSTAGES - 1);
        async::wait_groups<XSTAGES - 1>();
        __syncwarp();
        if (arrived != nullptr && c == CHUNKS - 1 && lane == 0)
          arrive(arrived);         // the warp's reads of the tile are done
        async::bar_wait(&full[c], 0);
        // rows g and g + 8, k 4 t .. 4 t + 3 of the chunk: this lane's A
        // fragments (the tables' k order, above)
        const float* xq = xw + (G % XSTAGES) * XSTAGE_F;
        const float4 a0 = ld4(xq + g * 16 + t * 4);
        const float4 a1 = ld4(xq + (g + 8) * 16 + t * 4);
        const float4 b0 = ld4(xq + (XROWS + g) * 16 + t * 4);
        const float4 b1 = ld4(xq + (XROWS + g + 8) * 16 + t * 4);
        wait<0>();                 // the last chunk's products read its A
        uint32_t rh[4], rl[4], ih[4], il[4];
        split2(a0.x, a0.y, rh[0], rl[0]);
        split2(a1.x, a1.y, rh[1], rl[1]);
        split2(a0.z, a0.w, rh[2], rl[2]);
        split2(a1.z, a1.w, rh[3], rl[3]);
        split2(b0.x, b0.y, ih[0], il[0]);
        split2(b1.x, b1.y, ih[1], il[1]);
        split2(b0.z, b0.w, ih[2], il[2]);
        split2(b1.z, b1.w, ih[3], il[3]);
        const uint32_t base = tab_s + c * CHUNK_BYTES;
        const uint64_t dah = desc(base), dal = desc(base + PART),
                       dbh = desc(base + 2 * PART),
                       dbl = desc(base + 3 * PART);
        // four hi.hi passes, (re, im) x (wgmma positions 0..7, 8..15), each
        // two partials from zero; behind each, two of the eight correction
        // products, so that the tensor core has work queued while the CUDA
        // cores add the partials
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = q / 2;
          const uint32_t xr[4] = {p ? 0u : rh[0], p ? 0u : rh[1],
                                  p ? rh[2] : 0u, p ? rh[3] : 0u};
          const uint32_t xi[4] = {p ? 0u : ih[0], p ? 0u : ih[1],
                                  p ? ih[2] : 0u, p ? ih[3] : 0u};
          fence();
          if (q % 2 == 0) {        // out_re: + xr.A_hi - xi.B_hi
            bf16<1>(p0, xr, dah, 0);
            bf16<1>(p1, xi, dbh, 0);
          } else {                 // out_im: + xr.B_hi + xi.A_hi
            bf16<1>(p0, xr, dbh, 0);
            bf16<1>(p1, xi, dah, 0);
          }
          commit();
          if (q == 0) {            // re: rl.A_hi + rh.A_lo - il.B_hi - ih.B_lo
            bf16<1>(cre, rl, dah, 1);
            bf16<1>(cre, rh, dal, 1);
          } else if (q == 1) {     // im: rl.B_hi + rh.B_lo + il.A_hi + ih.A_lo
            bf16<1>(cim, rl, dbh, 1);
            bf16<1>(cim, rh, dbl, 1);
          } else if (q == 2) {
            bf16<-1>(cre, il, dbh, 1);
            bf16<-1>(cre, ih, dbl, 1);
          } else {
            bf16<1>(cim, il, dah, 1);
            bf16<1>(cim, ih, dal, 1);
          }
          commit();
          wait<1>();
          pin(p0);
          pin(p1);
          if (q % 2 == 0) {
#pragma unroll
            for (int e = 0; e < 32; ++e) sre[e] = (sre[e] + p0[e]) - p1[e];
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e) sim[e] = (sim[e] + p0[e]) + p1[e];
          }
        }
      }
      wait<0>();
      pin(cre);
      pin(cim);

      if (arrived != nullptr) {  // every warp of the group has read the tile
        if (lane == 0) wait_arrivals(arrived, GROUP_WARPS * (i + 1));
        __syncwarp();
      }
      // D fragment: element 4 jn + 2 hh + e is row 16 (warp % 4) + g + 8 hh
      // of the warpgroup, column 8 jn + 2 t + e of the column block
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long r = map.row(rb, warp * XROWS + g + 8 * hh);
        if (r >= map.rows) continue;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const int col = cb * BN + jn * 8 + 2 * t, e = 4 * jn + 2 * hh;
          *reinterpret_cast<float2*>(map.out(0, r, col)) =
              make_float2(sre[e] + cre[e], sre[e + 1] + cre[e + 1]);
          *reinterpret_cast<float2*>(map.out(1, r, col)) =
              make_float2(sim[e] + cim[e], sim[e + 1] + cim[e + 1]);
        }
      }
    }
  } else {
    // Passes 4c .. 4c + 3 of chunk c: (re, im) x (positions 0..7, 8..15),
    // pass s into pair s % 2 (pa, pb or pc, pd), queued before pass s - 1
    // is waited on and added, over a run of KRUN chunks.  xr0/xi0 are
    // the chunk's half-zero fragments for positions 0..7 (read by passes
    // 4c, 4c + 1), xr1/xi1 for 8..15 (4c + 2, 4c + 3); their zero halves
    // are never written.
    float sre[32], sim[32], pa[32], pb[32], pc[32], pd[32];
    uint32_t xr0[4], xi0[4], xr1[4], xi1[4];
#pragma unroll
    for (int e = 0; e < 32; ++e) pa[e] = pb[e] = pc[e] = pd[e] = 0.f;
    xr0[2] = xr0[3] = xi0[2] = xi0[3] = 0u;
    xr1[0] = xr1[1] = xi1[0] = xi1[1] = 0u;
    // rows g and g + 8 of stage G: k 4 t, 4 t + 1 (positions 0..7) or
    // 4 t + 2, 4 t + 3 (8..15), rounded to bf16 (split2's hi)
    auto take = [&](int G, int h, uint32_t (&xr)[4], uint32_t (&xi)[4]) {
      const float* xq = xw + (G % XSTAGES) * XSTAGE_F + t * 4 + 2 * h;
      const float2 a0 = ld2(xq + g * 16), a1 = ld2(xq + (g + 8) * 16);
      const float2 b0 = ld2(xq + (XROWS + g) * 16);
      const float2 b1 = ld2(xq + (XROWS + g + 8) * 16);
      xr[2 * h] = hi2(a0.x, a0.y);
      xr[2 * h + 1] = hi2(a1.x, a1.y);
      xi[2 * h] = hi2(b0.x, b0.y);
      xi[2 * h + 1] = hi2(b1.x, b1.y);
    };
    auto add_re = [&](float (&d0)[32], float (&d1)[32]) {
      pin(d0);
      pin(d1);
#pragma unroll
      for (int e = 0; e < 32; ++e) sre[e] = (sre[e] + d0[e]) - d1[e];
    };
    auto add_im = [&](float (&d0)[32], float (&d1)[32]) {
      pin(d0);
      pin(d1);
#pragma unroll
      for (int e = 0; e < 32; ++e) sim[e] = (sim[e] + d0[e]) + d1[e];
    };
    // the tile's results: every warp of the group has read its rows first
    // (in place); element 4 jn + 2 hh + e of a D fragment is row 16 (warp %
    // 4) + g + 8 hh of the warpgroup, column 8 jn + 2 t + e of the column
    // block
    auto store = [&](int i, const float (&vre)[32],
                     const float (&vim)[32]) {
      if (arrived != nullptr) {
        if (lane == 0) wait_arrivals(arrived, GROUP_WARPS * (i + 1));
        __syncwarp();
      }
      const long long rb = cg + i * groups;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long r = map.row(rb, warp * XROWS + g + 8 * hh);
        if (r >= map.rows) continue;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const int col = cb * BN + jn * 8 + 2 * t, e = 4 * jn + 2 * hh;
          *reinterpret_cast<float2*>(map.out(0, r, col)) =
              make_float2(vre[e], vre[e + 1]);
          *reinterpret_cast<float2*>(map.out(1, r, col)) =
              make_float2(vim[e], vim[e + 1]);
        }
      }
    };
    stage_x(XSTAGES - 1);
    async::wait_groups<XSTAGES - 1>();
    __syncwarp();
    take(0, 0, xr0, xi0);

#pragma unroll 1
    for (int i = 0; i < tiles; ++i) {
      if (i > 0) __syncthreads();
      if (i + 2 < tiles) fill_src(i + 2);
#pragma unroll
      for (int e = 0; e < 32; ++e) sre[e] = sim[e] = 0.f;

      // KRUN chunks a run, unrolled: ptxas keeps passes in flight only
      // within straight-line code (across a loop's back edge it serializes
      // every wgmma), so a run ends with its last pass waited on
#pragma unroll 1
      for (int c0 = 0; c0 < CHUNKS; c0 += KRUN) {
#pragma unroll
        for (int u = 0; u < KRUN; ++u) {
          const int c = c0 + u, G = i * CHUNKS + c;
          async::bar_wait(&full[c], 0);
          const uint32_t base = tab_s + c * CHUNK_BYTES;
          const uint64_t dah = desc(base), dbh = desc(base + 2 * PART);
          fence();                 // 4c: out_re += xr.A_hi - xi.B_hi
          bf16<1>(pa, xr0, dah, 0);
          bf16<1>(pb, xi0, dbh, 0);
          commit();
          if (u > 0) {             // 4c - 1, of the chunk before
            wait<1>();
            add_im(pc, pd);
          }
          take(G, 1, xr1, xi1);    // passes 4c - 2, 4c - 1 read them
          fence();                 // 4c + 1: out_im += xr.B_hi + xi.A_hi
          bf16<1>(pc, xr0, dbh, 0);
          bf16<1>(pd, xi0, dah, 0);
          commit();
          wait<1>();
          add_re(pa, pb);          // 4c
          fence();                 // 4c + 2
          bf16<1>(pa, xr1, dah, 0);
          bf16<1>(pb, xi1, dbh, 0);
          commit();
          wait<1>();
          add_im(pc, pd);          // 4c + 1
          fence();                 // 4c + 3
          bf16<1>(pc, xr1, dbh, 0);
          bf16<1>(pd, xi1, dah, 0);
          commit();
          // the next chunk's rows, positions 0..7, while 4c + 2 and 4c + 3
          // run (4c and 4c + 1, which read xr0/xi0, are done)
          stage_x(G + XSTAGES);
          async::wait_groups<XSTAGES - 1>();
          __syncwarp();
          if (arrived != nullptr && c == CHUNKS - 2 && lane == 0)
            arrive(arrived);       // the warp's reads of the tile are done
          take(G + 1, 0, xr0, xi0);
          wait<1>();
          add_re(pa, pb);          // 4c + 2
        }
        wait<0>();
        add_im(pc, pd);            // the run's last pass
      }
      store(i, sre, sim);
    }
  }
  // the group's last warp past its last wait leaves both counters zero
  if (arrived != nullptr && lane == 0 &&
      atomicAdd(arrived + 1, 1) == GROUP_WARPS - 1) {
    arrived[0] = 0;
    arrived[1] = 0;
  }
}

}  // namespace wgh
