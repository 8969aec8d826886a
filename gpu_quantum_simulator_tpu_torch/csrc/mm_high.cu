// The mxu engine's mm step at the "high" rung, for Hopper (sm_90a) tensor
// cores: one launch per step, reading and writing the state through the
// block's row map.
//
// Replaces: the "high" product of gpu_quantum_simulator_tpu/engine/wide.py
// _apply_wide_karatsuba (:183-198), which XLA computes outside any Pallas
// kernel between two row shuffles: three jnp.matmul(..., precision=HIGH),
// each XLA's 3-pass bf16 product summed in fp32.  On the (M, D) view x of
// the state, D = 128 << kh:
//     t1 = (xr + xi).m1,  t2 = xr.m2,  t3 = xi.m3
//     out_re = t1 - t3,   out_im = t1 + t2
// with m1 = M_re^T, m2 = (M_im - M_re)^T, m3 = (M_re + M_im)^T, each real
// product x.m = xh.mh + xl.mh + xh.ml (h = bf16 of x, l = bf16 of x - h);
// s = xr + xi is formed in fp32 before its split, as the JAX package adds
// re_m + im_m.  cuBLAS's bf16 GEMMs keep their fp32 sums in the tensor
// core, whose adds truncate: |psi|^2 fell by ~7.7e-5 over 200 steps at
// n = 24 (PERF.md section 6), hence a kernel of the port's own.
//
// The row map.  The kernel takes the unshuffled (R, 128) state pair and the
// block's kh ascending row bits b_0 < b_1: row m of the (M, D) view (M =
// R >> kh), segment j = k / 128, is state row insert_bits(m, j): bit i of j
// placed at row bit b_i, the other bits of m around them in order (what
// kernels/wide.py row_shuffles' fwd copies out), a 512-byte run.  Output
// column n goes to column n % 128 of the same map's row for segment n /
// 128, in a separate out pair: no shuffle copy of the state is made, and
// the step is not in place (a CTA's rows are read by every column-block
// CTA of the row block before any of them writes).
//
// The arithmetic, where its sums are kept and the table image are
// karatsuba_high.cuh's, whose k-chunk body this kernel and kernel 7's
// "high" chain (wide_chain.cu) share.  The tables are split once per
// program (kernels/wide.py split_mm_tables).  The "default" rung's mm step
// (one bf16 pass, the hi.hi sums alone, in the same order) is
// mm_high_kernel<D, false>, on a k-loop of its own: three partial pairs,
// one a product, two wgmma groups queued while a third group's partials
// are added, the next chunk's rows loaded and rounded while the chunk's
// last groups run, no drain inside a tile; its tables the hi-only image
// (split_mm_tables_hi, 96 KB a column block at D = 512), which leaves room
// for an eight-stage row ring (two at "high" there).  At n = 24, D = 512
// its 6 hi.hi passes a k-chunk are 103 GFLOP issued (0.104 ms; the useful
// 3 products, 0.052 ms) against 0.080 ms of state bytes, and the partials'
// 3.2e9 fp32 adds (~0.1 ms of the CUDA cores) now run beside them: the
// adds alone take about as long as one bf16 torch.mm of the step, which
// keeps its sums in the tensor core, so the arm stays above that call.  On
// an H100 each side alone (chip_ab.py --strip adds, --strip wgmmas) takes
// about two thirds of the step: the CUDA cores issue ~280 instructions a
// k-chunk and thread (104 of them the adds) and the m64n32k16 wgmmas run
// well below the tensor core's peak (PERF.md section 6).

// Shapes.  A CTA is two warpgroups: a tile of 128 rows (64 each, wgmma's
// M) by 32 output columns (m64n32k16), per thread three fp32 sums T_P,
// three correction accumulators C_P and four partials of 16 floats.  The
// CTAs are persistent, one an SM: the D / 32 column blocks of a row block
// are a group of neighbouring CTAs (they read the same rows, which then
// come from device memory once and from L2 after), and group cg takes row
// blocks cg, cg + G, ...  Each CTA keeps its column block of the six
// tables resident in shared memory (D / 16 x 6 KB: 192 KB at D = 512, one
// bulk copy and one mbarrier a k-chunk, at the start), so the tables are
// read from L2 once per CTA and launch.  Each warp copies its own 16 rows
// with cp.async through the row map, a k-chunk at a time, into a ring of
// its own that runs on across tiles (two stages at D = 512, which is what
// the tables leave of the 227 KB; four below; eight at "default", whose
// hi-only tables take half the room); a lane copies exactly the
// 64 bytes it reads back as its A fragment, which it splits to bf16 (hi,
// lo) in registers.
//
// What bounds it on the card: at n = 24, D = 512 a real product is 2 x
// 32768 x 512^2 = 17.2 GFLOP.  A step issues 6 hi.hi passes and 6
// corrections a k-chunk, 12 bf16 products' worth: 206 GFLOP, 0.208 ms at
// 989 TFLOP/s (the useful work, 9 bf16 products, is 0.156 ms).  The
// partials' fp32 adds, 3 x M x D x D / 8 = 3.2e9, take ~0.1 ms of the CUDA
// cores, and on an H100 such adds do not hide behind the wgmmas (PERF.md
// section 6): the CUDA cores issue ~250 instructions a thread and k-chunk
// (half of them the adds, a quarter the splits) beside 12 wgmmas.  The
// state moved is 268 MB (0.080 ms at 3.35 TB/s); L2 serves each row block
// to its 16 column-block CTAs, 2.1 GB a step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"
#include "karatsuba_high.cuh"

namespace {

constexpr int LANES = 128;                  // a state row
constexpr int BN = kh::BN;                  // output columns per CTA
constexpr int WGS = 2;                      // warpgroups
constexpr int BM = 64 * WGS;                // rows per tile
constexpr int THREADS = 128 * WGS;
constexpr int WARPS = THREADS / 32;
constexpr int XROWS = 16;                   // rows a warp stages
constexpr int XSTAGE_F = 2 * XROWS * 16;    // floats: re, im of 16 rows
constexpr int XSTAGE_BYTES = WARPS * XSTAGE_F * 4;
constexpr int SMEM_MAX = 232448;            // a CTA's shared memory
constexpr int KRUN = 4;                     // "default": chunks a run
static_assert(WARPS * XROWS == BM, "each warp stages its own rows");

template <int D, bool LO>
struct Shape {
  static constexpr int CHUNKS = D / 16;
  static constexpr int SEG_CHUNKS = LANES / 16;     // k-chunks a segment
  static constexpr int COL_BLOCKS = D / BN;
  // a chunk of the tables: the six parts ("high") or the three hi parts
  static constexpr int CHUNK_BYTES =
      LO ? kh::CHUNK_BYTES : kh::HI_CHUNK_BYTES;
  static constexpr int TAB = CHUNKS * CHUNK_BYTES;  // a column block's
  static constexpr int BARS = CHUNKS * 8;
  static constexpr int FIT = (SMEM_MAX - TAB - BARS) / XSTAGE_BYTES;
  static constexpr int CAP = LO ? 4 : 8;           // stages of the ring
  static constexpr int XSTAGES = FIT < CAP ? FIT : CAP;
  static constexpr int SMEM = TAB + XSTAGES * XSTAGE_BYTES + BARS;
  static_assert(XSTAGES >= 2, "the ring needs two stages");
};

// The block's row map: rows of the (M, D) view, row bits b0 < b1 (-1:
// absent).  Rows fit in 32 bits (R <= 2^23).
struct RowMap {
  int rows;
  int b0, b1;

  // row m with a zero inserted at each row bit: its segment-0 state row
  __device__ __forceinline__ int base(int m) const {
    if (b0 >= 0) m = ((m >> b0) << (b0 + 1)) | (m & ((1 << b0) - 1));
    if (b1 >= 0) m = ((m >> b1) << (b1 + 1)) | (m & ((1 << b1) - 1));
    return m;
  }
  // segment j's state-row offset: bit i of j on row bit b_i
  __device__ __forceinline__ int seg(int j) const {
    return (b0 >= 0 ? (j & 1) << b0 : 0) |
           (b1 >= 0 ? ((j >> 1) & 1) << b1 : 0);
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One mm step.  blockIdx.x % (D / 32) is the column block, the CTA group
// blockIdx.x / (D / 32) of gridDim.x / (D / 32) takes every G-th row
// block of 128 view rows.  w: the tables as split_mm_tables (LO) or
// split_mm_tables_hi lays them out (D / 32 column blocks of D / 16 chunks
// of Shape::CHUNK_BYTES).
template <int D, bool LO>
__global__ void __launch_bounds__(THREADS, 1)
mm_high_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ out_re, float* __restrict__ out_im,
               const uint8_t* __restrict__ w, RowMap map) {
  using S = Shape<D, LO>;
  extern __shared__ __align__(1024) uint8_t smem[];
  float* xs = reinterpret_cast<float*>(smem + S::TAB);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + S::TAB + S::XSTAGES * XSTAGE_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;      // fragment row / column group
  const int cb = blockIdx.x % S::COL_BLOCKS;
  const int cg = blockIdx.x / S::COL_BLOCKS;
  const int groups = gridDim.x / S::COL_BLOCKS;
  const int blocks = (map.rows + BM - 1) / BM;
  if (cg >= blocks) return;                   // the whole group: no tile
  const int tiles = (blocks - 1 - cg) / groups + 1;

  if (tid == 0) {
    for (int c = 0; c < S::CHUNKS; ++c) async::bar_init(&full[c]);
    async::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < S::CHUNKS; ++c)
      async::bulk_load(smem + c * S::CHUNK_BYTES,
                       w + ((long long)cb * S::CHUNKS + c) * S::CHUNK_BYTES,
                       S::CHUNK_BYTES, &full[c]);

  float* xw = xs + warp * S::XSTAGES * XSTAGE_F;
  const int total = tiles * S::CHUNKS;
  const uint64_t tab0 = kh::desc(async::smem_u32(smem));
  // the CTA's output columns lie in one segment of the row map
  const int seg_out = cb * BN / LANES, col0 = cb * BN % LANES;

  if constexpr (LO) {
    // this warp's 16 rows of global chunk G (tile G / CHUNKS, k-chunk G %
    // CHUNKS): lane (g, t) copies k 4t .. 4t + 3 of rows g and g + 8, re
    // and im, through the row map -- the values it reads back as its
    // fragment
    auto stage_x = [&](int G) {
      if (G < total) {
        const int i = G / S::CHUNKS, c = G % S::CHUNKS;
        const int m0 = (cg + i * groups) * BM + warp * XROWS + g;
        const int k0 = map.seg(c / S::SEG_CHUNKS) * LANES +
                       (c % S::SEG_CHUNKS) * 16 + 4 * t;
        float* st = xw + (G % S::XSTAGES) * XSTAGE_F;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * h;
          const bool ok = m < map.rows;
          const int o = ok ? map.base(m) * LANES + k0 : 0;
          async::cp16(st + (g + 8 * h) * 16 + 4 * t, xr + o, ok);
          async::cp16(st + (XROWS + g + 8 * h) * 16 + 4 * t, xi + o, ok);
        }
      }
      async::commit();
    };
#pragma unroll
    for (int G = 0; G < S::XSTAGES - 1; ++G) stage_x(G);

    float T[3][16], C[3][16], X[4][16];
#pragma unroll
    for (int e = 0; e < 16; ++e) X[0][e] = X[1][e] = X[2][e] = X[3][e] = 0.f;

#pragma unroll 1
    for (int i = 0; i < tiles; ++i) {
      const int rb = cg + i * groups;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        T[0][e] = T[1][e] = T[2][e] = 0.f;
        C[0][e] = C[1][e] = C[2][e] = 0.f;
      }

#pragma unroll 1
      for (int c = 0; c < S::CHUNKS; ++c) {
        const int G = i * S::CHUNKS + c;
        stage_x(G + S::XSTAGES - 1);
        async::wait_groups<S::XSTAGES - 1>();
        if (i == 0) async::bar_wait(&full[c], 0);
        const float* xq = xw + (G % S::XSTAGES) * XSTAGE_F;
        const float4 r0 = ld4(xq + g * 16 + 4 * t);
        const float4 r1 = ld4(xq + (g + 8) * 16 + 4 * t);
        const float4 i0 = ld4(xq + (XROWS + g) * 16 + 4 * t);
        const float4 i1 = ld4(xq + (XROWS + g + 8) * 16 + 4 * t);
        uint32_t a[3][2][4];
        kh::split_rows(r0, r1, i0, i1, a);
        // the chunk's six parts: descriptors differ only in the address
        kh::chunk(T, C, X, a,
                      tab0 + (uint64_t)(c * (S::CHUNK_BYTES >> 4)));
      }
      kh::pin_corrections(C);

      // D fragment: element 4 jn + 2 hh + e is row 16 warp + g + 8 hh of
      // the tile, column 8 jn + 2 t + e of the column block
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = rb * BM + warp * XROWS + g + 8 * hh;
        if (m >= map.rows) continue;
        const int o =
            (map.base(m) + map.seg(seg_out)) * LANES + col0 + 2 * t;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const int x = 4 * jn + 2 * hh;
          const float2 v0 = kh::result<LO>(T, C, x);
          const float2 v1 = kh::result<LO>(T, C, x + 1);
          *reinterpret_cast<float2*>(out_re + o + 8 * jn) =
              make_float2(v0.x, v1.x);
          *reinterpret_cast<float2*>(out_im + o + 8 * jn) =
              make_float2(v0.y, v1.y);
        }
      }
    }
  } else {
    // The "default" k-loop: group (c, P) is product P's two hi.hi passes
    // of chunk c into the pair X[P]; it is queued while groups (c, P - 2)
    // and (c, P - 1) run and waited on (wait<2>) two groups later, when
    // its partials are added into T[P] -- in chunk order, so the sums are
    // the "high" arm's hi.hi sums.  A product's fragments h0[P], h1[P] are
    // rounded just before its group, once the group of the chunk before,
    // which read them, is done; the next chunk's rows load while the
    // chunk's last two groups run.  The queue drains once a run of KRUN
    // chunks.
    //
    // this warp's 16 rows of global chunk G, as the "high" arm stages them,
    // their row-map offsets worked out once a tile
    int st_tile = -1, st_o[2];
    auto stage_x = [&](int G) {
      if (G < total) {
        const int i = G / S::CHUNKS, c = G % S::CHUNKS;
        if (i != st_tile) {
          st_tile = i;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (cg + i * groups) * BM + warp * XROWS + g + 8 * h;
            st_o[h] = m < map.rows ? map.base(m) * LANES : -1;
          }
        }
        const int k0 = map.seg(c / S::SEG_CHUNKS) * LANES +
                       (c % S::SEG_CHUNKS) * 16 + 4 * t;
        float* st = xw + (G % S::XSTAGES) * XSTAGE_F;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = st_o[h] >= 0;
          const int o = ok ? st_o[h] + k0 : 0;
          async::cp16(st + (g + 8 * h) * 16 + 4 * t, xr + o, ok);
          async::cp16(st + (XROWS + g + 8 * h) * 16 + 4 * t, xi + o, ok);
        }
      }
      async::commit();
    };
    float4 r0, r1, i0, i1;       // the chunk's rows g and g + 8, re and im
    auto take = [&](int G) {
      const float* xq = xw + (G % S::XSTAGES) * XSTAGE_F;
      r0 = ld4(xq + g * 16 + 4 * t);
      r1 = ld4(xq + (g + 8) * 16 + 4 * t);
      i0 = ld4(xq + (XROWS + g) * 16 + 4 * t);
      i1 = ld4(xq + (XROWS + g + 8) * 16 + 4 * t);
    };
    float T[3][16], X[3][2][16];
    uint32_t h0[3][4], h1[3][4];
#pragma unroll
    for (int P = 0; P < 3; ++P) {
      h0[P][2] = h0[P][3] = h1[P][0] = h1[P][1] = 0u;
#pragma unroll
      for (int e = 0; e < 16; ++e) X[P][0][e] = X[P][1][e] = 0.f;
    }
    static_assert(S::CHUNKS % KRUN == 0, "a tile is whole runs of chunks");
    auto add = [&](int P) {      // T_P = (T_P + H(c, 0)) + H(c, 1)
      kh::add1(T[P], X[P][0]);
      kh::add1(T[P], X[P][1]);
    };
#pragma unroll
    for (int G = 0; G < S::XSTAGES; ++G) stage_x(G);
    async::wait_groups<S::XSTAGES - 1>();
    take(0);

#pragma unroll 1
    for (int i = 0; i < tiles; ++i) {
      const int rb = cg + i * groups;
#pragma unroll
      for (int e = 0; e < 16; ++e) T[0][e] = T[1][e] = T[2][e] = 0.f;

      // KRUN chunks a run, unrolled: ptxas keeps groups in flight only
      // within straight-line code (across a loop's back edge it serializes
      // every wgmma), so a run ends with its last groups waited on
#pragma unroll 1
      for (int c0 = 0; c0 < S::CHUNKS; c0 += KRUN) {
#pragma unroll
        for (int u = 0; u < KRUN; ++u) {
          const int c = c0 + u, G = i * S::CHUNKS + c;
          if (i == 0) async::bar_wait(&full[c], 0);
          const uint64_t d = tab0 + (uint64_t)(c * (S::CHUNK_BYTES >> 4));
          constexpr uint64_t part = kh::PART >> 4;
          kh::split_hi(kh::add4(r0, i0), kh::add4(r1, i1), h0[0], h1[0]);
          kh::hi_group(X[0], h0[0], h1[0], d);              // t1: s.m1
          if (u > 0) {
            kh::wait<2>();
            add(1);              // (c - 1, 1)
          }
          kh::split_hi(r0, r1, h0[1], h1[1]);
          kh::hi_group(X[1], h0[1], h1[1], d + part);       // t2: xr.m2
          if (u > 0) {
            kh::wait<2>();
            add(2);              // (c - 1, 2)
          }
          kh::split_hi(i0, i1, h0[2], h1[2]);
          kh::hi_group(X[2], h0[2], h1[2], d + 2 * part);   // t3: xi.m3
          stage_x(G + S::XSTAGES);
          async::wait_groups<S::XSTAGES - 1>();
          take(G + 1);
          kh::wait<2>();
          add(0);                // (c, 0)
        }
        kh::wait<1>();
        add(1);
        kh::wait<0>();
        add(2);
      }

      // D fragment, as the "high" arm stores it (result<false> reads no
      // corrections: T stands in for them)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = rb * BM + warp * XROWS + g + 8 * hh;
        if (m >= map.rows) continue;
        const int o =
            (map.base(m) + map.seg(seg_out)) * LANES + col0 + 2 * t;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const int x = 4 * jn + 2 * hh;
          const float2 v0 = kh::result<false>(T, T, x);
          const float2 v1 = kh::result<false>(T, T, x + 1);
          *reinterpret_cast<float2*>(out_re + o + 8 * jn) =
              make_float2(v0.x, v1.x);
          *reinterpret_cast<float2*>(out_im + o + 8 * jn) =
              make_float2(v0.y, v1.y);
        }
      }
    }
  }
}

template <int D, bool LO>
cudaError_t launch(const float* xr, const float* xi, float* out_re,
                   float* out_im, const void* w, RowMap map,
                   cudaStream_t stream) {
  using S = Shape<D, LO>;
  static unsigned smem_set = 0;
  static int slots = 0;      // CTAs of the kernel that fit on the card
  cudaError_t e = async::allow_smem(mm_high_kernel<D, LO>, S::SMEM,
                                    &smem_set);
  if (e == cudaSuccess && slots == 0)
    e = async::persistent_slots(mm_high_kernel<D, LO>, THREADS, S::SMEM,
                                &slots);
  if (e != cudaSuccess) return e;
  // persistent: CTA groups of the D / 32 column blocks, one row block each
  // at a time
  const int blocks = (map.rows + BM - 1) / BM;
  const int groups = std::min(blocks, std::max(1, slots / S::COL_BLOCKS));
  mm_high_kernel<D, LO><<<(unsigned)(groups * S::COL_BLOCKS), THREADS,
                          S::SMEM, stream>>>(
      xr, xi, out_re, out_im, static_cast<const uint8_t*>(w), map);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One "high" (lo = 1) or "default" (lo = 0) mm step on the (rows, 128)
// state pair (xr, xi) into the separate pair (out_re, out_im), D = 128 <<
// kh with kh = 0, 1 or 2 row bits b0 < b1 (-1 where absent); rows a power
// of two above every row bit.  w16: the step's Karatsuba tables,
// split_mm_tables at "high", split_mm_tables_hi at "default".
int qsim_mm_step_high(const float* xr, const float* xi, float* out_re,
                      float* out_im, const void* w16, long long rows, int D,
                      int b0, int b1, int lo, void* stream) {
  const int kh = D == 128 ? 0 : D == 256 ? 1 : D == 512 ? 2 : -1;
  const int top = b1 >= 0 ? b1 : b0;
  const bool bits_ok = kh == 0   ? b0 < 0 && b1 < 0
                       : kh == 1 ? b0 >= 0 && b1 < 0
                       : kh == 2 ? b0 >= 0 && b1 > b0
                                 : false;
  if (!bits_ok || rows < 1 || (rows & (rows - 1)) != 0 ||
      rows > (1LL << 30) / LANES || (top >= 0 && (2LL << top) > rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowMap map{(int)(rows >> kh), b0, b1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      lo ? (D == 128   ? launch<128, true>(xr, xi, out_re, out_im, w16, map, s)
            : D == 256 ? launch<256, true>(xr, xi, out_re, out_im, w16, map, s)
                       : launch<512, true>(xr, xi, out_re, out_im, w16, map, s))
         : (D == 128 ? launch<128, false>(xr, xi, out_re, out_im, w16, map, s)
            : D == 256
                ? launch<256, false>(xr, xi, out_re, out_im, w16, map, s)
                : launch<512, false>(xr, xi, out_re, out_im, w16, map, s));
  return static_cast<int>(e);
}

}  // extern "C"
