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
// Where the sums are kept, in this order.  A tensor core's fp32 adds
// truncate, so a sum that stays in its accumulator across many passes
// shrinks the norm a little every step.  For each output (m, n) and real
// product P (t1, t2, t3):
//   * hi.hi: for every k-chunk c of 16 in order and half h = 0, 1 of it, a
//     bf16 wgmma from zero (scale-d = 0) with the other half of its A
//     fragment zero, so eight of the chunk's k (wgmma positions 8 h ..
//     8 h + 7): the exact products summed by the tensor core into an
//     8-term partial H(c, h), added in fp32 on the CUDA cores, which round
//     to nearest:  T_P = (T_P + H(c, 0)) + H(c, 1);
//   * corrections: xl.mh and then xh.ml of every chunk in order, bf16
//     wgmmas accumulating over all k in the tensor core (C_P); they are
//     2^-8 the size of the hi.hi terms, so their truncation is too;
//   * t_P = T_P + C_P; out_re = t1 - t3, out_im = t1 + t2, IEEE fp32.
// chip_smoke.py's drift phase holds these sums to the plain version's
// drift over 200 steps and six seeds at D = 512 and 256.  4-term partials
// (quarter-masked passes, twice the passes and adds) drift a third as
// much and ran 28% slower a step; both forms pass the bars (PERF.md
// section 6).
//
// The tables are split once per program (kernels/wide.py split_mm_tables)
// into the image the kernel copies into shared memory: per 32-column block
// cb and k-chunk c, six parts [m1_hi, m1_lo, m2_hi, m2_lo, m3_hi, m3_lo],
// each the wgmma B operand K-major and unswizzled: 16-byte core matrices
// [kc 2][n 32][8], stride 512 bytes along k and 128 along n.  k is
// permuted inside every 16 (position p holds k 4 ((p % 8) / 2) + 2 (p / 8)
// + p % 2, as csrc/wgmma_high.cuh's tables), so that one float4 of a state
// row (k 4t .. 4t + 3) is lane t's A-fragment values.
//
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
// the tables leave of the 227 KB; four below); a lane copies exactly the
// 64 bytes it reads back as its A fragment, which it splits to bf16 (hi,
// lo) in registers.  A chunk is three groups of wgmmas, one a product:
// two hi.hi passes into a pair of partials and two corrections; a group's
// partials are added while the next group runs on the tensor core.
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

namespace {

constexpr int LANES = 128;                  // a state row
constexpr int BN = 32;                      // output columns per CTA
constexpr int WGS = 2;                      // warpgroups
constexpr int BM = 64 * WGS;                // rows per tile
constexpr int THREADS = 128 * WGS;
constexpr int WARPS = THREADS / 32;
constexpr int XROWS = 16;                   // rows a warp stages
constexpr int PART = 2 * BN * 16;           // bytes: one table's k-chunk
constexpr int CHUNK_BYTES = 6 * PART;       // the six tables' k-chunk
constexpr int CORE_K = BN * 16;             // core-matrix stride along k
constexpr int CORE_N = 128;                 // and along n
constexpr int XSTAGE_F = 2 * XROWS * 16;    // floats: re, im of 16 rows
constexpr int XSTAGE_BYTES = WARPS * XSTAGE_F * 4;
constexpr int SMEM_MAX = 232448;            // a CTA's shared memory
static_assert(WARPS * XROWS == BM, "each warp stages its own rows");

template <int D>
struct Shape {
  static constexpr int CHUNKS = D / 16;
  static constexpr int SEG_CHUNKS = LANES / 16;     // k-chunks a segment
  static constexpr int COL_BLOCKS = D / BN;
  static constexpr int TAB = CHUNKS * CHUNK_BYTES;  // a column block's
  static constexpr int BARS = CHUNKS * 8;
  static constexpr int FIT = (SMEM_MAX - TAB - BARS) / XSTAGE_BYTES;
  static constexpr int XSTAGES = FIT < 4 ? FIT : 4;
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

// (x0, x1) -> bf16x2 hi and bf16x2 lo (x0 in the low 16 bits)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// rows g (r0) and g + 8 (r1), k 4t .. 4t + 3: the A fragment, hi and lo
__device__ __forceinline__ void split_frag(float4 r0, float4 r1,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(r0.x, r0.y, hi[0], lo[0]);
  split2(r1.x, r1.y, hi[1], lo[1]);
  split2(r0.z, r0.w, hi[2], lo[2]);
  split2(r1.z, r1.w, hi[3], lo[3]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// half h of a fragment, the other half zero: registers 2 h and 2 h + 1,
// wgmma positions 8 h .. 8 h + 7 of the chunk
__device__ __forceinline__ void half(uint32_t (&o)[4], const uint32_t (&a)[4],
                                     int h) {
  o[0] = h ? 0u : a[0];
  o[1] = h ? 0u : a[1];
  o[2] = h ? a[2] : 0u;
  o[3] = h ? a[3] : 0u;
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
__device__ __forceinline__ void pin(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a.b + (acc ? d : 0) over k = 16: bf16, m64n32, a from registers (the
// m16n8k16 A fragment of the warp's 16 rows), b a descriptor
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                    uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// sum += x, element by element, after the wait that ends the pass
// writing x
__device__ __forceinline__ void add1(float (&sum)[16], float (&x)[16]) {
  pin(x);
#pragma unroll
  for (int e = 0; e < 16; ++e) sum[e] += x[e];
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One "high" mm step.  blockIdx.x % (D / 32) is the column block, the CTA
// group blockIdx.x / (D / 32) of gridDim.x / (D / 32) takes every G-th
// row block of 128 view rows.  w: the tables as split_mm_tables lays them
// out (D / 32 column blocks of D / 16 chunks of CHUNK_BYTES).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
mm_high_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ out_re, float* __restrict__ out_im,
               const uint8_t* __restrict__ w, RowMap map) {
  using S = Shape<D>;
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
      async::bulk_load(smem + c * CHUNK_BYTES,
                       w + ((long long)cb * S::CHUNKS + c) * CHUNK_BYTES,
                       CHUNK_BYTES, &full[c]);

  // this warp's 16 rows of global chunk G (tile G / CHUNKS, k-chunk G %
  // CHUNKS): lane (g, t) copies k 4t .. 4t + 3 of rows g and g + 8, re and
  // im, through the row map -- the values it reads back as its fragment
  float* xw = xs + warp * S::XSTAGES * XSTAGE_F;
  const int total = tiles * S::CHUNKS;
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

  const uint64_t tab0 = desc(async::smem_u32(smem));
  // the CTA's output columns lie in one segment of the row map
  const int seg_out = cb * BN / LANES, col0 = cb * BN % LANES;
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
      // [product: s, xr, xi][hi, lo][fragment register]
      uint32_t a[3][2][4];
      split_frag(add4(r0, i0), add4(r1, i1), a[0][0], a[0][1]);
      split_frag(r0, r1, a[1][0], a[1][1]);
      split_frag(i0, i1, a[2][0], a[2][1]);
      // the chunk's six parts: descriptors differ only in the address
      const uint64_t d = tab0 + (uint64_t)(c * (CHUNK_BYTES >> 4));
      // three groups, one a product P: its two hi.hi passes (halves 0 and
      // 1) into the partial pair X[2 (P % 2)], X[2 (P % 2) + 1], then its
      // corrections xl.mh and xh.ml into C[P]; a group's partials are
      // added once the next group is queued
#pragma unroll
      for (int P = 0; P < 3; ++P) {
        const int b = P % 2;
        uint32_t x0[4], x1[4];
        half(x0, a[P][0], 0);
        half(x1, a[P][0], 1);
        const uint64_t mh = d + (2 * P * PART >> 4);
        const uint64_t ml = d + ((2 * P + 1) * PART >> 4);
        fence();
        mma(X[2 * b], x0, mh, 0);
        mma(X[2 * b + 1], x1, mh, 0);
        mma(C[P], a[P][1], mh, 1);
        mma(C[P], a[P][0], ml, 1);
        commit();
        if (P > 0) {
          wait<1>();
          add1(T[P - 1], X[2 * (1 - b)]);
          add1(T[P - 1], X[2 * (1 - b) + 1]);
        }
      }
      wait<0>();                 // the chunk's passes read its fragments
      add1(T[2], X[0]);
      add1(T[2], X[1]);
    }
    pin(C[0]);
    pin(C[1]);
    pin(C[2]);

    // D fragment: element 4 jn + 2 hh + e is row 16 warp + g + 8 hh of the
    // tile, column 8 jn + 2 t + e of the column block
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = rb * BM + warp * XROWS + g + 8 * hh;
      if (m >= map.rows) continue;
      const int o = (map.base(m) + map.seg(seg_out)) * LANES + col0 + 2 * t;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        float re[2], im[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * jn + 2 * hh + e;
          const float t1 = T[0][x] + C[0][x];
          const float t2 = T[1][x] + C[1][x];
          const float t3 = T[2][x] + C[2][x];
          re[e] = t1 - t3;
          im[e] = t1 + t2;
        }
        *reinterpret_cast<float2*>(out_re + o + 8 * jn) =
            make_float2(re[0], re[1]);
        *reinterpret_cast<float2*>(out_im + o + 8 * jn) =
            make_float2(im[0], im[1]);
      }
    }
  }
}

template <int D>
cudaError_t launch(const float* xr, const float* xi, float* out_re,
                   float* out_im, const void* w, RowMap map,
                   cudaStream_t stream) {
  using S = Shape<D>;
  static bool smem_set = false;
  static int slots = 0;      // CTAs of the kernel that fit on the card
  cudaError_t e = async::allow_smem(mm_high_kernel<D>, S::SMEM, &smem_set);
  if (e == cudaSuccess && slots == 0)
    e = async::persistent_slots(mm_high_kernel<D>, THREADS, S::SMEM,
                                &slots);
  if (e != cudaSuccess) return e;
  // persistent: CTA groups of the D / 32 column blocks, one row block each
  // at a time
  const int blocks = (map.rows + BM - 1) / BM;
  const int groups = std::min(blocks, std::max(1, slots / S::COL_BLOCKS));
  mm_high_kernel<D><<<(unsigned)(groups * S::COL_BLOCKS), THREADS, S::SMEM,
                      stream>>>(xr, xi, out_re, out_im,
                                static_cast<const uint8_t*>(w), map);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One "high" mm step on the (rows, 128) state pair (xr, xi) into the
// separate pair (out_re, out_im), D = 128 << kh with kh = 0, 1 or 2 row
// bits b0 < b1 (-1 where absent); rows a power of two above every row
// bit.  w16: split_mm_tables of the step's Karatsuba tables.
int qsim_mm_step_high(const float* xr, const float* xi, float* out_re,
                      float* out_im, const void* w16, long long rows, int D,
                      int b0, int b1, void* stream) {
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
      D == 128   ? launch<128>(xr, xi, out_re, out_im, w16, map, s)
      : D == 256 ? launch<256>(xr, xi, out_re, out_im, w16, map, s)
                 : launch<512>(xr, xi, out_re, out_im, w16, map, s);
  return static_cast<int>(e);
}

}  // extern "C"
