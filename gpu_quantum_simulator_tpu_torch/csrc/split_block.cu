// In-place split-state kernels of the prefetch engine, for Hopper (sm_90a).
//
// Replaces: gpu_quantum_simulator_tpu/engine/prefetch.py get_split_kernels
// (the aliased block kernel over _steps_loop_halves and the pair-grid xswap
// kernel) and get_stream_split_kernel (its streamed twin, whose PAIR MODE
// folds a pending cross-tile swap into a block's input).  The state is FOUR
// (R2, 128) f32 tensors: the column halves h0 (columns 0..127) and h1
// (columns 128..255) of re and of im; flat index f = row * 256 + half * 128
// + lane, so flat bit 7 is the half.  Every kernel here reads and writes
// those four tensors and nothing else of state size: there is no second
// buffer pair to ping-pong with, as the flat kernels (prefetch_block.cu)
// have.
//
// On the TPU, input/output aliasing is safe because one grid step reads the
// (512, 128) tiles it writes, held in VMEM across the whole step list.  Here
// a block still runs as one launch per step (a tile exceeds an SM's shared
// memory), so in place means an OWNERSHIP rule per launch: a CTA (or a
// thread) owns a set of elements that the step maps onto itself, reads all
// of it into shared memory or registers, and only then writes.
//   mat      a row of 256 columns is one matrix-vector product: a cluster
//            of CTAs owns whole rows (all four halves of them), reads them
//            all, then writes.
//   tswap k  flat bits 7 and 7 + k: h1[r] <-> h0[r + s], s = 2^(k-1), for
//            rows r with that bit clear; one thread owns both ends.
//   xswap    the same exchange with a cross-tile row bit (kernel 5(b)): the
//            pair-grid swap h1[j] <-> h0[j | tmask] over tile pairs.
//   perm v, mono   permute columns inside a row (and rotate by the slot's
//            cos/sin rows): a CTA stages its rows, then writes.
//   pair mode (scal[1] == 1): the launch reads its input through the
//            pending xswap.  The CTA that owns row r also owns row
//            r | 2^b (b the cross-tile row bit): rows come in such pairs,
//            so the swapped input of an owned row lies in an owned row.
//
// What bounds them on the card: the index steps move bytes only (tswap and
// xswap half the state, read and written once; perm and mono all of it), so
// HBM bandwidth (3.35 TB/s published); the mat steps arithmetic (fp32: the
// 67 TFLOP/s of the CUDA cores; "high": the tensor cores).
//
// The fp32 mat step.  The TPU kernel (_make_mat_step, form "karatsuba")
// computes three dots per step on a VMEM-resident (512, 256) tile.  At
// n = 24 a step is 6 x 2^16 x 256 x 256 flops in that form, 0.385 ms at
// 67 TFLOP/s, against 0.08 ms to move the state once: the CUDA cores bound
// it.  In place, a CTA may write a row only when every reader of the row
// is done with it, and every owner of few rows reads all 512 KB of tables
// again.  mat_halves_kernel:
//   * A cluster of four CTAs owns 64 rows; CTA rank c computes columns
//     [64 c, 64 c + 64) of them, so the tables are read once per 64 rows,
//     a 64-column share each.  All four read every k of the rows, and one
//     cluster barrier (barrier.cluster) stands between the last read and
//     the first write: the step stays in place with no second buffer.
//     The rows a cluster reads are its own (owned_row), through the
//     pending swap in pair mode.
//   * k-slices of 16 in a two-stage ring: each thread copies 16 bytes of
//     the rows and of each table with cp.async one slice ahead, the tables
//     straight into the stage, the rows transposed to k-major by the
//     thread that copied them; one CTA barrier per slice.
//   * Schoolbook, in prefetch_block.cu's FMA order: a thread owns 4 rows x
//     4 columns, 32 sums, four float4 loads for 64 FMAs a k.  77 registers
//     and 41 KB let three CTAs share an SM.  The flat and in-place steps
//     give the same values, bit for bit.
//   Karatsuba (three sums an output, 25% fewer FMAs) kept the 1e-6 bar
//   with margin but ran slower in every form tried on an H100: its
//   operands s, m2, m3 cost shared-memory loads that the FMAs saved do not
//   pay for (PERF.md section 6, PR 8).
// The "high" step (mat_high_halves_kernel) is mat_high.cu's kernel body,
// wgmma_high.cuh, so the two give the same values bit for bit: persistent
// groups of four CTAs, each CTA 64 columns of both components of a 128-row
// tile on bf16 wgmma with its column block of the tables resident in
// shared memory.  The launch is cooperative, and the group's warps count
// their reads of a tile on a counter in device memory, which each waits
// for before it writes.  A tile resident across a block's steps is later
// work.  The "default" step (mat_high_halves_kernel<false>: the hi.hi sums
// alone) runs wgmma_high.cuh's "default" k-loop on the same tables, bit
// for bit mat_high.cu's "default" step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma_high.cuh"

namespace {

constexpr int LANES = 128;
constexpr int DVIEW = 256;
constexpr int QUADS = DVIEW / 4;      // float4 per 256-wide row

// Row owned by slot s of owner c (a CTA, or a cluster of them), bm slots
// per owner.  pair_bit < 0: the rows c * bm + s.  pair_bit = b: slots
// [0, bm/2) are rows with bit b clear, slots [bm/2, bm) their partners
// r | 2^b, so the set is closed under flipping bit b.
__device__ __forceinline__ long long owned_row(long long c, int s, int bm,
                                               int pair_bit) {
  if (pair_bit < 0) return c * bm + s;
  const int half = bm >> 1;
  const long long low = c * half + (s & (half - 1));
  const long long r = ((low >> pair_bit) << (pair_bit + 1))
                      | (low & ((1LL << pair_bit) - 1));
  return r | ((long long)(s / half) << pair_bit);
}

// Where element (row r, column half hc) of the input is read from under a
// pending swap of the half with row bit pair_bit: (source row, source half).
__device__ __forceinline__ void pair_source(long long r, int hc, int pair_bit,
                                            long long& sr, int& sh) {
  sr = r;
  sh = hc;
  if (pair_bit >= 0) {
    const int hb = (int)(r >> pair_bit) & 1;
    if (hb != hc) {
      sr = r ^ (1LL << pair_bit);
      sh = hb;
    }
  }
}

// ------------------------------------------------------------- fp32 mat
constexpr int MAT_BM = 64;                     // rows a cluster owns
constexpr int MAT_BN = 64;                     // columns a CTA computes
constexpr int MAT_CLUSTER = DVIEW / MAT_BN;    // CTAs sharing the rows
constexpr int MAT_THREADS = 256;
constexpr int MAT_BK = 16;                     // k per slice
constexpr int MAT_SLICES = DVIEW / MAT_BK;
constexpr int MAT_XLD = MAT_BM + 4;            // k-major row stride (floats)
// a stage: x_re, x_im slices [k][MAT_XLD] | A, B slices [k][MAT_BN]
constexpr int MAT_STAGE_F = 2 * MAT_BK * MAT_XLD + 2 * MAT_BK * MAT_BN;
// two stages | the thread's 16 bytes of x_re and of x_im
constexpr size_t MAT_SMEM =
    (2 * MAT_STAGE_F + 2 * MAT_THREADS * 4) * sizeof(float);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows <- rows @ (A + iB), in place, A and B float32 [k][n].  A cluster of
// four CTAs owns 64 rows (owned_row); CTA rank c computes their columns
// [64 c, 64 c + 64).  See the header note.
__global__ void __cluster_dims__(MAT_CLUSTER, 1, 1)
__launch_bounds__(MAT_THREADS)
mat_halves_kernel(float* re0, float* re1, float* im0, float* im1,
                  const float* __restrict__ A, const float* __restrict__ B,
                  long long rows, int pair_bit) {
  extern __shared__ __align__(128) float smem[];
  float* raw = smem + 2 * MAT_STAGE_F;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;  // 16 x 16
  const long long cl = blockIdx.x / MAT_CLUSTER;              // the row set
  const int n0 = (int)(blockIdx.x % MAT_CLUSTER) * MAT_BN;
  // this thread's piece of every x slice: row slot lr, k quad lk (read
  // through the pending swap); of every table slice: k row ak, columns an
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const long long xrow = owned_row(cl, lr, MAT_BM, pair_bit);
  const bool xok = xrow < rows;
  const int ak = tid >> 4, an = (tid & 15) * 4;

  // slice q: x pieces into `raw`, A and B straight into stage q
  auto issue_slice = [&](int q) {
    if (q >= MAT_SLICES) return;
    const int k = q * MAT_BK + lk;
    long long sr = 0;
    int sh = 0;
    if (xok) pair_source(xrow, k >> 7, pair_bit, sr, sh);
    const long long o = sr * LANES + (k & (LANES - 1));
    async::cp16(raw + tid * 4, (sh ? re1 : re0) + o, xok);
    async::cp16(raw + (MAT_THREADS + tid) * 4, (sh ? im1 : im0) + o, xok);
    float* st = smem + (q & 1) * MAT_STAGE_F + 2 * MAT_BK * MAT_XLD;
    const long long t = (long long)(q * MAT_BK + ak) * DVIEW + n0 + an;
    async::cp16(st + ak * MAT_BN + an, A + t);
    async::cp16(st + (MAT_BK + ak) * MAT_BN + an, B + t);
  };
  // this thread's x pieces of slice q, transposed into stage q (k-major)
  auto form_slice = [&](int q) {
    float* xr = smem + (q & 1) * MAT_STAGE_F;
    float* xi = xr + MAT_BK * MAT_XLD;
    const float4 a = ld4(raw + tid * 4), b = ld4(raw + (MAT_THREADS + tid) * 4);
    xr[(lk + 0) * MAT_XLD + lr] = a.x; xr[(lk + 1) * MAT_XLD + lr] = a.y;
    xr[(lk + 2) * MAT_XLD + lr] = a.z; xr[(lk + 3) * MAT_XLD + lr] = a.w;
    xi[(lk + 0) * MAT_XLD + lr] = b.x; xi[(lk + 1) * MAT_XLD + lr] = b.y;
    xi[(lk + 2) * MAT_XLD + lr] = b.z; xi[(lk + 3) * MAT_XLD + lr] = b.w;
  };

  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;
  issue_slice(0);
  async::commit();
  async::wait_groups<0>();
  form_slice(0);
  __syncthreads();
  for (int q = 0; q < MAT_SLICES; ++q) {
    issue_slice(q + 1);
    async::commit();
    const float* xr = smem + (q & 1) * MAT_STAGE_F;
    const float* xi = xr + MAT_BK * MAT_XLD;
    const float* sa = xi + MAT_BK * MAT_XLD;
    const float* sb = sa + MAT_BK * MAT_BN;
#pragma unroll
    for (int kk = 0; kk < MAT_BK; ++kk) {
      const float4 r4 = ld4(xr + kk * MAT_XLD + ty * 4);
      const float4 i4 = ld4(xi + kk * MAT_XLD + ty * 4);
      const float4 a4 = ld4(sa + kk * MAT_BN + tx * 4);
      const float4 b4 = ld4(sb + kk * MAT_BN + tx * 4);
      const float r[4] = {r4.x, r4.y, r4.z, r4.w};
      const float m[4] = {i4.x, i4.y, i4.z, i4.w};
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {          // prefetch_block.cu's order
          acc_r[i][j] = fmaf(r[i], a[j], acc_r[i][j]);
          acc_r[i][j] = fmaf(-m[i], b[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(r[i], b[j], acc_i[i][j]);
          acc_i[i][j] = fmaf(m[i], a[j], acc_i[i][j]);
        }
    }
    async::wait_groups<0>();
    if (q + 1 < MAT_SLICES) form_slice(q + 1);
    __syncthreads();            // stage q + 1 formed; stage q read out
  }
  // every CTA of the cluster has read all of the rows: then write
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  float* ore = n0 >= LANES ? re1 : re0;
  float* oim = n0 >= LANES ? im1 : im0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = owned_row(cl, ty * 4 + i, MAT_BM, pair_bit);
    if (r >= rows) continue;
    const long long o = r * LANES + (n0 & (LANES - 1)) + tx * 4;
    *reinterpret_cast<float4*>(ore + o) =
        make_float4(acc_r[i][0], acc_r[i][1], acc_r[i][2], acc_r[i][3]);
    *reinterpret_cast<float4*>(oim + o) =
        make_float4(acc_i[i][0], acc_i[i][1], acc_i[i][2], acc_i[i][3]);
  }
}

// ----------------------------------------------------------- "high" mat
// The four halves; a group of four CTAs (the column blocks) owns each tile
// of 128 rows (owned_row), read through the pending swap in pair mode.
struct HalvesMap {
  float* re0;
  float* re1;
  float* im0;
  float* im1;
  long long rows;
  int pair_bit;

  __device__ long long row(long long rb, int s) const {
    return owned_row(rb, s, wgh::BM, pair_bit);
  }
  __device__ uint32_t code(long long r, int hf) const {
    long long sr;
    int sh;
    pair_source(r, hf, pair_bit, sr, sh);
    return (uint32_t)(2 * sr + sh);
  }
  __device__ const float* src(int comp, uint32_t code) const {
    const float* h = code & 1 ? (comp ? im1 : re1) : (comp ? im0 : re0);
    return h + (long long)(code >> 1) * LANES;
  }
  __device__ float* out(int comp, long long r, int col) const {
    float* h = col >= LANES ? (comp ? im1 : re1) : (comp ? im0 : re0);
    return h + r * LANES + (col & (LANES - 1));
  }
};

// The "high" mat step in place: mat_high.cu's kernel body
// (wgmma_high.cuh), launched cooperatively so that the four CTAs of a row
// block's group can wait for each other's reads through counters in
// device memory (sync) before writing.  (As clusters of four, which must
// each sit in one GPC, fewer of these one-an-SM CTAs run at once.)
// LO: the "high" rung; false: the "default" rung (wgmma_high.cuh).
template <bool LO>
__global__ void __launch_bounds__(wgh::THREADS, 1)
mat_high_halves_kernel(HalvesMap map, const uint8_t* __restrict__ w,
                       int* sync) {
  wgh::mat_step<LO>(map, w, sync);
}

template <bool LO>
cudaError_t launch_high(HalvesMap map, const void* w, int* sync,
                        int sync_groups, cudaStream_t stream) {
  static unsigned smem_set = 0;
  static int slots = 0;   // CTAs of the kernel that fit on the card at once
  cudaError_t e = async::allow_smem(mat_high_halves_kernel<LO>, wgh::SMEM,
                                    &smem_set);
  if (e == cudaSuccess && slots == 0)
    e = async::persistent_slots(mat_high_halves_kernel<LO>, wgh::THREADS,
                                wgh::SMEM, &slots);
  if (e != cudaSuccess) return e;
  // persistent: CTA groups of the four column blocks, one row block each
  // at a time, every CTA resident
  const long long blocks = (map.rows + wgh::BM - 1) / wgh::BM;
  long long groups = slots / wgh::COL_BLOCKS;
  if (groups > sync_groups) groups = sync_groups;
  if (groups > blocks) groups = blocks;
  void* args[] = {&map, &w, &sync};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mat_high_halves_kernel<LO>),
      dim3((unsigned)(groups * wgh::COL_BLOCKS)), dim3(wgh::THREADS), args,
      wgh::SMEM, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ------------------------------------------------------------ index steps
constexpr int THREADS = 256;

__device__ __forceinline__ long long insert_zero(long long x, int b) {
  return ((x >> b) << (b + 1)) | (x & ((1LL << b) - 1));
}

// h1[r] <-> h0[r | 2^b] for every row r with bit b clear: tswap k (b = k-1)
// and the cross-tile pair swap (b a tile-index bit).  blockIdx.y: re or im.
__global__ void __launch_bounds__(THREADS)
swap_rows_kernel(float4* re0, float4* re1, float4* im0, float4* im1,
                 long long quads, int b) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= quads) return;
  const long long r = insert_zero(idx >> 5, b);
  const int q = (int)(idx & 31);
  float4* up = (blockIdx.y ? im1 : re1) + r * 32 + q;
  float4* dn = (blockIdx.y ? im0 : re0) + (r | (1LL << b)) * 32 + q;
  const float4 vu = *up, vd = *dn;
  *up = vd;
  *dn = vu;
}

// tswap (row bit a) on an input read through the pending swap with row bit
// b > a: out(h, i, j) = in(j, h, i) over the half h and row bits i (a) and
// j (b).  One thread owns the eight float4 of its orbit.
__global__ void __launch_bounds__(THREADS)
tswap_pair_kernel(float4* re0, float4* re1, float4* im0, float4* im1,
                  long long quads, int a, int b) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= quads) return;
  const long long r = insert_zero(insert_zero(idx >> 5, a), b);
  const int q = (int)(idx & 31);
  float4* h0 = blockIdx.y ? im0 : re0;
  float4* h1 = blockIdx.y ? im1 : re1;
  float4 v[2][2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        v[h][i][j] = (h ? h1 : h0)[(r | ((long long)i << a) | ((long long)j << b)) * 32 + q];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        (h ? h1 : h0)[(r | ((long long)i << a) | ((long long)j << b)) * 32 + q] = v[j][h][i];
}

constexpr int RL_ROWS = 8;        // rows per CTA of the row-local steps

// perm v (columns with bits v and 7 exchanged) or mono (column gather by
// col_src, then the rotation by the cos row cs[0..255] and the sin row
// cs[256..511], products rounded separately as gather_step_kernel has
// them), in place, optionally on an input read through the pending swap.
__global__ void __launch_bounds__(THREADS)
row_local_kernel(float* re0, float* re1, float* im0, float* im1,
                 long long rows, int perm_v, const int* __restrict__ col_src,
                 const float* __restrict__ cs, int pair_bit) {
  __shared__ __align__(16) float sr_s[RL_ROWS][DVIEW];
  __shared__ __align__(16) float si_s[RL_ROWS][DVIEW];
  const int tid = threadIdx.x;
  for (int t = tid; t < RL_ROWS * QUADS; t += THREADS) {
    const int s = t >> 6, q = t & 63;
    const long long r = owned_row(blockIdx.x, s, RL_ROWS, pair_bit);
    float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
    if (r < rows) {
      long long sr;
      int sh;
      pair_source(r, q >> 5, pair_bit, sr, sh);
      const long long o = sr * LANES + (q & 31) * 4;
      vr = *reinterpret_cast<const float4*>((sh ? re1 : re0) + o);
      vi = *reinterpret_cast<const float4*>((sh ? im1 : im0) + o);
    }
    *reinterpret_cast<float4*>(&sr_s[s][q * 4]) = vr;
    *reinterpret_cast<float4*>(&si_s[s][q * 4]) = vi;
  }
  __syncthreads();
  for (int t = tid; t < RL_ROWS * QUADS; t += THREADS) {
    const int s = t >> 6, q = t & 63;
    const long long r = owned_row(blockIdx.x, s, RL_ROWS, pair_bit);
    if (r >= rows) continue;
    float vr[4], vi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = q * 4 + e;
      int src = c;
      if (perm_v >= 0) {
        const int d = ((c >> perm_v) ^ (c >> 7)) & 1;
        src = c ^ ((d << perm_v) | (d << 7));
      } else if (col_src != nullptr) {
        src = col_src[c];
      }
      float gr = sr_s[s][src], gi = si_s[s][src];
      if (cs != nullptr) {
        const float cc = cs[c], sn = cs[DVIEW + c];
        const float nr = __fmul_rn(gr, cc) - __fmul_rn(gi, sn);
        const float ni = __fmul_rn(gr, sn) + __fmul_rn(gi, cc);
        gr = nr;
        gi = ni;
      }
      vr[e] = gr;
      vi[e] = gi;
    }
    const long long o = r * LANES + (q & 31) * 4;
    *reinterpret_cast<float4*>((q >> 5 ? re1 : re0) + o) =
        make_float4(vr[0], vr[1], vr[2], vr[3]);
    *reinterpret_cast<float4*>((q >> 5 ? im1 : im0) + o) =
        make_float4(vi[0], vi[1], vi[2], vi[3]);
  }
}

inline unsigned ceil_div(long long a, long long b) {
  return (unsigned)((a + b - 1) / b);
}

}  // namespace

extern "C" {

// Every entry works on the four (rows, 128) halves in place.  pair_bit: the
// ROW bit (flat bit - 8) of a pending cross-tile swap that the launch reads
// its input through, or -1.

int qsim_split_mat_step(float* re0, float* re1, float* im0, float* im1,
                        const float* a, const float* b, long long rows,
                        int pair_bit, void* stream) {
  mat_halves_kernel<<<ceil_div(rows, MAT_BM) * MAT_CLUSTER, MAT_THREADS,
                      MAT_SMEM, static_cast<cudaStream_t>(stream)>>>(
      re0, re1, im0, im1, a, b, rows, pair_bit);
  return static_cast<int>(cudaGetLastError());
}

// w: the slot's tables as kernels/block.py split_tables lays them out;
// sync: 2 * sync_groups ints, zero (and left zero), for as many CTA groups;
// lo: 1 the "high" rung, 0 the "default" rung (the hi words alone).
int qsim_split_mat_step_high(float* re0, float* re1, float* im0, float* im1,
                             const void* w, long long rows, int pair_bit,
                             int* sync, int sync_groups, int lo,
                             void* stream) {
  if (rows < 1 || rows > (1LL << 30) / DVIEW || sync_groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  HalvesMap map{re0, re1, im0, im1, rows, pair_bit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      lo ? launch_high<true>(map, w, sync, sync_groups, s)
         : launch_high<false>(map, w, sync, sync_groups, s));
}

// h1[r] <-> h0[r | 2^bit] over the rows with that bit clear (tswap, xswap).
int qsim_split_swap_rows(float* re0, float* re1, float* im0, float* im1,
                         long long rows, int bit, void* stream) {
  if (bit < 0 || (2LL << bit) > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = rows / 2 * 32;
  dim3 grid(ceil_div(quads, THREADS), 2);
  swap_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(re0), reinterpret_cast<float4*>(re1),
      reinterpret_cast<float4*>(im0), reinterpret_cast<float4*>(im1), quads,
      bit);
  return static_cast<int>(cudaGetLastError());
}

// tswap on row bit `bit` read through the pending swap with row bit pair_bit.
int qsim_split_tswap_pair(float* re0, float* re1, float* im0, float* im1,
                          long long rows, int bit, int pair_bit, void* stream) {
  if (bit < 0 || pair_bit <= bit || (2LL << pair_bit) > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = rows / 4 * 32;
  dim3 grid(ceil_div(quads, THREADS), 2);
  tswap_pair_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(re0), reinterpret_cast<float4*>(re1),
      reinterpret_cast<float4*>(im0), reinterpret_cast<float4*>(im1), quads,
      bit, pair_bit);
  return static_cast<int>(cudaGetLastError());
}

// perm (perm_v >= 0) or mono (col_src: 256 ints; cs: 512 floats, cos row
// then sin row) inside every row.
int qsim_split_row_step(float* re0, float* re1, float* im0, float* im1,
                        long long rows, int perm_v, const int* col_src,
                        const float* cs, int pair_bit, void* stream) {
  if (perm_v >= 7 || (pair_bit >= 0 && (2LL << pair_bit) > rows))
    return static_cast<int>(cudaErrorInvalidValue);
  row_local_kernel<<<ceil_div(rows, RL_ROWS), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      re0, re1, im0, im1, rows, perm_v, col_src, cs, pair_bit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
