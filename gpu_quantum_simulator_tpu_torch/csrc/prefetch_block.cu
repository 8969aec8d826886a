// Block kernel of the prefetch engine, for Hopper (sm_90a).
//
// Replaces: gpu_quantum_simulator_tpu/engine/prefetch.py get_block_kernel
// (plain form kernel_full and steered form kernel), whose step interpreter
// is _steps_loop, and get_stream_block_kernel, its streamed twin with the
// folded-relayout input (mode 5).  On the TPU one pallas_call ran a
// block's whole step list (<= 48 steps) on each (512, 256) tile held in
// VMEM.  That tile is 1 MB of
// re/im f32, more than one SM's 227 KB of shared memory, so here a block
// runs as ONE LAUNCH PER STEP, each a whole-state pass from one buffer pair
// into the other (the host walks the step list; see kernels/block.py).
// The tile size T still shapes the plan: it only enters the index math
// below (tswap reach, the steered prologue's tile bit).
//
// The state is (R2, 256) f32 re/im, flat index f = row * 256 + col.  Every
// step except mat is an index map on f:
//   tswap k : exchange flat bits 7 and 7 + k      (column bit 7 <-> row bit k-1)
//   perm v  : exchange flat bits v and 7          (_window_swap_index(v))
//   mono    : column gather by mono_src, then the phase rotation by the
//             cos/sin rows 0/1 of the slot's b-table
//   steered prologue (scal[1] == 1): exchange flat bits 7 and p, p the
//             cross-tile position, applied to the block's INPUT (map_half)
//   folded relayout (scal[1] == 5): row r of the INPUT is read from row
//             fold_row(r) (rowmap.cuh; the stream kernel's in_folded)
// so they share one gather kernel.  Both input maps apply to a block's
// first launch only, whichever step it runs; later launches read the
// ping-pong buffer plainly.  On the TPU the stream kernel's 4-deep DMA
// window overlapped HBM copies with VMEM compute; here the first launch
// reads through the map directly, so a folded relayout costs no state pass
// of its own (sigma's loop runs once per row a thread reads, unrolled over
// the parameter struct; rowmap.cuh).  mat is out = X @ (A + iB) with
// A = M_re^T, B = M_im^T (256 x 256): four real products, fp32 FMA on the
// CUDA cores, IEEE fp32 throughout (no TF32), the "highest" rung.
//
// What bounds it on the card: at n = 22 a mat step is 2 * 2^14 * 256 * 256
// * 4 = 8.6 GFLOP against 64 MB of state moved, ~134 FLOP/B, so it is bound
// by fp32 CUDA-core throughput (67 TFLOP/s published at 700 W).  Every
// other step is a pure gather, bound by memory bandwidth (2 x 2 x state
// bytes per pass).
//
// The mat step's design.  Each output keeps ONE fp32 sum, k ascending,
// with the four fmaf of a k in a fixed order (re: +xr.A, -xi.B; im: +xr.B,
// +xi.A), so the flat step and the in-place one (split_block.cu, which
// shares this micro-kernel's order) agree bit for bit.  A 256-thread CTA
// owns a 64 x 64 output tile, a thread 4 x 4 complex outputs; three CTAs
// (68 KB of shared memory, at most 85 registers a thread) share an SM.
// Around that:
//   * k-slices of 16 in a three-stage ring: every thread copies a 16-byte
//     piece of the x rows (through the input map) and of both tables with
//     cp.async two slices ahead; the tables land where they are read, the
//     rows land row-major and are transposed to k-major one slice ahead, a
//     warp reading 32 consecutive rows' same k quad (landing rows padded to
//     20 floats) and writing 32 consecutive floats, both without bank
//     conflicts; one CTA barrier a slice;
//   * the four operand loads of k + 1 are issued before k's 64 FMAs.
// On an H100, 8 x 8 outputs a thread (128 x 128 tiles, eight loads for
// 256 FMAs) ran no faster than this form and other tilings slower (PERF.md
// section 6): the sum order above pins the FMA count, and the fp32 pipe,
// not the shared-memory loads, sets the pace.  wgmma/3xTF32, TMA and
// keeping a tile resident across steps are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "rowmap.cuh"

namespace {

constexpr int DVIEW = 256;
constexpr int THREADS = 256;

__device__ __forceinline__ long long swap_bits(long long x, int a, int b) {
  long long d = ((x >> a) ^ (x >> b)) & 1LL;
  return x ^ ((d << a) | (d << b));
}

// ------------------------------------------------------------ fp32 mat
constexpr int BM = 64;                 // output rows per CTA
constexpr int BN = 64;                 // output columns per CTA
constexpr int BK = 16;                 // k per slice
constexpr int SLICES = DVIEW / BK;
constexpr int STAGES = 3;              // the slice ring
constexpr int RAW_LD = BK + 4;         // landing row stride (floats): the
                                       // transposing reads are conflict-free
constexpr int XS = BK * BM;            // one x component's slice, k-major
constexpr int TS = BK * BN;            // one table's slice, [k][n]
constexpr int RAW = BM * RAW_LD;       // one x component's slice as landed
// a stage: x_re, x_im k-major | A, B; then two landing slots of x_re, x_im
// rows (slice q lands in slot q % 2: it is transposed one slice before
// slice q + 2 lands)
constexpr int STAGE = 2 * XS + 2 * TS;
constexpr size_t MAT_SMEM =
    (size_t)(STAGES * STAGE + 2 * 2 * RAW) * sizeof(float);
static_assert(BM * BK / 4 == THREADS && BK * BN / 4 == THREADS,
              "one 16-byte piece of each slice a thread");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// out = map(in) @ (A + iB) on an (rows, 256) state; steer_row >= 0 reads
// the input with column bit 7 exchanged with row bit steer_row, fold.m > 0
// reads row r from row fold_row(r).  See the header note.
__global__ void __launch_bounds__(THREADS, 3)
mat_step_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                float* __restrict__ out_re, float* __restrict__ out_im,
                const float* __restrict__ A, const float* __restrict__ B,
                long long rows, int steer_row, Fold fold) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;             // 16 x 16 threads
  // the DVIEW / BN column tiles of a row block are neighbouring CTAs, so
  // the block's rows are read from device memory once and then hit in L2
  const long long row0 = (long long)(blockIdx.x / (DVIEW / BN)) * BM;
  const int col0 = (blockIdx.x % (DVIEW / BN)) * BN;

  // copy roles: row lr of the tile, k quad lk of the slice (read through
  // the input map); table row ak, columns an
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const int ak = tid >> 4, an = (tid & 15) * 4;
  const long long r = row0 + lr;
  const bool xok = r < rows;
  const long long fr = fold.m > 0 && xok ? fold_row(r, fold) : r;
  // transposing role: row tr of the tile, k quad tq (a warp: 32 rows)
  const int tr = tid % BM, tq = tid / BM;

  auto stage = [&](int q) { return smem + (q % STAGES) * STAGE; };
  auto landing = [&](int q) {
    return smem + STAGES * STAGE + (q & 1) * 2 * RAW;
  };
  // slice q: the x rows into the landing buffer, A and B into the stage
  auto issue = [&](int q) {
    if (q >= SLICES) return;
    float* st = stage(q);
    long long sr = fr;
    int sk = q * BK + lk;
    if (steer_row >= 0 && (((sk >> 7) ^ (int)(r >> steer_row)) & 1)) {
      sr = r ^ (1LL << steer_row);
      sk ^= 128;
    }
    const long long o = xok ? sr * DVIEW + sk : 0;
    float* raw = landing(q) + lr * RAW_LD + lk;
    async::cp16(raw, in_re + o, xok);
    async::cp16(raw + RAW, in_im + o, xok);
    const long long t = (long long)(q * BK + ak) * DVIEW + col0 + an;
    async::cp16(st + 2 * XS + ak * BN + an, A + t);
    async::cp16(st + 2 * XS + TS + ak * BN + an, B + t);
  };
  // slice q's landed rows, k-major: a warp reads 32 consecutive rows' same
  // k quad and writes 32 consecutive floats of each k
  auto transpose = [&](int q) {
    float* x = stage(q) + tq * 4 * BM + tr;
    const float* raw = landing(q) + tr * RAW_LD + tq * 4;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 v = ld4(raw + c * RAW);
      x[c * XS] = v.x;
      x[c * XS + BM] = v.y;
      x[c * XS + 2 * BM] = v.z;
      x[c * XS + 3 * BM] = v.w;
    }
  };

  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  issue(0);
  async::commit();
  issue(1);
  async::commit();
  async::wait_groups<1>();
  __syncthreads();                       // slice 0 landed
  transpose(0);
  for (int q = 0; q < SLICES; ++q) {
    async::wait_groups<0>();
    __syncthreads();   // slice q + 1 landed, slice q formed, slice q - 1 read
    if (q + 1 < SLICES) transpose(q + 1);
    issue(q + 2);
    async::commit();
    const float* xr = stage(q);
    const float* sa = xr + 2 * XS;
    // the operands of k + 1 are read while k's FMAs run
    float4 fr4[2], fi4[2], fa4[2], fb4[2];
    auto frag = [&](int kk, int u) {
      fr4[u] = ld4(xr + kk * BM + ty * 4);
      fi4[u] = ld4(xr + XS + kk * BM + ty * 4);
      fa4[u] = ld4(sa + kk * BN + tx * 4);
      fb4[u] = ld4(sa + TS + kk * BN + tx * 4);
    };
    frag(0, 0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const int u = kk & 1;
      if (kk + 1 < BK) frag(kk + 1, u ^ 1);
      const float x_r[4] = {fr4[u].x, fr4[u].y, fr4[u].z, fr4[u].w};
      const float x_i[4] = {fi4[u].x, fi4[u].y, fi4[u].z, fi4[u].w};
      const float a[4] = {fa4[u].x, fa4[u].y, fa4[u].z, fa4[u].w};
      const float b[4] = {fb4[u].x, fb4[u].y, fb4[u].z, fb4[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {   // one sum an output, k ascending
          acc_r[i][j] = fmaf(x_r[i], a[j], acc_r[i][j]);
          acc_r[i][j] = fmaf(-x_i[i], b[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(x_r[i], b[j], acc_i[i][j]);
          acc_i[i][j] = fmaf(x_i[i], a[j], acc_i[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long orow = row0 + ty * 4 + i;
    if (orow >= rows) continue;
    const long long o = orow * DVIEW + col0 + tx * 4;
    *reinterpret_cast<float4*>(out_re + o) =
        make_float4(acc_r[i][0], acc_r[i][1], acc_r[i][2], acc_r[i][3]);
    *reinterpret_cast<float4*>(out_im + o) =
        make_float4(acc_i[i][0], acc_i[i][1], acc_i[i][2], acc_i[i][3]);
  }
}

// out[f] = phase(f) * in[map(g(f))] for the index-map steps, map the
// steered or folded input map (or none); four consecutive outputs per
// thread, stored as one float4 per component.
__global__ void __launch_bounds__(THREADS)
gather_step_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                   float* __restrict__ out_re, float* __restrict__ out_im,
                   long long total, int swap_a, int swap_b, int steer,
                   const int* __restrict__ col_src, const float* __restrict__ cs,
                   Fold fold) {
  const long long base = ((long long)blockIdx.x * THREADS + threadIdx.x) * 4;
  if (base >= total) return;
  float vr[4], vi[4];
  // the folded source row of the last row seen: a thread's four elements
  // share their row in every step kind, so sigma's loop runs once
  long long fold_in = -1, fold_out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long f = base + e;
    long long s = f;
    if (swap_a >= 0) s = swap_bits(s, swap_a, swap_b);
    if (col_src != nullptr) s = (s & ~255LL) | col_src[f & 255];
    if (steer >= 0) s = swap_bits(s, 7, steer);
    if (fold.m > 0) {
      if ((s >> 8) != fold_in) {
        fold_in = s >> 8;
        fold_out = fold_row(fold_in, fold);
      }
      s = (fold_out << 8) | (s & 255);
    }
    float gr = in_re[s], gi = in_im[s];
    if (cs != nullptr) {
      const float c = cs[f & 255], sn = cs[DVIEW + (f & 255)];
      // separately rounded products, as the plain version computes them
      const float re = __fmul_rn(gr, c) - __fmul_rn(gi, sn);
      const float im = __fmul_rn(gr, sn) + __fmul_rn(gi, c);
      gr = re;
      gi = im;
    }
    vr[e] = gr;
    vi[e] = gi;
  }
  *reinterpret_cast<float4*>(out_re + base) = make_float4(vr[0], vr[1], vr[2], vr[3]);
  *reinterpret_cast<float4*>(out_im + base) = make_float4(vi[0], vi[1], vi[2], vi[3]);
}

}  // namespace

extern "C" {

const char* qsim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One mat step on an (rows, 256) state pair; steer_bit is the flat bit
// (>= 8) exchanged with bit 7 on input, or -1; sigma/m/tr the folded
// relayout on input (m = 0: none).
int qsim_mat_step(const float* in_re, const float* in_im, float* out_re,
                  float* out_im, const float* a, const float* b,
                  long long rows, int steer_bit, const int* sigma, int m,
                  int tr, void* stream) {
  Fold fold;
  if (!make_fold(&fold, sigma, m, tr) || (m > 0 && steer_bit >= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned attr = 0;
  const cudaError_t e = async::allow_smem(mat_step_kernel, MAT_SMEM, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = (unsigned)((rows + BM - 1) / BM) * (DVIEW / BN);
  mat_step_kernel<<<grid, THREADS, MAT_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, a, b, rows,
      steer_bit >= 0 ? steer_bit - 8 : -1, fold);
  return static_cast<int>(cudaGetLastError());
}

// One index-map step over `total` = rows * 256 elements.  swap_a/swap_b:
// flat bits to exchange (-1: none); col_src: 256-entry column gather (or
// null); cs: 512 floats, cos row then sin row (or null); steer: flat bit
// exchanged with bit 7 on input (-1: none); sigma/m/tr: the folded
// relayout on input (m = 0: none).
int qsim_gather_step(const float* in_re, const float* in_im, float* out_re,
                     float* out_im, long long total, int swap_a, int swap_b,
                     int steer, const int* col_src, const float* cs,
                     const int* sigma, int m, int tr, void* stream) {
  Fold fold;
  if (!make_fold(&fold, sigma, m, tr) || (m > 0 && steer >= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = total / 4;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  gather_step_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, total, swap_a, swap_b, steer, col_src, cs,
      fold);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
