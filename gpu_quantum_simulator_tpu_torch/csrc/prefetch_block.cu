// Block kernel of the prefetch engine, for Hopper (sm_90a).
//
// Replaces: gpu_quantum_simulator_tpu/engine/prefetch.py get_block_kernel
// (plain form kernel_full and steered form kernel), whose step interpreter
// is _steps_loop.  On the TPU one pallas_call ran a block's whole step list
// (<= 48 steps) on each (512, 256) tile held in VMEM.  That tile is 1 MB of
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
// so they share one gather kernel.  mat is out = X @ (A + iB) with
// A = M_re^T, B = M_im^T (256 x 256): four real products, fp32 FMA on the
// CUDA cores, IEEE fp32 throughout (no TF32), the "highest" rung.
//
// What bounds it on the card: at n = 22 a mat step is 2 * 2^14 * 256 * 256
// * 4 = 8.6 GFLOP against 64 MB of state moved, ~134 FLOP/B, so it is bound
// by fp32 CUDA-core throughput (67 TFLOP/s published at 700 W).  The design
// keeps the operands in registers: a 64 x 64 output tile per 256-thread
// CTA, 4 x 4 complex outputs per thread, K staged 16 at a time in shared
// memory (16 FMA per operand load).  Every other step is a pure
// gather, bound by memory bandwidth (2 x 2 x state bytes per pass).
// wgmma/3xTF32, TMA and keeping a tile resident across steps are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DVIEW = 256;
constexpr int BM = 64;        // output rows per CTA
constexpr int BN = 64;        // output columns per CTA
constexpr int BK = 16;        // contraction slice staged in shared memory
constexpr int THREADS = 256;

__device__ __forceinline__ long long swap_bits(long long x, int a, int b) {
  long long d = ((x >> a) ^ (x >> b)) & 1LL;
  return x ^ ((d << a) | (d << b));
}

// out = steer(in) @ (A + iB) on an (rows, 256) state; steer_row >= 0 reads
// the input with column bit 7 exchanged with row bit steer_row.
__global__ void __launch_bounds__(THREADS)
mat_step_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                float* __restrict__ out_re, float* __restrict__ out_im,
                const float* __restrict__ A, const float* __restrict__ B,
                long long rows, int steer_row) {
  __shared__ __align__(16) float xr_s[BK][BM + 4];   // X slice, k-major
  __shared__ __align__(16) float xi_s[BK][BM + 4];
  __shared__ __align__(16) float a_s[BK][BN];
  __shared__ __align__(16) float b_s[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;             // 16 x 16 threads
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  // loader roles: X slice = 64 rows x 16 k, one float4 per thread;
  // table slice = 16 k x 64 cols, one float4 per thread
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const int ak = tid >> 4, an = (tid & 15) * 4;
  const long long r = row0 + lr;

  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  for (int k0 = 0; k0 < DVIEW; k0 += BK) {
    float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
    if (r < rows) {
      long long sr = r;
      int sk = k0 + lk;
      if (steer_row >= 0 && (((sk >> 7) ^ (int)(r >> steer_row)) & 1)) {
        sr = r ^ (1LL << steer_row);
        sk ^= 128;
      }
      vr = *reinterpret_cast<const float4*>(in_re + sr * DVIEW + sk);
      vi = *reinterpret_cast<const float4*>(in_im + sr * DVIEW + sk);
    }
    xr_s[lk + 0][lr] = vr.x; xr_s[lk + 1][lr] = vr.y;
    xr_s[lk + 2][lr] = vr.z; xr_s[lk + 3][lr] = vr.w;
    xi_s[lk + 0][lr] = vi.x; xi_s[lk + 1][lr] = vi.y;
    xi_s[lk + 2][lr] = vi.z; xi_s[lk + 3][lr] = vi.w;
    *reinterpret_cast<float4*>(&a_s[ak][an]) =
        *reinterpret_cast<const float4*>(A + (long long)(k0 + ak) * DVIEW + col0 + an);
    *reinterpret_cast<float4*>(&b_s[ak][an]) =
        *reinterpret_cast<const float4*>(B + (long long)(k0 + ak) * DVIEW + col0 + an);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 xr4 = *reinterpret_cast<const float4*>(&xr_s[kk][ty * 4]);
      const float4 xi4 = *reinterpret_cast<const float4*>(&xi_s[kk][ty * 4]);
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[kk][tx * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float xr[4] = {xr4.x, xr4.y, xr4.z, xr4.w};
      const float xi[4] = {xi4.x, xi4.y, xi4.z, xi4.w};
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_r[i][j] = fmaf(xr[i], a[j], acc_r[i][j]);
          acc_r[i][j] = fmaf(-xi[i], b[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(xr[i], b[j], acc_i[i][j]);
          acc_i[i][j] = fmaf(xi[i], a[j], acc_i[i][j]);
        }
    }
    __syncthreads();
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

// out[f] = phase(f) * in[steer(g(f))] for the index-map steps; four
// consecutive outputs per thread, stored as one float4 per component.
__global__ void __launch_bounds__(THREADS)
gather_step_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                   float* __restrict__ out_re, float* __restrict__ out_im,
                   long long total, int swap_a, int swap_b, int steer,
                   const int* __restrict__ col_src, const float* __restrict__ cs) {
  const long long base = ((long long)blockIdx.x * THREADS + threadIdx.x) * 4;
  if (base >= total) return;
  float vr[4], vi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long f = base + e;
    long long s = f;
    if (swap_a >= 0) s = swap_bits(s, swap_a, swap_b);
    if (col_src != nullptr) s = (s & ~255LL) | col_src[f & 255];
    if (steer >= 0) s = swap_bits(s, 7, steer);
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
// (>= 8) exchanged with bit 7 on input, or -1.
int qsim_mat_step(const float* in_re, const float* in_im, float* out_re,
                  float* out_im, const float* a, const float* b,
                  long long rows, int steer_bit, void* stream) {
  dim3 grid((unsigned)((rows + BM - 1) / BM), DVIEW / BN);
  mat_step_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, a, b, rows,
      steer_bit >= 0 ? steer_bit - 8 : -1);
  return static_cast<int>(cudaGetLastError());
}

// One index-map step over `total` = rows * 256 elements.  swap_a/swap_b:
// flat bits to exchange (-1: none); col_src: 256-entry column gather (or
// null); cs: 512 floats, cos row then sin row (or null); steer: flat bit
// exchanged with bit 7 on input (-1: none).
int qsim_gather_step(const float* in_re, const float* in_im, float* out_re,
                     float* out_im, long long total, int swap_a, int swap_b,
                     int steer, const int* col_src, const float* cs,
                     void* stream) {
  const long long threads = total / 4;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  gather_step_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, out_re, out_im, total, swap_a, swap_b, steer, col_src, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
