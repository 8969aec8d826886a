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
//   mat      a row of 256 columns is one matrix-vector product: a CTA owns
//            whole rows (all four halves of them), stages them, then writes.
//            fp32 FMA in the order of prefetch_block.cu ("highest"), or the
//            3-pass bf16 mma.sync arithmetic of mma_high.cuh ("high"): both
//            give the flat kernels' results bit for bit.
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
// HBM bandwidth (3.35 TB/s published); the mat steps as their flat twins
// (fp32: 67 TFLOP/s CUDA cores; "high": tensor cores), with the whole-row
// rule costing the fp32 step a 64 KB row stage per CTA.  wgmma, TMA and a
// tile resident across steps are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_high.cuh"

namespace {

constexpr int LANES = 128;
constexpr int DVIEW = 256;
constexpr int QUADS = DVIEW / 4;      // float4 per 256-wide row

// Row owned by slot s of CTA c, bm slots per CTA.  pair_bit < 0: the rows
// c * bm + s.  pair_bit = b: slots [0, bm/2) are rows with bit b clear,
// slots [bm/2, bm) their partners r | 2^b, so the set is closed under
// flipping bit b.
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
constexpr int MAT_BM = 32;        // rows per CTA
constexpr int MAT_BK = 16;        // table rows staged per slice
constexpr int MAT_THREADS = 256;
constexpr int MAT_SMEM = (2 * MAT_BM + 2 * MAT_BK) * DVIEW * 4;   // 96 KB

// rows <- rows @ (A + iB) for the CTA's rows, in place.  Thread (tx, ty)
// computes rows ty*4..+3 at columns tx*4..+3 of each half; sums run over k
// ascending with the FMA order of mat_step_kernel (prefetch_block.cu).
__global__ void __launch_bounds__(MAT_THREADS)
mat_halves_kernel(float* re0, float* re1, float* im0, float* im1,
                  const float* __restrict__ A, const float* __restrict__ B,
                  long long rows, int pair_bit) {
  extern __shared__ __align__(16) float smem[];
  float (*xr)[DVIEW] = reinterpret_cast<float (*)[DVIEW]>(smem);
  float (*xi)[DVIEW] = xr + MAT_BM;
  float (*a_s)[DVIEW] = xi + MAT_BM;
  float (*b_s)[DVIEW] = a_s + MAT_BK;

  const int tid = threadIdx.x;
  for (int t = tid; t < MAT_BM * QUADS; t += MAT_THREADS) {
    const int s = t >> 6, q = t & 63;
    const long long r = owned_row(blockIdx.x, s, MAT_BM, pair_bit);
    float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vi = vr;
    if (r < rows) {
      long long sr;
      int sh;
      pair_source(r, q >> 5, pair_bit, sr, sh);
      const long long o = sr * LANES + (q & 31) * 4;
      vr = *reinterpret_cast<const float4*>((sh ? re1 : re0) + o);
      vi = *reinterpret_cast<const float4*>((sh ? im1 : im0) + o);
    }
    *reinterpret_cast<float4*>(&xr[s][q * 4]) = vr;
    *reinterpret_cast<float4*>(&xi[s][q * 4]) = vi;
  }

  const int tx = tid & 31, ty = tid >> 5;
  float acc_r[4][8], acc_i[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  for (int k0 = 0; k0 < DVIEW; k0 += MAT_BK) {
    for (int t = tid; t < MAT_BK * QUADS; t += MAT_THREADS) {
      const int kk = t >> 6, q = t & 63;
      const long long o = (long long)(k0 + kk) * DVIEW + q * 4;
      *reinterpret_cast<float4*>(&a_s[kk][q * 4]) =
          *reinterpret_cast<const float4*>(A + o);
      *reinterpret_cast<float4*>(&b_s[kk][q * 4]) =
          *reinterpret_cast<const float4*>(B + o);
    }
    __syncthreads();   // also orders the row stage above before its first use

#pragma unroll
    for (int kq = 0; kq < MAT_BK; kq += 4) {
      float xrv[4][4], xiv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 r4 = *reinterpret_cast<const float4*>(&xr[ty * 4 + i][k0 + kq]);
        const float4 i4 = *reinterpret_cast<const float4*>(&xi[ty * 4 + i][k0 + kq]);
        xrv[i][0] = r4.x; xrv[i][1] = r4.y; xrv[i][2] = r4.z; xrv[i][3] = r4.w;
        xiv[i][0] = i4.x; xiv[i][1] = i4.y; xiv[i][2] = i4.z; xiv[i][3] = i4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 al = *reinterpret_cast<const float4*>(&a_s[kq + e][tx * 4]);
        const float4 ah = *reinterpret_cast<const float4*>(&a_s[kq + e][LANES + tx * 4]);
        const float4 bl = *reinterpret_cast<const float4*>(&b_s[kq + e][tx * 4]);
        const float4 bh = *reinterpret_cast<const float4*>(&b_s[kq + e][LANES + tx * 4]);
        const float a[8] = {al.x, al.y, al.z, al.w, ah.x, ah.y, ah.z, ah.w};
        const float b[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc_r[i][j] = fmaf(xrv[i][e], a[j], acc_r[i][j]);
            acc_r[i][j] = fmaf(-xiv[i][e], b[j], acc_r[i][j]);
            acc_i[i][j] = fmaf(xrv[i][e], b[j], acc_i[i][j]);
            acc_i[i][j] = fmaf(xiv[i][e], a[j], acc_i[i][j]);
          }
      }
    }
    __syncthreads();
  }

  // every read of the state went into xr/xi before the first barrier
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = owned_row(blockIdx.x, ty * 4 + i, MAT_BM, pair_bit);
    if (r >= rows) continue;
    const long long o = r * LANES + tx * 4;
    *reinterpret_cast<float4*>(re0 + o) =
        make_float4(acc_r[i][0], acc_r[i][1], acc_r[i][2], acc_r[i][3]);
    *reinterpret_cast<float4*>(re1 + o) =
        make_float4(acc_r[i][4], acc_r[i][5], acc_r[i][6], acc_r[i][7]);
    *reinterpret_cast<float4*>(im0 + o) =
        make_float4(acc_i[i][0], acc_i[i][1], acc_i[i][2], acc_i[i][3]);
    *reinterpret_cast<float4*>(im1 + o) =
        make_float4(acc_i[i][4], acc_i[i][5], acc_i[i][6], acc_i[i][7]);
  }
}

// ----------------------------------------------------------- "high" mat
constexpr int HALF = 128;
constexpr int WARPS_N = 8;                 // 8 x 32 = all 256 output columns
constexpr int WM = 32, WN = 32;            // warp tile, as mat_high.cu
constexpr int HIGH_THREADS = 32 * WARPS_N;
constexpr int MT = WM / 16, NT = WN / 8;

// The "high" mat step in place: mat_high_kernel's warp tile and arithmetic
// (mat_high.cu, mma_high.cuh), with eight warps side by side covering 32
// whole rows and one CTA barrier between the last read and the first write.  (Sixteen
// warps on 64 rows halve the table traffic from L2 but are capped at 128
// registers and spill; on an H100 at n = 24 they were no faster.)
__global__ void __launch_bounds__(HIGH_THREADS)
mat_high_halves_kernel(float* re0, float* re1, float* im0, float* im1,
                       const uint32_t* __restrict__ w, long long rows,
                       int pair_bit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = warp * WN;

  high::Acc<MT, NT> acc;
  acc.zero();

  // this thread's A-fragment rows: slots 16 mt + g + 8 h
  long long frow[MT][2];
  bool valid[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      frow[mt][h] = owned_row(blockIdx.x, mt * 16 + g + 8 * h, WM, pair_bit);
      valid[mt][h] = frow[mt][h] < rows;
    }

  for (int half = 0; half < 2; ++half) {     // column half of the k index
    const float* pr[MT][2];
    const float* pi[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        long long sr;
        int sh;
        pair_source(frow[mt][h], half, pair_bit, sr, sh);
        pr[mt][h] = (sh ? re1 : re0) + sr * LANES;
        pi[mt][h] = (sh ? im1 : im0) + sr * LANES;
      }

#pragma unroll 2
    for (int kk = 0; kk < HALF; kk += 16) {
      uint32_t xrh[MT][4], xrl[MT][4], xih[MT][4], xil[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q & 1;
          float2 vr = make_float2(0.f, 0.f), vi = vr;
          if (valid[mt][h]) {
            const int o = kk + 2 * t + (q >> 1) * 8;
            vr = *reinterpret_cast<const float2*>(pr[mt][h] + o);
            vi = *reinterpret_cast<const float2*>(pi[mt][h] + o);
          }
          high::split2(vr.x, vr.y, xrh[mt][q], xrl[mt][q]);
          high::split2(vi.x, vi.y, xih[mt][q], xil[mt][q]);
        }
      high::chunk(acc, xrh, xrl, xih, xil, w, col0 + g,
                  (half * HALF + kk) / 2 + t);
    }
  }

  // the CTA's rows are read by all of its warps: none writes before all
  // have their sums
  __syncthreads();
  float* out_re = col0 >= HALF ? re1 : re0;
  float* out_im = col0 >= HALF ? im1 : im0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[mt][h]) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const long long o = frow[mt][h] * LANES + (col0 & (HALF - 1)) + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out_re + o) =
            make_float2(acc.r[mt][nt][2 * h], acc.r[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(out_im + o) =
            make_float2(acc.i[mt][nt][2 * h], acc.i[mt][nt][2 * h + 1]);
      }
    }
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
  cudaError_t rc = cudaFuncSetAttribute(
      mat_halves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAT_SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  mat_halves_kernel<<<ceil_div(rows, MAT_BM), MAT_THREADS, MAT_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      re0, re1, im0, im1, a, b, rows, pair_bit);
  return static_cast<int>(cudaGetLastError());
}

// w16: the slot's [A_hi, A_lo, B_hi, B_lo] bf16 tables (kernels/block.py
// split_tables).
int qsim_split_mat_step_high(float* re0, float* re1, float* im0, float* im1,
                             const void* w16, long long rows, int pair_bit,
                             void* stream) {
  mat_high_halves_kernel<<<ceil_div(rows, WM), HIGH_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      re0, re1, im0, im1, static_cast<const uint32_t*>(w16), rows, pair_bit);
  return static_cast<int>(cudaGetLastError());
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
