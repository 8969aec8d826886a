// Relayout kernel of the prefetch engine, for Hopper (sm_90a).
//
// Replaces: gpu_quantum_simulator_tpu/engine/prefetch.py get_relayout_kernel,
// a single-program pallas_call that kept a window of 16 HBM->HBM DMAs in
// flight.  It permutes the row-block bits of the (R2, 256) f32 re/im state
// in one pass: output row block i (Tr rows) is input row block src(i),
// where bit a of src(i) is bit sigma(a) of i, sigma over the exposed
// row-block bits (at most 24, passed by value as a kernel argument).
//
// What bounds it on the card: it is a pure copy, 2 x 2 x state bytes per
// pass (read + write, re + im; 64 MB at n = 22), so HBM bandwidth (3.35
// TB/s published) is the only limit.  The design gives each (block,
// component) pair one CTA that computes src(i) once and streams the
// contiguous Tr x 256 block with 16-byte vector loads and stores, so every
// warp moves 512 contiguous bytes per instruction and no index math runs
// per element.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SLOTS = 24;
constexpr int THREADS = 256;

struct Sigma {
  int s[MAX_SLOTS];
};

__global__ void __launch_bounds__(THREADS)
relayout_kernel(const float4* __restrict__ in_re, const float4* __restrict__ in_im,
                float4* __restrict__ out_re, float4* __restrict__ out_im,
                int block4, Sigma sigma, int m) {
  const long long i = blockIdx.x;
  long long j = 0;
  for (int a = 0; a < m; ++a) j |= ((i >> sigma.s[a]) & 1LL) << a;
  const float4* src = (blockIdx.y ? in_im : in_re) + j * block4;
  float4* dst = (blockIdx.y ? out_im : out_re) + i * block4;
  for (int t = threadIdx.x; t < block4; t += THREADS) dst[t] = src[t];
}

}  // namespace

extern "C" {

// nblk row blocks of tr rows each; sigma: m host ints (m <= 24).
int qsim_relayout(const float* in_re, const float* in_im, float* out_re,
                  float* out_im, long long nblk, int tr, const int* sigma,
                  int m, void* stream) {
  if (m < 0 || m > MAX_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  Sigma sg = {};
  for (int a = 0; a < m; ++a) sg.s[a] = sigma[a];
  dim3 grid((unsigned)nblk, 2);
  relayout_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in_re), reinterpret_cast<const float4*>(in_im),
      reinterpret_cast<float4*>(out_re), reinterpret_cast<float4*>(out_im),
      tr * 256 / 4, sg, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
