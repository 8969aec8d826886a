// The mesh gswap's half-block exchange between two shards, for Hopper
// (sm_90a).
//
// Replaces, on cards, the two torch copies a component of
// parallel/sharded.py swap_halves (the JAX package's lax.ppermute of half a
// block): shard s, whose shard-index bit g is `my`, keeps its half of local
// bit l == my and takes its partner's half l == my into its half
// l == 1 - my.  One launch a shard, on the shard's own card, writes both
// components of its new block into its spare pair: the kept half read from
// its own memory, the partner's half read from the partner's card (peer
// access over NVLink, or the same card's memory).  Each card thus pulls
// exactly the half block it receives, and no staging buffer exists.
//
// What bounds it: between two cards the link (a shard of 2^32 amplitudes
// pulls 16 GiB a gswap); on one card, HBM (the whole pair read once and
// written once).  The design: a grid-stride loop of 16-byte loads, four
// of each component in flight a thread before any store, so that enough
// remote reads are outstanding to cover the link's latency.  l >= 2, so a
// float4 never straddles the two halves, and a warp's 32 consecutive
// float4 (512 bytes) all come from one side once l >= 7.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int CTAS_PER_SM = 8;

// out[f] = own[f] where bit `bit` of the float4 index f is `my`, else
// part[f ^ 2^bit]; both components.
__global__ void __launch_bounds__(THREADS)
gswap_halves_kernel(const float4* __restrict__ own_re,
                    const float4* __restrict__ own_im,
                    const float4* __restrict__ part_re,
                    const float4* __restrict__ part_im,
                    float4* __restrict__ out_re, float4* __restrict__ out_im,
                    long long n4, int bit, int my) {
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long base = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
       base < n4; base += step) {
    float4 vr[UNROLL], vi[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long f = base + (long long)u * THREADS;
      if (f < n4) {
        const bool kept = ((f >> bit) & 1LL) == my;
        const long long s = kept ? f : f ^ (1LL << bit);
        vr[u] = (kept ? own_re : part_re)[s];
        vi[u] = (kept ? own_im : part_im)[s];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long f = base + (long long)u * THREADS;
      if (f < n4) {
        out_re[f] = vr[u];
        out_im[f] = vi[u];
      }
    }
  }
}

}  // namespace

extern "C" {

// One shard's side of the exchange of local bit l (2 <= l, 2^(l+1) <= n)
// with the shard-index bit whose value on this shard is my (0 or 1): own_*
// this shard's n floats a component, part_* its partner's (on any card this
// card can read), out_* the new block, distinct from both.  Launched on the
// current device, whose stream `stream` is.
int qsim_gswap_halves(const float* own_re, const float* own_im,
                      const float* part_re, const float* part_im,
                      float* out_re, float* out_im, long long n, int l,
                      int my, void* stream) {
  if (n < 8 || (n & 3) || l < 2 || l > 62 || (2LL << l) > n ||
      (my & ~1))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n4 = n / 4;
  const long long need = (n4 + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const unsigned grid =
      (unsigned)std::min<long long>(need, (long long)sms * CTAS_PER_SM);
  gswap_halves_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(own_re),
      reinterpret_cast<const float4*>(own_im),
      reinterpret_cast<const float4*>(part_re),
      reinterpret_cast<const float4*>(part_im),
      reinterpret_cast<float4*>(out_re), reinterpret_cast<float4*>(out_im),
      n4, l - 2, my);
  return static_cast<int>(cudaGetLastError());
}

// Let `device` read `peer`'s memory (cudaDeviceEnablePeerAccess, made on
// `device`); already enabled counts as done.  The current device is left
// as it was.  Returns cudaErrorPeerAccessUnsupported where the two cards
// cannot reach each other.
int qsim_enable_peer(int device, int peer) {
  int cur = 0, can = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      (void)cudaGetLastError();
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(cur);
  return static_cast<int>(e != cudaSuccess ? e : back);
}

}  // extern "C"
