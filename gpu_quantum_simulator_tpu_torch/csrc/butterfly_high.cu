// A 2x2 complex gate on one high qubit of the lane-layout state, for
// Hopper (sm_90a).
//
// Replaces: gpu_quantum_simulator_tpu/ops/pallas_kernels.py
// apply_butterfly_high (_butterfly_kernel), TPU kernel 10.  The state is the
// (R, 128) float32 re/im pair, R = 2^(n-7); the gate u acts on row bit h
// (qubit h + 7): for every pair of rows r and r + 2^h with bit h of r clear,
// across all 128 lanes,
//   a' = u00 a + u01 b,   b' = u10 a + u11 b.
// The TPU kernel streams paired (512, 128) row tiles through VMEM and writes
// new arrays.
//
// What bounds it on the card: bytes.  One read and one write of the state,
// 16 bytes per amplitude, against 14 flops per amplitude; at 3.35 TB/s
// (published, 700 W) that is 5.13 ms at n = 30.
//
// Design: one thread owns one float4 (four lanes) of BOTH rows of a pair,
// so it reads a, b of re and im, and writes a', b' back: in place (out may
// be the input) without a race, and without a second state buffer.  The 32
// threads of a warp cover one 512-byte row of each of the four streams, so
// every load and store is a full 128-bit coalesced access whatever h is
// (h = 0, neighbouring rows, included).  The gate rides in the parameter
// struct, by value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QUADS = 32;                 // float4 per 128-lane row
constexpr int THREADS = 256;

struct Gate {
  float u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i;
};

// re' = xr ar - xi ai + yr br - yi bi, im' = xr ai + xi ar + yr bi + yi br
// for (x, y) = (u00, u01) or (u10, u11): each product and sum rounded on
// its own, left to right (no fused multiply-add), as the plain version's
// torch ops and the JAX kernel's jnp ops round them.
__device__ __forceinline__ float mix_re(float xr, float xi, float yr, float yi,
                                        float ar, float ai, float br,
                                        float bi) {
  return __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(xr, ar), __fmul_rn(xi, ai)),
                             __fmul_rn(yr, br)),
                   __fmul_rn(yi, bi));
}
__device__ __forceinline__ float mix_im(float xr, float xi, float yr, float yi,
                                        float ar, float ai, float br,
                                        float bi) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(xr, ai), __fmul_rn(xi, ar)),
                             __fmul_rn(yr, bi)),
                   __fmul_rn(yi, br));
}

// one output row of the pair: (x, y) = (u00, u01) for a', (u10, u11) for b'
__device__ __forceinline__ void mix4(float xr, float xi, float yr, float yi,
                                     const float4& ar, const float4& ai,
                                     const float4& br, const float4& bi,
                                     float4& ore, float4& oim) {
  ore = make_float4(mix_re(xr, xi, yr, yi, ar.x, ai.x, br.x, bi.x),
                    mix_re(xr, xi, yr, yi, ar.y, ai.y, br.y, bi.y),
                    mix_re(xr, xi, yr, yi, ar.z, ai.z, br.z, bi.z),
                    mix_re(xr, xi, yr, yi, ar.w, ai.w, br.w, bi.w));
  oim = make_float4(mix_im(xr, xi, yr, yi, ar.x, ai.x, br.x, bi.x),
                    mix_im(xr, xi, yr, yi, ar.y, ai.y, br.y, bi.y),
                    mix_im(xr, xi, yr, yi, ar.z, ai.z, br.z, bi.z),
                    mix_im(xr, xi, yr, yi, ar.w, ai.w, br.w, bi.w));
}

// items = R / 2 * QUADS: (row pair, quad) with the quad fastest.
__global__ void __launch_bounds__(THREADS)
butterfly_high_kernel(const float4* in_re, const float4* in_im,
                      float4* out_re, float4* out_im, long long items,
                      int high_bit, Gate g) {
  const long long it = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (it >= items) return;
  const long long pair = it / QUADS;
  const int q = (int)(it % QUADS);
  // row r: the pair index with a zero inserted at bit high_bit
  const long long lo = pair & ((1LL << high_bit) - 1);
  const long long r = ((pair >> high_bit) << (high_bit + 1)) | lo;
  const long long ia = r * QUADS + q;
  const long long ib = ia + ((long long)QUADS << high_bit);
  const float4 ar = in_re[ia], ai = in_im[ia];
  const float4 br = in_re[ib], bi = in_im[ib];
  float4 a_re, a_im, b_re, b_im;
  mix4(g.u00r, g.u00i, g.u01r, g.u01i, ar, ai, br, bi, a_re, a_im);
  mix4(g.u10r, g.u10i, g.u11r, g.u11i, ar, ai, br, bi, b_re, b_im);
  out_re[ia] = a_re;
  out_im[ia] = a_im;
  out_re[ib] = b_re;
  out_im[ib] = b_im;
}

}  // namespace

extern "C" {

// out = the gate u on row bit high_bit of the (rows, 128) pair in; out may
// be in.  u: eight floats, [u00r, u00i, u01r, u01i, u10r, u10i, u11r, u11i]
// (host memory, copied into the launch).
int qsim_butterfly_high(const float* in_re, const float* in_im, float* out_re,
                        float* out_im, long long rows, int high_bit,
                        const float* u, void* stream) {
  if (high_bit < 0 || high_bit > 62 || (2LL << high_bit) > rows ||
      rows % (2LL << high_bit) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Gate g{u[0], u[1], u[2], u[3], u[4], u[5], u[6], u[7]};
  const long long items = rows / 2 * QUADS;
  const long long blocks = (items + THREADS - 1) / THREADS;
  butterfly_high_kernel<<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in_re),
      reinterpret_cast<const float4*>(in_im), reinterpret_cast<float4*>(out_re),
      reinterpret_cast<float4*>(out_im), items, high_bit, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
