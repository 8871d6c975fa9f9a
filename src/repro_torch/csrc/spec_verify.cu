// SPEC-RL accept / first-reject test for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/spec_verify/kernel.py:44
// (spec_verify_pallas, body _verify_kernel :24) together with the clamp of
// its wrapper (ops.py:29).
//
// Per row b: n[b] = the first t < valid_len[b] with
// u[b, t] > exp(min(lp_curr[b, t] - lp_prev[b, t] + log_lenience, 0)),
// else valid_len[b].  lp_curr, lp_prev, u: (B, N) float32; valid_len,
// out: (B,) int32.  The arithmetic is the plain version's, operation for
// operation in float32 (no fused or fast-math exp), so the result is
// exactly equal to it.
//
// What bounds it on the H100: bytes (12 bytes read per token, a handful of
// FLOPs), and at the slice's size (16 x 256) launch latency.  One block per
// row: each thread walks its strided tokens and stops at its first
// rejection, then a warp-shuffle min-reduction gives the row's first.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) spec_verify_kernel(
    const float* __restrict__ lp_curr, const float* __restrict__ lp_prev,
    const float* __restrict__ u, const int* __restrict__ valid_len,
    int* __restrict__ out, int N, float log_lenience) {
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vl = valid_len[b];
  int first = INT_MAX;
  for (int t = tid; t < N && t < vl; t += THREADS) {
    const size_t i = (size_t)b * N + t;
    const float diff = lp_curr[i] - lp_prev[i];
    const float log_alpha = fminf(diff + log_lenience, 0.f);
    const float alpha = expf(log_alpha);
    if (u[i] > alpha) {
      first = t;
      break;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
  __shared__ int red[THREADS / 32];
  if (lane == 0) red[warp] = first;
  __syncthreads();
  if (warp == 0) {
    int x = lane < THREADS / 32 ? red[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) out[b] = min(x, vl);
  }
}

}  // namespace

extern "C" int repro_spec_verify(const void* lp_curr, const void* lp_prev,
                                 const void* u, const void* valid_len, void* out,
                                 int B, int N, float log_lenience, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  spec_verify_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp_curr), static_cast<const float*>(lp_prev),
      static_cast<const float*>(u), static_cast<const int*>(valid_len),
      static_cast<int*>(out), N, log_lenience);
  return static_cast<int>(cudaGetLastError());
}
