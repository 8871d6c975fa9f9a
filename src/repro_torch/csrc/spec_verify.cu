// SPEC-RL accept / first-reject test for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/spec_verify/kernel.py:44
// (spec_verify_pallas, body _verify_kernel :24) together with the clamp of
// its wrapper (ops.py:29).
//
// Per row b: n[b] = the first t < valid_len[b] with
// u[b, t] > exp(min(lp_curr[b, t] - lp_prev[b, t] + log_lenience, 0)),
// else valid_len[b].  lp_curr, lp_prev, u: (B, N) float32; valid_len: (B,)
// int32 or int64, as the caller holds it (no conversion launched); out:
// (B,) int32.  The arithmetic is the plain version's, operation for
// operation in float32 (no fused or fast-math exp), so the result is
// exactly equal to it.
//
// What bounds it on the H100: bytes (12 bytes read per token, a handful of
// FLOPs), and at the slice's size (16 x 256, 49 KB) the launch and one
// DRAM round trip.  So the kernel makes one memory trip: one warp per row,
// each lane issuing its float4 loads of lp_curr, lp_prev and u for up to
// 256 tokens at once together with the read of valid_len, masked by
// valid_len only afterwards (the previous version's token loop waited for
// valid_len before its first load: two dependent trips).  The first
// rejection is a ballot over the lanes, each holding four consecutive
// tokens, and __ffs of the first lane's bits: no shared memory, no block
// barrier, no second reduction.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int UNROLL = 2;                // 128-token chunks loaded at once
constexpr int SPAN = UNROLL * 128;       // tokens a warp covers at once
constexpr unsigned FULL = 0xffffffffu;

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int t, int N) {
  if (VEC) return *reinterpret_cast<const float4*>(p + t);
  float4 x;
  x.x = t < N ? p[t] : 0.f;
  x.y = t + 1 < N ? p[t + 1] : 0.f;
  x.z = t + 2 < N ? p[t + 2] : 0.f;
  x.w = t + 3 < N ? p[t + 3] : 0.f;
  return x;
}

__device__ __forceinline__ bool rejects(float c, float p, float u, float ll) {
  const float diff = c - p;
  const float log_alpha = fminf(diff + ll, 0.f);
  return u > expf(log_alpha);
}

// One warp (block) per row.  VEC: N % 4 == 0 and the three rows 16-byte
// aligned (float4 loads); vl_int64: valid_len holds long long, else int.
template <bool VEC>
__global__ void __launch_bounds__(32) spec_verify_kernel(
    const float* __restrict__ lp_curr, const float* __restrict__ lp_prev,
    const float* __restrict__ u, const void* __restrict__ valid_len,
    int vl_int64, int* __restrict__ out, int N, float log_lenience) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const long long vl = vl_int64 ? static_cast<const long long*>(valid_len)[b]
                                : static_cast<const int*>(valid_len)[b];
  const size_t row = static_cast<size_t>(b) * N;
  int first = INT_MAX;
  for (int t0 = 0; t0 < N; t0 += SPAN) {
    float4 c[UNROLL], p[UNROLL], q[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {       // every load before any use
      const int t = t0 + i * 128 + lane * 4;
      if (t < N) {
        c[i] = load4<VEC>(lp_curr + row, t, N);
        p[i] = load4<VEC>(lp_prev + row, t, N);
        q[i] = load4<VEC>(u + row, t, N);
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int t0i = t0 + i * 128, t = t0i + lane * 4;
      unsigned bits = 0;
      if (t < N) {
        const float cs[4] = {c[i].x, c[i].y, c[i].z, c[i].w};
        const float ps[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
        const float qs[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)     // no branch: every lane tests 4
          bits |= static_cast<unsigned>(
                      rejects(cs[j], ps[j], qs[j], log_lenience) &
                      (t + j < N) & (t + j < vl)) << j;
      }
      const unsigned lanes = __ballot_sync(FULL, bits != 0);
      if (lanes != 0 && first == INT_MAX) {
        const int src = __ffs(lanes) - 1;
        const unsigned sb = __shfl_sync(FULL, bits, src);
        first = t0i + src * 4 + __ffs(sb) - 1;
      }
    }
    if (first != INT_MAX || t0 + SPAN >= vl) break;
  }
  if (lane == 0) out[b] = first != INT_MAX ? first : static_cast<int>(vl);
}

}  // namespace

extern "C" int repro_spec_verify(const void* lp_curr, const void* lp_prev,
                                 const void* u, const void* valid_len,
                                 int vl_int64, void* out, int B, int N,
                                 float log_lenience, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = N % 4 == 0 &&
      ((reinterpret_cast<size_t>(lp_curr) | reinterpret_cast<size_t>(lp_prev) |
        reinterpret_cast<size_t>(u)) & 15) == 0;
  const auto* c = static_cast<const float*>(lp_curr);
  const auto* p = static_cast<const float*>(lp_prev);
  const auto* q = static_cast<const float*>(u);
  auto* o = static_cast<int*>(out);
  if (vec)
    spec_verify_kernel<true><<<B, 32, 0, st>>>(c, p, q, valid_len, vl_int64, o,
                                               N, log_lenience);
  else
    spec_verify_kernel<false><<<B, 32, 0, st>>>(c, p, q, valid_len, vl_int64,
                                                o, N, log_lenience);
  return static_cast<int>(cudaGetLastError());
}
