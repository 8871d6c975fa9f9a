// Split-K flash-decode attention, shared by the dense kernel
// (decode_attention.cu) and the paged one (paged_decode_attention.cu).
//
// One block per (split, KV head, row) computes the fp32 softmax partial
// (m, l, acc) of the G * T queries that share the KV head over BK cache
// slots; a second kernel merges the live splits with the log-sum-exp
// rescale.  The two layouts differ only in where a split's K/V tile lives:
//  * dense:  k[b, h, split * BK + j, :] of a (B, Hkv, S, D) cache;
//  * paged:  k_pool[table[b, split], h, j, :] of a (NB, Hkv, BK, D) pool, so
//    a split is one block of the pool (BK = the block size).
// A split outside [starts, lengths) returns before loading anything (and
// the merge never reads it); inside a live split, slots outside the bounds
// load zeros, so what they hold (stale or unwritten K/V) cannot leak.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

constexpr int THREADS = 128;    // 4 warps
constexpr int MAX_GT = 16;      // G * T queries per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int BK>
__device__ __forceinline__ int first_live_split(int start) { return start / BK; }
template <int BK>
__device__ __forceinline__ int end_live_split(int len) { return (len + BK - 1) / BK; }

// k/v: the dense cache (B, Hkv, S, D) or the pool (NB, Hkv, BK, D); table
// (B, nsplit) block ids when PAGED (S == nsplit * BK), unused otherwise.
template <int D, int BK, bool PAGED>
__global__ void __launch_bounds__(THREADS) split_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ table,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int Hkv, int G, int T, int S, int nsplit,
    int window, float scale) {
  static_assert(BK % 32 == 0, "a split is whole warps of slots");
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int GT = G * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b], st = starts[b];
  if (split < first_live_split<BK>(st) || split >= end_live_split<BK>(len) ||
      len <= st)
    return;  // dead split: the combine kernel never reads its partials

  __shared__ float qs[MAX_GT][D];
  __shared__ __align__(16) __nv_bfloat16 ks[BK][D + 8];  // +8: no bank conflicts
  __shared__ __align__(16) __nv_bfloat16 vs[BK][D];
  __shared__ float ps[MAX_GT][BK];
  __shared__ int kp[BK];
  __shared__ int qp[MAX_GT];

  const int Hq = Hkv * G;
  const int j0 = split * BK;
  for (int i = tid; i < GT * D; i += THREADS) {
    const int r = i / D, d = i % D, g = r / T, t = r % T;
    qs[r][d] = __bfloat162float(q[(((size_t)b * Hq + h * G + g) * T + t) * D + d]);
  }
  if (tid < GT) qp[tid] = q_pos[(size_t)b * T + (tid % T)];

  // the split's tile: slot j of the split is row j of `tile`
  size_t tile;
  if (PAGED)
    tile = ((size_t)table[(size_t)b * nsplit + split] * Hkv + h) * BK;
  else
    tile = ((size_t)b * Hkv + h) * S + j0;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < BK * VPR; i += THREADS) {
    const int j = i / VPR, c = (i % VPR) * 8;
    const int slot = j0 + j;
    uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
    if (slot < S && slot >= st && slot < len) {
      kv4 = *reinterpret_cast<const uint4*>(k + (tile + j) * D + c);
      vv4 = *reinterpret_cast<const uint4*>(v + (tile + j) * D + c);
    }
    *reinterpret_cast<uint4*>(&ks[j][c]) = kv4;
    *reinterpret_cast<uint4*>(&vs[j][c]) = vv4;
  }
  for (int j = tid; j < BK; j += THREADS) {
    const int slot = j0 + j;
    kp[j] = slot < S ? k_pos[(size_t)b * S + slot] : -1;
  }
  __syncthreads();

  // scores: one (query row, slot) pair per thread and pass
  for (int p = tid; p < GT * BK; p += THREADS) {
    const int r = p / BK, j = p % BK, slot = j0 + j;
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(&ks[j][c]);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        acc += qs[r][c + 2 * e] * f.x + qs[r][c + 2 * e + 1] * f.y;
      }
    }
    const int kpj = kp[j], qpr = qp[r];
    bool ok = kpj >= 0 && kpj <= qpr && slot < len && slot >= st;
    if (window > 0) ok = ok && (qpr - kpj) < window;
    ps[r][j] = ok ? acc * scale : NEG_INF;
  }
  __syncthreads();

  // per-row partial softmax over this split: (m, l); p overwrites the scores
  constexpr int PER_LANE = BK / 32;
  const size_t part = ((size_t)b * Hkv + h) * nsplit + split;
  for (int r = warp; r < GT; r += THREADS / 32) {
    float s[PER_LANE];
    float mx = NEG_INF;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      s[e] = ps[r][lane + 32 * e];
      mx = fmaxf(mx, s[e]);
    }
    const float m = warp_max(mx);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const float p = s[e] == NEG_INF ? 0.f : expf(s[e] - m);
      ps[r][lane + 32 * e] = p;
      psum += p;
    }
    const float l = warp_sum(psum);
    if (lane == 0) {
      m_part[part * GT + r] = m;
      l_part[part * GT + r] = l;
    }
  }
  __syncthreads();

  for (int i = tid; i < GT * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < BK; ++j) a += ps[r][j] * __bfloat162float(vs[j][d]);
    acc_part[(part * GT + r) * D + d] = a;
  }
}

// One block per (query row, kv head, batch row); threads over D.
template <int D, int BK>
__global__ void __launch_bounds__(D) combine_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, const int* __restrict__ lengths,
    const int* __restrict__ starts, float* __restrict__ out, int Hkv, int G,
    int T, int nsplit) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int GT = G * T;
  const int len = lengths[b], st = starts[b];
  int s_lo = first_live_split<BK>(st), s_hi = end_live_split<BK>(len);
  if (len <= st) s_hi = s_lo;  // no live slot: the output is 0
  const size_t base = ((size_t)b * Hkv + h) * nsplit;
  float mg = NEG_INF;
  for (int s = s_lo; s < s_hi; ++s) mg = fmaxf(mg, m_part[(base + s) * GT + r]);
  float lt = 0.f, at = 0.f;
  for (int s = s_lo; s < s_hi; ++s) {
    const float coef = expf(m_part[(base + s) * GT + r] - mg);
    lt += coef * l_part[(base + s) * GT + r];
    at += coef * acc_part[((base + s) * GT + r) * D + d];
  }
  const int g = r / T, t = r % T;
  const int Hq = Hkv * G;
  out[(((size_t)b * Hq + h * G + g) * T + t) * D + d] = at / (lt > 0.f ? lt : 1.f);
}

template <int D, int BK, bool PAGED>
cudaError_t run(const void* q, const void* k, const void* v, const int* table,
                const int* q_pos, const int* k_pos, const int* lengths,
                const int* starts, float* m, float* l, float* acc, float* out,
                int B, int Hq, int Hkv, int T, int S, int nsplit, int window,
                float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  split_kernel<D, BK, PAGED><<<dim3(nsplit, Hkv, B), THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), table, q_pos, k_pos, lengths, starts,
      m, l, acc, Hkv, G, T, S, nsplit, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<D, BK><<<dim3(G * T, Hkv, B), D, 0, stream>>>(
      m, l, acc, lengths, starts, out, Hkv, G, T, nsplit);
  return cudaGetLastError();
}

}  // namespace decode_attn
