// Split-K flash-decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/kernel.py:193
// (decode_attention_pallas: body _decode_kernel :55, merge _combine :96).
//
// Contract (the Pallas kernel's): q (B, Hq, T, D), k/v (B, Hkv, S, D) bf16;
// q_pos (B, T), k_pos (B, S), lengths/starts (B,) int32.  Key slot j of row b
// feeds query t iff k_pos >= 0, k_pos <= q_pos[b, t], (window > 0) q_pos -
// k_pos < window, and starts[b] <= j < lengths[b].  A query with q_pos -1
// (a done row) comes out exactly 0.  Output (B, Hq, T, D) float32.  The
// kernel takes the per-query positions themselves where the Pallas kernel
// takes (q_pos0, q_len): for the valid-prefix blocks every caller builds,
// the two say the same.
//
// What bounds it on the H100: bytes.  Each decode token reads the live K/V
// of every row (2 * live * Hkv * D * 2 bytes) for 4 * G * T * D FLOPs per
// slot and KV head, about 1 FLOP per byte, far below the ~295 FLOP/byte at
// which bf16 tensor cores become the limit.  So the design spends nothing
// on tensor cores and everything on touching only live bytes once:
//  * the grid is (split, kv head, row); a split of BK = 64 slots outside
//    [starts, lengths) returns at once and reads nothing (the dead left pad
//    of a compacted cache, the unwritten tail);
//  * the G * T queries that share a KV head are packed into one block, so
//    each K/V tile is read from device memory once per group, with 16-byte
//    loads into shared memory;
//  * scores, softmax partials and P.V are fp32; a second small kernel merges
//    the splits' (m, l, acc) partials with the log-sum-exp rescale, reading
//    only the live splits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;          // cache slots per split
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

__device__ __forceinline__ int first_live_split(int start) { return start / BK; }
__device__ __forceinline__ int end_live_split(int len) { return (len + BK - 1) / BK; }

template <int D>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, const int* __restrict__ lengths,
    const int* __restrict__ starts, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int Hkv, int G,
    int T, int S, int nsplit, int window, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int GT = G * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b], st = starts[b];
  if (split < first_live_split(st) || split >= end_live_split(len) || len <= st)
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

  constexpr int VPR = D / 8;  // 16-byte vectors per row
  const size_t kv_base = ((size_t)b * Hkv + h) * S;
  for (int i = tid; i < BK * VPR; i += THREADS) {
    const int j = i / VPR, c = (i % VPR) * 8;
    const int slot = j0 + j;
    uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
    if (slot < S) {
      kv4 = *reinterpret_cast<const uint4*>(k + (kv_base + slot) * D + c);
      vv4 = *reinterpret_cast<const uint4*>(v + (kv_base + slot) * D + c);
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
  const size_t part = ((size_t)b * Hkv + h) * nsplit + split;
  for (int r = warp; r < GT; r += THREADS / 32) {
    const float s0 = ps[r][lane], s1 = ps[r][lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = s0 == NEG_INF ? 0.f : expf(s0 - m);
    const float p1 = s1 == NEG_INF ? 0.f : expf(s1 - m);
    const float l = warp_sum(p0 + p1);
    ps[r][lane] = p0;
    ps[r][lane + 32] = p1;
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
template <int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, const int* __restrict__ lengths,
    const int* __restrict__ starts, float* __restrict__ out, int Hkv, int G,
    int T, int nsplit) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int GT = G * T;
  const int len = lengths[b], st = starts[b];
  int s_lo = first_live_split(st), s_hi = end_live_split(len);
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

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, const int* q_pos,
                const int* k_pos, const int* lengths, const int* starts,
                float* m, float* l, float* acc, float* out, int B, int Hq,
                int Hkv, int T, int S, int nsplit, int window, float scale,
                cudaStream_t stream) {
  const int G = Hq / Hkv;
  decode_split_kernel<D><<<dim3(nsplit, Hkv, B), THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, k_pos, lengths, starts, m, l,
      acc, Hkv, G, T, S, nsplit, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<D><<<dim3(G * T, Hkv, B), D, 0, stream>>>(
      m, l, acc, lengths, starts, out, Hkv, G, T, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, const void* lengths, const void* starts, void* m,
    void* l, void* acc, void* out, int B, int Hq, int Hkv, int T, int S, int D,
    int nsplit, int window, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (Hq / Hkv) * T > MAX_GT ||
      nsplit * BK < S)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* qp = static_cast<const int*>(q_pos);
  auto* kp = static_cast<const int*>(k_pos);
  auto* ln = static_cast<const int*>(lengths);
  auto* sp = static_cast<const int*>(starts);
  auto* mm = static_cast<float*>(m);
  auto* ll = static_cast<float*>(l);
  auto* aa = static_cast<float*>(acc);
  auto* oo = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = run<128>(q, k, v, qp, kp, ln, sp, mm, ll, aa, oo, B, Hq, Hkv, T, S,
                   nsplit, window, scale, st);
  else if (D == 64)
    err = run<64>(q, k, v, qp, kp, ln, sp, mm, ll, aa, oo, B, Hq, Hkv, T, S,
                  nsplit, window, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
