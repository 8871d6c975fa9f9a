// Causal GQA flash attention (forward, T > 1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py:69
// (flash_attention_pallas, body _flash_kernel :27).
//
// Contract: q (B, Hq, T, D), k/v (B, Hkv, S, D) bf16; q_pos (B, T), k_pos
// (B, S) int32.  Key j feeds query t iff k_pos >= 0, (causal) k_pos <= q_pos,
// and (window > 0) q_pos - k_pos < window.  Fully masked rows give 0.
// Output (B, Hq, T, D) float32.  Query head hq reads KV head hq / G; no
// repeated heads are materialised.
//
// What bounds it on the H100: operations.  Prefill and verify do 4 * D
// FLOPs per (query, key) pair against 2 * D * 2 bytes per key read once per
// q-tile, so at BQ = 64 the kernel needs ~64 FLOPs per byte of K/V traffic;
// the bound is the tensor-core rate (989 TFLOP/s bf16).  This first version
// runs its products on the CUDA cores in fp32 (a wgmma/TMA version is later
// work), so it sits far above that bound.  What the design does about the
// rest:
//  * one block per (q-tile of BQ = 64 queries, query head, batch row), a
//    loop over K tiles of BK = 64 with an online softmax in fp32; each warp
//    owns 16 query rows and keeps their (m, l, acc) in registers;
//  * K/V tiles go through shared memory once per block, converted to fp32
//    (K padded by one column so the lanes' column reads avoid bank
//    conflicts);
//  * a K tile with no key visible to any query of the q-tile (all empty,
//    or all after the tile's last position under the causal mask) is
//    skipped whole: left padding and the causal upper triangle cost no
//    arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;            // 4 warps x 16 query rows
constexpr int ROWS = BQ / (THREADS / 32);
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * BK) +
         sizeof(int) * (BK + BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out, int Hq, int Hkv,
    int T, int S, int causal, int window, float scale) {
  constexpr int C = D / 32;  // output columns per lane
  const int qt = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int h = hq / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = qt * BQ, r0 = warp * ROWS;

  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][D]
  float* ks = qs + BQ * D;             // [BK][D + 1]
  float* vs = ks + BK * (D + 1);       // [BK][D]
  float* ps = vs + BK * D;             // [BQ][BK]
  int* kp = reinterpret_cast<int*>(ps + BQ * BK);  // [BK]
  int* qp = kp + BK;                   // [BQ]

  const size_t q_base = ((size_t)b * Hq + hq) * T;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, t = t0 + r;
    qs[i] = t < T ? __bfloat162float(q[(q_base + t) * D + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    const int t = t0 + r;
    qp[r] = t < T ? q_pos[(size_t)b * T + t] : -1;
  }
  __syncthreads();
  int qmax = -1;
  for (int r = 0; r < BQ; ++r) qmax = max(qmax, qp[r]);

  float acc[ROWS][C];
  float m_r[ROWS], l_r[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m_r[r] = NEG_INF;
    l_r[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const size_t kv_base = ((size_t)b * Hkv + h) * S;
  constexpr int VPR = D / 8;
  for (int j0 = 0; j0 < S; j0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    int live = 0;
    if (tid < BK) {
      const int slot = j0 + tid;
      const int kv = slot < S ? k_pos[(size_t)b * S + slot] : -1;
      kp[tid] = kv;
      live = kv >= 0 && (!causal || kv <= qmax);
    }
    if (!__syncthreads_or(live)) continue;  // no visible key in this tile

    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int j = i / VPR, c = (i % VPR) * 8, slot = j0 + j;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = make_uint4(0u, 0u, 0u, 0u);
      if (slot < S) {
        kr = *reinterpret_cast<const uint4*>(k + (kv_base + slot) * D + c);
        vr = *reinterpret_cast<const uint4*>(v + (kv_base + slot) * D + c);
      }
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kr);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vr);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 kf = __bfloat1622float2(k2[e]);
        const float2 vf = __bfloat1622float2(v2[e]);
        ks[j * (D + 1) + c + 2 * e] = kf.x;
        ks[j * (D + 1) + c + 2 * e + 1] = kf.y;
        vs[j * D + c + 2 * e] = vf.x;
        vs[j * D + c + 2 * e + 1] = vf.y;
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's rows; lane holds keys lane and lane + 32
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0 = ks[lane * (D + 1) + d];
      const float k1 = ks[(lane + 32) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = qs[(r0 + r) * D + d];
        s[r][0] += qv * k0;
        s[r][1] += qv * k1;
      }
    }

    const int kp0 = kp[lane], kp1 = kp[lane + 32];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpr = qp[r0 + r];
      bool ok0 = kp0 >= 0 && (!causal || kp0 <= qpr);
      bool ok1 = kp1 >= 0 && (!causal || kp1 <= qpr);
      if (window > 0) {
        ok0 = ok0 && (qpr - kp0) < window;
        ok1 = ok1 && (qpr - kp1) < window;
      }
      const float x0 = ok0 ? s[r][0] * scale : NEG_INF;
      const float x1 = ok1 ? s[r][1] * scale : NEG_INF;
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(x0, x1)));
      const float p0 = ok0 ? expf(x0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(x1 - m_new) : 0.f;
      const float corr = expf(m_r[r] - m_new);
      l_r[r] = corr * l_r[r] + warp_sum(p0 + p1);
      m_r[r] = m_new;
      ps[(r0 + r) * BK + lane] = p0;
      ps[(r0 + r) * BK + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

    // acc += P V; lane owns columns lane + 32 c
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = ps[(r0 + r) * BK + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] += pj * vv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int t = t0 + r0 + r;
    if (t >= T) continue;
    const float denom = l_r[r] > 0.f ? l_r[r] : 1.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[(q_base + t) * D + lane + 32 * c] = acc[r][c] / denom;
  }
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, const int* q_pos,
                const int* k_pos, float* out, int B, int Hq, int Hkv, int T,
                int S, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, k_pos, out, Hq, Hkv, T, S,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     const void* q_pos, const void* k_pos,
                                     void* out, int B, int Hq, int Hkv, int T,
                                     int S, int D, int causal, int window,
                                     float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* qp = static_cast<const int*>(q_pos);
  auto* kp = static_cast<const int*>(k_pos);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = run<128>(q, k, v, qp, kp, o, B, Hq, Hkv, T, S, causal, window, scale, st);
  else if (D == 64)
    err = run<64>(q, k, v, qp, kp, o, B, Hq, Hkv, T, S, causal, window, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
