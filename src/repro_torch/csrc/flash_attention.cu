// GQA flash attention (forward; causal at T > 1, or non-causal at any T)
// for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py:69
// (flash_attention_pallas, body _flash_kernel :27).
//
// Contract: q (B, Hq, T, DK), k (B, Hkv, S, DK), v (B, Hkv, S, DV) bf16,
// (DK, DV) = (64, 64), (128, 128) or (192, 128) (MLA's decompressed heads:
// nope 128 + rope 64 against a v of 128), S <= 131,072 (2,048 key tiles),
// B <= 65535; q_pos (B, T), k_pos (B, S) int32.  Key j feeds query t iff
// k_pos >= 0, (causal) k_pos <= q_pos, and (window > 0) q_pos - k_pos <
// window.  Rows that see no key give exactly 0.  Output (B, Hq, T, DV)
// float32, the scores scaled by the caller's 1 / sqrt(DK).  Query head hq
// reads KV head hq / G; no repeated heads are materialised.
//
// What bounds it on the H100: bytes.  At the verify shapes the fp32 output
// is most of them, then the K/V that some query sees; the operations (4 D
// flops per visible (query, key) pair) take a tenth of that time at the
// bf16 tensor-core rate.  What the design does about it:
//  * one block per (64-query tile, KV head, batch row) takes CW query heads
//    of that KV head (CW = 2 when G is even, else 1): one consumer
//    warpgroup per query head, so each K/V tile goes HBM -> shared memory
//    once for all of them;
//  * one producer warp keeps a ring of NS K/V stages in flight with TMA
//    (3-D tensor maps (D, rows, heads), 128-byte swizzle, so a tile past S
//    fills with zeros and never reads the next head), full/empty mbarriers.
//    Under that swizzle a box is at most 128 bytes wide, so a 64-row tile
//    loads as D / 64 boxes of 64 columns: 3 for a K or Q row of 192, each
//    its own [64 rows][64 bf16] chunk of shared memory.  With DK = 192 and
//    DV = 128 a stage is 24 KB of K and 16 KB of V, and each query head's
//    Q tile 24 KB: 144 KB for one consumer warpgroup, 168 KB for two;
//  * S = Q K^T on wgmma (m64n64k16, Q and K K-major from shared memory,
//    DK / 16 k-steps);
//    the online softmax in fp32 registers; O += P V on wgmma with P from
//    registers (the S accumulator's fragment is the A fragment) and V
//    MN-major (the transpose bit), N = DV.  P is split into bf16 hi + lo halves,
//    two wgmma each step, so the weights keep ~16 mantissa bits;
//  * the block first lists the K tiles that hold a key visible to some
//    query of its tile (k_pos >= 0, <= the tile's largest q_pos when
//    causal, inside the window of its smallest): producer and consumers
//    walk that list, so empty cache slots, the causal upper triangle, the
//    keys behind a sliding window and query tiles that are all padding
//    cost neither loads nor products.  The tiles are flagged in rounds of
//    ROUND = 512 (one byte each, all warps) and compacted after each round
//    into the list, which dynamic shared memory sizes to the call's tiles
//    (4 bytes a tile: 8 KB beside the 128 KB ring at 2,048 tiles, D =
//    128, two consumer warpgroups).  A non-causal call (an encoder, a
//    cross-attention) lists every tile with a live key, for query tiles
//    of padding too, whose rows then attend like any other;
//  * the output leaves in 16-byte stores after one shuffle per pair of
//    8-column blocks, rows t >= T not written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;           // queries per tile (one wgmma M)
constexpr int BK = 64;           // keys per tile
constexpr int NS = 3;            // K/V stages in the ring
constexpr int MAX_TILES = 2048;  // K tiles of a call: S <= 131,072
constexpr int ROUND = 512;       // K tiles flagged between two compactions
constexpr int CHUNK = 64 * 64 * 2;  // one [64 rows][64 bf16] swizzled chunk
constexpr float NEG_INF = -1e30f;

template <int DK, int DV, int CW>
struct Smem {
  static constexpr int NCK = DK / 64;        // 128-byte column chunks of Q, K
  static constexpr int NCV = DV / 64;        // and of V
  static constexpr int TILE_K = NCK * CHUNK; // one 64-row tile of Q or K
  static constexpr int TILE_V = NCV * CHUNK; // one 64-row tile of V
  static constexpr int Q = 0;
  static constexpr int K = Q + CW * TILE_K;
  static constexpr int V = K + NS * TILE_K;
  static constexpr int BARS = V + NS * TILE_V;        // q_full, full, empty
  static constexpr int FLAGS = BARS + 8 * (1 + 2 * NS);
  static constexpr int META = FLAGS + ROUND;           // count, qmax, qmin
  static constexpr int LIST = META + 16;
  // a call over nk K tiles; + alignment slack
  static constexpr int bytes(int nk) { return LIST + 4 * nk + 1024; }
  static_assert((DK == DV && (DK == 64 || DK == 128)) ||
                    (DK == 192 && DV == 128),
                "(DK, DV): (64, 64), (128, 128), (192, 128)");
};

template <int DK, int DV, int CW>
__global__ void __launch_bounds__(128 * (CW + 1), 1) flash_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out, int Hq, int Hkv,
    int T, int S, int causal, int window, float scale_log2) {
  using L = Smem<DK, DV, CW>;
  constexpr int NCK = L::NCK, NCV = L::NCV;
  const int qt = blockIdx.x, hq0 = blockIdx.y * CW, b = blockIdx.z;
  const int h = hq0 / (Hq / Hkv);
  const int t0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem + L::Q;
  uint8_t* sk = smem + L::K;
  uint8_t* sv = smem + L::V;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NS;
  int* list = reinterpret_cast<int*>(smem + L::LIST);
  uint8_t* flags = smem + L::FLAGS;
  int* meta = reinterpret_cast<int*>(smem + L::META);

  // ---- the tile's query positions and the barriers (warp 0)
  if (warp == 0) {
    int qmax = -1, qmin = 0x7fffffff;
    for (int r = lane; r < BQ; r += 32) {
      const int t = t0 + r;
      if (t < T) {
        const int p = q_pos[(size_t)b * T + t];
        qmax = max(qmax, p);
        qmin = min(qmin, p);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    }
    if (lane == 0) {
      meta[1] = qmax;
      meta[2] = qmin;
      mbar_init(q_full, 1);
      for (int s = 0; s < NS; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 4 * CW);   // lane 0 of every consumer warp
      }
      mbar_fence_init();
    }
  }
  __syncthreads();

  // ---- the live K tiles: some key visible to some query of the tile,
  // flagged a round of ROUND tiles at a time, then appended to the list
  const int nk = (S + BK - 1) / BK;
  {
    const int qmax = meta[1], qmin = meta[2];
    int count = 0;                           // warp 0's running count
    for (int base = 0; base < nk; base += ROUND) {
      const int end = min(nk, base + ROUND);
      for (int tile = base + warp; tile < end; tile += 4 * (CW + 1)) {
        bool live = false;
        for (int j = lane; j < BK; j += 32) {
          const int slot = tile * BK + j;
          if (slot < S) {
            const int kp = k_pos[(size_t)b * S + slot];
            live |= kp >= 0 && (!causal || kp <= qmax) &&
                    (window <= 0 || (long long)kp > (long long)qmin - window);
          }
        }
        live = __any_sync(0xffffffffu, live);
        if (lane == 0) flags[tile - base] = live;
      }
      __syncthreads();
      if (warp == 0) {
        for (int t = base; t < end; t += 32) {
          const int tile = t + lane;
          const bool live = tile < end && flags[tile - base];
          const unsigned m = __ballot_sync(0xffffffffu, live);
          if (live) list[count + __popc(m & ((1u << lane) - 1u))] = tile;
          count += __popc(m);
        }
        if (lane == 0) meta[0] = count;
      }
      __syncthreads();                       // the flags are free again
    }
  }
  const int n = meta[0];

  if (warp >= 4 * CW) {
    // ================================================= producer warpgroup
    if constexpr (CW == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * CW && n > 0) {
      mbar_expect_tx(q_full, CW * L::TILE_K);
      for (int c = 0; c < CW; ++c)
        for (int ch = 0; ch < NCK; ++ch)
          tma_load_3d(sq + c * L::TILE_K + ch * CHUNK, &q_map, q_full,
                      ch * 64, t0, b * Hq + hq0 + c);
      for (int i = 0; i < n; ++i) {
        const int s = i % NS;
        mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::TILE_K + L::TILE_V);
        const int row = list[i] * BK, z = b * Hkv + h;
        for (int ch = 0; ch < NCK; ++ch)
          tma_load_3d(sk + s * L::TILE_K + ch * CHUNK, &k_map, &full[s],
                      ch * 64, row, z);
        for (int ch = 0; ch < NCV; ++ch)
          tma_load_3d(sv + s * L::TILE_V + ch * CHUNK, &v_map, &full[s],
                      ch * 64, row, z);
      }
    }
  } else {
    // ================================================= consumer warpgroups
    if constexpr (CW == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, hq = hq0 + wg;
    const int quad = lane & 3;
    // this thread's two rows of the tile and its 16 columns of a K tile:
    // row r0 + 8 e, column 8 j + 2 quad + c of accumulator entry 4 j + 2 e + c
    const int r0 = 16 * (warp & 3) + (lane >> 2);
    int qp[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + r0 + 8 * e;
      qp[e] = t < T ? q_pos[(size_t)b * T + t] : -1;
    }
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    if (n > 0) mbar_wait(q_full, 0);
    const uint32_t q_addr = smem_u32(sq + wg * L::TILE_K);
    for (int i = 0; i < n; ++i) {
      const int s = i % NS;
      const int kbase = list[i] * BK;
      // the positions of this thread's 16 keys (loads overlap the wait)
      int kp[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int slot = kbase + 8 * j + 2 * quad + c;
          kp[2 * j + c] = slot < S ? __ldg(&k_pos[(size_t)b * S + slot]) : -1;
        }
      mbar_wait(&full[s], (i / NS) & 1);

      // S = Q K^T: DK / 16 steps of k16, 32 bytes apart inside a 128-byte
      // row, the next 64 columns a chunk further
      float sc[32];
      const uint32_t k_addr = smem_u32(sk + s * L::TILE_K);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const uint32_t off = (kk >> 2) * CHUNK + (kk & 3) * 32;
        wgmma_ss_n64(sc, desc_sw128(q_addr + off, 16, 1024),
                     desc_sw128(k_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // masked online softmax in the exp2 domain; p = 0 exactly where masked
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = kp[2 * j + c], qpe = qp[e];
            const bool ok = key >= 0 && (!causal || key <= qpe) &&
                            (window <= 0 || qpe - key < window);
            float& x = sc[4 * j + 2 * e + c];
            x = ok ? x * scale_log2 : NEG_INF;
            mx[e] = fmaxf(mx[e], x);
          }
      float corr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        corr[e] = exp2f(m[e] - mx[e]);
        m[e] = mx[e];
        l[e] *= corr[e];
      }
      uint32_t ph[16], pl[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = sc[4 * j + 2 * e + c];
            p[c] = x > 0.5f * NEG_INF ? exp2f(x - m[e]) : 0.f;
            l[e] += p[c];
          }
          // A fragment of k-step j / 2: registers (row, keys 0-7),
          // (row + 8, keys 0-7), (row, keys 8-15), (row + 8, keys 8-15)
          const int a = 4 * (j >> 1) + 2 * (j & 1) + e;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p[0], p[1]);
          const float2 hf = __bfloat1622float2(hi);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(p[0] - hf.x, p[1] - hf.y);
          ph[a] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[a] = *reinterpret_cast<const uint32_t*>(&lo);
        }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          o[4 * j + 2 * e] *= corr[e];
          o[4 * j + 2 * e + 1] *= corr[e];
        }

      // O += P V: four k16 steps of 16 keys (2048 bytes of V rows each);
      // V is MN-major: 64-column chunks lie CHUNK apart (lbo), groups of 8
      // keys 1024 bytes apart (sbo)
      const uint32_t v_addr = smem_u32(sv + s * L::TILE_V);
      reg_fence(o);
      reg_fence(ph);
      reg_fence(pl);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dv = desc_sw128(v_addr + ks * 2048, CHUNK, 1024);
        if constexpr (DV == 128) {
          wgmma_rs_n128(o, ph + 4 * ks, dv);
          wgmma_rs_n128(o, pl + 4 * ks, dv);
        } else {
          wgmma_rs_n64(o, ph + 4 * ks, dv);
          wgmma_rs_n64(o, pl + 4 * ks, dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // ---- normalise and store: after one exchange with the neighbouring
    // lane, each lane holds 4 consecutive columns of one 8-column block
    float inv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
      inv[e] = l[e] > 0.f ? 1.f / l[e] : 0.f;
    }
    const bool odd = lane & 1;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + r0 + 8 * e;
      float* row = out + (((size_t)b * Hq + hq) * T + t) * DV;
#pragma unroll
      for (int j = 0; j < DV / 8; j += 2) {
        const float a0 = o[4 * j + 2 * e] * inv[e];
        const float a1 = o[4 * j + 2 * e + 1] * inv[e];
        const float b0 = o[4 * (j + 1) + 2 * e] * inv[e];
        const float b1 = o[4 * (j + 1) + 2 * e + 1] * inv[e];
        const float g0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float g1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        if (t < T) {
          const float4 val = odd ? make_float4(g0, g1, b0, b1)
                                 : make_float4(a0, a1, g0, g1);
          const int col = odd ? 8 * (j + 1) + 2 * (quad - 1) : 8 * j + 2 * quad;
          *reinterpret_cast<float4*>(row + col) = val;
        }
      }
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (D, rows, heads) bf16 tensor in boxes of (64, 64, 1), 128-byte swizzle;
// boxes past `rows` fill with zeros.
bool make_map(CUtensorMap* map, const void* base, int D, int rows, int heads) {
  auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)BQ, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV, int CW>
cudaError_t run(const void* q, const void* k, const void* v, const int* q_pos,
                const int* k_pos, float* out, int B, int Hq, int Hkv, int T,
                int S, int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, DK, T, B * Hq) || !make_map(&km, k, DK, S, B * Hkv) ||
      !make_map(&vm, v, DV, S, B * Hkv))
    return cudaErrorInvalidValue;
  const int bytes = Smem<DK, DV, CW>::bytes((S + BK - 1) / BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DK, DV, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, Hq / CW, B);
  flash_kernel<DK, DV, CW><<<grid, 128 * (CW + 1), bytes, stream>>>(
      qm, km, vm, q_pos, k_pos, out, Hq, Hkv, T, S, causal, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t run_d(const void* q, const void* k, const void* v, const int* qp,
                  const int* kp, float* o, int B, int Hq, int Hkv, int T, int S,
                  int causal, int window, float scale, cudaStream_t st) {
  if ((Hq / Hkv) % 2 == 0)
    return run<DK, DV, 2>(q, k, v, qp, kp, o, B, Hq, Hkv, T, S, causal, window,
                          scale, st);
  return run<DK, DV, 1>(q, k, v, qp, kp, o, B, Hq, Hkv, T, S, causal, window,
                        scale, st);
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     const void* q_pos, const void* k_pos,
                                     void* out, int B, int Hq, int Hkv, int T,
                                     int S, int Dk, int Dv, int causal,
                                     int window, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || T < 1 || S < 1 ||
      (S + BK - 1) / BK > MAX_TILES ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* qp = static_cast<const int*>(q_pos);
  auto* kp = static_cast<const int*>(k_pos);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Dk == 192 && Dv == 128)
    err = run_d<192, 128>(q, k, v, qp, kp, o, B, Hq, Hkv, T, S, causal, window,
                          scale, st);
  else if (Dk == 128 && Dv == 128)
    err = run_d<128, 128>(q, k, v, qp, kp, o, B, Hq, Hkv, T, S, causal, window,
                          scale, st);
  else if (Dk == 64 && Dv == 64)
    err = run_d<64, 64>(q, k, v, qp, kp, o, B, Hq, Hkv, T, S, causal, window,
                        scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
