// Flash-decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/kernel.py:193
// (decode_attention_pallas: body _decode_kernel :55, merge _combine :96).
//
// Contract (the Pallas kernel's): q (B, Hq, T, DK), k (B, Hkv, S, DK), v
// (B, Hkv, S, DV) bf16, (DK, DV) = (64, 64), (128, 128) or (192, 128) (MLA's
// decompressed heads), G * T <= 4096 (G = Hq / Hkv); q_pos (B, T), k_pos (B, S),
// lengths/starts (B,) int32.  Key slot j of row b feeds query t iff k_pos >=
// 0, k_pos <= q_pos[b, t], (window > 0) q_pos - k_pos < window, and
// starts[b] <= j < lengths[b].  A query with q_pos -1 (a done row), and
// every query of a row with lengths <= starts, comes out exactly 0.  Output
// (B, Hq, T, DV) float32, scaled by 1 / sqrt(DK) as the caller passes it.  The kernel takes the per-query positions
// themselves where the Pallas kernel takes (q_pos0, q_len): for the
// valid-prefix blocks every caller builds, the two say the same.  What a
// slot outside [starts, lengths) holds is never read.
//
// What bounds it on the H100: bytes, the live K/V of each (row, KV head)
// read once (about one flop a byte); at decode shapes, latency on the way
// there.  The design is in decode_attention.cuh, which the paged kernel
// (paged_decode_attention.cu) shares: one launch of (C, Hkv * nq, B) blocks
// in clusters of C (the caller's `cluster`; nq chunks of 16 packed queries
// when G * T > 16, the draft-verify blocks), a bulk-copy ring of TILE = 32
// contiguous slots of the row's (S, D) cache, fp32 online softmax on the
// CUDA cores, and the cluster's partials merged through shared memory.
#include "decode_attention.cuh"

namespace {

using decode_attn::Layout;
using decode_attn::Params;

constexpr int TILE = 32;        // cache slots a tile (one bulk copy of K, of V)

template <int DK, int DV, int GTP>
__global__ void __launch_bounds__(decode_attn::THREADS,
                                  decode_attn::min_blocks(GTP))
    dense_decode_kernel(const Params p) {
  decode_attn::body<DK, DV, TILE, GTP, false>(p);
}

// The kernel for G * T queries padded to GTP (2, 4, 8 or 16), or cut into
// chunks of 16 above 16.
template <int DK, int DV>
cudaError_t run(const Params& p, int B, int C, cudaStream_t st) {
  const int GT = p.G * p.T;
  if (GT <= 2)
    return decode_attn::launch(dense_decode_kernel<DK, DV, 2>, 2,
                               Layout<DK, DV, TILE, 2>::BYTES, p, B, C, st);
  if (GT <= 4)
    return decode_attn::launch(dense_decode_kernel<DK, DV, 4>, 4,
                               Layout<DK, DV, TILE, 4>::BYTES, p, B, C, st);
  if (GT <= 8)
    return decode_attn::launch(dense_decode_kernel<DK, DV, 8>, 8,
                               Layout<DK, DV, TILE, 8>::BYTES, p, B, C, st);
  // G * T > 16: chunks of 16 queries, one more grid row each
  return decode_attn::launch(dense_decode_kernel<DK, DV, 16>, 16,
                             Layout<DK, DV, TILE, 16>::BYTES, p, B, C, st);
}

}  // namespace

extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, const void* lengths, const void* starts, void* out,
    int B, int Hq, int Hkv, int T, int S, int Dk, int Dv, int cluster,
    int window, float scale, void* stream) {
  if (!decode_attn::valid(B, Hq, Hkv, T, S, cluster) ||
      !decode_attn::head_dims(Dk, Dv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v),
           nullptr,
           static_cast<const int*>(q_pos),
           static_cast<const int*>(k_pos),
           static_cast<const int*>(lengths),
           static_cast<const int*>(starts),
           static_cast<float*>(out),
           Hkv, Hq / Hkv, T, S, 0, window,
           scale * decode_attn::LOG2E};
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = Dk == 192 ? run<192, 128>(p, B, cluster, st)
                        : Dk == 128 ? run<128, 128>(p, B, cluster, st)
                                    : run<64, 64>(p, B, cluster, st);
  return static_cast<int>(err);
}
