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
//
// The kernels themselves are in decode_attention.cuh, which the paged kernel
// (paged_decode_attention.cu) shares; here a split is BK = 64 contiguous
// slots of the row's (S, D) cache.
#include "decode_attention.cuh"

namespace {

constexpr int BK = 64;          // cache slots per split

}  // namespace

extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, const void* lengths, const void* starts, void* m,
    void* l, void* acc, void* out, int B, int Hq, int Hkv, int T, int S, int D,
    int nsplit, int window, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (Hq / Hkv) * T > decode_attn::MAX_GT ||
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
    err = decode_attn::run<128, BK, false>(q, k, v, nullptr, qp, kp, ln, sp, mm,
                                           ll, aa, oo, B, Hq, Hkv, T, S, nsplit,
                                           window, scale, st);
  else if (D == 64)
    err = decode_attn::run<64, BK, false>(q, k, v, nullptr, qp, kp, ln, sp, mm,
                                          ll, aa, oo, B, Hq, Hkv, T, S, nsplit,
                                          window, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
