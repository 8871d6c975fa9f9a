// Split-K flash-decode attention over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// src/repro/kernels/decode_attention/kernel.py:120
// (paged_decode_attention_pallas: body _paged_kernel :109, merge _combine
// :96).
//
// Contract (the Pallas kernel's): q (B, Hq, T, D) bf16; k_pool/v_pool
// (NB, Hkv, bs, D) bf16 physical block pools; table (B, nb) int32, logical
// slot j of row b lives at pool[table[b, j / bs], :, j % bs]; k_pos (B,
// nb * bs) int32 (the wrapper pads a short logical width with -1);
// q_pos (B, T), lengths/starts (B,) int32, the dense kernel's masking.
// Output (B, Hq, T, D) float32; a query that sees no key comes out exactly 0.
//
// What bounds it on the H100: bytes, as for the dense kernel (about 1 FLOP
// per byte of K/V).  The design is the dense kernel's (decode_attention.cuh)
// with one change: a split is one block of the pool (BK = bs), and its
// K/V tile address comes from table[b, split], which the block reads itself
// (no scalar prefetch on Hopper).  A split outside [starts, lengths) reads
// neither its table entry nor its block, so dead table entries may point
// anywhere; it is neutral in the merge (never read), and a row with no
// live split comes out 0.
#include "decode_attention.cuh"

extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* q_pos, const void* k_pos, const void* lengths,
    const void* starts, void* m, void* l, void* acc, void* out, int B, int Hq,
    int Hkv, int T, int nb, int bs, int D, int window, float scale,
    void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (Hq / Hkv) * T > decode_attn::MAX_GT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* tb = static_cast<const int*>(table);
  auto* qp = static_cast<const int*>(q_pos);
  auto* kp = static_cast<const int*>(k_pos);
  auto* ln = static_cast<const int*>(lengths);
  auto* sp = static_cast<const int*>(starts);
  auto* mm = static_cast<float*>(m);
  auto* ll = static_cast<float*>(l);
  auto* aa = static_cast<float*>(acc);
  auto* oo = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int S = nb * bs;
  cudaError_t err;
#define PAGED_RUN(DD, BS)                                                      \
  decode_attn::run<DD, BS, true>(q, k_pool, v_pool, tb, qp, kp, ln, sp, mm, ll, \
                                 aa, oo, B, Hq, Hkv, T, S, nb, window, scale, st)
  if (D == 128 && bs == 32)
    err = PAGED_RUN(128, 32);
  else if (D == 128 && bs == 64)
    err = PAGED_RUN(128, 64);
  else if (D == 64 && bs == 32)
    err = PAGED_RUN(64, 32);
  else if (D == 64 && bs == 64)
    err = PAGED_RUN(64, 64);
  else
    err = cudaErrorInvalidValue;
#undef PAGED_RUN
  return static_cast<int>(err);
}
