// Flash-decode attention over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// src/repro/kernels/decode_attention/kernel.py:120
// (paged_decode_attention_pallas: body _paged_kernel :109, merge _combine
// :96).
//
// Contract (the Pallas kernel's, at Dk = Dv: MLA's paged reads go through
// the dense gather and never reach this kernel): q (B, Hq, T, D) bf16, D =
// 64 or 128, G * T <= 4096; k_pool/v_pool (NB, Hkv, bs, D) bf16 physical block pools,
// bs = 32 or 64; table (B, nb) int32, logical slot j of row b lives at
// pool[table[b, j / bs], :, j % bs]; k_pos (B, nb * bs) int32 (the wrapper
// pads a short logical width with -1); q_pos (B, T), lengths/starts (B,)
// int32, the dense kernel's masking.  Output (B, Hq, T, D) float32; a
// query that sees no key comes out exactly 0.  The kernel reads no table
// entry, and no pool row, outside [starts, lengths): dead entries may point
// anywhere, dead slots of a live block may hold anything.
//
// What bounds it on the H100: bytes, as for the dense kernel.  The design
// is the dense kernel's (decode_attention.cuh) with a tile of one pool block
// (TILE = bs): the producer warp reads the row's table entries for its
// share of blocks 32 at a time and bulk-copies each block's live rows from
// pool[table[b, tile], h]; everything after the copy is the dense kernel's.
#include "decode_attention.cuh"

namespace {

using decode_attn::Layout;
using decode_attn::Params;

template <int D, int BS, int GTP>
__global__ void __launch_bounds__(decode_attn::THREADS,
                                  decode_attn::min_blocks(GTP))
    paged_decode_kernel(const Params p) {
  decode_attn::body<D, D, BS, GTP, true>(p);
}

// The kernel for G * T queries padded to GTP (2, 4, 8 or 16), or cut into
// chunks of 16 above 16.
template <int D, int BS>
cudaError_t run(const Params& p, int B, int C, cudaStream_t st) {
  const int GT = p.G * p.T;
  if (GT <= 2)
    return decode_attn::launch(paged_decode_kernel<D, BS, 2>, 2,
                               Layout<D, D, BS, 2>::BYTES, p, B, C, st);
  if (GT <= 4)
    return decode_attn::launch(paged_decode_kernel<D, BS, 4>, 4,
                               Layout<D, D, BS, 4>::BYTES, p, B, C, st);
  if (GT <= 8)
    return decode_attn::launch(paged_decode_kernel<D, BS, 8>, 8,
                               Layout<D, D, BS, 8>::BYTES, p, B, C, st);
  // G * T > 16: chunks of 16 queries, one more grid row each
  return decode_attn::launch(paged_decode_kernel<D, BS, 16>, 16,
                             Layout<D, D, BS, 16>::BYTES, p, B, C, st);
}

}  // namespace

extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* q_pos, const void* k_pos, const void* lengths,
    const void* starts, void* out, int B, int Hq, int Hkv, int T, int nb,
    int bs, int D, int cluster, int window, float scale, void* stream) {
  if (!decode_attn::valid(B, Hq, Hkv, T, nb * bs, cluster) ||
      (D != 64 && D != 128) || (bs != 32 && bs != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k_pool),
           static_cast<const __nv_bfloat16*>(v_pool),
           static_cast<const int*>(table),
           static_cast<const int*>(q_pos),
           static_cast<const int*>(k_pos),
           static_cast<const int*>(lengths),
           static_cast<const int*>(starts),
           static_cast<float*>(out),
           Hkv, Hq / Hkv, T, nb * bs, nb, window,
           scale * decode_attn::LOG2E};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = bs == 32 ? run<128, 32>(p, B, cluster, st) : run<128, 64>(p, B, cluster, st);
  else
    err = bs == 32 ? run<64, 32>(p, B, cluster, st) : run<64, 64>(p, B, cluster, st);
  return static_cast<int>(err);
}
