// Slot admission scatter for Hopper (sm_90a): write admitted rows into the
// persistent KV cache (or, for paged_slot_write, into pool blocks).
//
// Replaces the Pallas kernel src/repro/kernels/cache_slot_write/kernel.py:30
// (cache_slot_write_pallas, body _slot_write_kernel :25).
//
// dst (Rd, row) and src (Rs, row) rows of row_bytes each; src_for_dst (Rd,)
// int32 is the inverted admission map (the wrapper builds it last-wins on
// duplicate destinations, as ops.py:_invert_rows does).  For every d with
// src_for_dst[d] >= 0: dst[d] = src[src_for_dst[d]].  Other rows are not
// touched.  The TPU kernel writes a new buffer (out[d] = dst[d] where the
// index is -1); the port's caches are written in place, so a row nobody
// admits costs nothing here and stays bit-identical.
//
// Like the TPU kernel it walks destination rows, so each destination row is
// written exactly once, whatever duplicates the admission group carries (a
// group padded by repeating its row 0).
//
// What bounds it on the H100: bytes, the admitted rows read once and written
// once (2 * rows * row_bytes).  A grid-stride loop over destination rows:
// a block reads its row's index and, for an admitted row, its threads copy
// the row in 16-byte vectors, neighbouring threads on neighbouring
// addresses (a 128-wide bf16 row of one slot is 16 vectors).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) slot_write_kernel(
    const uint4* __restrict__ src, const int* __restrict__ src_for_dst,
    uint4* __restrict__ dst, long long Rd, int vpr) {
  for (long long d = blockIdx.x; d < Rd; d += gridDim.x) {
    const int s = src_for_dst[d];
    if (s < 0) continue;
    const uint4* from = src + (long long)s * vpr;
    uint4* to = dst + d * vpr;
    for (int c = threadIdx.x; c < vpr; c += THREADS) to[c] = from[c];
  }
}

}  // namespace

extern "C" int repro_cache_slot_write(void* dst, const void* src,
                                      const void* src_for_dst, long long Rd,
                                      long long row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || row_bytes / 16 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Rd == 0) return static_cast<int>(cudaSuccess);
  long long blocks = Rd < 132LL * 16 ? Rd : 132LL * 16;
  slot_write_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<const int*>(src_for_dst),
      static_cast<uint4*>(dst), Rd, (int)(row_bytes / 16));
  return static_cast<int>(cudaGetLastError());
}
