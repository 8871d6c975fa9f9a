// KV-cache compaction roll for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/cache_gather/kernel.py:38
// (cache_roll_pallas, body _roll_kernel :29).
//
// out[r, j, :] = buf[r, (j - shift[r]) mod S, :] for r < R, j < S: a per-row
// circular shift along the sequence axis of the flattened (run, batch, head)
// cache rows.  Out of place, bit-identical to the plain gather; wrapped-in
// slots carry their stale K/V (their positions are rewritten to -1 by the
// caller).
//
// What bounds it on the H100: bytes.  Pure data movement, every input byte
// read once and every output byte written once (2 * R * S * row_bytes).
// Each thread moves one 16-byte vector; neighbouring threads move
// neighbouring vectors of a row, so reads and writes are fully coalesced
// (a row of D = 128 bf16 is 16 vectors, a whole warp covers two rows).  A
// grid-stride loop over the vectors keeps a fixed number of blocks resident.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) cache_roll_kernel(
    const uint4* __restrict__ src, const int* __restrict__ shift,
    uint4* __restrict__ dst, long long R, int S, int vpr) {
  const long long total = R * S * (long long)vpr;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += stride) {
    const long long row = i / vpr;
    const int c = (int)(i - row * vpr);
    const long long r = row / S;
    const int j = (int)(row - r * S);
    int sj = (j - shift[r]) % S;
    if (sj < 0) sj += S;
    dst[i] = src[(r * S + sj) * vpr + c];
  }
}

}  // namespace

extern "C" int repro_cache_roll(const void* buf, const void* shift, void* out,
                                long long R, int S, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vpr = row_bytes / 16;
  const long long total = R * S * (long long)vpr;
  if (total == 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  cache_roll_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), static_cast<const int*>(shift),
      static_cast<uint4*>(out), R, S, vpr);
  return static_cast<int>(cudaGetLastError());
}
