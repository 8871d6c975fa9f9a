// Paged-cache gather for Hopper (sm_90a): the dense logical view of a block
// pool.
//
// Replaces the Pallas kernel src/repro/kernels/cache_gather/kernel.py:63
// (paged_gather_pallas, body _gather_kernel :58).
//
// pool (NB, block) rows of block_bytes each; table (R, nb) int32 block ids
// in [0, NB).  out[r, i, :] = pool[table[r, i], :], out (R, nb, block).
//
// What bounds it on the H100: bytes, each addressed block read once and
// each output byte written once (2 * R * nb * block_bytes).  Pure movement:
// each thread moves one 16-byte vector, neighbouring threads move
// neighbouring vectors of one block (a 32-slot, 8-head, 128-wide bf16 block
// is 4096 vectors), and a grid-stride loop keeps a fixed number of blocks
// resident.  The table entry is read once per vector from L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) paged_gather_kernel(
    const uint4* __restrict__ pool, const int* __restrict__ table,
    uint4* __restrict__ out, long long n_blocks, int vpb) {
  const long long total = n_blocks * vpb;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += stride) {
    const long long rb = i / vpb;
    const int c = (int)(i - rb * vpb);
    out[i] = pool[(long long)table[rb] * vpb + c];
  }
}

}  // namespace

extern "C" int repro_paged_gather(const void* pool, const void* table, void* out,
                                  long long n_blocks, long long block_bytes,
                                  void* stream) {
  if (block_bytes % 16 != 0 || block_bytes / 16 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vpb = (int)(block_bytes / 16);
  const long long total = n_blocks * vpb;
  if (total == 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  paged_gather_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), static_cast<const int*>(table),
      static_cast<uint4*>(out), n_blocks, vpb);
  return static_cast<int>(cudaGetLastError());
}
