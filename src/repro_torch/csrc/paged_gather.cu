// Paged-cache gather for Hopper (sm_90a): the dense logical view of a block
// pool, moved by the bulk-copy engine.
//
// Replaces the Pallas kernel src/repro/kernels/cache_gather/kernel.py:63
// (paged_gather_pallas, body _gather_kernel :58).
//
// pool (NB, block) rows of block_bytes each; table (R, nb) int32 block ids
// in [0, NB).  out[r, i, :] = pool[table[r, i], :], out (R, nb, block).
//
// What bounds it on the H100: bytes, each addressed block read once and
// each output byte written once (2 * R * nb * block_bytes).  Pure movement,
// so no thread touches the data: the output is cut into chunks of up to
// CHUNK bytes (a 32-slot, 8-head, 128-wide bf16 block is four), dealt out
// round-robin to a grid of a few 32-thread blocks per SM.  One thread of
// each block reads a chunk's table entry once, brings the chunk into a
// ring of NS shared-memory stages with cp.async.bulk (completion on an
// mbarrier) and sends it out with a bulk store; a stage is refilled once
// the store from it has read it, so NS - 1 loads stay in flight.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CHUNK = 16384;
constexpr int NS = 4;
constexpr int BLOCKS_PER_SM = 3;   // 3 x 64 KB rings fit one SM

__global__ void __launch_bounds__(32) paged_gather_kernel(
    const uint8_t* __restrict__ pool, const int* __restrict__ table,
    uint8_t* __restrict__ out, long long n_blocks, long long block_bytes,
    long long cpb) {
  extern __shared__ __align__(128) uint8_t ring[];   // NS x CHUNK
  __shared__ __align__(8) uint64_t full[NS];
  if (threadIdx.x != 0) return;
  const long long total = n_blocks * cpb, first = blockIdx.x,
                  stride = gridDim.x;
  if (first >= total) return;
  const long long m = (total - first + stride - 1) / stride;
  for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
  mbar_fence_init();

  // chunk k of this block: entry e, byte offset off inside the block
  auto where = [&](long long k, long long& e, long long& off) {
    const long long c = first + k * stride;
    e = c / cpb;
    off = (c - e * cpb) * CHUNK;
  };
  auto load = [&](long long k) {
    long long e, off;
    where(k, e, off);
    const uint32_t bytes = (uint32_t)min((long long)CHUNK, block_bytes - off);
    const int s = (int)(k % NS);
    mbar_expect_tx(&full[s], bytes);
    bulk_load(ring + s * CHUNK, pool + (long long)table[e] * block_bytes + off,
              bytes, &full[s]);
  };

  for (long long k = 0; k < m && k < NS; ++k) load(k);
  for (long long k = 0; k < m; ++k) {
    const int s = (int)(k % NS);
    mbar_wait(&full[s], (uint32_t)((k / NS) & 1));
    long long e, off;
    where(k, e, off);
    bulk_store(out + e * block_bytes + off, ring + s * CHUNK,
               (uint32_t)min((long long)CHUNK, block_bytes - off));
    bulk_commit();
    // the stage of chunk k - 1 is free once its store has read it
    if (k >= 1 && k - 1 + NS < m) {
      bulk_wait_read<1>();
      load(k - 1 + NS);
    }
  }
  bulk_wait<0>();
}

}  // namespace

extern "C" int repro_paged_gather(const void* pool, const void* table, void* out,
                                  long long n_blocks, long long block_bytes,
                                  void* stream) {
  if (block_bytes <= 0 || block_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return static_cast<int>(cudaSuccess);
  const long long cpb = (block_bytes + CHUNK - 1) / CHUNK;
  const long long total = n_blocks * cpb;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(paged_gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               NS * CHUNK);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (long long)sms * BLOCKS_PER_SM;
  if (blocks > total) blocks = total;
  paged_gather_kernel<<<(unsigned)blocks, 32, NS * CHUNK,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int*>(table),
      static_cast<uint8_t*>(out), n_blocks, block_bytes, cpb);
  return static_cast<int>(cudaGetLastError());
}
