// Flash-decode attention for Hopper (sm_90a) in one launch, shared by the
// dense kernel (decode_attention.cu) and the paged one
// (paged_decode_attention.cu).
//
// What bounds it: bytes.  A decode step reads the live K/V of every (row,
// KV head) once, 2 * live * D * 2 bytes, for 4 * G * T * D flops a slot:
// about one flop a byte, so the arithmetic stays on the CUDA cores in fp32
// (mma.sync would pad G * T = 2 queries to 16 rows and split P into bf16
// terms; a version built that way was no faster).  At decode shapes (a few
// hundred live slots a row, 128 (row, KV head) pairs, 14.5 MB a step) the
// time beside the bytes is latency, in this order (tools/
// decode_attention_probe.py measures each): the launch and one round trip
// for the row bounds before the first copy; the tiles, which a block
// requests together and which land together near the end of the transfer;
// the compute of the last tiles after they land; the merge.  The design:
//
//  * One launch.  The grid is (C, Hkv * nq, B) in thread-block clusters of
//    C blocks along x (C <= 4; 2 when G * T > 4): the C blocks of one (row,
//    KV head, query chunk) split its live tiles [starts / TILE,
//    ceil(lengths / TILE)) into equal shares of whole tiles
//    (decode_work_ranges in ops.py is the Python twin).  A KV head's G * T
//    packed queries (query r = g * T + t) are cut into nq = ceil(G * T / 16)
//    chunks of CHUNK = 16 consecutive queries, the last one short (G * T =
//    18 is 16 + 2, not 9 + 9: a block computes all GTP = 16 padded rows
//    whatever its real count, so an even split would save nothing and only
//    cost the chunk's offset arithmetic); every chunk is padded to the same
//    GTP bucket and runs the body below on its own q/out rows.  This takes
//    the draft-verify blocks of DESIGN.md §9 (T = k + 1 <= 64 at any G up
//    to 64, G * T <= MAX_GT = 4096: granite-34b's 48 query heads on one KV
//    head take G * T = 432 at T = 9, 27 chunks; the Pallas kernel takes
//    any G * T through its packed sublane dim) in one launch; a (row, KV
//    head)'s live K/V is read once a chunk, from L2 after the first.
//    MAX_GT bounds nothing inside a block (a block sees only its chunk of
//    at most 16 queries): only the grid's y extent, Hkv * nq <= 65535.  No partial goes through device memory: each block
//    merges its warps' softmax partials (m, l, acc) in shared memory,
//    rank c > 0 stores its own into a slot of rank 0's shared memory
//    (st.shared::cluster) and leaves after one cluster-barrier arrive, and
//    rank 0 waits on that barrier, merges with the log-sum-exp rescale and
//    writes `out`.  The wrapper allocates only `out` and picks C: the
//    smallest that puts a block on every SM (more only add merging).
//  * Loads in flight while the block computes.  A producer warp fills a
//    ring of NS = 4 stages with cp.async.bulk, one copy each of K and V a
//    tile (a head's slots are contiguous in both layouts) and the tile's
//    k_pos by cp.async, on a full mbarrier per stage; consumer warp w takes
//    tiles w, w + 4, ... in stage w and frees it through its empty
//    mbarrier.  A copy brings only the tile's live rows [max(starts, j0),
//    min(lengths, j0 + TILE)): no byte outside a row's live range is read,
//    a tile with no live slot is never fetched, and a row none of whose
//    queries is live (q_pos < 0) fetches nothing.  The layouts differ only
//    in a tile's address: (b * Hkv + h) * S + j0 for dense, table[b, tile]
//    * Hkv + h (a pool block, TILE = its size) for paged: the PAGED
//    template parameter.
//  * A warp computes a whole tile, so four tiles of a block run at once,
//    each warp with its own online softmax (m, l, acc) for the G * T
//    queries of the KV head (padded to GTP).  Lane l holds columns
//    [l * D / 32, (l + 1) * D / 32) of q (scaled into the exp2 domain) and
//    of acc in registers; a slot's K row is one 8-byte (D = 128) or 4-byte
//    load a lane, and the dot products of 32 (slot, query) pairs at a time
//    are reduced by a reduce-scatter butterfly (31 shuffles for 32 sums,
//    lane i keeps sum i).  The scores are masked, exponentiated (l summed
//    per lane, reduced once at the end) and handed to P.V through a few
//    floats of shared memory.  Slots outside [starts, lengths) hold
//    whatever the ring held before: their scores are selected to -inf and
//    P.V walks the live rows only, so nothing there can leak, not even a
//    NaN.
//  * K and V may differ in width (DK, DV): (64, 64) and (128, 128) for GQA,
//    (192, 128) for MLA's decompressed heads (nope 128 + rope 64 against a
//    v of 128).  A stage holds the K tile (TILE rows of DK) and then the V
//    tile (TILE rows of DV), each one bulk copy; the scores reduce over DK
//    (DK / 32 columns a lane: 6 at 192, three 4-byte loads) and the
//    accumulator, the partials and the output run over DV.
//  * A block with no tile still reaches every barrier; its partial (m =
//    -inf, l = 0, acc = 0) weighs nothing, and a query that sees no key
//    comes out exactly 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace decode_attn {

constexpr int NW = 4;                      // consumer warps
constexpr int THREADS = 32 * (NW + 1);     // + the producer warp
constexpr int NS = NW;                     // K/V stages: one a consumer warp
constexpr int CHUNK = 16;                  // packed queries a block at most
constexpr int MAX_GT = 4096;               // G * T queries per KV head
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int min_blocks(int gtp) { return gtp <= 4 ? 3 : 2; }
// The largest cluster for GTP padded queries: rank 0 keeps a slot for each
// peer's partial.
__host__ __device__ constexpr int cluster_cap(int gtp) { return gtp <= 4 ? 4 : 2; }

struct Params {
  const __nv_bfloat16* q;      // (B, Hkv * G, T, DK)
  const __nv_bfloat16* k;      // dense (B, Hkv, S, DK); paged (NB, Hkv, TILE, DK)
  const __nv_bfloat16* v;      // the same with DV
  const int* table;            // paged: (B, nb) block ids
  const int* q_pos;            // (B, T)
  const int* k_pos;            // (B, S)
  const int* lengths;          // (B,)
  const int* starts;           // (B,)
  float* out;                  // (B, Hkv * G, T, DV)
  int Hkv, G, T, S, nb, window;
  float scale_log2;            // softmax scale * log2(e)
};

// The (DK, DV) pairs the kernels are built for.
__host__ __device__ constexpr bool head_dims(int dk, int dv) {
  return (dk == dv && (dk == 64 || dk == 128)) || (dk == 192 && dv == 128);
}

template <int DK, int DV, int TILE, int GTP>
struct Layout {
  static constexpr int DPLK = DK / 32;                // K columns a lane
  static constexpr int DPLV = DV / 32;                // V columns a lane
  static constexpr int PAIRS = TILE * GTP;            // (slot, query) pairs
  static constexpr int NV = 32;                       // sums a butterfly
  static constexpr int ROUNDS = PAIRS / NV;
  static constexpr int SPR = NV / GTP;                // slots a round
  static constexpr int ROWK = DK * 2;                 // bytes of a K slot
  static constexpr int ROWV = DV * 2;                 // bytes of a V slot
  static constexpr int STAGE = TILE * (ROWK + ROWV);  // K tile, then V tile
  static constexpr int PART = 2 * GTP + GTP * DV;     // floats: m, l, acc
  // byte offsets into dynamic shared memory; the warps' acc partials go
  // over the ring once it is drained
  static constexpr int KPOS = NS * STAGE;             // a stage's k_pos
  static constexpr int CPART = KPOS + NS * TILE * 4;  // the block's partial
  static constexpr int PEERS = CPART + PART * 4;      // rank 0: its peers'
  static constexpr int WM = PEERS + (cluster_cap(GTP) - 1) * PART * 4;
  static constexpr int WL = WM + NW * GTP * 4;        // warp partial m, l
  static constexpr int PW = WL + NW * GTP * 4;        // a warp's p
  static constexpr int PA = PW + NW * PAIRS * 4;      // a warp's rescale
  static constexpr int BARS = PA + NW * GTP * 4;      // full[NS], empty[NS]
  static constexpr int BYTES = BARS + 16 * NS;
  static_assert(head_dims(DK, DV), "(DK, DV): (64, 64), (128, 128), (192, 128)");
  static_assert(TILE % 32 == 0 && GTP >= 2 && GTP <= CHUNK, "shape");
  static_assert(PAIRS % NV == 0 && NV % GTP == 0, "whole rounds");
  static_assert(NW * GTP * DV * 4 <= NS * STAGE, "warp partials fit the ring");
  static_assert(BARS % 8 == 0 && PEERS % 16 == 0, "alignment");
};

// DPL consecutive bf16 at p (4-byte aligned; 8-byte at DPL = 4) as floats.
template <int DPL>
__device__ __forceinline__ void load_bf16(const void* p, float (&f)[DPL]) {
  if constexpr (DPL == 6) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint32_t raw = w[i];
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
      f[2 * i] = a.x; f[2 * i + 1] = a.y;
    }
  } else if constexpr (DPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else {
    static_assert(DPL == 2, "D / 32 columns a lane");
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    f[0] = a.x; f[1] = a.y;
  }
}

// Reduce-scatter over the warp: afterwards lane l holds the warp's sum of
// v[l / (32 / NV)].  N - 1 shuffles at offsets 16, 8, ... halve the set each
// level (lanes with bit O set keep the upper half); plain shuffles at the
// offsets left finish the sum among the 32 / NV lanes that share one.  A
// template recursion, so that every index is a constant and v stays in
// registers.
template <int N, int O, int NV>
__device__ __forceinline__ float reduce_scatter_level(float (&v)[NV], int lane) {
  if constexpr (N > 1) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
    return reduce_scatter_level<N / 2, O / 2>(v, lane);
  } else {
    float x = v[0];
#pragma unroll
    for (int o = O; o >= 1; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
  }
}

template <int NV>
__device__ __forceinline__ float reduce_scatter(float (&v)[NV], int lane) {
  return reduce_scatter_level<NV, 16>(v, lane);
}

template <int DK, int DV, int TILE, int GTP, bool PAGED>
__device__ __forceinline__ void body(const Params& p) {
  using L = Layout<DK, DV, TILE, GTP>;
  constexpr int DPLK = L::DPLK, DPLV = L::DPLV, NV = L::NV;
  constexpr int ROUNDS = L::ROUNDS, SPR = L::SPR;
  constexpr int ROWK = L::ROWK, ROWV = L::ROWV, PART = L::PART;
  static_assert(NS == NW, "consumer warp w owns stage w");
  extern __shared__ __align__(128) uint8_t smem[];
  float* cpart = reinterpret_cast<float*>(smem + L::CPART);
  float* peers = reinterpret_cast<float*>(smem + L::PEERS);
  float* wm = reinterpret_cast<float*>(smem + L::WM);
  float* wl = reinterpret_cast<float*>(smem + L::WL);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + NS;

  // block (c, h * nq + chunk, b): rank c of the cluster of (row b, KV head
  // h, query chunk), whose queries are the packed rows [q0, q0 + GTc)
  const int GT = p.G * p.T, nq = (GT + GTP - 1) / GTP;
  const int C = gridDim.x, h = blockIdx.y / nq, b = blockIdx.z;
  const int q0 = (blockIdx.y % nq) * GTP, GTc = min(GTP, GT - q0);
  const int rank = (int)hopper::cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = p.T, S = p.S;
  const int st = max(p.starts[b], 0), len = min(p.lengths[b], S);

  // this block's share of the row's live tiles (none if no query is live)
  bool any_query = false;
  for (int t = 0; t < T; ++t) any_query |= p.q_pos[(size_t)b * T + t] >= 0;
  int t_lo = 0, t_hi = 0;
  if (len > st && any_query) {
    const int first = st / TILE, n = (len + TILE - 1) / TILE - first;
    t_lo = first + rank * n / C;
    t_hi = first + (rank + 1) * n / C;
  }
  const int ntiles = t_hi - t_lo;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 33);       // the bulk copies + 32 lanes
      hopper::mbar_init(&empty[s], 1);       // the stage's consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  hopper::cluster_arrive_relaxed();          // phase 1: this block runs

  const size_t head = (size_t)b * p.Hkv + h;
  if (warp == NW) {
    // ============================================================ producer
    int entry = 0;                           // table[b, t_lo + i] in lane i % 32
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % NS, tile = t_lo + i, j0 = tile * TILE;
      if (PAGED && i % 32 == 0)
        entry = i + lane < ntiles ? p.table[(size_t)b * p.nb + tile + lane] : 0;
      const int blk = PAGED ? __shfl_sync(FULL, entry, i % 32) : 0;
      const int lo = max(st, j0), hi = min(len, j0 + TILE);
      const size_t row = PAGED ? ((size_t)blk * p.Hkv + h) * TILE + (lo - j0)
                               : head * S + lo;
      hopper::mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t n = (uint32_t)(hi - lo);
        uint8_t* ks = smem + s * L::STAGE;
        hopper::mbar_expect_tx(&full[s], n * (ROWK + ROWV));
        hopper::bulk_load(ks + (lo - j0) * ROWK, p.k + row * DK, n * ROWK,
                          &full[s]);
        hopper::bulk_load(ks + TILE * ROWK + (lo - j0) * ROWV, p.v + row * DV,
                          n * ROWV, &full[s]);
      }
      // the live slots' positions, 4 bytes a lane and copy
      int* kps = reinterpret_cast<int*>(smem + L::KPOS) + s * TILE;
#pragma unroll
      for (int j = lane; j < TILE; j += 32)
        if (j0 + j >= lo && j0 + j < hi)
          hopper::cp_async_4(kps + j, p.k_pos + (size_t)b * S + j0 + j);
      hopper::cp_async_arrive(&full[s]);
      __syncwarp();
    }
  } else {
    // =========================================================== consumers
    // lane's columns of each query row, in the exp2 domain (0 past the
    // chunk's last query)
    float qr[GTP][DPLK];
#pragma unroll
    for (int r = 0; r < GTP; ++r) {
      if (r < GTc) {
        load_bf16<DPLK>(p.q + (head * GT + q0 + r) * DK + lane * DPLK, qr[r]);
#pragma unroll
        for (int c = 0; c < DPLK; ++c) qr[r][c] *= p.scale_log2;
      } else {
#pragma unroll
        for (int c = 0; c < DPLK; ++c) qr[r][c] = 0.f;
      }
    }
    // after the butterfly this lane holds the sum of pair (slot sl, query
    // rq) of each round of SPR slots; its query's position masks it
    const int rq = lane % GTP, sl = lane / GTP;
    const int qp = rq < GTc ? p.q_pos[(size_t)b * T + (q0 + rq) % T] : -1;
    float m_run = NEG_INF, l_run = 0.f;     // l: this lane's slots only
    float acc[GTP][DPLV];
#pragma unroll
    for (int r = 0; r < GTP; ++r)
#pragma unroll
      for (int c = 0; c < DPLV; ++c) acc[r][c] = 0.f;
    const int s = warp;                      // this warp's stage
    float* pw = reinterpret_cast<float*>(smem + L::PW) + warp * L::PAIRS;
    float* pa = reinterpret_cast<float*>(smem + L::PA) + warp * GTP;
    const uint8_t* ks = smem + s * L::STAGE;
    const uint8_t* vs = ks + TILE * ROWK;
    const int* kps = reinterpret_cast<const int*>(smem + L::KPOS) + s * TILE;

    for (int i = warp; i < ntiles; i += NW) {
      const int j0 = (t_lo + i) * TILE;
      const int lo = max(st, j0) - j0, hi = min(len, j0 + TILE) - j0;
      hopper::mbar_wait(&full[s], (i / NS) & 1);
      float sc[ROUNDS];
      float mt = NEG_INF;
#pragma unroll
      for (int k = 0; k < ROUNDS; ++k) {
        float dots[NV];
#pragma unroll
        for (int e = 0; e < SPR; ++e) {
          float kf[DPLK];
          load_bf16<DPLK>(ks + (k * SPR + e) * ROWK + lane * DPLK * 2, kf);
#pragma unroll
          for (int r = 0; r < GTP; ++r) {
            float d = 0.f;
#pragma unroll
            for (int c = 0; c < DPLK; ++c) d += qr[r][c] * kf[c];
            dots[e * GTP + r] = d;
          }
        }
        const float x = reduce_scatter<NV>(dots, lane);
        const int j = k * SPR + sl;
        const int key = j >= lo && j < hi ? kps[j] : -1;
        const bool ok = key >= 0 && key <= qp &&
                        (p.window <= 0 || qp - key < p.window);
        sc[k] = ok ? x : NEG_INF;
        mt = fmaxf(mt, sc[k]);
      }
      // online softmax of this lane's query over the tile
#pragma unroll
      for (int o = GTP; o < 32; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
      const float m_new = fmaxf(m_run, mt);
      const float alpha = exp2f(m_run - m_new);
      l_run *= alpha;
#pragma unroll
      for (int k = 0; k < ROUNDS; ++k) {
        const float pk = sc[k] > 0.5f * NEG_INF ? exp2f(sc[k] - m_new) : 0.f;
        l_run += pk;
        pw[k * NV + lane] = pk;
      }
      m_run = m_new;
      if (sl == 0) pa[rq] = alpha;
      __syncwarp();
      // acc = acc * alpha + sum over the live rows of p * V
#pragma unroll
      for (int r = 0; r < GTP; ++r) {
        const float a = pa[r];
#pragma unroll
        for (int c = 0; c < DPLV; ++c) acc[r][c] *= a;
      }
#pragma unroll 4
      for (int j = lo; j < hi; ++j) {
        float vf[DPLV];
        load_bf16<DPLV>(vs + j * ROWV + lane * DPLV * 2, vf);
        const float* pj = pw + j * GTP;
#pragma unroll
        for (int r = 0; r < GTP; ++r) {
          const float pr = pj[r];
#pragma unroll
          for (int c = 0; c < DPLV; ++c) acc[r][c] += pr * vf[c];
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int o = GTP; o < 32; o <<= 1)
      l_run += __shfl_xor_sync(FULL, l_run, o);

    // ---- the four warps' partials -> the block's (acc over the ring)
    hopper::named_barrier(1, 32 * NW);       // every warp is off the ring
    float* wacc = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int r = 0; r < GTP; ++r)
#pragma unroll
      for (int c = 0; c < DPLV; ++c)
        wacc[(warp * GTP + r) * DV + lane * DPLV + c] = acc[r][c];
    if (sl == 0) {
      wm[warp * GTP + rq] = m_run;
      wl[warp * GTP + rq] = l_run;
    }
    hopper::named_barrier(1, 32 * NW);
    // the block's partial: m[GTP], l[GTP], acc[GTP][DV]
    for (int e = tid; e < GTc * DV; e += 32 * NW) {
      const int r = e / DV;
      float mg = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) mg = fmaxf(mg, wm[w * GTP + r]);
      float a = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = exp2f(wm[w * GTP + r] - mg);
        a += f * wacc[(w * GTP + r) * DV + e % DV];
        l += f * wl[w * GTP + r];
      }
      cpart[2 * GTP + e] = a;
      if (e % DV == 0) {
        cpart[r] = mg;
        cpart[GTP + r] = l;
      }
    }
    hopper::named_barrier(1, 32 * NW);
  }

  // ---- rank c > 0 hands its partial to rank 0 and leaves
  __syncwarp();
  hopper::cluster_wait();                    // phase 1: rank 0 runs
  if (rank > 0) {
    if (warp < NW) {
      float* slot = peers + (rank - 1) * PART;
      for (int e = tid; e < PART / 4; e += 32 * NW)
        hopper::st_cluster_v4(hopper::cluster_map(slot + 4 * e, 0),
                              reinterpret_cast<const float4*>(cpart)[e]);
    }
    __syncwarp();
    hopper::cluster_arrive();                // phase 2: released to rank 0
    return;
  }
  __syncwarp();
  hopper::cluster_arrive();
  hopper::cluster_wait();                    // phase 2: every peer's partial
  if (warp < NW) {
    float* o = p.out + (head * GT + q0) * DV;
    for (int e = tid; e < GTc * DV; e += 32 * NW) {
      const int r = e / DV;
      float mg = cpart[r];
#pragma unroll
      for (int c = 1; c < cluster_cap(GTP); ++c)
        if (c < C) mg = fmaxf(mg, peers[(c - 1) * PART + r]);
      float f = exp2f(cpart[r] - mg);
      float a = f * cpart[2 * GTP + e], l = f * cpart[GTP + r];
#pragma unroll
      for (int c = 1; c < cluster_cap(GTP); ++c)
        if (c < C) {
          const float* q = peers + (c - 1) * PART;
          f = exp2f(q[r] - mg);
          a += f * q[2 * GTP + e];
          l += f * q[GTP + r];
        }
      o[e] = l > 0.f ? a / l : 0.f;
    }
  }
}

// Launch `kernel` (a __global__ wrapper of body for GTP padded queries a
// chunk) with `bytes` of dynamic shared memory as a (C, Hkv * nq, B) grid
// of C-block clusters, nq = ceil(G * T / GTP).  Returns the launch's
// error: a refused cluster launch never runs.
inline cudaError_t launch(void (*kernel)(Params), int gtp, int bytes,
                          const Params& p, int B, int C, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, p.Hkv * ((p.G * p.T + gtp - 1) / gtp), B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The checks both entry points share; true if the launch may go ahead.
inline bool valid(int B, int Hq, int Hkv, int T, int S, int C) {
  if (B < 0 || Hkv <= 0 || Hq % Hkv != 0 || T <= 0 || S <= 0) return false;
  const int GT = (Hq / Hkv) * T;
  return GT <= MAX_GT && Hkv * ((GT + CHUNK - 1) / CHUNK) <= 65535 &&
         C >= 1 && C <= cluster_cap(GT <= 2 ? 2 : GT);
}

}  // namespace decode_attn
