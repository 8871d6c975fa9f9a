// Mamba (S6) selective scan for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes the recurrence with
// jax.lax.scan inside XLA (src/repro/models/mamba.py:101-128, `step` at
// :101-107, the D skip at :130).  The port gives it a kernel so that a
// Mamba layer's no-grad forward is one launch for every T, where a scan in
// PyTorch would be a host loop of T steps of several launches each.
//
// Per row b and inner channel d, with the state s[b, d, 0:DS] (DS = 16):
//     s   = exp(dt_t * A[d, :]) * s + (dt_t * u_t) * B_t[:]
//     y_t = sum_s s[s] * C_t[s] + u_t * D[d]
// dt, u, y: (B, T, di) float32 contiguous (the model's layout, read in
// place); Bc, Cc: (B, T, DS); A: (di, DS) (= -exp(A_log)); D: (di,);
// s: (B, di, DS), read as the initial state and overwritten with the final
// one by the same thread, which is how the decode cache is updated in
// place.  A and s are 16-byte aligned.  Pads need no mask: the caller sets
// dt = 0 there, which leaves the state unchanged.
//
// Bound by bytes: dt, u and y are read or written once each, 0.50 GB at
// jamba-v0.1-52b's B = 16, T = 320, di = 8,192 (0.150 ms at 3.35 TB/s);
// the state's read and write, 16.8 MB, are what a T = 1 decode step moves.
// The work, an exponential and 6 float32 flops per state element a step
// (two products, two fused multiply-adds), runs on the CUDA cores: 0.07 ms
// at the float32 peak for jamba's T = 320, exponentials counted as one.
//
// First design, one kernel for every T:
// * one thread per (b, d), holding its DS states and A[d, :] in registers
//   for the whole sequence (DS consecutive floats: four 16-byte loads);
// * blocks of CH = 128 channels of one row b: the grid is
//   (di / CH, B) = (64, 16) = 1,024 blocks at jamba's width, so the whole
//   batch runs in about one wave of 8 blocks an SM;
// * time in tiles of TT = 16 steps: the tile's B_t and C_t (2 x 16 floats a
//   step, the same for every thread of the block) are staged once in
//   shared memory and read as broadcasts; each thread issues all 2 x TT of
//   its tile's dt and u loads at once (coalesced across the block's
//   channels) before the tile's compute, so one memory round trip serves
//   TT steps;
// * y goes straight to global memory each step (coalesced);
// * expf, not __expf: the kernel stays within the smoke's MAMBA_TOL (1e-4
//   of the output's largest magnitude) of the plain version.
// Nothing carries between blocks: each (b, d) chain is independent.
#include <cuda_runtime.h>

namespace {

constexpr int DS = 16;   // state size a channel (jamba: mamba_d_state 16)
constexpr int CH = 128;  // channels a block, one a thread
constexpr int TT = 16;   // time steps a tile

__device__ __forceinline__ void load16(const float* p, float (&x)[DS]) {
#pragma unroll
  for (int i = 0; i < DS; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    x[i] = q.x; x[i + 1] = q.y; x[i + 2] = q.z; x[i + 3] = q.w;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&x)[DS]) {
#pragma unroll
  for (int i = 0; i < DS; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2],
                                                    x[i + 3]);
}

__global__ void __launch_bounds__(CH)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ u,
                  const float* __restrict__ Bc, const float* __restrict__ Cc,
                  const float* __restrict__ A, const float* __restrict__ D,
                  float* s, float* __restrict__ y, int T, int di) {
  __shared__ __align__(16) float bc[TT][2 * DS];   // B_t then C_t, a step
  const int b = blockIdx.y;
  const int d = blockIdx.x * CH + threadIdx.x;
  const bool live = d < di;
  float a[DS], st[DS];
  float skip = 0.0f;
  float* s_row = s + (static_cast<size_t>(b) * di + d) * DS;
  if (live) {
    load16(A + static_cast<size_t>(d) * DS, a);
    load16(s_row, st);
    skip = D[d];
  } else {
#pragma unroll
    for (int i = 0; i < DS; ++i) a[i] = st[i] = 0.0f;
  }
  const size_t row0 = static_cast<size_t>(b) * T;
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int n = min(TT, T - t0);
    __syncthreads();                  // the last tile's bc has been read
    for (int i = threadIdx.x; i < n * 2 * DS; i += CH) {
      const int tt = i / (2 * DS), j = i % (2 * DS);
      const float* src = j < DS ? Bc : Cc;
      bc[tt][j] = src[(row0 + t0 + tt) * DS + (j % DS)];
    }
    float dtv[TT], uv[TT];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const bool in = live && tt < n;
      const size_t at = (row0 + t0 + tt) * di + d;
      dtv[tt] = in ? dt[at] : 0.0f;
      uv[tt] = in ? u[at] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      if (tt >= n) break;             // n is the same for the whole block
      const float step = dtv[tt];
      const float x = step * uv[tt];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < DS; ++i) {
        st[i] = fmaf(expf(step * a[i]), st[i], x * bc[tt][i]);
        acc = fmaf(st[i], bc[tt][DS + i], acc);
      }
      if (live) y[(row0 + t0 + tt) * di + d] = fmaf(uv[tt], skip, acc);
    }
  }
  if (live) store16(s_row, st);
}

}  // namespace

extern "C" int repro_mamba_scan(const void* dt, const void* u, const void* Bc,
                                const void* Cc, const void* A, const void* D,
                                void* s, void* y, int B, int T, int di, int ds,
                                void* stream) {
  if (ds != DS) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || di <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((di + CH - 1) / CH, B);
  mamba_scan_kernel<<<grid, CH, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dt), static_cast<const float*>(u),
      static_cast<const float*>(Bc), static_cast<const float*>(Cc),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<float*>(s), static_cast<float*>(y), T, di);
  return static_cast<int>(cudaGetLastError());
}
