// RWKV6 ("Finch") time-mix recurrence for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_wkv/kernel.py:53
// (wkv_pallas, body _wkv_kernel :23) and its wrapper's to_bh transposes
// (ops.py:25); the reference recurrence is src/repro/models/rwkv.py:106
// (wkv_scan).
//
// Per (batch b, head h), with the state S (hd x hd, row i = key channel,
// column j = value channel) starting at s0[b, h]:
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r, k, v, w: (B, T, H, hd) float32 contiguous (the model's layout, read
// in place: no transpose); u: (H, hd); s0, s_out: (B, H, hd, hd); y:
// (B, T, H, hd).  s_out may be s0: each block reads its state before it
// writes it, which is how the decode cache is updated in place.  Pads
// need no mask: the caller sets w = 1 and k = 0 there, which leaves S
// unchanged.
//
// What bounds it on the H100: at T = 320 (the verify score) the bytes
// (r/k/v/w/y and the state, 283 MB: 85 us at peak) bound the function; its
// fp32 CUDA-core work, 5 flops per state element per step (2 for
// sum_i r_i S_ij, 3 for the update; the u-term (sum_i r_i u_i k_i) v_j is
// O(hd) a step), is 4.2 GFLOP at B = 16, H = 40, hd = 64, 63 us.  This
// kernel spends 7 flops (four instructions) an element: it keeps
// wkv_scan's order, u*k*v inside the r-sum; factoring the u-term out of
// the element loop would take it to three.  The T sequential steps set a
// latency floor on top.  At T = 1 (a decode step) the state's read and
// write (21 MB) bound it.  Nothing carries between blocks on Hopper,
// so the TPU's walk over time tiles with S in VMEM becomes a loop inside
// one block that keeps S in registers for the whole sequence:
// * one block per (b, h) of 4 * hd threads; thread (p, g) holds rows
//   i = ii * 16 + p (ii < hd / 16) of the four columns 4g .. 4g + 3, so a
//   staged row feeds four columns and a step costs a thread hd / 16
//   shared-memory loads for its 4 * hd / 16 state elements;
// * r, k, w and u*k of a row are packed as one float4 and v as rows of
//   float4, staged in shared memory TC steps at a time in one coalesced
//   pass (rows of hd contiguous floats), so the global latency is paid once
//   per TC steps; y of the chunk goes back the same way;
// * y's four column sums over the 16 row lanes of a half-warp are a
//   butterfly: two shuffles halve the columns a lane carries to two, one
//   to one, two more finish the sum (5 shuffles for 4 columns);
// * registers are the occupancy limit: at most 51 let five 256-thread
//   blocks share an SM, so all B * H = 640 blocks of the slice run in one
//   wave.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 16;   // row lanes sharing a column group
constexpr int TC = 16;      // time steps staged at a time

template <int HD>
__global__ void __launch_bounds__(4 * HD, 1280 / (4 * HD)) wkv_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* y, float* s_out,
    int T, int H) {
  constexpr int NT = 4 * HD;
  constexpr int R = HD / LANES;
  __shared__ float4 rkw_s[TC][HD];   // (r, k, w, u*k) of each row
  __shared__ __align__(16) float v_s[TC][HD];
  __shared__ float y_s[TC][HD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int p = tid % LANES, g = tid / LANES;
  const bool hi = p & 8, mid = p & 4;
  const int col = (hi ? 2 : 0) + (mid ? 1 : 0);   // after the butterfly

  float S[R][4];
  const float4* s_in = reinterpret_cast<const float4*>(s0 + (size_t)bh * HD * HD);
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const float4 x = s_in[(ii * LANES + p) * (HD / 4) + g];
    S[ii][0] = x.x; S[ii][1] = x.y; S[ii][2] = x.z; S[ii][3] = x.w;
  }

  const size_t t_stride = (size_t)H * HD;                 // one time step
  const size_t base = ((size_t)b * T * H + h) * HD;       // (b, 0, h, 0)
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int nt = min(TC, T - t0);
    __syncthreads();          // the previous chunk's y_s is written out
    for (int e = tid; e < nt * HD; e += NT) {
      const int tt = e / HD, c = e % HD;
      const size_t off = base + (size_t)(t0 + tt) * t_stride + c;
      const float kc = k[off];
      rkw_s[tt][c] = make_float4(r[off], kc, w[off], u[h * HD + c] * kc);
      v_s[tt][c] = v[off];
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float4 v4 = reinterpret_cast<const float4*>(v_s[tt])[g];
      const float vc[4] = {v4.x, v4.y, v4.z, v4.w};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const float4 q = rkw_s[tt][ii * LANES + p];    // (r, k, w, u*k)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[c] = fmaf(q.x, fmaf(q.w, vc[c], S[ii][c]), acc[c]);
          S[ii][c] = fmaf(q.z, S[ii][c], q.y * vc[c]);
        }
      }
      // butterfly over the 16 row lanes: keep two columns, then one
      const float a0 = hi ? acc[2] : acc[0], a1 = hi ? acc[3] : acc[1];
      const float b0 = hi ? acc[0] : acc[2], b1 = hi ? acc[1] : acc[3];
      const float c0 = a0 + __shfl_xor_sync(0xffffffffu, b0, 8);
      const float c1 = a1 + __shfl_xor_sync(0xffffffffu, b1, 8);
      float sum = (mid ? c1 : c0) +
                  __shfl_xor_sync(0xffffffffu, mid ? c0 : c1, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((p & 3) == 0) y_s[tt][4 * g + col] = sum;
    }
    __syncthreads();
    for (int e = tid; e < nt * HD; e += NT) {
      const int tt = e / HD, c = e % HD;
      y[base + (size_t)(t0 + tt) * t_stride + c] = y_s[tt][c];
    }
  }

  float4* s_dst = reinterpret_cast<float4*>(s_out + (size_t)bh * HD * HD);
#pragma unroll
  for (int ii = 0; ii < R; ++ii)
    s_dst[(ii * LANES + p) * (HD / 4) + g] =
        make_float4(S[ii][0], S[ii][1], S[ii][2], S[ii][3]);
}

template <int HD>
void launch_hd(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* s_out, int B,
               int T, int H, cudaStream_t stream) {
  wkv_kernel<HD><<<B * H, 4 * HD, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), T, H);
}

}  // namespace

extern "C" int repro_wkv(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0, void* y,
                         void* s_out, int B, int T, int H, int hd,
                         void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (hd == 64) {
    launch_hd<64>(r, k, v, w, u, s0, y, s_out, B, T, H, st);
  } else if (hd == 32) {
    launch_hd<32>(r, k, v, w, u, s0, y, s_out, B, T, H, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
