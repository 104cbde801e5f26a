// Staging and product helpers shared by the SSD scan's forward
// (ssd_scan.cu) and backward (ssd_scan_bwd.cu) kernels: the 64 x 64
// register-tiled f32 product and the loads that stage its operands.
//
// The product: 64 threads, every thread an 8 x 8 micro-tile of the block's
// 64 x 64 output (rows ty·4 + {0..3} and 32 + ty·4 + {0..3}, columns
// likewise with tx), both operands staged k-major in shared memory KT deep
// with a row stride of LD floats, read as float4: four 16-byte loads per
// 64 FMAs.  Staging reads a group of 8 (4 for a float row) consecutive
// elements in 16-byte loads where the group is whole and `vec` says its
// rows keep 16-byte alignment, element by element otherwise; both give the
// same values.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // output tile of a block's product
constexpr int KT = 32;          // depth of one shared-memory step
constexpr int LD = TILE + 4;    // row stride of a staged operand (floats)
constexpr int THREADS = 64;     // 8 x 8 threads, an 8 x 8 micro-tile each
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int MAX_L = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool BF16C>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16C) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Row (or column) of micro-tile entry r of thread t in a 64-wide tile.
__device__ __forceinline__ int frag(int t, int r) {
  return (r < 4 ? 0 : 32) + t * 4 + (r & 3);
}

// acc[r][c] += Σ_k sA[k][frag(ty, r)] · sB[k][frag(tx, c)] over one step.
__device__ __forceinline__ void mma_step(const float* sA, const float* sB,
                                         int ty, int tx, float (&acc)[8][8]) {
#pragma unroll 4
  for (int k = 0; k < KT; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(sA + k * LD + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(sA + k * LD + 32 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(sB + k * LD + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(sB + k * LD + 32 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
  }
}

// 8 consecutive elements as floats, from a 16-byte-aligned address.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};    // two bf16 each, low one first
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

// The first `cnt` of 8 (or 4) consecutive elements at p, zeros after: in
// 16-byte loads when the group is whole and `vec` says its rows keep
// 16-byte alignment, else one by one.  cnt <= 0 reads nothing.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int cnt, bool vec, float (&v)[8]) {
  if (vec && cnt >= 8) {
    load8(p, v);
    return;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = u < cnt ? to_f(p[u]) : 0.f;
}
__device__ __forceinline__ void load4(const float* p, int cnt, bool vec, float (&v)[4]) {
  if (vec && cnt >= 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = u < cnt ? p[u] : 0.f;
}
// The first `cnt` of 4 consecutive floats to p, likewise.
__device__ __forceinline__ void store4(float* p, int cnt, bool vec, float a,
                                       float b, float c, float d) {
  if (vec && cnt >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
    return;
  }
  const float v[4] = {a, b, c, d};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < cnt) p[u] = v[u];
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

// acc += Σ_n M[row0 + r0 + row][n] · S[n][p] over all n < N, rows past l
// zero: 64 rows of B or C (N wide) against one chunk's state, stored
// (N, P).  Its first barrier also publishes what the block staged before.
template <typename TX>
__device__ void rows_times_state(const TX* M, const float* S, size_t row0, int r0,
                                 int l, int N, int P, bool vn, bool vs, float* sA,
                                 float* sB, float (&acc)[8][8]) {
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  for (int n0 = 0; n0 < N; n0 += KT) {
    __syncthreads();
    for (int g = tid; g < TILE * KT / 8; g += THREADS) {  // 8 n at a time, rows fastest
      const int r = g % TILE, k = g / TILE * 8;
      const int n = n0 + k, i = r0 + r;
      float v[8];
      load8(M + (row0 + i) * N + n, i < l ? N - n : 0, vn, v);
#pragma unroll
      for (int u = 0; u < 8; ++u) sA[(k + u) * LD + r] = v[u];
    }
    for (int g = tid; g < KT * TILE / 8; g += THREADS) {  // 8 p at a time
      const int k = g / (TILE / 8), p = g % (TILE / 8) * 8;
      const int n = n0 + k;
      float v[8];
      load8(S + (size_t)n * P + p, n < N ? P - p : 0, vs, v);
      store8(sB + k * LD + p, v);
    }
    __syncthreads();
    mma_step(sA, sB, ty, tx, acc);
  }
}

}  // namespace
