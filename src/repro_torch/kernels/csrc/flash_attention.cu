// Flash attention forward (causal / sliding-window GQA) — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py (called through `flash_attention`)
// and computes what it computes: softmax(q·kᵀ·D^-0.5 + mask)·v with an
// online softmax, m, l and acc in f32, P rounded to v's dtype before P·V,
// masked scores set to NEG = -1e9, kv tiles that are entirely masked
// skipped, the GQA kv head h / group read in place, output in q's dtype.
// It adds `q_offset` (absolute position of q row 0 against k row 0), which
// the model's attention takes.
//
// What bounds it on an H100: operations.  4·D flops per (query, key) pair
// against 2·D·bytes per row of q, k, v and o: at D = 80 and S = T = 4096
// that is ~1000 flops per byte, far above the card's ~295 bf16 flops per
// byte.  This first kernel does its products on the f32 pipes, not on the
// tensor cores (a later PR moves them to wgmma), so its ceiling is the
// 67 TFLOP/s f32 rate and, below that, shared-memory bandwidth.
//
// Design:
//   * One block per (batch·head, 64-row q tile), 256 threads; the kv loop
//     runs inside the block over 64-row tiles, in place of the TPU's
//     sequential grid axis.  Tiles the causal or window mask hides from
//     every row of the q tile are skipped, as the TPU kernel skips them.
//   * q, k and v tiles are converted to f32 into shared memory with a
//     padded row stride (D + 1 floats), so the 16 threads that read 16
//     different k rows hit 16 different banks.
//   * Each thread owns a 4 x 4 micro-tile of the 64 x 64 score tile (rows
//     ty + 16a, keys tx + 16b): 8 shared loads per 16 FMAs.  The row max
//     and row sum of the online softmax reduce over the 16 lanes that own
//     a row with two-level xor shuffles; m and l stay in registers.
//   * P goes through shared memory (rounded to v's dtype); each thread
//     then owns 4 rows x D/16 columns of acc in registers.
//   * Any strides with a unit last axis: the model passes its (B, S, H, D)
//     tensors as (B, H, S, D) views, so nothing is transposed or copied.
//   * D is a template parameter, any multiple of 16 up to 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;

struct Strides {  // elements, for (batch, head, row) of q, k, v, o
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T's precision (P is cast to v's dtype before P·V)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int d = 8; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int d = 8; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides st, int H,
          int group, int S, int Tk, float scale, int causal, int window,
          int q_offset) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // BQ x LD
  float* sK = sQ + BQ * LD;     // BK x LD
  float* sV = sK + BK * LD;     // BK x LD
  float* sP = sV + BK * LD;     // BQ x LDP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / group;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];
  T* ob = o + b * st.o[0] + h * st.o[1];

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    sQ[r * LD + d] = q0 + r < S ? to_f(qb[(q0 + r) * st.q[2] + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[a][j] = 0.f;
  }

  // absolute positions of the first and last row of this q tile
  const int qlo = q0 + q_offset;
  const int qhi = q0 + BQ - 1 + q_offset;
  const int nk = (Tk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (causal && k0 > qhi) break;                      // later tiles too
    if (window > 0 && k0 + BK - 1 <= qlo - window) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      const bool ok = k0 + r < Tk;
      sK[r * LD + d] = ok ? to_f(kb[(k0 + r) * st.k[2] + d]) : 0.f;
      sV[r * LD + d] = ok ? to_f(vb[(k0 + r) * st.v[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = sQ[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = sK[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = __fmaf_rn(qa[a], kc[c], s[a][c]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty + 16 * a + q_offset;
      float rmax = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[a][c] = ok ? s[a][c] * scale : NEG;
        rmax = fmaxf(rmax, s[a][c]);
      }
      const float m_new = fmaxf(m[a], max16(rmax));
      const float alpha = expf(m[a] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);
        rsum += p;
        sP[(ty + 16 * a) * LDP + tx + 16 * c] = round_to<T>(p);
      }
      l[a] = l[a] * alpha + sum16(rsum);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = sP[(ty + 16 * a) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sV[c * LD + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][j] = __fmaf_rn(pa[a], vv, acc[a][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[r * st.o[2] + tx + 16 * j] = from_f<T>(acc[a][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Strides& st, int B, int H, int Hkv, int S, int Tk,
                   float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  fa_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, H, H / Hkv, S, Tk,
      scale, causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, const Strides& st, int B, int H, int Hkv,
                       int S, int Tk, float scale, int causal, int window,
                       int q_offset, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 32: return launch<T, 32>(q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 48: return launch<T, 48>(q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 80: return launch<T, 80>(q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 96: return launch<T, 96>(q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 112: return launch<T, 112>(q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  strides: 12
// int64 element strides, (batch, head, row) of q, k, v, o in that order.
// window <= 0 means none.  Returns the CUDA error of the launch.
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         int dtype, int B, int H, int Hkv, int S, int Tk, int D,
                         const long long* strides, float scale, int causal,
                         int window, int q_offset, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
