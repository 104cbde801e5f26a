// Mamba2 SSD chunked scan (state-space duality) — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` in
// src/repro/kernels/ssd_scan.py (called through `ssd_scan`, helper
// `_segsum`) and computes what the model's `ssd_chunked` computes, chunk by
// chunk of l positions, with one B/C group shared by every head:
//   cs     = cumsum(dt·A) inside the chunk
//   y_i    = Σ_{j≤i} (C_i·B_j)·exp(cs_i − cs_j)·dt_j·x_j  +  exp(cs_i)·C_i·h_prev
//   h_new  = exp(cs_last)·h_prev + Σ_j B_j ⊗ (exp(cs_last − cs_j)·dt_j·x_j)
// with the state h (P, N) in f32 across chunks, an optional initial state
// h0, and `compute_dtype` bfloat16 rounding where `ssd_chunked` rounds
// (C·Bᵀ, the gated scores and dt·x), so the intra-chunk products see the
// same operands.  y and the final h come out in f32.
//
// What bounds it on an H100: operations.  Per (batch, chunk) it does
// ~l²·N flops of C·Bᵀ and per head ~l²·P + 4·l·N·P, against l·H·P·(2 + 4)
// bytes of x and y: ~100 flops per byte at the main path's shape, all on
// the f32 pipes (67 TFLOP/s), and below that shared-memory bandwidth.
//
// Design:
//   * One block per (batch, head), 256 threads; the chunk loop runs inside
//     the block in order, in place of the TPU's sequential grid axis, and
//     the (P, N) state lives in shared memory for the whole sequence.
//   * The TPU kernel builds the (H, l, l) decay matrix L whole; at l = 256
//     one head's L alone is 256 KB, more than a block's 227 KB.  Here the
//     chunk is cut into 64-row tiles of query positions i and 64-row tiles
//     of source positions j ≤ i; exp(cs_i − cs_j) is computed on the fly
//     for each (i, j) of a tile and is 0 above the diagonal (tiles with
//     j > i are never visited).
//   * C·Bᵀ is recomputed by every head's block (one 64 x 64 tile at a
//     time) instead of being shared across the H blocks of a batch row:
//     simple, and it doubles the intra-chunk work.
//   * Each thread owns a 4 x 4 micro-tile (rows ty + 16a, columns
//     tx + 16b) of the score tile and of the y tile, and a 4 x 8 micro-tile
//     of the state for the update; B and C tiles use a padded row stride
//     (N + 1) so the 16 threads reading 16 rows hit 16 banks.
//   * P <= 64, N <= 128, chunk <= 1024; the wrapper refuses anything else.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;
constexpr int LDG = TILE + 1;
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool BF16C>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16C) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <typename TX, bool BF16C>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const TX* __restrict__ Bm,
           const TX* __restrict__ Cm, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ hout, int H, int T,
           int P, int N, int l) {
  extern __shared__ float smem[];
  const int LDN = N + 1;
  float* sH = smem;                  // P x LDN   state h[p][n]
  float* sC = sH + P * LDN;          // TILE x LDN
  float* sB = sC + TILE * LDN;       // TILE x LDN
  float* sX = sB + TILE * LDN;       // TILE x P  (dt·x, or decayed dt·x)
  float* sG = sX + TILE * P;         // TILE x LDG gated scores
  float* sCS = sG + TILE * LDG;      // l  cumulative log-decay
  float* sDT = sCS + l;              // l  dt

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.x / H, h = blockIdx.x % H;
  const float Ah = A[h];
  const size_t bh = (size_t)bi * H + h;

  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx / N, n = idx - p * N;
    sH[p * LDN + n] = h0 ? h0[bh * P * N + idx] : 0.f;
  }

  const int nchunks = T / l;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * l;
    __syncthreads();  // the previous chunk is done with sCS/sDT and sH
    for (int i = tid; i < l; i += THREADS)
      sDT[i] = dt[((size_t)bi * T + t0 + i) * H + h];
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum of dt·A over the chunk
      float carry = 0.f;
      for (int base = 0; base < l; base += 32) {
        const int i = base + lane;
        float vsum = i < l ? sDT[i] * Ah : 0.f;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, vsum, d);
          if (lane >= d) vsum += o;
        }
        vsum += carry;
        if (i < l) sCS[i] = vsum;
        carry = __shfl_sync(0xffffffffu, vsum, 31);
      }
    }
    __syncthreads();
    const float cs_last = sCS[l - 1];

    // ---- y for each 64-row tile of query positions -------------------
    for (int i0 = 0; i0 < l; i0 += TILE) {
      __syncthreads();
      for (int idx = tid; idx < TILE * N; idx += THREADS) {
        const int r = idx / N, n = idx - r * N;
        sC[r * LDN + n] = i0 + r < l
            ? to_f(Cm[((size_t)bi * T + t0 + i0 + r) * N + n]) : 0.f;
      }
      __syncthreads();
      // inbound state: exp(cs_i) · C_i · h_prev
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int n = 0; n < N; ++n) {
          const float cv = sC[(ty + 16 * a) * LDN + n];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = tx + 16 * b;
            if (p < P) s[b] = __fmaf_rn(cv, sH[p * LDN + n], s[b]);
          }
        }
        const float dec = i < l ? expf(sCS[i]) : 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = s[b] * dec;
      }
      // intra-chunk: (L ⊙ C·Bᵀ)·(dt·x) over source tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        __syncthreads();
        for (int idx = tid; idx < TILE * N; idx += THREADS) {
          const int r = idx / N, n = idx - r * N;
          sB[r * LDN + n] = j0 + r < l
              ? to_f(Bm[((size_t)bi * T + t0 + j0 + r) * N + n]) : 0.f;
        }
        for (int idx = tid; idx < TILE * P; idx += THREADS) {
          const int r = idx / P, p = idx - r * P;
          const int j = j0 + r;
          sX[idx] = j < l
              ? rnd<BF16C>(to_f(x[(((size_t)bi * T + t0 + j) * H + h) * P + p]) * sDT[j])
              : 0.f;
        }
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) g[a][b] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = rnd<BF16C>(sC[(ty + 16 * a) * LDN + n]);
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = rnd<BF16C>(sB[(tx + 16 * b) * LDN + n]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) g[a][b] = __fmaf_rn(cv[a], bv[b], g[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + tx + 16 * b;
            float gv = 0.f;
            if (j <= i && i < l)
              gv = rnd<BF16C>(rnd<BF16C>(g[a][b]) * expf(sCS[i] - sCS[j]));
            sG[(ty + 16 * a) * LDG + tx + 16 * b] = gv;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < TILE; ++jj) {
          float gv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) gv[a] = sG[(ty + 16 * a) * LDG + jj];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = tx + 16 * b;
            if (p < P) {
              const float xv = sX[jj * P + p];
#pragma unroll
              for (int a = 0; a < 4; ++a) acc[a][b] = __fmaf_rn(gv[a], xv, acc[a][b]);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= l) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = tx + 16 * b;
          if (p < P) y[(((size_t)bi * T + t0 + i) * H + h) * P + p] = acc[a][b];
        }
      }
    }

    // ---- state: h = exp(cs_last)·h + Σ_j B_j ⊗ (exp(cs_last − cs_j)·dt_j·x_j)
    float hs[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) hs[a][e] = 0.f;
    for (int j0 = 0; j0 < l; j0 += TILE) {
      __syncthreads();
      for (int idx = tid; idx < TILE * N; idx += THREADS) {
        const int r = idx / N, n = idx - r * N;
        sB[r * LDN + n] = j0 + r < l
            ? to_f(Bm[((size_t)bi * T + t0 + j0 + r) * N + n]) : 0.f;
      }
      for (int idx = tid; idx < TILE * P; idx += THREADS) {
        const int r = idx / P, p = idx - r * P;
        const int j = j0 + r;
        sX[idx] = j < l
            ? to_f(x[(((size_t)bi * T + t0 + j) * H + h) * P + p]) *
                  (expf(cs_last - sCS[j]) * sDT[j])
            : 0.f;
      }
      __syncthreads();
      const int jn = min(TILE, l - j0);
      for (int jj = 0; jj < jn; ++jj) {
        float xv[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int p = ty + 16 * a;
          xv[a] = p < P ? sX[jj * P + p] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = tx + 16 * e;
          bv[e] = n < N ? sB[jj * LDN + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 8; ++e) hs[a][e] = __fmaf_rn(xv[a], bv[e], hs[a][e]);
      }
    }
    __syncthreads();  // every y tile has read the old state
    const float decay = expf(cs_last);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int p = ty + 16 * a;
      if (p >= P) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int n = tx + 16 * e;
        if (n < N) sH[p * LDN + n] = sH[p * LDN + n] * decay + hs[a][e];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx / N, n = idx - p * N;
    hout[bh * P * N + idx] = sH[p * LDN + n];
  }
}

template <typename TX, bool BF16C>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* h0, float* y,
                   float* hout, int b, int T, int H, int P, int N, int l,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)P * (N + 1) + 2 * TILE * (N + 1) + TILE * P + TILE * LDG + 2 * l);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<TX, BF16C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<TX, BF16C><<<b * H, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), dt, A, static_cast<const TX*>(B),
      static_cast<const TX*>(C), h0, y, hout, H, T, P, N, l);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C alike); dt, A, h0 f32.
// bf16_compute: 1 rounds the intra-chunk product operands to bfloat16.
// h0 may be null (zero initial state).  Returns the CUDA error of the
// launch.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, const void* h0,
                          void* y, void* hout, int dtype, int bf16_compute,
                          int b, int T, int H, int P, int N, int l,
                          void* stream) {
  if (b <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      l <= 0 || l > 1024 || T % l)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* hp = static_cast<float*>(hout);
  cudaError_t err;
  if (dtype == 0 && !bf16_compute)
    err = launch<float, false>(x, dtp, Ap, B, C, h0p, yp, hp, b, T, H, P, N, l, s);
  else if (dtype == 0)
    err = launch<float, true>(x, dtp, Ap, B, C, h0p, yp, hp, b, T, H, P, N, l, s);
  else if (dtype == 1 && !bf16_compute)
    err = launch<__nv_bfloat16, false>(x, dtp, Ap, B, C, h0p, yp, hp, b, T, H, P, N, l, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, true>(x, dtp, Ap, B, C, h0p, yp, hp, b, T, H, P, N, l, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
