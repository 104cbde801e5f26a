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
// the f32 pipes (67 TFLOP/s).
//
// Design: the chunk-parallel decomposition of Mamba2's SSD, five kernels
// launched in order on the caller's stream.  The TPU kernel walks the
// chunks in order on one core; here only pass 4 is sequential over the
// chunks, and it is an elementwise recurrence on the states.
//   1. ssd_cumsum_kernel  cs (b, H, nc, l) in f64: one warp per (b, chunk,
//                         head), a shuffle scan 32 positions at a time.  A
//                         difference cs_i − cs_j is taken in f64 and then
//                         rounded to f32 for expf: at chunk 1024 an f32 sum
//                         reaches −1e3, where each of its steps rounds by
//                         ~3e-5 and exp(cs_i − cs_j) of neighbours would
//                         carry that.
//   2. ssd_cb_kernel      C·Bᵀ once per (b, chunk) — not once per head —
//                         stored transposed, CBᵀ (b, nc, j, i), over 64 x 64
//                         tiles with j-tile <= i-tile; tiles above the
//                         diagonal are never written or read.  With bf16
//                         compute the stored value is already rounded.
//   3. ssd_state_kernel   each chunk's own state Σ_j B_j ⊗ (exp(cs_last −
//                         cs_j)·dt_j·x_j) per (b, chunk, head, 64-wide n
//                         tile), stored (b, nc, H, N, P) so that pass 5
//                         reads it along p.
//   4. ssd_pass_kernel    the inter-chunk recurrence, one thread per
//                         (b, head, n, p), sequential over the chunks and in
//                         place: chunk c's own state is replaced by the
//                         state entering chunk c, carried = exp(cs_last)·
//                         carried + own, from h0 or 0; the last carry is h.
//   5. ssd_scan_kernel    y per (b, chunk, head, 64-row tile of i), heaviest
//                         row tiles first: exp(cs_i)·C_i·h_in, then the
//                         diagonal term from the stored CBᵀ tiles j <= i,
//                         with exp(cs_i − cs_j) taken as a difference (the
//                         cumulative log-decays reach −1e3; exp(cs_i)·
//                         exp(−cs_j) would overflow).
// Passes 2, 3 and 5 are one register-tiled f32 product each: 64 threads,
// every thread an 8 x 8 micro-tile of the block's 64 x 64 output (rows
// ty·4 + {0..3} and 32 + ty·4 + {0..3}, columns likewise with tx), both
// operands staged k-major in shared memory 32 deep, read as float4: four
// 16-byte loads per 64 FMAs.  Staging reads a group of 8 (4 for CBᵀ)
// consecutive elements of a row in 16-byte loads where the group is whole
// and the rows of x (P), of B and C (N) or of CBᵀ (chunk) keep 16-byte
// alignment, element by element otherwise; both give the same values.
// P <= 64, N <= 128, chunk <= 1024; the wrapper refuses anything else and
// allocates the scratch (cs, CBᵀ, the states); nothing here allocates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_tiles.cuh"

namespace {

constexpr int PASS_THREADS = 256;

// ---- pass 1: cs[b][h][c][i] = Σ_{i' <= i} dt[b][c·l + i'][h] · A[h], f64 --
__global__ void __launch_bounds__(32)
ssd_cumsum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  double* __restrict__ cs, int H, int l, int nc) {
  const int lane = threadIdx.x;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;   // bc = b·nc + c
  const int bi = bc / nc, c = bc - bi * nc;
  const float Ah = A[h];
  const float* d = dt + (size_t)bc * l * H + h;        // dt[(bc·l + i)·H + h]
  double* out = cs + (((size_t)bi * H + h) * nc + c) * l;
  double carry = 0.0;
  for (int base = 0; base < l; base += 32) {
    const int i = base + lane;
    double v = i < l ? (double)(d[(size_t)i * H] * Ah) : 0.0;  // dt·A in f32
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, v, s);
      if (lane >= s) v += o;
    }
    v += carry;
    if (i < l) out[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// ---- pass 2: cbt[b][c][j][i] = C_i · B_j for 64 x 64 tiles, j-tile <= i-tile
template <typename TX, bool BF16C>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const TX* __restrict__ Bm, const TX* __restrict__ Cm,
              float* __restrict__ cbt, int N, int l, int nt, bool vn) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);   // KT x LD: B rows j, k-major
  float* sB = sA + KT * LD;                      // KT x LD: C rows i, k-major
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int ntri = nt * (nt + 1) / 2;
  const int bc = blockIdx.x / ntri;
  int rem = blockIdx.x - bc * ntri, ti = 0;      // (ti, tj) in row order
  while (rem > ti) { rem -= ti + 1; ++ti; }
  const int j0 = rem * TILE, i0 = ti * TILE;
  const size_t row0 = (size_t)bc * l;            // the chunk's first row of B, C

  float acc[8][8];
  zero(acc);
  for (int n0 = 0; n0 < N; n0 += KT) {
    __syncthreads();
    for (int g = tid; g < TILE * KT / 8; g += THREADS) {  // 8 n at a time, rows fastest
      const int r = g % TILE, k = g / TILE * 8;
      const int n = n0 + k, j = j0 + r, i = i0 + r;
      float bv[8], cv[8];
      load8(Bm + (row0 + j) * N + n, j < l ? N - n : 0, vn, bv);
      load8(Cm + (row0 + i) * N + n, i < l ? N - n : 0, vn, cv);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        sA[(k + u) * LD + r] = rnd<BF16C>(bv[u]);
        sB[(k + u) * LD + r] = rnd<BF16C>(cv[u]);
      }
    }
    __syncthreads();
    mma_step(sA, sB, ty, tx, acc);
  }
  float* out = cbt + row0 * l;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = j0 + frag(ty, r);
    if (j >= l) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = i0 + frag(tx, c);
      if (i < l) out[(size_t)j * l + i] = rnd<BF16C>(acc[r][c]);
    }
  }
}

// ---- pass 3: st[b][c][h][n][p] = Σ_j B_j[n] · exp(cs_last − cs_j)·dt_j·x_j[p]
template <typename TX>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                 const TX* __restrict__ Bm, const double* __restrict__ cs,
                 float* __restrict__ st, int H, int P, int N, int l, int nc,
                 bool vx, bool vn) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);   // KT x LD: B[j][n]
  float* sB = sA + KT * LD;                      // KT x LD: weighted x[j][p]
  float* sW = sB + KT * LD;                      // l: exp(cs_last − cs_j)·dt_j
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int ntn = (N + TILE - 1) / TILE;
  const int n0 = (blockIdx.x % ntn) * TILE;
  const int bch = blockIdx.x / ntn;              // (b·nc + c)·H + h
  const int h = bch % H, bc = bch / H;
  const int bi = bc / nc, c = bc - bi * nc;
  const size_t row0 = (size_t)bc * l;
  const double* csr = cs + (((size_t)bi * H + h) * nc + c) * l;
  const double last = csr[l - 1];
  for (int j = tid; j < l; j += THREADS)
    sW[j] = expf((float)(last - csr[j])) * dt[(row0 + j) * H + h];

  float acc[8][8];
  zero(acc);
  for (int j0 = 0; j0 < l; j0 += KT) {
    __syncthreads();                             // also publishes sW
    for (int g = tid; g < KT * TILE / 8; g += THREADS) {  // 8 n or p at a time
      const int k = g / (TILE / 8), r = g % (TILE / 8) * 8;
      const int j = j0 + k, n = n0 + r;
      float bv[8], xv[8];
      load8(Bm + (row0 + j) * N + n, j < l ? N - n : 0, vn, bv);
      load8(x + ((row0 + j) * H + h) * P + r, j < l ? P - r : 0, vx, xv);
      const float w = j < l ? sW[j] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) xv[u] *= w;
      store8(sA + k * LD + r, bv);
      store8(sB + k * LD + r, xv);
    }
    __syncthreads();
    mma_step(sA, sB, ty, tx, acc);
  }
  float* out = st + (size_t)bch * N * P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + frag(ty, r);
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int p = frag(tx, c);
      if (p < P) out[(size_t)n * P + p] = acc[r][c];
    }
  }
}

// ---- pass 4: states entering each chunk, in place; the last carry is h --
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(const double* __restrict__ cs, const float* __restrict__ h0,
                float* __restrict__ st, float* __restrict__ hout, int H,
                int P, int N, int l, int nc, size_t total) {
  const size_t e = (size_t)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= total) return;                        // e over (b, h, n, p), p fastest
  const int p = (int)(e % P);
  const size_t bhn = e / P;
  const int n = (int)(bhn % N);
  const size_t bh = bhn / N;
  const int h = (int)(bh % H);
  const size_t bi = bh / H;
  const size_t nstride = (size_t)N * P;
  const size_t hstride = (size_t)H * nstride;    // one chunk of st
  float* s = st + (bi * nc * H + h) * nstride + (size_t)n * P + p;
  const double* csr = cs + bh * nc * l + (l - 1);
  float carried = h0 ? h0[(bh * P + p) * N + n] : 0.f;
  constexpr int U = 8;                           // chunks whose loads go out together
  for (int c0 = 0; c0 < nc; c0 += U) {
    float own[U], dec[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < nc) {
        own[u] = s[(size_t)(c0 + u) * hstride];
        dec[u] = expf((float)csr[(size_t)(c0 + u) * l]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < nc) {
        s[(size_t)(c0 + u) * hstride] = carried;
        carried = carried * dec[u] + own[u];
      }
    }
  }
  hout[(bh * P + p) * N + n] = carried;
}

// ---- pass 5: y for one 64-row tile of query positions ----------------------
template <typename TX, bool BF16C>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const TX* __restrict__ Cm, const double* __restrict__ cs,
                const float* __restrict__ cbt, const float* __restrict__ st,
                float* __restrict__ y, int H, int P, int N, int l, int nc,
                int nt, bool vx, bool vn) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);   // KT x LD: C (then G) rows i
  float* sB = sA + KT * LD;                      // KT x LD: h_in (then dt·x) cols p
  double* sCS = reinterpret_cast<double*>(sB + KT * LD);  // cs[0, jend)
  float* sDT = reinterpret_cast<float*>(sCS + l);         // dt[0, jend)
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int nbch = gridDim.x / nt;               // b·nc·H
  const int ti = nt - 1 - (int)blockIdx.x / nbch;  // heaviest row tiles first
  const int bch = blockIdx.x % nbch;             // (b·nc + c)·H + h
  const int h = bch % H, bc = bch / H;
  const int bi = bc / nc, c = bc - bi * nc;
  const int i0 = ti * TILE;
  const int jend = min(l, i0 + TILE);            // positions that reach this tile
  const bool vl = (l & 3) == 0;                  // CBᵀ rows as float4
  const size_t row0 = (size_t)bc * l;
  const double* csr = cs + (((size_t)bi * H + h) * nc + c) * l;
  for (int j = tid; j < jend; j += THREADS) {
    sCS[j] = csr[j];
    sDT[j] = dt[(row0 + j) * H + h];
  }

  float acc[8][8];
  zero(acc);
  // inbound state: Σ_n C_i[n] · h_in[n][p]; the first barrier publishes sCS, sDT
  rows_times_state(Cm, st + (size_t)bch * N * P, row0, i0, l, N, P, vn, vx, sA,
                   sB, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + frag(ty, r);
    const float dec = i < l ? expf((float)sCS[i]) : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] *= dec;
  }
  // intra-chunk: Σ_{j <= i} rnd(rnd(C_i·B_j)·exp(cs_i − cs_j)) · rnd(dt_j·x_j)
  const float* cb = cbt + row0 * l;
  for (int j0 = 0; j0 < jend; j0 += KT) {
    __syncthreads();
    for (int g = tid; g < KT * TILE / 4; g += THREADS) {  // 4 i at a time
      const int k = g / (TILE / 4), r = g % (TILE / 4) * 4;
      const int j = j0 + k, i = i0 + r;
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < jend && j <= i + 3) {
        float cbv[4];
        load4(cb + (size_t)j * l + i, l - i, vl, cbv);
        const double cj = sCS[j];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j <= i + q && i + q < l)
            gv[q] = rnd<BF16C>(cbv[q] * expf((float)(sCS[i + q] - cj)));
      }
      *reinterpret_cast<float4*>(sA + k * LD + r) = make_float4(gv[0], gv[1], gv[2], gv[3]);
    }
    for (int g = tid; g < KT * TILE / 8; g += THREADS) {  // 8 p at a time
      const int k = g / (TILE / 8), p = g % (TILE / 8) * 8;
      const int j = j0 + k;
      float v[8];
      load8(x + ((row0 + j) * H + h) * P + p, j < jend ? P - p : 0, vx, v);
      const float d = j < jend ? sDT[j] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = rnd<BF16C>(v[u] * d);
      store8(sB + k * LD + p, v);
    }
    __syncthreads();
    mma_step(sA, sB, ty, tx, acc);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + frag(ty, r);
    if (i >= l) continue;
    float* yr = y + ((row0 + i) * H + h) * P;
    store4(yr + tx * 4, P - tx * 4, vx, acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    store4(yr + 32 + tx * 4, P - 32 - tx * 4, vx, acc[r][4], acc[r][5], acc[r][6],
           acc[r][7]);
  }
}

template <typename TX, bool BF16C>
cudaError_t launch(const void* x_, const float* dt, const float* A,
                   const void* B_, const void* C_, const float* h0, float* y,
                   float* hout, double* cs, float* cbt, float* st, int b,
                   int T, int H, int P, int N, int l, cudaStream_t s) {
  const TX* x = static_cast<const TX*>(x_);
  const TX* Bm = static_cast<const TX*>(B_);
  const TX* Cm = static_cast<const TX*>(C_);
  const int nc = T / l, nt = (l + TILE - 1) / TILE;
  const int ntn = (N + TILE - 1) / TILE;
  const size_t tiles = sizeof(float) * 2 * KT * LD;
  const size_t total = (size_t)b * H * N * P;
  // 16-byte loads where rows of x, the states and y (P) and of B, C (N)
  // come in whole groups of 8; the scratch and y are aligned
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vx = P % 8 == 0 && aligned(x_);
  const bool vn = N % 8 == 0 && aligned(B_) && aligned(C_);
  cudaError_t err;
  ssd_cumsum_kernel<<<b * nc * H, 32, 0, s>>>(dt, A, cs, H, l, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_cb_kernel<TX, BF16C><<<b * nc * (nt * (nt + 1) / 2), THREADS, tiles, s>>>(
      Bm, Cm, cbt, N, l, nt, vn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_kernel<TX><<<b * nc * H * ntn, THREADS, tiles + sizeof(float) * l, s>>>(
      x, dt, Bm, cs, st, H, P, N, l, nc, vx, vn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_pass_kernel<<<(unsigned)((total + PASS_THREADS - 1) / PASS_THREADS),
                    PASS_THREADS, 0, s>>>(cs, h0, st, hout, H, P, N, l, nc, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_scan_kernel<TX, BF16C><<<b * nc * H * nt, THREADS,
                               tiles + (sizeof(double) + sizeof(float)) * l, s>>>(
      x, dt, Cm, cs, cbt, st, y, H, P, N, l, nc, nt, vx, vn);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C alike); dt, A, h0 f32.
// bf16_compute: 1 rounds the intra-chunk product operands to bfloat16.
// h0 may be null (zero initial state).  Scratch on the device of x: cs
// (b, H, T/l, l) f64, cbt (b, T/l, l, l) and st (b, T/l, H, N, P) f32.
// Launches the five passes on `stream` and returns the first CUDA error.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* B, const void* C, const void* h0,
                          void* y, void* hout, void* cs, void* cbt, void* st,
                          int dtype, int bf16_compute, int b, int T, int H,
                          int P, int N, int l, void* stream) {
  if (b <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      l <= 0 || l > MAX_L || T % l)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* hp = static_cast<float*>(hout);
  double* csp = static_cast<double*>(cs);
  float* cbp = static_cast<float*>(cbt);
  float* stp = static_cast<float*>(st);
  cudaError_t err;
  if (dtype == 0 && !bf16_compute)
    err = launch<float, false>(x, dtp, Ap, B, C, h0p, yp, hp, csp, cbp, stp, b, T, H, P, N, l, s);
  else if (dtype == 0)
    err = launch<float, true>(x, dtp, Ap, B, C, h0p, yp, hp, csp, cbp, stp, b, T, H, P, N, l, s);
  else if (dtype == 1 && !bf16_compute)
    err = launch<__nv_bfloat16, false>(x, dtp, Ap, B, C, h0p, yp, hp, csp, cbp, stp, b, T, H, P, N, l, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, true>(x, dtp, Ap, B, C, h0p, yp, hp, csp, cbp, stp, b, T, H, P, N, l, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
