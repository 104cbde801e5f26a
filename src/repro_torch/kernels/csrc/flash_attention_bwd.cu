// Flash attention backward (causal / sliding-window GQA) — CUDA C++ for sm_90a.
//
// The gradient of `flash_attention` (csrc/flash_attention.cu): dQ, dK and
// dV of softmax(q·kᵀ·D^-0.5 + mask)·v on the forward's layouts, q and o
// (B, H, S, D), k and v (B, Hkv, T, D), any strides with a unit last axis,
// float32 or bfloat16, GQA (kv head h / group), causal or not, `window`
// and `q_offset`.  The JAX package has no backward kernel: there XLA
// differentiates the model's `chunked_attention`.  This kernel is what
// lets the port train through its forward kernel.
//
// What it differentiates is the forward kernel as it runs, masked rows
// included.  Masked scores are NEG = -1e9, and the forward skips every kv
// tile that no row of a 64-row q group (aligned at multiples of 64) can
// see: tiles of `kv_tile` = 64 rows for float32 (the SIMT kernel's), 128
// for bfloat16 (the wgmma kernel's, per warpgroup).  A row whose visited
// keys are all masked therefore averages v over every slot of its visited
// tiles (padding past T counts in the sum l and adds nothing), and a row
// with no visited tile is 0.  The backward recomputes the same statistics
// over the same tiles, so it is the gradient of that function: such a row
// sends dO/l to dV of its visited keys and nothing to dQ or dK.  The
// forward's rounding of P to bfloat16 before P·V is taken as the identity.
//
// Three launches, no atomics, so the result is deterministic:
//   1. `fa_bwd_stats_kernel`, one block per (b·h, 64-row q tile): the
//      row's max m and 1/l over the visited slots, recomputed with the
//      forward's online softmax, and Δ = rowsum(dO ∘ O) in f32;
//   2. `fa_bwd_dkdv_kernel`, one block per (b·hkv, 64-row k tile): over the
//      H/Hkv query heads of the group and every q tile the mask lets
//      through, P = exp(s - m)/l, dV += Pᵀ·dO, dP = dO·Vᵀ,
//      dS = P ∘ (dP - Δ) (0 where masked), dK += dSᵀ·Q; both accumulate in
//      f32 registers and are written once (dK times D^-0.5);
//   3. `fa_bwd_dq_kernel`, one block per (b·h, 64-row q tile): over the kv
//      tiles the mask lets through, dQ += dS·K, written once times D^-0.5.
//
// What bounds it on an H100: operations.  Five products of 2·D flops per
// (query, key) pair are the least work (Q·Kᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K);
// this design does eight (Q·Kᵀ three times, dO·Vᵀ twice), all in f32 on
// the SIMT pipes: 256 threads a block, each a 4 x 4 micro-tile of the
// 64 x 64 score tile (row max and sum over the 16 lanes of a row by xor
// shuffles, as in the forward's SIMT kernel), operands converted to f32 in
// shared memory with rows of D + 1 floats.  A right kernel first: the
// tensor cores, and the forward saving its log-sum-exp, are later work.
//
// D is a template parameter, any multiple of 16 up to 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;
constexpr int BQ = 64;           // q rows per tile
constexpr int BK = 64;           // k rows per tile
constexpr int THREADS = 256;     // 16 x 16, each a 4 x 4 micro-tile
constexpr int LDP = BK + 1;

struct Strides {  // elements, for (batch, head, row)
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

struct Problem {
  int B, H, group, S, Tk;
  float scale;
  int causal, window, q_offset, kv_tile;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// Whether the forward visits the kv tile holding key k0 for the 64-row q
// group starting at q row g0 (its skip rule, per group and kv tile).
__device__ __forceinline__ bool visited(const Problem& p, int g0, int k0) {
  const int kv0 = (k0 / p.kv_tile) * p.kv_tile;
  const int glo = g0 + p.q_offset, ghi = glo + BQ - 1;
  return (!p.causal || kv0 <= ghi) &&
         (p.window <= 0 || kv0 + p.kv_tile - 1 > glo - p.window);
}

__device__ __forceinline__ bool unmasked(const Problem& p, int qpos, int kpos) {
  bool ok = kpos < p.Tk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// rows x D of a (row, d) tile with row stride `rs`, as f32 in shared memory
// (row stride D + 1); rows at or past `n` read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long rs,
                                          int row0, int n) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    dst[r * LD + d] = row0 + r < n ? to_f32(src[(long long)(row0 + r) * rs + d]) : 0.f;
  }
}

// acc[a][c] = Σ_d A[ty + 16a][d] · B[tx + 16c][d] over shared tiles.
template <int D>
__device__ __forceinline__ void dot_tile(const float* sA, const float* sB, int ty,
                                         int tx, float (&acc)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = sA[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = sB[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = __fmaf_rn(x[a], y[c], acc[a][c]);
  }
}

// ------------------------------------------------------------ 1. statistics
// stats: three planes of B·H·S floats: m, 1/l (0 where l = 0) and Δ.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ stats, Strides st, Problem p) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const long long plane = (long long)p.B * p.H * p.S;
  const long long row_base = (long long)bh * p.S;

  {  // Δ = rowsum(dO ∘ O): four lanes a row
    const int r = tid >> 2, part = tid & 3;
    const T* ob = o + b * st.o[0] + h * st.o[1] + (long long)(q0 + r) * st.o[2];
    const T* gb = dout + b * st.dout[0] + h * st.dout[1] + (long long)(q0 + r) * st.dout[2];
    float sum = 0.f;
    if (q0 + r < p.S)
      for (int d = part; d < D; d += 4) sum = __fmaf_rn(to_f32(gb[d]), to_f32(ob[d]), sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0 && q0 + r < p.S) stats[2 * plane + row_base + q0 + r] = sum;
  }

  load_tile<T, D>(sQ, q + b * st.q[0] + h * st.q[1], st.q[2], q0, p.S);
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
  }
  const int slots = (p.Tk + p.kv_tile - 1) / p.kv_tile * p.kv_tile;
  for (int k0 = 0; k0 < slots; k0 += BK) {
    if (!visited(p, q0, k0)) continue;
    __syncthreads();
    load_tile<T, D>(sK, kb, st.k[2], k0, p.Tk);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty + 16 * a + p.q_offset;
      float rmax = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = unmasked(p, qpos, k0 + tx + 16 * c) ? s[a][c] * p.scale : NEG;
        rmax = fmaxf(rmax, s[a][c]);
      }
      const float m_new = fmaxf(m[a], max16(rmax));
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) rsum += expf(s[a][c] - m_new);
      l[a] = l[a] * expf(m[a] - m_new) + sum16(rsum);
      m[a] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = q0 + ty + 16 * a;
      if (r >= p.S) continue;
      stats[row_base + r] = m[a];
      stats[plane + row_base + r] = l[a] > 0.f ? 1.f / l[a] : 0.f;
    }
  }
}

// P and dS of one (q tile, k tile) pair from the scores s = Q·Kᵀ and
// dp = dO·Vᵀ (both raw sums), the rows' statistics in shared memory.
__device__ __forceinline__ void probs(const Problem& p, const float* sM,
                                      const float* sL, const float* sDelta,
                                      int q0, int k0, int ty, int tx,
                                      float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int qpos = q0 + r + p.q_offset;
    const float m = sM[r], inv_l = sL[r], delta = sDelta[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = unmasked(p, qpos, k0 + tx + 16 * c);
      const float pr = expf((ok ? s[a][c] * p.scale : NEG) - m) * inv_l;
      s[a][c] = pr;                                  // P
      dp[a][c] = ok ? pr * (dp[a][c] - delta) : 0.f;  // dS
    }
  }
}

template <int R>
__device__ __forceinline__ void load_stats(float* sM, float* sL, float* sDelta,
                                           const float* stats, long long plane,
                                           long long row_base, int q0, int S) {
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const bool in = q0 + r < S;
    sM[r] = in ? stats[row_base + q0 + r] : INFINITY;   // P = 0 past S
    sL[r] = in ? stats[plane + row_base + q0 + r] : 0.f;
    sDelta[r] = in ? stats[2 * plane + row_base + q0 + r] : 0.f;
  }
}

// ------------------------------------------------------------ 2. dK and dV
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ stats, T* __restrict__ dk,
                   T* __restrict__ dv, Strides st, Problem p) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sG = sQ + BQ * LD;        // dO
  float* sP = sG + BQ * LD;        // P, then dS: BQ x LDP
  float* sM = sP + BQ * LDP;
  float* sL = sM + BQ;
  float* sDelta = sL + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int bhk = blockIdx.y, Hkv = p.H / p.group, b = bhk / Hkv, hk = bhk % Hkv;
  const long long plane = (long long)p.B * p.H * p.S;
  load_tile<T, D>(sK, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, p.Tk);
  load_tile<T, D>(sV, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, p.Tk);

  float acc_k[4][DJ], acc_v[4][DJ];   // key rows ty + 16a, columns tx + 16j
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[a][j] = acc_v[a][j] = 0.f;

  const int nq = (p.S + BQ - 1) / BQ;
  for (int h = hk * p.group; h < (hk + 1) * p.group; ++h) {
    const long long row_base = ((long long)b * p.H + h) * p.S;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      if (!visited(p, q0, k0)) continue;
      __syncthreads();   // the previous pair's readers are done
      load_tile<T, D>(sQ, q + b * st.q[0] + h * st.q[1], st.q[2], q0, p.S);
      load_tile<T, D>(sG, dout + b * st.dout[0] + h * st.dout[1], st.dout[2], q0, p.S);
      load_stats<BQ>(sM, sL, sDelta, stats, plane, row_base, q0, p.S);
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<D>(sQ, sK, ty, tx, s);
      dot_tile<D>(sG, sV, ty, tx, dp);
      probs(p, sM, sL, sDelta, q0, k0, ty, tx, s, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sP[(ty + 16 * a) * LDP + tx + 16 * c] = s[a][c];
      __syncthreads();
      // dV[key][d] += Σ_r P[r][key] · dO[r][d]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) pa[a] = sP[r * LDP + ty + 16 * a];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float g = sG[r * LD + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc_v[a][j] = __fmaf_rn(pa[a], g, acc_v[a][j]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sP[(ty + 16 * a) * LDP + tx + 16 * c] = dp[a][c];
      __syncthreads();
      // dK[key][d] += Σ_r dS[r][key] · Q[r][d]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) pa[a] = sP[r * LDP + ty + 16 * a];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float x = sQ[r * LD + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc_k[a][j] = __fmaf_rn(pa[a], x, acc_k[a][j]);
        }
      }
    }
  }

  T* dkb = dk + b * st.dk[0] + hk * st.dk[1];
  T* dvb = dv + b * st.dv[0] + hk * st.dv[1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[(long long)key * st.dk[2] + tx + 16 * j] = from_f32<T>(acc_k[a][j] * p.scale);
      dvb[(long long)key * st.dv[2] + tx + 16 * j] = from_f32<T>(acc_v[a][j]);
    }
  }
}

// ------------------------------------------------------------------ 3. dQ
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ stats, T* __restrict__ dq,
                 Strides st, Problem p) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + BQ * LD;
  float* sK = sG + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;        // dS: BQ x LDP
  float* sM = sP + BQ * LDP;
  float* sL = sM + BQ;
  float* sDelta = sL + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const long long plane = (long long)p.B * p.H * p.S;
  load_tile<T, D>(sQ, q + b * st.q[0] + h * st.q[1], st.q[2], q0, p.S);
  load_tile<T, D>(sG, dout + b * st.dout[0] + h * st.dout[1], st.dout[2], q0, p.S);
  load_stats<BQ>(sM, sL, sDelta, stats, plane, (long long)bh * p.S, q0, p.S);
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

  float acc[4][DJ];   // q rows ty + 16a, columns tx + 16j
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[a][j] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += BK) {
    if (!visited(p, q0, k0)) continue;
    __syncthreads();
    load_tile<T, D>(sK, kb, st.k[2], k0, p.Tk);
    load_tile<T, D>(sV, vb, st.v[2], k0, p.Tk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(sQ, sK, ty, tx, s);
    dot_tile<D>(sG, sV, ty, tx, dp);
    probs(p, sM, sL, sDelta, q0, k0, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sP[(ty + 16 * a) * LDP + tx + 16 * c] = dp[a][c];
    __syncthreads();
    // dQ[r][d] += Σ_key dS[r][key] · K[key][d]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds[a] = sP[(ty + 16 * a) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = sK[c * LD + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][j] = __fmaf_rn(ds[a], kk, acc[a][j]);
      }
    }
  }

  T* dqb = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= p.S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[(long long)r * st.dq[2] + tx + 16 * j] = from_f32<T>(acc[a][j] * p.scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* stats,
           const Strides& st, const Problem& p, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const size_t smem1 = sizeof(float) * (BQ + BK) * LD;
  const size_t smem23 = sizeof(float) * ((2 * BQ + 2 * BK) * LD + BQ * LDP + 3 * BQ);
  cudaError_t err = allow_smem(fa_bwd_stats_kernel<T, D>, smem1);
  if (err == cudaSuccess) err = allow_smem(fa_bwd_dkdv_kernel<T, D>, smem23);
  if (err == cudaSuccess) err = allow_smem(fa_bwd_dq_kernel<T, D>, smem23);
  if (err != cudaSuccess) return (int)err;
  const int Hkv = p.H / p.group;
  const dim3 qgrid((p.S + BQ - 1) / BQ, p.B * p.H);
  const dim3 kgrid((p.Tk + BK - 1) / BK, p.B * Hkv);
  fa_bwd_stats_kernel<T, D><<<qgrid, THREADS, smem1, stream>>>(
      q_, k_, static_cast<const T*>(o), static_cast<const T*>(dout), stats, st, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dkdv_kernel<T, D><<<kgrid, THREADS, smem23, stream>>>(
      q_, k_, v_, static_cast<const T*>(dout), stats, static_cast<T*>(dk),
      static_cast<T*>(dv), st, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dq_kernel<T, D><<<qgrid, THREADS, smem23, stream>>>(
      q_, k_, v_, static_cast<const T*>(dout), stats, static_cast<T*>(dq), st, p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* stats,
               const Strides& st, const Problem& p, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
    case 48: return launch<T, 48>(q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
    case 80: return launch<T, 80>(q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
    case 96: return launch<T, 96>(q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
    case 112: return launch<T, 112>(q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk and dv
// alike.  strides: 24 int64 element strides, (batch, head, row) of q, k, v,
// o, dout, dq, dk, dv in that order; every last axis is unit.  stats:
// 3·B·H·S floats of scratch.  kv_tile: the forward kernel's kv tile (64 for
// float32, 128 for bfloat16), a multiple of 64.  window <= 0 means none.
// Returns 0 or a cudaError_t.
extern "C" int fa_bwd_launch(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq, void* dk,
                             void* dv, float* stats, int dtype, int B, int H,
                             int Hkv, int S, int Tk, int D, const long long* strides,
                             float scale, int causal, int window, int q_offset,
                             int kv_tile, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || Tk <= 0 ||
      kv_tile <= 0 || kv_tile % BK)
    return (int)cudaErrorInvalidValue;
  Strides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  const Problem p{B, H, H / Hkv, S, Tk, scale, causal, window, q_offset, kv_tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, dout, dq, dk, dv, stats, st, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
