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
// tiles (padding past T counts in the sum l and nowhere else), and a row
// with no visited tile is 0.  The backward uses each row's statistics over
// the same tiles, so it is the gradient of that function: such a row sends
// dO/l to dV of its visited keys and nothing to dQ or dK.  The forward's
// rounding of P to bfloat16 before P·V is taken as the identity; P and dS
// are rounded to bfloat16 only as operands of the bf16 products.
//
// What bounds it on an H100: operations.  Five products of 2·D flops per
// unmasked (query, key) pair are the least work (Q·Kᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q,
// dS·K): at Phi-3's shape (S = T = 4096, D = 96, causal) ~1700 flops per
// byte of q, k, v, o, dO and the gradients, far above the card's ~295 bf16
// flops per byte, so the ceiling is the 989 TFLOP/s bf16 tensor-core rate.
//
// bfloat16: on the tensor cores, the statistics from the forward.  The
// forward kernel saves each row's max m (base 2) and 1/l (`stats`, two f32
// planes of B·H·S), so nothing recomputes them; three kernels a call, no
// atomics, so the result is deterministic:
//   1. `fa_bwd_delta_kernel`: Δ = rowsum(dO ∘ O) in f32, four lanes a row,
//      16-byte loads; one pass over the bytes of O and dO.
//   2. `fa_bwd_dkdv_wgmma_kernel`: one block per (b, kv head, 128-key tile),
//      blocks issued first-key-tile first (the most q tiles when causal);
//      two consumer warpgroups of 64 keys each and a producer warpgroup,
//      one warp of which loads: K and V once by TMA, then the 64-row Q and
//      dO tiles of the group's query heads that the forward's skip rule
//      visits, through a 3-stage mbarrier ring, with the 64 rows' m, 1/l
//      and Δ beside them (rows past S as m = +inf, so P = 0).  Per q tile
//      each warpgroup runs Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as m64n64k16 wgmma
//      from shared memory (one commit group), forms
//      Pᵀ = 2^(Sᵀ·D^-0.5·log2 e − m)·(1/l) and dSᵀ = Pᵀ ∘ (dPᵀ − Δ) (0
//      where masked) on the accumulator fragments and rounds both to bf16
//      in registers, where they are the A fragments of dV += Pᵀ·dO and
//      dK += dSᵀ·Q (m64nDk16, Q and dO read in place through wgmma's
//      transpose of B).  dK·D^-0.5 and dV are written once.
//   3. `fa_bwd_dq_wgmma_kernel`: one block per (b·h, 128-row q tile),
//      heaviest tile first; two consumer warpgroups of 64 rows and a
//      producer warpgroup.  Q and dO arrive once by TMA, K and V tiles of
//      128 rows stream through a ring (3 stages, 2 at D = 128 for shared
//      memory).  Per visited tile: S = Q·Kᵀ and dP = dO·Vᵀ as m64n128k16,
//      dS formed on the fragments and rounded to bf16, dQ += dS·K
//      (m64nDk16, K through the transpose of B); dQ·D^-0.5 written once.
//   Seven products where five suffice (Q·Kᵀ and dO·Vᵀ run in both 2 and
//   3): fusing dQ into 2 would need atomics or a second reduction.  Masks
//   are computed only on tiles that cut the diagonal, the window edge or
//   T.  The producer warpgroup hands its registers to the consumers
//   (setmaxnreg: 24 and 240 a thread, from 168): at 168 both kernels
//   spilled from D = 16 or 48 up; at 240 only the dQ kernel spills, 16-80
//   bytes a thread from D = 80 up.  Shared memory holds every tile as D/16
//   column chunks of 32-byte swizzled rows, the forward's layout (D = 80
//   and 96 unpadded; the TMA, mbarrier and wgmma helpers are shared with
//   it in csrc/fa_hopper.cuh), which is each tile's K-major operand and its
//   MN-major one alike.  Each warpgroup waits for its wgmma groups, as the
//   forward does; the two warpgroups of a block fill each other's waits.
//
// float32: three SIMT kernels on the f32 pipes (TF32 would miss the 2e-5
// tolerance), which recompute the statistics:
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
//   Eight products (Q·Kᵀ three times, dO·Vᵀ twice): 256 threads a block,
//   each a 4 x 4 micro-tile of the 64 x 64 score tile, operands converted
//   to f32 in shared memory with rows of D + 1 floats.
//
// D is a template parameter, any multiple of 16 up to 128.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fa_hopper.cuh"

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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
int launch_f32(const void* q, const void* k, const void* v, const void* o,
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

// --------------------------------------------------------------- bfloat16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = NEG * LOG2E;  // a masked score in the base-2 domain
constexpr int WQ = 64;               // q rows per warpgroup (and per dK/dV q tile)
constexpr int WK = 128;              // keys per dK/dV block; kv rows per dQ tile
constexpr int STAGES = 3;            // the dK/dV kernel's Q/dO ring
constexpr int CONSUMERS = 256;       // two warpgroups
constexpr int WTHREADS = CONSUMERS + 128;  // + the producer warpgroup
// Registers a thread after setmaxnreg: 384 threads start at 168 each; the
// producer warpgroup gives its share to the consumers, whose S and dP
// fragments (or Sᵀ, dPᵀ and two accumulators) need more than 168.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536, "registers");
static_assert(WQ == BQ, "the skip rule's q groups are the warpgroups' rows");

// The dQ kernel's K/V ring: 3 stages, 2 at D = 128 (Q, dO and three stages
// of K and V would take 256 KiB of shared memory there).
template <int D> __host__ __device__ constexpr int dq_stages() { return D > 112 ? 2 : 3; }

template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Sᵀ (64 x 64) += A (64 x 16) · Bᵀ (16 x 64): m64n64k16, both from shared
// memory, K-major: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (dK/dV).
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// ------------------------------------------------------------ 1. Δ
// Δ = rowsum(dO ∘ O) in f32 over the B·H·S rows, four lanes a row, 16-byte
// loads (the wrapper gives o and dout 16-byte-aligned rows).
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ delta, Strides st, Problem p) {
  const long long row = (long long)blockIdx.x * 64 + threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const long long rows = (long long)p.B * p.H * p.S;
  float sum = 0.f;
  if (row < rows) {
    const long long bh = row / p.S;
    const int r = (int)(row - bh * p.S), b = (int)(bh / p.H), h = (int)(bh % p.H);
    const __nv_bfloat16* ob = o + b * st.o[0] + h * st.o[1] + (long long)r * st.o[2];
    const __nv_bfloat16* gb =
        dout + b * st.dout[0] + h * st.dout[1] + (long long)r * st.dout[2];
    for (int c = part; c < D / 8; c += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(ob + 8 * c);
      const uint4 y = *reinterpret_cast<const uint4*>(gb + 8 * c);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(xp[j]), g = __bfloat1622float2(yp[j]);
        sum = __fmaf_rn(a.x, g.x, sum);
        sum = __fmaf_rn(a.y, g.y, sum);
      }
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (part == 0 && row < rows) delta[row] = sum;
}

// ------------------------------------------------------------ 2. dK and dV
// stats: the forward's two planes (m in base 2, 1/l), row (b·H + h)·S + s;
// delta: Δ, same rows.  Grid (B·Hkv, key tiles of WK), WTHREADS threads.
template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ stats,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, Strides st, Problem p) {
  constexpr uint32_t KTILE = D * WK * 2;       // bytes of a 128-row K or V tile
  constexpr uint32_t QTILE = D * WQ * 2;       // bytes of a 64-row Q or dO tile
  constexpr int NCH = D / CHUNK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = sK + KTILE;
  const uint32_t sQ = sV + KTILE;                 // + stage * QTILE
  const uint32_t sG = sQ + STAGES * QTILE;        // dO, + stage * QTILE
  const uint32_t sStat = sG + STAGES * QTILE;     // per stage: m, 1/l, Δ of 64 rows
  const uint32_t kv_full = sStat + STAGES * 3 * WQ * 4;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + STAGES + s); };
  float* stat_smem = reinterpret_cast<float*>(smem_raw + (sStat - raw));

  const int Hkv = p.H / p.group;
  const int bhk = blockIdx.x, b = bhk / Hkv, hk = bhk % Hkv;
  const int k0 = blockIdx.y * WK;     // the first key tile (most q tiles) first
  const int nq = (p.S + WQ - 1) / WQ;
  const long long plane = (long long)p.B * p.H * p.S;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);          // every producer lane, one with the bytes
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {                // ---- producer warpgroup ----
    setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x - CONSUMERS;
    if (lane >= 32) return;                      // one warp loads
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * KTILE);
      tma_tile<D>(sK, &tk, kv_full, k0, hk, b, WK);
      tma_tile<D>(sV, &tv, kv_full, k0, hk, b, WK);
    }
    int i = 0;
    for (int h = hk * p.group; h < (hk + 1) * p.group; ++h) {
      const long long row_base = ((long long)b * p.H + h) * p.S;
      for (int qt = 0; qt < nq; ++qt) {
        const int q0 = qt * WQ;
        if (!visited(p, q0, k0)) continue;
        const int s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        ++i;
        mbar_wait(empty(s), ph ^ 1);             // both warpgroups are done
        float* ss = stat_smem + s * 3 * WQ;
        for (int r = lane; r < WQ; r += 32) {    // rows past S: P = 0
          const bool in = q0 + r < p.S;
          const long long row = row_base + q0 + r;
          ss[r] = in ? stats[row] : INFINITY;
          ss[WQ + r] = in ? stats[plane + row] : 0.f;
          ss[2 * WQ + r] = in ? delta[row] : 0.f;
        }
        if (lane == 0) {                         // its arrival carries the bytes
          mbar_expect_tx(full(s), 2 * QTILE);
          tma_tile<D>(sQ + s * QTILE, &tq, full(s), q0, h, b, WQ);
          tma_tile<D>(sG + s * QTILE, &tdo, full(s), q0, h, b, WQ);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32, g = lane / 4, c = lane % 4;
  const int kp0 = k0 + wg * 64 + (t / 32) * 16 + g;   // this thread's keys:
  const int kp1 = kp0 + 8;                            // kp0 and kp0 + 8
  const int kw0 = k0 + wg * 64;                       // the warpgroup's first
  const float scale_log2 = p.scale * LOG2E;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc_k[j] = acc_v[j] = 0.f;

  const uint64_t dka = smem_desc(sK + wg * 64 * 32, 16, 256);   // A of Sᵀ
  const uint64_t dva = smem_desc(sV + wg * 64 * 32, 16, 256);   // A of dPᵀ
  mbar_wait(kv_full, 0);
  int i = 0;
  for (int h = hk * p.group; h < (hk + 1) * p.group; ++h) {
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * WQ;
      if (!visited(p, q0, k0)) continue;
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      ++i;
      mbar_wait(full(s), ph);
      const uint32_t q_s = sQ + s * QTILE, g_s = sG + s * QTILE;
      float sc[32], dp[32];
      {
        const uint64_t dqb = smem_desc(q_s, 16, 256), dgb = smem_desc(g_s, 16, 256);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NCH; ++kk)
          wgmma_ss64(sc, dka + ((kk * WK * 32) >> 4), dqb + ((kk * WQ * 32) >> 4), kk > 0);
#pragma unroll
        for (int kk = 0; kk < NCH; ++kk)
          wgmma_ss64(dp, dva + ((kk * WK * 32) >> 4), dgb + ((kk * WQ * 32) >> 4), kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);
      }

      // sc[j], dp[j]: key kp0 + 8·((j>>1)&1), q row q0 + (j>>2)·8 + 2c + (j&1)
      const float* ss = stat_smem + s * 3 * WQ;
      const int glo = q0 + p.q_offset;           // the tile's first q position
      const bool edge = kw0 + 63 >= p.Tk || (p.causal && kw0 + 63 > glo) ||
                        (p.window > 0 && kw0 <= glo + WQ - 1 - p.window);
      uint32_t pf[16], sf[16];   // Pᵀ and dSᵀ in bf16: A fragments of dV and dK
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int kp = (j & 2) ? kp1 : kp0;
        float pr[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = (j >> 2) * 8 + 2 * c + e;
          float x = sc[j + e] * scale_log2;
          bool ok = true;
          if (edge) {
            ok = unmasked(p, q0 + r + p.q_offset, kp);
            if (!ok) x = NEG2;
          }
          pr[e] = ex2(x - ss[r]) * ss[WQ + r];
          ds[e] = ok ? pr[e] * (dp[j + e] - ss[2 * WQ + r]) : 0.f;
        }
        pf[j / 2] = pack_bf16(pr[0], pr[1]);
        sf[j / 2] = pack_bf16(ds[0], ds[1]);
      }

      // dV += Pᵀ·dO, dK += dSᵀ·Q: dO and Q as B, MN-major (the transpose)
      const uint64_t dgt = smem_desc(g_s, WQ * 32, 256), dqt = smem_desc(q_s, WQ * 32, 256);
      fence_regs(acc_v);
      fence_regs(acc_k);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WQ / 16; ++kk)
        WgmmaRS<D>::run(acc_v, &pf[4 * kk], dgt + ((kk * 16 * 32) >> 4));
#pragma unroll
      for (int kk = 0; kk < WQ / 16; ++kk)
        WgmmaRS<D>::run(acc_k, &sf[4 * kk], dqt + ((kk * 16 * 32) >> 4));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc_v);
      fence_regs(acc_k);
      mbar_arrive(empty(s));
    }
  }

  __nv_bfloat16* dkb = dk + b * st.dk[0] + hk * st.dk[1];
  __nv_bfloat16* dvb = dv + b * st.dv[0] + hk * st.dv[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * c;
    if (kp0 < p.Tk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)kp0 * st.dk[2] + col) =
          __floats2bfloat162_rn(acc_k[4 * j] * p.scale, acc_k[4 * j + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)kp0 * st.dv[2] + col) =
          __floats2bfloat162_rn(acc_v[4 * j], acc_v[4 * j + 1]);
    }
    if (kp1 < p.Tk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)kp1 * st.dk[2] + col) =
          __floats2bfloat162_rn(acc_k[4 * j + 2] * p.scale, acc_k[4 * j + 3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)kp1 * st.dv[2] + col) =
          __floats2bfloat162_rn(acc_v[4 * j + 2], acc_v[4 * j + 3]);
    }
  }
}

// ------------------------------------------------------------------ 3. dQ
// Grid (B·H, q tiles of 2·WQ rows), WTHREADS threads.
template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ stats,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, Strides st, Problem p) {
  constexpr uint32_t TILE = D * WK * 2;        // bytes of a 128-row tile
  constexpr int NCH = D / CHUNK;
  constexpr int NS = dq_stages<D>();
  constexpr int BQ2 = 2 * WQ;                  // q rows per block
  static_assert(BQ2 == WK, "one tile size for Q, dO, K and V");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sG = sQ + TILE;
  const uint32_t sK = sG + TILE;                 // + stage * TILE
  const uint32_t sV = sK + NS * TILE;
  const uint32_t q_full = sV + NS * TILE;        // then full, empty
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + NS + s); };

  const int qt = gridDim.y - 1 - blockIdx.y;     // heaviest q tile first
  const int q0 = qt * BQ2;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, hk = h / p.group;

  // the kv tiles some row of this block can see (the forward's range)
  const int qlo = q0 + p.q_offset, qhi = q0 + BQ2 - 1 + p.q_offset;
  const int nk = (p.Tk + WK - 1) / WK;
  const int kt_end = p.causal ? min(nk, qhi / WK + 1) : nk;
  const int first = qlo - p.window + 1;          // first key row qlo may see
  const int kt_begin = (p.window > 0 && first > 0) ? first / WK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {                // ---- producer warpgroup ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {              // one thread loads
      mbar_expect_tx(q_full, 2 * TILE);
      tma_tile<D>(sQ, &tq, q_full, q0, h, b, BQ2);
      tma_tile<D>(sG, &tdo, q_full, q0, h, b, BQ2);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % NS;
        const uint32_t ph = (i / NS) & 1;
        mbar_wait(empty(s), ph ^ 1);             // both warpgroups are done
        mbar_expect_tx(full(s), 2 * TILE);
        tma_tile<D>(sK + s * TILE, &tk, full(s), kt * WK, hk, b, WK);
        tma_tile<D>(sV + s * TILE, &tv, full(s), kt * WK, hk, b, WK);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32, g = lane / 4, c = lane % 4;
  const int row0 = q0 + wg * 64 + (t / 32) * 16 + g;   // this thread's rows:
  const int row1 = row0 + 8;                            // row0 and row0 + 8
  const int qp0 = row0 + p.q_offset, qp1 = row1 + p.q_offset;
  const int g0 = q0 + wg * 64;                          // the warpgroup's q group
  const int wlo = g0 + p.q_offset, whi = wlo + WQ - 1;
  const float scale_log2 = p.scale * LOG2E;

  const long long plane = (long long)p.B * p.H * p.S;
  const long long rb = (long long)bh * p.S;
  // rows past S: m = +inf, so P = 0 and dS = 0
  const float m0 = row0 < p.S ? stats[rb + row0] : INFINITY;
  const float m1 = row1 < p.S ? stats[rb + row1] : INFINITY;
  const float il0 = row0 < p.S ? stats[plane + rb + row0] : 0.f;
  const float il1 = row1 < p.S ? stats[plane + rb + row1] : 0.f;
  const float dl0 = row0 < p.S ? delta[rb + row0] : 0.f;
  const float dl1 = row1 < p.S ? delta[rb + row1] : 0.f;

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  const uint64_t dqa = smem_desc(sQ + wg * 64 * 32, 16, 256);   // A of S
  const uint64_t dga = smem_desc(sG + wg * 64 * 32, 16, 256);   // A of dP
  mbar_wait(q_full, 0);
  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % NS;
    const uint32_t ph = (i / NS) & 1;
    const int k0 = kt * WK;
    mbar_wait(full(s), ph);
    if (visited(p, g0, k0)) {
      float sc[64], dp[64];
      {
        const uint64_t dkb = smem_desc(sK + s * TILE, 16, 256);
        const uint64_t dvb = smem_desc(sV + s * TILE, 16, 256);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NCH; ++kk)
          wgmma_qk(sc, dqa + ((kk * BQ2 * 32) >> 4), dkb + ((kk * WK * 32) >> 4), kk > 0);
#pragma unroll
        for (int kk = 0; kk < NCH; ++kk)
          wgmma_qk(dp, dga + ((kk * BQ2 * 32) >> 4), dvb + ((kk * WK * 32) >> 4), kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);
      }

      // sc[j], dp[j]: row row0 + 8·((j>>1)&1), key k0 + (j>>2)·8 + 2c + (j&1)
      const bool edge = k0 + WK > p.Tk || (p.causal && k0 + WK - 1 > wlo) ||
                        (p.window > 0 && k0 <= whi - p.window);
      uint32_t sf[32];   // dS in bf16: the A fragments of dS·K
#pragma unroll
      for (int j = 0; j < 64; j += 2) {
        const bool hi = j & 2;
        const int qp = hi ? qp1 : qp0;
        const float m = hi ? m1 : m0, il = hi ? il1 : il0, dl = hi ? dl1 : dl0;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[j + e] * scale_log2;
          bool ok = true;
          if (edge) {
            ok = unmasked(p, qp, k0 + (j >> 2) * 8 + 2 * c + e);
            if (!ok) x = NEG2;
          }
          const float pr = ex2(x - m) * il;
          ds[e] = ok ? pr * (dp[j + e] - dl) : 0.f;
        }
        sf[j / 2] = pack_bf16(ds[0], ds[1]);
      }

      // dQ += dS·K: K as B, MN-major (the transpose)
      const uint64_t dkt = smem_desc(sK + s * TILE, WK * 32, 256);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)
        WgmmaRS<D>::run(acc, &sf[4 * kk], dkt + ((kk * 16 * 32) >> 4));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    mbar_arrive(empty(s));
  }

  __nv_bfloat16* dqb = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * c;
    if (row0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)row0 * st.dq[2] + col) =
          __floats2bfloat162_rn(acc[4 * j] * p.scale, acc[4 * j + 1] * p.scale);
    if (row1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)row1 * st.dq[2] + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * p.scale, acc[4 * j + 3] * p.scale);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv,
                const float* stats, float* delta, const Strides& st,
                const Problem& p, cudaStream_t stream) {
  static const EncodeTiledFn encode =
      reinterpret_cast<EncodeTiledFn>(cu_entry_point("cuTensorMapEncodeTiled"));
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const int Hkv = p.H / p.group;
  // Q and dO in 64-row boxes (dK/dV) and 128-row boxes (dQ); K and V in 128.
  CUtensorMap tq64, tdo64, tq, tdo, tk, tv;
  CUresult r = make_map(encode, &tq64, q, D, p.S, p.H, p.B, 2 * st.q[2],
                        2 * st.q[1], 2 * st.q[0], WQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tdo64, dout, D, p.S, p.H, p.B, 2 * st.dout[2],
                 2 * st.dout[1], 2 * st.dout[0], WQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tq, q, D, p.S, p.H, p.B, 2 * st.q[2], 2 * st.q[1],
                 2 * st.q[0], 2 * WQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tdo, dout, D, p.S, p.H, p.B, 2 * st.dout[2],
                 2 * st.dout[1], 2 * st.dout[0], 2 * WQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tk, k, D, p.Tk, Hkv, p.B, 2 * st.k[2], 2 * st.k[1],
                 2 * st.k[0], WK);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tv, v, D, p.Tk, Hkv, p.B, 2 * st.v[2], 2 * st.v[1],
                 2 * st.v[0], WK);
  if (r != CUDA_SUCCESS) return CU_ERR + (int)r;

  constexpr int NS = dq_stages<D>();
  const size_t smem_kv = 1024 + (size_t)D * WK * 2 * 2 + (size_t)D * WQ * 2 * 2 * STAGES +
                         STAGES * 3 * WQ * 4 + 8 * (1 + 2 * STAGES);
  const size_t smem_q = 1024 + (size_t)D * WK * 2 * (2 + 2 * NS) + 8 * (1 + 2 * NS);
  cudaError_t err = allow_smem(fa_bwd_dkdv_wgmma_kernel<D>, smem_kv);
  if (err == cudaSuccess) err = allow_smem(fa_bwd_dq_wgmma_kernel<D>, smem_q);
  if (err != cudaSuccess) return (int)err;

  const __nv_bfloat16* o_ = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* g_ = static_cast<const __nv_bfloat16*>(dout);
  const long long rows = (long long)p.B * p.H * p.S;
  fa_bwd_delta_kernel<D><<<(unsigned)((rows + 63) / 64), 256, 0, stream>>>(
      o_, g_, delta, st, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 kgrid(p.B * Hkv, (p.Tk + WK - 1) / WK);
  fa_bwd_dkdv_wgmma_kernel<D><<<kgrid, WTHREADS, smem_kv, stream>>>(
      tq64, tk, tv, tdo64, stats, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), st, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 qgrid(p.B * p.H, (p.S + 2 * WQ - 1) / (2 * WQ));
  fa_bwd_dq_wgmma_kernel<D><<<qgrid, WTHREADS, smem_q, stream>>>(
      tq, tk, tv, tdo, stats, delta, static_cast<__nv_bfloat16*>(dq), st, p);
  return (int)cudaGetLastError();
}

template <bool BF16, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* stats,
           float* delta, const Strides& st, const Problem& p,
           cudaStream_t stream) {
  if constexpr (BF16)
    return launch_bf16<D>(q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, stream);
  else
    return launch_f32<float, D>(q, k, v, o, dout, dq, dk, dv, stats, st, p, stream);
}

template <bool BF16>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* stats,
               float* delta, const Strides& st, const Problem& p, cudaStream_t s) {
  switch (D) {
    case 16: return launch<BF16, 16>(q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
    case 32: return launch<BF16, 32>(q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
    case 48: return launch<BF16, 48>(q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
    case 64: return launch<BF16, 64>(q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
    case 80: return launch<BF16, 80>(q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
    case 96: return launch<BF16, 96>(q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
    case 112: return launch<BF16, 112>(q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
    case 128: return launch<BF16, 128>(q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk and dv
// alike.  strides: 24 int64 element strides, (batch, head, row) of q, k, v,
// o, dout, dq, dk, dv in that order; every last axis is unit.  float32:
// stats is 3·B·H·S floats of scratch and delta is unused.  bfloat16: stats
// is the forward's two planes of B·H·S floats (m in base 2, 1/l), delta
// B·H·S floats of scratch; q, k, v and dout as TMA takes them (strides of
// multiples of 8 elements, 16-byte-aligned pointers) and o 16-byte-aligned
// too (the wrapper checks).  kv_tile: the forward kernel's kv tile (64 for
// float32, 128 for bfloat16).  window <= 0 means none.  Returns 0, a
// cudaError_t, or 1000 + a CUresult of the tensor-map encode.
extern "C" int fa_bwd_launch(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq, void* dk,
                             void* dv, float* stats, float* delta, int dtype,
                             int B, int H, int Hkv, int S, int Tk, int D,
                             const long long* strides, float scale, int causal,
                             int window, int q_offset, int kv_tile, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || Tk <= 0 ||
      kv_tile <= 0 || kv_tile % BK || (dtype == 1 && (kv_tile != WK || !delta)))
    return (int)cudaErrorInvalidValue;
  Strides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  const Problem p{B, H, H / Hkv, S, Tk, scale, causal, window, q_offset, kv_tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<false>(D, q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
  if (dtype == 1)
    return dispatch_d<true>(D, q, k, v, o, dout, dq, dk, dv, stats, delta, st, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_bwd_error_string(int err) { return cu_error_string(err); }
