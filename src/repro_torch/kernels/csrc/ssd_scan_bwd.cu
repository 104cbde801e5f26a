// Mamba2 SSD chunked scan, backward — CUDA C++ for sm_90a.
//
// The gradient of the forward in ssd_scan.cu: dx, ddt, dA, dB, dC and dh0
// from dy and the final state's gradient dh.  The JAX package has no kernel
// here: XLA differentiates the model's `ssd_chunked`
// (src/repro/models/ssm.py:66).  Per chunk and head, with a = dt·A,
// cs = cumsum(a), u = dt·x, S = C·Bᵀ, G_ij = S_ij·exp(cs_i − cs_j) (j ≤ i),
// h_in the state entering the chunk (the forward's pass 4 leaves it in its
// scratch `st`) and g the gradient of the state leaving it:
//   g_{c−1} = exp(cs_L)·g_c + Σ_i exp(cs_i)·dy_i ⊗ C_i,  from dh (or 0)
//   du_j    = Σ_{i≥j} G_ij·dy_i + exp(cs_L − cs_j)·(g B_j);   dx = dt·du
//   dS_ij   = Σ_h exp(cs_i − cs_j)·(dy_i·u_j)                  (j ≤ i)
//   dC_i    = Σ_j dS_ij·B_j + Σ_h exp(cs_i)·(h_inᵀ dy_i)
//   dB_j    = Σ_i dS_ij·C_i + Σ_h exp(cs_L − cs_j)·(gᵀ u_j)
//   dcs     = the row sums of G∘(dy·uᵀ) at i, less its column sums at j,
//             + exp(cs_i)·dy_i·(h_in C_i), − s_j with s_j = exp(cs_L − cs_j)·
//             u_j·(g B_j); at cs_L also + Σ_j s_j + exp(cs_L)·⟨g, h_in⟩
//   da      = the reverse cumulative sum of dcs;  ddt = x·du + A·da;
//   dA      = Σ dt·da over b and t;  dh0 = exp(cs_L)·g_0 + Σ_i exp(cs_i)·dy_i ⊗ C_i
// With bf16 compute the products read the forward's rounded operands (C·Bᵀ
// from the saved CBᵀ, the gated scores, dt·x); the cotangents pass the
// casts unrounded.  exp(cs_i − cs_j) is taken of the f64 difference and
// only where j ≤ i: the cumulative log-decays reach −1e3 at chunk 1024, so
// exp(cs_i)·exp(−cs_j) or an unmasked exponential would overflow.
//
// What bounds it on an H100: operations.  Per (batch, chunk) and head it
// does two causal l²·P products (dy·uᵀ and G·dy) and five l·N·P ones (the
// state gradient, C·h_in for the y_off term, g B, and the head terms of dC
// and dB), and per chunk two causal l²·N ones (dS·B, dSᵀ·C), against
// ~l·H·P·(2 + 4 + 4 + 2) bytes of x, dy, dx and more.  In f32 on the SIMT
// pipes that is 67 TFLOP/s; here every product runs on the tensor cores as
// 3xTF32 (ssd_mma.cuh: three TF32 products of the split operands, two
// where one operand is bf16 or bf16-rounded), f32-accurate, at 495 TFLOP/s
// a term.  The replaced SIMT design (two 64-thread blocks an SM, staging
// through registers with no overlap, a spilling two-kind kernel) reached
// 0.19 of the f32 bound.
//
// Design: eight kernels on the caller's stream and no atomics.  Every
// output element and every partial sum has one writer, and every sum runs
// in a fixed order, so two calls give the same bits.  The product kernels
// run 128-thread blocks (4 warps, each a warp tile of mma.sync m16n8k8)
// fed by a two-stage cp.async ring: the next 32-deep slice of operand rows
// loads while the current one multiplies.  Where every i of a tile pair
// lies past every j, exp(cs_i − cs_j) is taken as exp(cs_i − cs_m)·
// exp(cs_m − cs_j), m the last j: both factors <= 1, and a tile needs two
// rows of exponentials instead of one a pair.
//   1. ssd_bwd_ds_kernel       dS per (b, chunk, i-tile, j-tile <= i-tile,
//      group of HG heads): dy_i·x_jᵀ per head (P deep, 32 a stage), scaled
//      by dt_j in the epilogue (by dt before the product with bf16 compute,
//      whose u is rounded), weighted by exp(cs_i − cs_j) and summed over
//      the group's heads in registers; each group writes a partial dS
//      plane of its own.  Each head's row and column sums of G∘(dy·uᵀ) go
//      to a dcs partial slot of their own, slot = the other tile's index.
//   2. ssd_bwd_ds_sum_kernel   the groups' planes summed in group order
//      into group 0's.
//   3. ssd_bwd_state_kernel    each chunk's own state gradient
//      Σ_i exp(cs_i)·C_i ⊗ dy_i per (b, chunk, head, 64-wide n tile),
//      stored (b, nc, H, N, P) as the forward's states.
//   4. ssd_bwd_pass_kernel     the reverse inter-chunk recurrence, one
//      thread per (b, head, n, p), sequential over the chunks from the last
//      and in place: chunk c's own gradient is replaced by g_c, carried =
//      exp(cs_L)·carried + own, from dh or 0; the last carry is dh0.
//   5. ssd_bwd_bc_heads_kernel the head terms of dC (exp(cs_i)·dy_i against
//      h_in) and dB (exp(cs_L − cs_j)·dt_j·x_j against g) per (b, chunk,
//      64-row tile, 64-wide n tile, slice of HS heads of the H·P axis):
//      raw dy or x rows copy asynchronously; the weight of (row, head)
//      multiplies each element as it is read into a fragment.  Each slice
//      writes a partial of its own.
//   6. ssd_bwd_bc_kernel       dS·B over j <= i (dC) and dSᵀ·C over i >= j
//      (dB) per (b, chunk, 64-row tile, 64-wide n tile); then the slices'
//      partials added in slice order, and the result stored.
//   7. ssd_bwd_dx_kernel       per (b, chunk, head, 64-row tile), heaviest
//      first: C·h_in and a row dot with dy (the y_off term of dcs), then
//      B·gᵀ (s_j and the state part of du), then Σ_{i>=j} G_ij·dy_i with G
//      formed from the saved CBᵀ as its fragments are read; dx = dt·du, and
//      x·du into ddt.  The tile-0 block also takes exp(cs_L)·⟨g, h_in⟩.
//   8. ssd_bwd_cumsum_kernel   one block per head, a warp per (b, chunk):
//      dcs from its partial sums, its reverse cumulative sum in f64, 32
//      positions a step; A·da added to ddt, dA = Σ dt·da over the warps in
//      a fixed order.
// P <= 64, N <= 128, chunk <= 1024; the wrapper refuses anything else and
// allocates one workspace (ssd_bwd_workspace_floats); nothing here
// allocates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_tiles.cuh"
#include "ssd_mma.cuh"

namespace {

constexpr int BT = 128;                   // threads of a product block: 4 warps
constexpr int HG = 16;                    // heads of a dS block (kernel 1)
constexpr int HS = 16;                    // heads of an H·P slice (kernel 5)
constexpr int PASS_THREADS = 256;
constexpr int SUM_THREADS = 256;          // kernel 2
constexpr int CS_THREADS = 1024;          // 32 warps a head in kernel 8
constexpr int NSTAGE = 2;                 // the cp.async ring
constexpr int ACC = 32;                   // accumulator entries of a thread (64 x 64 over 128)

// Row strides of staged operands, in elements: rows that the product reads
// along k (k-contiguous) take KT + 4 floats or KT + 8 halves; rows read
// along m or n take TILE + 8 floats or TILE + 16 halves.  Both keep the
// fragment reads of a warp on 32 distinct banks.
template <typename T>
__host__ __device__ constexpr int ldk() { return sizeof(T) == 4 ? KT + 4 : KT + 8; }
template <typename T>
__host__ __device__ constexpr int ldn() { return sizeof(T) == 4 ? TILE + 8 : TILE + 16; }
template <typename T>
__host__ __device__ constexpr bool is_bf16() { return sizeof(T) == 2; }

struct Args {
  const void* x;        // (b, T, H, P) TX
  const float* dt;      // (b, T, H)
  const float* A;       // (H,)
  const void* B;        // (b, T, N) TX
  const void* C;        // (b, T, N) TX
  const double* cs;     // (b, H, nc, l)       the forward's pass 1
  const float* cbt;     // (b, nc, l, l)       (C·Bᵀ)ᵀ, the forward's pass 2
  const float* st;      // (b, nc, H, N, P)    h_in, the forward's pass 4
  const float* dy;      // (b, T, H, P)
  const float* dhf;     // (b, H, P, N) or null
  void* dx;             // (b, T, H, P) TX
  float* ddt;           // (b, T, H)
  float* dA;            // (H,)
  void* dB;             // (b, T, N) TX
  void* dC;             // (b, T, N) TX
  float* dh0;           // (b, H, P, N) or null
  float* gst;           // (b, nc, H, N, P)    own state gradient, then g_c
  float* dsp;           // (b, nc, ng, l, l)   dS of each head group, tiles j <= i
  float* bcp;           // (2, nks, b·T, N)    dC (0) and dB (1) head terms of each slice
  float* part;          // (b, H, nc, nt, l)   dcs partial sums, one per slot
  float* off;           // (b, H, nc, l)       exp(cs_i)·dy_i·(h_in C_i)
  float* sj;            // (b, H, nc, l)       s_j
  float* gh;            // (b, H, nc)          exp(cs_L)·⟨g, h_in⟩
  int b, T, H, P, N, l, nc, nt, ntn, ng, nks;
  // 16-byte staging of: rows of x (P), of dy (P), of B and C (N), of the
  // states (P), of CBᵀ (l), of cs (l), of x and dy over H·P, of dS (l)
  bool vx, vy, vn, vs, vl, vc, vkx, vky, vd;
};

// v summed over the lanes whose index differs in the bits from..to−1: a
// butterfly, so every lane ends with the same bits.
template <typename T>
__device__ __forceinline__ T xor_sum(T v, int from, int to) {
  for (int m = from; m < to; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ size_t head_row(const Args& a, int bi, int h, int c) {
  return ((size_t)bi * a.H + h) * a.nc + c;     // (b, H, nc) index
}

// The warp's tile in a 2 x 2 arrangement of 32 x 32 tiles.
__device__ __forceinline__ int warp_m() { return (threadIdx.x >> 6) * 32; }
__device__ __forceinline__ int warp_n() { return ((threadIdx.x >> 5) & 1) * 32; }

// Accumulator entry q < ACC of acc[2][4][4] in that arrangement: its
// indices and its row and column in the block's 64 x 64 tile.
struct Entry {
  int mt, nt, e, row, col;
};
__device__ __forceinline__ Entry entry(int q) {
  const int mt = q >> 4, nt = (q >> 2) & 3, e = q & 3;
  return {mt, nt, e, warp_m() + mt * 16 + acc_row(e), warp_n() + nt * 8 + acc_col(e)};
}

// ---- kernel 1: dS of a head group, and the heads' dcs partial sums ----------
template <typename TX>
constexpr size_t ds_smem() {
  return sizeof(float) * NSTAGE * TILE * ldk<float>() + sizeof(TX) * NSTAGE * TILE * ldk<TX>() +
         sizeof(double) * NSTAGE * 2 * TILE + sizeof(float) * (HG * TILE + ACC * BT + 4 * TILE);
}

template <typename TX, bool BF16C>
__global__ void __launch_bounds__(BT)
ssd_bwd_ds_kernel(const Args a) {
  constexpr int LY = ldk<float>(), LX = ldk<TX>();
  extern __shared__ float4 smem4[];
  float* sY = reinterpret_cast<float*>(smem4);            // stages: dy rows i, k = p
  TX* sX = reinterpret_cast<TX*>(sY + NSTAGE * TILE * LY);  // stages: x rows j
  double* sCs = reinterpret_cast<double*>(sX + NSTAGE * TILE * LX);  // a head a stage: cs at i, j
  float* sDt = reinterpret_cast<float*>(sCs + NSTAGE * 2 * TILE);  // HG x TILE: dt at columns j
  float* sS = sDt + HG * TILE;                            // ACC x BT: S at each thread's entries
  float* sRow = sS + ACC * BT;                            // 2 x TILE: row sums of the column halves
  float* sCol = sRow + 2 * TILE;                          // 2 x TILE: column sums of the row halves
  const int tid = threadIdx.x, lane = tid & 31;
  const int l = a.l, H = a.H, P = a.P, nt = a.nt;
  const int ntri = nt * (nt + 1) / 2;
  int blk = blockIdx.x;
  const int grp = blk % a.ng;
  blk /= a.ng;
  const int bc = blk / ntri;
  int rem = blk - bc * ntri, ti = 0;              // (ti, tj) in row order
  while (rem > ti) { rem -= ti + 1; ++ti; }
  const int tj = rem, i0 = ti * TILE, j0 = tj * TILE;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const int h0 = grp * HG, nh = min(HG, H - h0);
  const size_t row0 = (size_t)bc * l;
  const int wm = warp_m(), wn = warp_n();
  const TX* x = static_cast<const TX*>(a.x);
  const int nsp = (P + KT - 1) / KT;              // stages a head
  const int nsteps = nh * nsp;

  const auto stage = [&](int s) {
    const int buf = s % NSTAGE, hh = s / nsp, h = h0 + hh, p0 = (s - hh * nsp) * KT;
    const size_t hp = (size_t)H * P;
    stage_rows<float, KT>(sY + buf * TILE * LY, LY, a.dy + ((row0 + i0) * H + h) * P + p0, hp,
                          TILE, [&](int r) { return i0 + r < l ? P - p0 : 0; }, a.vy);
    stage_rows<TX, KT>(sX + buf * TILE * LX, LX, x + ((row0 + j0) * H + h) * P + p0, hp, TILE,
                       [&](int r) { return j0 + r < l ? P - p0 : 0; }, a.vx);
    if (p0 == 0) {                                // the head's cs at rows i and columns j
      const double* csr = a.cs + head_row(a, bi, h, c) * l;
      double* d = sCs + (hh % NSTAGE) * 2 * TILE;
      stage_rows<double, TILE>(d, TILE, csr + i0, 0, 1, [&](int) { return l - i0; }, a.vc);
      stage_rows<double, TILE>(d + TILE, TILE, csr + j0, 0, 1, [&](int) { return l - j0; }, a.vc);
    }
  };
  stage(0);
  cp_async_commit();
  for (int e = tid; e < HG * TILE; e += BT) {     // dt at columns j, heads fastest
    const int hh = e % HG, jl = e / HG, j = j0 + jl;
    sDt[hh * TILE + jl] = hh < nh && j < l ? a.dt[(row0 + j) * H + h0 + hh] : 0.f;
  }
  const float* cb = a.cbt + row0 * l;             // S_ij = cbt[j][i], as the forward rounded it
#pragma unroll
  for (int q = 0; q < ACC; ++q) {
    const Entry f = entry(q);
    const int i = i0 + f.row, j = j0 + f.col;
    sS[q * BT + tid] = i < l && j <= i ? cb[(size_t)j * l + i] : 0.f;
  }

  float acc[2][4][4], M[2][4][4];
  zero(acc);
  zero(M);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                              // stage s (and sDt, sS) visible
    const int buf = s % NSTAGE, hh = s / nsp;
    const float* Y = sY + buf * TILE * LY;
    const TX* X = sX + buf * TILE * LX;
    const float* D = sDt + hh * TILE;
    const auto dyv = [&](int m, int k) { return Y[m * LY + k]; };
    if constexpr (BF16C) {                        // u = rnd(dt·x), as the forward rounded it
      mma_tile<KT, 2, 4, false, true>(wm, wn, dyv, [&](int k, int n) {
        return rnd<true>(to_f(X[n * LX + k]) * D[n]);
      }, acc);
    } else {                                      // dy·xᵀ; dt_j in the epilogue
      mma_tile<KT, 2, 4, false, is_bf16<TX>()>(wm, wn, dyv, [&](int k, int n) {
        return to_f(X[n * LX + k]);
      }, acc);
    }
    const bool last = s - hh * nsp == nsp - 1;
    if (last) {
      // acc = dy_i·u_j (times 1/dt_j with f32 compute); M += it·exp(cs_i − cs_j);
      // the dcs terms G∘(dy·uᵀ) by rows and by columns, where j <= i
      const double* ci = sCs + (hh % NSTAGE) * 2 * TILE;
      const double* cj = ci + TILE;
      float rs[2][2], cl[4][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) rs[u][0] = rs[u][1] = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) cl[u][0] = cl[u][1] = 0.f;
      const auto weigh = [&](const auto& decay) {
#pragma unroll
        for (int q = 0; q < ACC; ++q) {
          const Entry f = entry(q);
          const int i = i0 + f.row, j = j0 + f.col;
          float v = acc[f.mt][f.nt][f.e];
          if constexpr (!BF16C) v *= D[f.col];
          acc[f.mt][f.nt][f.e] = 0.f;
          if (i < l && j <= i) {
            const float E = decay(f);
            const float w = sS[q * BT + tid] * E * v;
            M[f.mt][f.nt][f.e] = __fmaf_rn(v, E, M[f.mt][f.nt][f.e]);
            rs[f.mt][f.e >> 1] += w;
            cl[f.nt][f.e & 1] += w;
          }
        }
      };
      if (ti > tj) {
        // every i past every j: exp(cs_i − cs_j) = exp(cs_i − cs_m)·exp(cs_m −
        // cs_j) with m the last j of the tile, both factors <= 1, 12
        // exponentials a thread instead of 32
        const double cm = cj[TILE - 1];
        float ui[2][2], vj[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            ui[mt][hf] = expf((float)(ci[wm + mt * 16 + hf * 8 + (lane >> 2)] - cm));
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            vj[u][cc] = expf((float)(cm - cj[wn + u * 8 + 2 * (lane & 3) + cc]));
        weigh([&](const Entry& f) { return ui[f.mt][f.e >> 1] * vj[f.nt][f.e & 1]; });
      } else {
        weigh([&](const Entry& f) { return expf((float)(ci[f.row] - cj[f.col])); });
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float v = xor_sum(rs[mt][hf], 1, 4);        // over the 4 lanes of a row
          if ((lane & 3) == 0) sRow[(wn >> 5) * TILE + wm + mt * 16 + hf * 8 + (lane >> 2)] = v;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float v = xor_sum(cl[u][cc], 4, 32);        // over the 8 lanes of a column
          if (lane < 4) sCol[(wm >> 5) * TILE + wn + u * 8 + 2 * lane + cc] = v;
        }
    }
    __syncthreads();                              // stage s read; the sums visible
    if (last && tid < TILE) {
      // one writer per (slot, position): rows of tile ti to slot tj, columns
      // of tile tj (negated) to slot ti; the diagonal tile writes both at once
      float* pb = a.part + head_row(a, bi, h0 + hh, c) * nt * l;
      const float row = sRow[tid] + sRow[TILE + tid];
      const float col = sCol[tid] + sCol[TILE + tid];
      if (ti == tj) {
        if (i0 + tid < l) pb[(size_t)ti * l + i0 + tid] = row - col;
      } else {
        if (i0 + tid < l) pb[(size_t)tj * l + i0 + tid] = row;
        if (j0 + tid < l) pb[(size_t)ti * l + j0 + tid] = -col;
      }
    }
  }
  float* out = a.dsp + ((size_t)bc * a.ng + grp) * l * l;   // zeros where j > i
#pragma unroll
  for (int q = 0; q < ACC; ++q) {
    const Entry f = entry(q);
    const int i = i0 + f.row, j = j0 + f.col;
    if (i < l && j < l) out[(size_t)i * l + j] = M[f.mt][f.nt][f.e];
  }
}

// ---- kernel 2: dS summed over the head groups, in group order, in place ----
// One block per (b, chunk, i-tile, j-tile <= i-tile); group 0's plane takes
// the sum, 4 positions of a row a thread.
__global__ void __launch_bounds__(SUM_THREADS)
ssd_bwd_ds_sum_kernel(const Args a) {
  const int l = a.l, nt = a.nt, ntri = nt * (nt + 1) / 2;
  const int bc = blockIdx.x / ntri;
  int rem = blockIdx.x - bc * ntri, ti = 0;
  while (rem > ti) { rem -= ti + 1; ++ti; }
  const int i0 = ti * TILE, j0 = rem * TILE;
  const size_t plane = (size_t)l * l;
  float* d = a.dsp + (size_t)bc * a.ng * plane;
  for (int e = threadIdx.x; e < TILE * TILE / 4; e += SUM_THREADS) {
    const int i = i0 + e / (TILE / 4), j = j0 + e % (TILE / 4) * 4;
    if (i >= l || j >= l) continue;
    float* p = d + (size_t)i * l + j;
    if (a.vd) {                                   // l % 4 == 0: whole, aligned groups
      float4 v = *reinterpret_cast<const float4*>(p);
      for (int g = 1; g < a.ng; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(p + g * plane);
        v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
      }
      *reinterpret_cast<float4*>(p) = v;
    } else {
      for (int u = 0; u < 4 && j + u < l; ++u) {
        float v = p[u];
        for (int g = 1; g < a.ng; ++g) v += p[g * plane + u];
        p[u] = v;
      }
    }
  }
}

// ---- kernel 3: gst[b][c][h][n][p] = Σ_i C_i[n] · exp(cs_i)·dy_i[p] ---------
template <typename TX>
size_t state_smem(int l) {
  return sizeof(TX) * NSTAGE * KT * ldn<TX>() + sizeof(float) * NSTAGE * KT * ldn<float>() +
         sizeof(float) * ((l + KT - 1) / KT * KT);
}

template <typename TX>
__global__ void __launch_bounds__(BT)
ssd_bwd_state_kernel(const Args a) {
  constexpr int LC = ldn<TX>(), LY = ldn<float>();
  extern __shared__ float4 smem4[];
  TX* sC = reinterpret_cast<TX*>(smem4);                      // stages: C rows i, n contiguous
  float* sY = reinterpret_cast<float*>(sC + NSTAGE * KT * LC);  // stages: dy rows i
  float* sW = sY + NSTAGE * KT * LY;                          // exp(cs_i), 0 past l
  const int tid = threadIdx.x;
  const int l = a.l, H = a.H, P = a.P, N = a.N;
  const int n0 = (blockIdx.x % a.ntn) * TILE;
  const int bch = blockIdx.x / a.ntn;             // (b·nc + c)·H + h
  const int h = bch % H, bc = bch / H;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const size_t row0 = (size_t)bc * l;
  const TX* Cm = static_cast<const TX*>(a.C);
  const double* csr = a.cs + head_row(a, bi, h, c) * l;
  const int wm = warp_m(), wn = warp_n();
  const int nsteps = (l + KT - 1) / KT;

  const auto stage = [&](int s) {
    const int buf = s % NSTAGE, k0 = s * KT;
    const auto rows = [&](int r) { return k0 + r < l; };
    stage_rows<TX, TILE>(sC + buf * KT * LC, LC, Cm + (row0 + k0) * N + n0, N, KT,
                         [&](int r) { return rows(r) ? N - n0 : 0; }, a.vn);
    stage_rows<float, TILE>(sY + buf * KT * LY, LY, a.dy + ((row0 + k0) * H + h) * P,
                            (size_t)H * P, KT, [&](int r) { return rows(r) ? P : 0; }, a.vy);
  };
  stage(0);
  cp_async_commit();
  for (int i = tid; i < nsteps * KT; i += BT) sW[i] = i < l ? expf((float)csr[i]) : 0.f;

  float acc[2][4][4];
  zero(acc);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = s % NSTAGE;
    const TX* Cs = sC + buf * KT * LC;
    const float* Y = sY + buf * KT * LY;
    const float* W = sW + s * KT;
    mma_tile<KT, 2, 4, is_bf16<TX>(), false>(
        wm, wn, [&](int m, int k) { return to_f(Cs[k * LC + m]); },
        [&](int k, int n) { return Y[k * LY + n] * W[k]; }, acc);
    __syncthreads();
  }
  float* out = a.gst + (size_t)bch * N * P;
#pragma unroll
  for (int q = 0; q < ACC; ++q) {
    const Entry f = entry(q);
    const int n = n0 + f.row, p = f.col;
    if (n < N && p < P) out[(size_t)n * P + p] = acc[f.mt][f.nt][f.e];
  }
}

// ---- kernel 4: g leaving each chunk, in place, from the last chunk ----------
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_pass_kernel(const Args a, size_t total) {
  const size_t e = (size_t)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= total) return;                         // e over (b, h, n, p), p fastest
  const int P = a.P, N = a.N, H = a.H, l = a.l, nc = a.nc;
  const int p = (int)(e % P);
  const size_t bhn = e / P;
  const int n = (int)(bhn % N);
  const size_t bh = bhn / N;
  const int h = (int)(bh % H);
  const size_t bi = bh / H;
  const size_t nstride = (size_t)N * P;
  const size_t hstride = (size_t)H * nstride;     // one chunk of gst
  float* s = a.gst + (bi * nc * H + h) * nstride + (size_t)n * P + p;
  const double* csr = a.cs + bh * nc * l + (l - 1);
  float carried = a.dhf ? a.dhf[(bh * P + p) * N + n] : 0.f;
  constexpr int U = 8;                            // chunks whose loads go out together
  for (int c0 = nc - 1; c0 >= 0; c0 -= U) {
    float own[U], dec[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 - u >= 0) {
        own[u] = s[(size_t)(c0 - u) * hstride];
        dec[u] = expf((float)csr[(size_t)(c0 - u) * l]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 - u >= 0) {
        s[(size_t)(c0 - u) * hstride] = carried;
        carried = carried * dec[u] + own[u];
      }
    }
  }
  if (a.dh0) a.dh0[(bh * P + p) * N + n] = carried;
}

// ---- kernel 5: the head terms of dC (which 0) and dB (which 1), one slice ---
constexpr size_t bc_heads_smem() {
  return sizeof(float) * (NSTAGE * TILE * ldk<float>() * 2 + HS * TILE) +
         sizeof(int) * NSTAGE * KT;
}

// rows t of the tile, k = (h, p) over the slice's heads: dC takes
// exp(cs_t)·dy_t[h][p] against h_in[h][n][p], dB takes
// exp(cs_L − cs_t)·dt_t·x_t[h][p] against g[h][n][p].
template <typename TA>
__device__ void bc_heads(const Args& a, const TA* src, bool vsrc, int which, int s, int tr,
                         int tn, int bc, float* smem) {
  constexpr int LA = ldk<TA>(), LB = ldk<float>();
  TA* sA = reinterpret_cast<TA*>(smem);                        // stages: rows t, k contiguous
  float* sB = smem + NSTAGE * TILE * ldk<float>();             // stages: state rows n
  float* sWt = sB + NSTAGE * TILE * LB;                        // HS x TILE: weight of (head, row)
  int* sKH = reinterpret_cast<int*>(sWt + HS * TILE);          // stages: head of each k
  const int tid = threadIdx.x;
  const int l = a.l, H = a.H, P = a.P, N = a.N;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const int r0 = tr * TILE, n0 = tn * TILE;
  const int h0 = s * HS, nh = min(HS, H - h0);
  const int K = nh * P;                           // the slice's depth
  const size_t K2 = (size_t)H * P, row0 = (size_t)bc * l;
  const float* state = (which == 0 ? a.st : a.gst) + ((size_t)bc * H + h0) * N * P;
  const int wm = warp_m(), wn = warp_n();
  const int nsteps = (K + KT - 1) / KT;

  const auto stage = [&](int st) {
    const int buf = st % NSTAGE, k0 = st * KT;
    stage_rows<TA, KT>(sA + buf * TILE * LA, LA, src + (row0 + r0) * K2 + (size_t)h0 * P + k0,
                       K2, TILE, [&](int r) { return r0 + r < l ? K - k0 : 0; }, vsrc);
    float* dB = sB + buf * TILE * LB;
    for (int q = tid; q < TILE * KT / 4; q += BT) {   // 4 k of a state row n
      const int nl = q / (KT / 4), k = q % (KT / 4) * 4, n = n0 + nl;
      const int kk = k0 + k, hh = kk / P, p = kk - hh * P;
      const int valid = n < N ? K - kk : 0;
      if (a.vs) {                                 // P % 4 == 0: the 4 k share a head
        stage16(dB + nl * LB + k, valid > 0 ? state + ((size_t)hh * N + n) * P + p : state,
                valid, true);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int f = kk + u, fh = f / P;
          dB[nl * LB + k + u] = u < valid ? state[((size_t)fh * N + n) * P + (f - fh * P)] : 0.f;
        }
      }
    }
    if (tid < KT) sKH[buf * KT + tid] = min((k0 + tid) / P, HS - 1);
  };
  stage(0);
  cp_async_commit();
  for (int e = tid; e < HS * TILE; e += BT) {     // the weights, rows fastest
    const int hh = e / TILE, r = e % TILE, t = r0 + r;
    float w = 0.f;
    if (hh < nh && t < l) {
      const double* csr = a.cs + head_row(a, bi, h0 + hh, c) * l;
      w = which == 0 ? expf((float)csr[t])
                     : expf((float)(csr[l - 1] - csr[t])) * a.dt[(row0 + t) * H + h0 + hh];
    }
    sWt[e] = w;
  }

  float acc[2][4][4];
  zero(acc);
  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) stage(st + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = st % NSTAGE;
    const TA* As = sA + buf * TILE * LA;
    const float* Bs = sB + buf * TILE * LB;
    const auto bv = [&](int k, int n) { return Bs[n * LB + k]; };
    if (P % KT == 0) {                            // the stage lies in one head
      const float* W = sWt + (st * KT / P) * TILE;
      mma_tile<KT, 2, 4, false, false>(
          wm, wn, [&](int m, int k) { return to_f(As[m * LA + k]) * W[m]; }, bv, acc);
    } else {
      const int* kh = sKH + buf * KT;
      mma_tile<KT, 2, 4, false, false>(
          wm, wn, [&](int m, int k) { return to_f(As[m * LA + k]) * sWt[kh[k] * TILE + m]; },
          bv, acc);
    }
    __syncthreads();
  }
  float* out = a.bcp + ((size_t)which * a.nks + s) * a.b * a.T * N;
#pragma unroll
  for (int q = 0; q < ACC; ++q) {
    const Entry f = entry(q);
    const int t = r0 + f.row, n = n0 + f.col;
    if (t < l && n < N) out[(row0 + t) * N + n] = acc[f.mt][f.nt][f.e];
  }
}

// dC's half (dy rows) and dB's half (x rows) of one grid: the same tile
// product, staging and epilogue over other rows, so one register budget
// serves both without a spill, and one launch puts both halves on the card
// at once.
template <typename TX>
__global__ void __launch_bounds__(BT)
ssd_bwd_bc_heads_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int q = blockIdx.x;
  const int s = q % a.nks;
  q /= a.nks;
  const int tn = q % a.ntn;
  q /= a.ntn;
  const int tr = q % a.nt;
  q /= a.nt;
  const int bc = q % (a.b * a.nc), which = q / (a.b * a.nc);
  if (which == 0)
    bc_heads<float>(a, a.dy, a.vky, 0, s, tr, tn, bc, smem);
  else
    bc_heads<TX>(a, static_cast<const TX*>(a.x), a.vkx, 1, s, tr, tn, bc, smem);
}

// ---- kernel 6: dS·B (dC, which 0) or dSᵀ·C (dB, which 1), then the sums ----
template <typename TX>
constexpr size_t bc_smem() {
  return sizeof(float) * NSTAGE * TILE * ldk<float>() + sizeof(TX) * NSTAGE * KT * ldn<TX>();
}

// dS·B: rows i, k = j <= i, dS rows staged as they lie; dSᵀ·C: rows j, k =
// i >= j, dS rows staged along m.  B and C rounded as the forward's C·Bᵀ
// read them.  dS is group 0's plane, which kernel 2 made the sum.
template <typename TX, bool BF16C, int WHICH>
__device__ void bc_block(const Args& a, int tr, int tn, int bc, float* smem) {
  constexpr int LA = WHICH == 0 ? ldk<float>() : ldn<float>(), LB = ldn<TX>();
  static_assert(TILE * ldk<float>() == KT * ldn<float>(), "a stage of dS holds either layout");
  float* sA = smem;                                        // stages: dS
  TX* sB = reinterpret_cast<TX*>(sA + NSTAGE * TILE * ldk<float>());  // stages: B or C rows
  const int l = a.l, N = a.N;
  const int r0 = tr * TILE, n0 = tn * TILE;
  const size_t row0 = (size_t)bc * l;
  const float* ds = a.dsp + (size_t)bc * a.ng * l * l;
  const TX* other = static_cast<const TX*>(WHICH == 0 ? a.B : a.C);
  const int kbeg = WHICH == 0 ? 0 : r0;
  const int kend = WHICH == 0 ? min(l, r0 + TILE) : l;
  const int wm = warp_m(), wn = warp_n();
  const int nsteps = (kend - kbeg + KT - 1) / KT;

  const auto stage = [&](int s) {
    const int buf = s % NSTAGE, k0 = kbeg + s * KT;
    stage_rows<TX, TILE>(sB + buf * KT * LB, LB, other + (row0 + k0) * N + n0, N, KT,
                         [&](int r) { return k0 + r < kend ? N - n0 : 0; }, a.vn);
    float* dA = sA + buf * TILE * ldk<float>();
    if constexpr (WHICH == 0)                     // rows i, j along k
      stage_rows<float, KT>(dA, LA, ds + (size_t)r0 * l + k0, l, TILE,
                            [&](int r) { return r0 + r < l ? kend - k0 : 0; }, a.vd);
    else                                          // rows i along k, j along m
      stage_rows<float, TILE>(dA, LA, ds + (size_t)k0 * l + r0, l, KT,
                              [&](int r) { return k0 + r < l ? l - r0 : 0; }, a.vd);
  };
  stage(0);
  cp_async_commit();

  float acc[2][4][4];
  zero(acc);
  constexpr bool EB = is_bf16<TX>() || BF16C;
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = s % NSTAGE;
    const float* As = sA + buf * TILE * ldk<float>();
    const TX* Bs = sB + buf * KT * LB;
    mma_tile<KT, 2, 4, false, EB>(
        wm, wn,
        [&](int m, int k) { return WHICH == 0 ? As[m * LA + k] : As[k * LA + m]; },
        [&](int k, int n) { return rnd<BF16C>(to_f(Bs[k * LB + n])); }, acc);
    __syncthreads();
  }
  // + the head terms of each slice, in slice order
  const size_t plane2 = (size_t)a.b * a.T * N;
  const float* pp = a.bcp + (size_t)WHICH * a.nks * plane2;
  TX* out = static_cast<TX*>(WHICH == 0 ? a.dC : a.dB);
#pragma unroll
  for (int q = 0; q < ACC; ++q) {
    const Entry f = entry(q);
    const int t = r0 + f.row, n = n0 + f.col;
    if (t >= l || n >= N) continue;
    const size_t at = (row0 + t) * N + n;
    float v = acc[f.mt][f.nt][f.e];
    for (int s = 0; s < a.nks; ++s) v += pp[s * plane2 + at];
    put(out + at, v);
  }
}

// dC's and dB's halves of one grid, as in kernel 5: at Zamba2's shape each
// half alone is 128 blocks, one 4-warp block on each of 128 of 132 SMs.
template <typename TX, bool BF16C>
__global__ void __launch_bounds__(BT)
ssd_bwd_bc_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int q = blockIdx.x;
  const int tn = q % a.ntn;
  q /= a.ntn;
  const int tr = q % a.nt;
  q /= a.nt;
  const int bc = q % (a.b * a.nc), which = q / (a.b * a.nc);
  if (which == 0)
    bc_block<TX, BF16C, 0>(a, tr, tn, bc, smem);
  else
    bc_block<TX, BF16C, 1>(a, tr, tn, bc, smem);
}

// ---- kernel 7: du for one head and 64-row tile; dx, x·du, s_j, y_off term --
template <typename TX>
size_t dx_smem(int l) {
  return sizeof(float) * NSTAGE * (TILE * ldk<float>() + KT * ldn<float>()) +
         sizeof(double) * l + sizeof(float) * (2 * TILE + l + KT + 4);
}

// 4 blocks an SM: at most 128 registers, which the bf16-compute instance
// also fits without spilling (left to itself, ptxas took 96 and spilled)
template <typename TX, bool BF16C>
__global__ void __launch_bounds__(BT, 4)
ssd_bwd_dx_kernel(const Args a) {
  constexpr int LR = ldk<TX>(), LG = ldk<float>(), LB = ldn<float>();
  static_assert(sizeof(TX) * LR <= sizeof(float) * LG, "a stage of rows holds B, C or CBᵀ");
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);          // stages: B, C (TX) or CBᵀ rows
  float* sB = sA + NSTAGE * TILE * LG;                  // stages: state or dy rows
  double* sCS = reinterpret_cast<double*>(sB + NSTAGE * KT * LB);  // cs[0, l)
  float* sDT = reinterpret_cast<float*>(sCS + a.l);     // dt at the tile's rows
  float* sV = sDT + TILE;                               // exp(cs_m − cs_j) at the tile's rows
  float* sU = sV + TILE;                                // exp(cs_i − cs_m) at i past the tile
  float* sRed = sU + a.l + KT;                          // 4: the warps' sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int l = a.l, H = a.H, P = a.P, N = a.N;
  const int nbch = a.b * a.nc * H;
  const int tr = blockIdx.x / nbch;               // row tile 0, the heaviest, first
  const int bch = blockIdx.x % nbch;              // (b·nc + c)·H + h
  const int h = bch % H, bc = bch / H;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const int r0 = tr * TILE;
  const size_t row0 = (size_t)bc * l;
  const size_t hr = head_row(a, bi, h, c);
  const TX* x = static_cast<const TX*>(a.x);
  const TX* Bm = static_cast<const TX*>(a.B);
  const TX* Cm = static_cast<const TX*>(a.C);
  const double* csr = a.cs + hr * l;
  const float* hin = a.st + (size_t)bch * N * P;
  const float* gc = a.gst + (size_t)bch * N * P;
  const float* cb = a.cbt + row0 * l;
  const int wm = warp * 16;                       // 4 x 1 warps: 16 rows, all 64 columns
  const int nn = (N + KT - 1) / KT;               // stages of C·h_in and of B·gᵀ
  const int nsteps = 2 * nn + (l - r0 + KT - 1) / KT;

  // steps [0, nn): C·h_in; [nn, 2nn): B·gᵀ; then G·dy over i >= r0
  const auto stage = [&](int s) {
    const int buf = s % NSTAGE;
    float* dA = sA + buf * TILE * LG;
    float* dB = sB + buf * KT * LB;
    if (s < 2 * nn) {
      const int k0 = (s % nn) * KT;
      stage_rows<TX, KT>(reinterpret_cast<TX*>(dA), LR, (s < nn ? Cm : Bm) + (row0 + r0) * N + k0,
                         N, TILE, [&](int r) { return r0 + r < l ? N - k0 : 0; }, a.vn);
      stage_rows<float, TILE>(dB, LB, (s < nn ? hin : gc) + (size_t)k0 * P, P, KT,
                              [&](int r) { return k0 + r < N ? P : 0; }, a.vs);
    } else {
      const int k0 = r0 + (s - 2 * nn) * KT;
      stage_rows<float, KT>(dA, LG, cb + (size_t)r0 * l + k0, l, TILE,
                            [&](int r) { return r0 + r < l ? l - k0 : 0; }, a.vl);
      stage_rows<float, TILE>(dB, LB, a.dy + ((row0 + k0) * H + h) * P, (size_t)H * P, KT,
                              [&](int r) { return k0 + r < l ? P : 0; }, a.vy);
    }
  };
  stage(0);
  cp_async_commit();
  for (int i = tid; i < l; i += BT) sCS[i] = csr[i];
  for (int r = tid; r < TILE; r += BT) sDT[r] = r0 + r < l ? a.dt[(row0 + r0 + r) * H + h] : 0.f;
  if constexpr (!BF16C) {
    // G_ji = S_ij·exp(cs_i − cs_m)·exp(cs_m − cs_j) where every i is past
    // the tile: both factors <= 1, m its last row (bf16 compute rounds
    // S·exp(cs_i − cs_j) itself, as the forward did)
    const double cm = csr[min(r0 + TILE, l) - 1];
    for (int r = tid; r < TILE; r += BT) sV[r] = r0 + r < l ? expf((float)(cm - csr[r0 + r])) : 0.f;
    for (int i = tid; i < l + KT; i += BT)
      sU[i] = i >= r0 + TILE && i < l ? expf((float)(csr[i] - cm)) : 0.f;
  }

  // row entries of this lane: rows wm + g + 8·hf, columns 8·nt + 2·t4 + cc
  const auto row_dot = [&](const float (&acc)[1][8][4], int hf, const auto& vec) {
    float part = 0.f;
#pragma unroll
    for (int nt_ = 0; nt_ < 8; ++nt_)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int p = nt_ * 8 + 2 * t4 + cc;
        if (p < P) part += acc[0][nt_][2 * hf + cc] * vec(p);
      }
    return xor_sum(part, 1, 4);
  };

  float acc[1][8][4];
  zero(acc);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = s % NSTAGE;
    const float* As = sA + buf * TILE * LG;
    const float* Bs = sB + buf * KT * LB;
    const auto bv = [&](int k, int n) { return Bs[k * LB + n]; };
    if (s < 2 * nn) {
      const TX* Ar = reinterpret_cast<const TX*>(As);
      mma_tile<KT, 1, 8, is_bf16<TX>(), false>(
          wm, 0, [&](int m, int k) { return to_f(Ar[m * LR + k]); }, bv, acc);
    } else {
      const int k0 = r0 + (s - 2 * nn) * KT;
      if (!BF16C && k0 >= r0 + TILE) {            // (S_ij·exp(cs_m − cs_j))·(exp(cs_i − cs_m)·dy_i)
        const float* U = sU + k0;
        mma_tile<KT, 1, 8, false, false>(
            wm, 0, [&](int m, int k) { return As[m * LG + k] * sV[m]; },
            [&](int k, int n) { return Bs[k * LB + n] * U[k]; }, acc);
      } else {                                    // G_ji = rnd(S_ij·exp(cs_i − cs_j)), i >= j
        mma_tile<KT, 1, 8, BF16C, false>(wm, 0, [&](int m, int k) {
          const int j = r0 + m, i = k0 + k;
          return i >= j && i < l ? rnd<BF16C>(As[m * LG + k] * expf((float)(sCS[i] - sCS[j])))
                                 : 0.f;
        }, bv, acc);
      }
    }
    __syncthreads();
    if (s == nn - 1) {
      // the y_off term of dcs: exp(cs_i)·Σ_p dy_i[p]·(C_i·h_in)[p]
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = r0 + wm + g + 8 * hf;
        const float* dyr = a.dy + ((row0 + min(i, l - 1)) * H + h) * P;
        const float part = row_dot(acc, hf, [&](int p) { return dyr[p]; });
        if (t4 == 0 && i < l) a.off[hr * l + i] = expf((float)sCS[i]) * part;
      }
      zero(acc);
    } else if (s == 2 * nn - 1) {
      // g·B_j: s_j = exp(cs_L − cs_j)·dt_j·Σ_p x_j[p]·(g B_j)[p], and the
      // state part of du, exp(cs_L − cs_j)·(g B_j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = r0 + wm + g + 8 * hf;
        const bool ok = j < l;
        const TX* xr = x + ((row0 + min(j, l - 1)) * H + h) * P;
        const float part = row_dot(acc, hf, [&](int p) { return to_f(xr[p]); });
        const float e = ok ? expf((float)(sCS[l - 1] - sCS[j])) : 0.f;
        if (t4 == 0 && ok) a.sj[hr * l + j] = e * sDT[j - r0] * part;
#pragma unroll
        for (int nt_ = 0; nt_ < 8; ++nt_)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) acc[0][nt_][2 * hf + cc] *= e;
      }
    }
  }
  TX* dx = static_cast<TX*>(a.dx);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = r0 + wm + g + 8 * hf;
    const bool ok = j < l;
    const size_t at = ((row0 + min(j, l - 1)) * H + h) * P;
    const TX* xr = x + at;
    const float part = row_dot(acc, hf, [&](int p) { return to_f(xr[p]); });
    if (t4 == 0 && ok) a.ddt[(row0 + j) * H + h] = part;   // kernel 8 adds A·da
    if (ok) {
      const float d = sDT[j - r0];
#pragma unroll
      for (int nt_ = 0; nt_ < 8; ++nt_)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int p = nt_ * 8 + 2 * t4 + cc;
          if (p < P) put(dx + at + p, d * acc[0][nt_][2 * hf + cc]);
        }
    }
  }
  if (tr == 0) {                                  // exp(cs_L)·⟨g, h_in⟩, once a chunk
    float v = 0.f;
    for (int e = tid; e < N * P; e += BT) v += gc[e] * hin[e];
    v = xor_sum(v, 1, 32);
    if (lane == 0) sRed[warp] = v;
    __syncthreads();
    if (tid == 0) a.gh[hr] = expf((float)sCS[l - 1]) * (sRed[0] + sRed[1] + sRed[2] + sRed[3]);
  }
}

// ---- kernel 8: dcs, its reverse cumulative sum (f64), ddt += A·da, dA ------
__global__ void __launch_bounds__(CS_THREADS)
ssd_bwd_cumsum_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  double* sRed = reinterpret_cast<double*>(smem4);      // a warp's dA sum each
  constexpr int NW = CS_THREADS / 32;
  const int h = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = a.l, nt = a.nt, H = a.H;
  const double Ah = a.A[h];
  double dA = 0.0;
  for (int bc = warp; bc < a.b * a.nc; bc += NW) {
    const int bi = bc / a.nc, c = bc - bi * a.nc;
    const size_t hr = head_row(a, bi, h, c);
    const float* pb = a.part + hr * nt * l;
    const float* ob = a.off + hr * l;
    const float* sb = a.sj + hr * l;
    const size_t row0 = (size_t)bc * l;
    double stot = 0.0;
    for (int i = lane; i < l; i += 32) stot += sb[i];
    const double extra = xor_sum(stot, 1, 32) + a.gh[hr];
    double carry = 0.0;                           // dcs summed over the later positions
    for (int top = l - 1; top >= 0; top -= 32) {
      const int i = top - lane;                   // lanes walk back from top
      double v = 0.0;
      if (i >= 0) {
        for (int s = 0; s < nt; ++s) v += pb[(size_t)s * l + i];
        v += (double)ob[i] - (double)sb[i];
        if (i == l - 1) v += extra;
      }
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v += o;
      }
      const double da = v + carry;
      if (i >= 0) {
        const size_t at = (row0 + i) * H + h;
        a.ddt[at] = (float)((double)a.ddt[at] + Ah * da);
        dA += (double)a.dt[at] * da;
      }
      carry = __shfl_sync(0xffffffffu, da, 31);
    }
  }
  dA = xor_sum(dA, 1, 32);
  if (lane == 0) sRed[warp] = dA;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < NW; ++w) s += sRed[w];
    a.dA[h] = (float)s;
  }
}

// The workspace, in floats, carved in this order, each piece rounded up to
// 64 floats: gst, dsp, bcp, part, off, sj, gh.
struct Pieces {
  size_t n[7];
};

Pieces pieces(int b, int T, int H, int P, int N, int l) {
  const size_t nc = (size_t)T / l, nt = (l + TILE - 1) / TILE;
  const size_t ng = (H + HG - 1) / HG, nks = (H + HS - 1) / HS;
  Pieces s = {{(size_t)b * nc * H * N * P, (size_t)b * nc * ng * l * l,
               2 * nks * (size_t)b * T * N, (size_t)b * H * nc * nt * l,
               (size_t)b * H * nc * l, (size_t)b * H * nc * l, (size_t)b * H * nc}};
  for (size_t& v : s.n) v = (v + 63) / 64 * 64;
  return s;
}

// Grid, block and dynamic shared memory of the eight kernels, in launch order.
constexpr int NKERNELS = 8;
struct Config {
  long long grid, block, smem;
};

template <typename TX>
void configs(int b, int T, int H, int P, int N, int l, Config (&k)[NKERNELS]) {
  const long long nc = T / l, nt = (l + TILE - 1) / TILE, ntn = (N + TILE - 1) / TILE;
  const long long bnc = b * nc, ng = (H + HG - 1) / HG, nks = (H + HS - 1) / HS;
  const long long total = (long long)b * H * N * P, ntri = nt * (nt + 1) / 2;
  k[0] = {bnc * ntri * ng, BT, (long long)ds_smem<TX>()};
  k[1] = {bnc * ntri, SUM_THREADS, 0};
  k[2] = {bnc * H * ntn, BT, (long long)state_smem<TX>(l)};
  k[3] = {(total + PASS_THREADS - 1) / PASS_THREADS, PASS_THREADS, 0};
  k[4] = {2 * bnc * nt * ntn * nks, BT, (long long)bc_heads_smem()};
  k[5] = {2 * bnc * nt * ntn, BT, (long long)bc_smem<TX>()};
  k[6] = {bnc * H * nt, BT, (long long)dx_smem<TX>(l)};
  k[7] = {H, CS_THREADS, (long long)(sizeof(double) * CS_THREADS / 32)};
}

template <typename K>
cudaError_t go(K kernel, const Config& k, cudaStream_t s, const Args& a) {
  if (k.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)k.grid, (unsigned)k.block, (size_t)k.smem, s>>>(a);
  return cudaGetLastError();
}

template <typename TX, bool BF16C>
cudaError_t launch(const Args& a, cudaStream_t s) {
  Config k[NKERNELS];
  configs<TX>(a.b, a.T, a.H, a.P, a.N, a.l, k);
  cudaError_t err;
  if ((err = go(ssd_bwd_ds_kernel<TX, BF16C>, k[0], s, a)) != cudaSuccess) return err;
  if ((err = go(ssd_bwd_ds_sum_kernel, k[1], s, a)) != cudaSuccess) return err;
  if ((err = go(ssd_bwd_state_kernel<TX>, k[2], s, a)) != cudaSuccess) return err;
  const size_t total = (size_t)a.b * a.H * a.N * a.P;
  ssd_bwd_pass_kernel<<<(unsigned)k[3].grid, PASS_THREADS, 0, s>>>(a, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = go(ssd_bwd_bc_heads_kernel<TX>, k[4], s, a)) != cudaSuccess) return err;
  if ((err = go(ssd_bwd_bc_kernel<TX, BF16C>, k[5], s, a)) != cudaSuccess) return err;
  if ((err = go(ssd_bwd_dx_kernel<TX, BF16C>, k[6], s, a)) != cudaSuccess) return err;
  return go(ssd_bwd_cumsum_kernel, k[7], s, a);
}

}  // namespace

// Floats of workspace that ssd_bwd_launch needs for these shapes.
extern "C" long long ssd_bwd_workspace_floats(int b, int T, int H, int P, int N,
                                               int l) {
  if (b <= 0 || H <= 0 || P <= 0 || N <= 0 || l <= 0 || T % l) return 0;
  const Pieces s = pieces(b, T, H, P, N, l);
  long long total = 0;
  for (size_t v : s.n) total += (long long)v;
  return total;
}

// Grid, block and dynamic shared memory bytes of each kernel that
// ssd_bwd_launch runs for these shapes, in launch order, three numbers a
// kernel into out[24]; returns the number of kernels (0 for bad shapes).
extern "C" int ssd_bwd_kernel_configs(int b, int T, int H, int P, int N, int l, int dtype,
                                      long long* out) {
  if (b <= 0 || H <= 0 || P <= 0 || N <= 0 || l <= 0 || T % l || dtype < 0 || dtype > 1)
    return 0;
  Config k[NKERNELS];
  if (dtype == 0)
    configs<float>(b, T, H, P, N, l, k);
  else
    configs<__nv_bfloat16>(b, T, H, P, N, l, k);
  for (int i = 0; i < NKERNELS; ++i) {
    out[3 * i] = k[i].grid;
    out[3 * i + 1] = k[i].block;
    out[3 * i + 2] = k[i].smem;
  }
  return NKERNELS;
}

// dtype: 0 = float32, 1 = bfloat16 (x, B and C, and dx, dB, dC alike); dt,
// A, dy, dh, ddt, dA and dh0 f32.  bf16_compute as in ssd_launch.  cs, cbt
// and st are the forward's scratch for the same inputs, after its pass 4.
// dh and dh0 may be null (a zero final-state gradient; no h0).  `work` holds
// ssd_bwd_workspace_floats(b, T, H, P, N, l) floats on the device of x.
// Launches the eight kernels on `stream` and returns the first CUDA error.
extern "C" int ssd_bwd_launch(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* cs,
                              const void* cbt, const void* st, const void* dy,
                              const void* dh, void* dx, void* ddt, void* dA,
                              void* dB, void* dC, void* work, void* dh0,
                              int dtype, int bf16_compute, int b, int T, int H,
                              int P, int N, int l, void* stream) {
  if (b <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      l <= 0 || l > MAX_L || T % l || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const Pieces s = pieces(b, T, H, P, N, l);
  float* w = static_cast<float*>(work);
  Args a;
  a.x = x; a.dt = static_cast<const float*>(dt); a.A = static_cast<const float*>(A);
  a.B = B; a.C = C;
  a.cs = static_cast<const double*>(cs);
  a.cbt = static_cast<const float*>(cbt);
  a.st = static_cast<const float*>(st);
  a.dy = static_cast<const float*>(dy);
  a.dhf = static_cast<const float*>(dh);
  a.dx = dx; a.ddt = static_cast<float*>(ddt); a.dA = static_cast<float*>(dA);
  a.dB = dB; a.dC = dC; a.dh0 = static_cast<float*>(dh0);
  a.gst = w;
  a.dsp = a.gst + s.n[0];
  a.bcp = a.dsp + s.n[1];
  a.part = a.bcp + s.n[2];
  a.off = a.part + s.n[3];
  a.sj = a.off + s.n[4];
  a.gh = a.sj + s.n[5];
  a.b = b; a.T = T; a.H = H; a.P = P; a.N = N; a.l = l;
  a.nc = T / l; a.nt = (l + TILE - 1) / TILE; a.ntn = (N + TILE - 1) / TILE;
  a.ng = (H + HG - 1) / HG; a.nks = (H + HS - 1) / HS;
  // cp.async where every row of a staged operand starts on 16 bytes: rows
  // of x (P elements of x's type), dy and the states (P floats), B and C
  // (N elements), CBᵀ (l floats), cs (l doubles), and x and dy as rows of
  // H·P; the workspace and the scratch are aligned
  const int xe = dtype == 0 ? 4 : 8;             // elements of x, B, C in 16 bytes
  a.vx = P % xe == 0 && aligned(x);
  a.vy = P % 4 == 0 && aligned(dy);
  a.vn = N % xe == 0 && aligned(B) && aligned(C);
  a.vs = P % 4 == 0 && aligned(st) && aligned(work);
  a.vl = l % 4 == 0 && aligned(cbt);
  a.vc = l % 2 == 0 && aligned(cs);
  a.vkx = (H * P) % xe == 0 && aligned(x);
  a.vky = (H * P) % 4 == 0 && aligned(dy);
  a.vd = l % 4 == 0 && aligned(work);
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && !bf16_compute)
    err = launch<float, false>(a, st_);
  else if (dtype == 0)
    err = launch<float, true>(a, st_);
  else if (!bf16_compute)
    err = launch<__nv_bfloat16, false>(a, st_);
  else
    err = launch<__nv_bfloat16, true>(a, st_);
  return (int)err;
}

extern "C" const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
