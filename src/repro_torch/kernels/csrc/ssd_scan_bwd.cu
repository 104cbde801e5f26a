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
// What bounds it on an H100: operations, like the forward.  Per (batch,
// chunk) and head it does two causal l²·P products (dy·uᵀ and G·dy) and
// five l·N·P ones (the state gradient, h_in C for the y_off term, g B, and
// the head terms of dC and dB), and per chunk two causal l²·N ones (dS·B,
// dS·C), all on the f32 pipes (67 TFLOP/s), against ~l·H·P·(2 + 4 + 4 + 2)
// bytes of x, dy, dx and more.
//
// Design: four kernels on the caller's stream and no atomics.  Every output
// element and every partial sum has one writer, and every sum runs in a
// fixed order, so two calls give the same bits.
//   1. ssd_bwd_chunk_kernel   two kinds of block.  (a) dS per (b, chunk,
//      i-tile, j-tile <= i-tile), the heads in a loop inside the block:
//      dy_i·u_jᵀ per head (a 64 x 64 product over p), weighted by
//      exp(cs_i − cs_j) and summed over the heads in registers, so that dB
//      and dC take one l²·N product per chunk, not one per head; each head's
//      row and column sums of G∘(dy·uᵀ) go to a partial-sum slot of their
//      own, slot = the other tile's index.  (b) each chunk's own state
//      gradient Σ_i exp(cs_i)·C_i ⊗ dy_i per (b, chunk, head, 64-wide n
//      tile), stored (b, nc, H, N, P) as the forward's states.
//   2. ssd_bwd_pass_kernel    the reverse inter-chunk recurrence, one thread
//      per (b, head, n, p), sequential over the chunks from the last and in
//      place: chunk c's own gradient is replaced by g_c, carried =
//      exp(cs_L)·carried + own, from dh or 0; the last carry is dh0.  The
//      mirror of the forward's pass 4.
//   3. ssd_bwd_grad_kernel    two kinds of block.  (a) dC or dB per (b,
//      chunk, 64-row tile, 64-wide n tile): dS·B over j <= i (dSᵀ·C over
//      i >= j), then the head terms as one product over the H·P axis.
//      (b) per (b, chunk, head, 64-row tile), heaviest first: C·h_in and a
//      row dot with dy (the y_off term of dcs), then B·gᵀ (s_j and the
//      state part of du), then Σ_{i>=j} G_ij·dy_i with G formed from the
//      saved CBᵀ; dx = dt·du, and x·du into ddt.  The tile-0 block also
//      takes exp(cs_L)·⟨g, h_in⟩.
//   4. ssd_bwd_cumsum_kernel  one block per head, a warp per (b, chunk):
//      dcs from its partial sums, its reverse cumulative sum in f64, 32
//      positions a step; A·da added to ddt, dA = Σ dt·da over the warps in
//      a fixed order.
// The products are ssd_tiles.cuh's register-tiled 64 x 64 f32 micro-tiles,
// as in the forward.  P <= 64, N <= 128, chunk <= 1024; the wrapper
// refuses anything else and allocates one workspace
// (ssd_bwd_workspace_floats); nothing here allocates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_tiles.cuh"

namespace {

constexpr int PASS_THREADS = 256;
constexpr int CS_THREADS = 256;           // 8 warps a head in kernel 4
constexpr int SLD = TILE + 1;             // row stride of the staged S tile

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
  float* dS;            // (b, nc, l, l)       dS_ij at [i][j], tiles j <= i
  float* part;          // (b, H, nc, nt, l)   dcs partial sums, one per slot
  float* off;           // (b, H, nc, l)       exp(cs_i)·dy_i·(h_in C_i)
  float* sj;            // (b, H, nc, l)       s_j
  float* gh;            // (b, H, nc)          exp(cs_L)·⟨g, h_in⟩
  int b, T, H, P, N, l, nc, nt, ntn;
  bool vx, vn, vy, vl;  // rows of x/dx, B/C/dB/dC, dy, and l-long rows take 16-byte loads
};

// v summed over the lanes whose index differs in the bits from..to−1: a
// butterfly, so every lane ends with the same bits.
template <typename T>
__device__ __forceinline__ T xor_sum(T v, int from, int to) {
  for (int m = from; m < to; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// A thread's 8 row sums of its micro-tile, summed over the 8 threads (tx)
// that share its rows.
__device__ __forceinline__ float row_sum(float v) { return xor_sum(v, 1, 8); }

__device__ __forceinline__ void store4(__nv_bfloat16* p, int cnt, bool, float a,
                                       float b, float c, float d) {
  const float v[4] = {a, b, c, d};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < cnt) p[u] = __float2bfloat16_rn(v[u]);
}

__device__ __forceinline__ size_t head_row(const Args& a, int bi, int h, int c) {
  return ((size_t)bi * a.H + h) * a.nc + c;     // (b, H, nc) index
}

// ---- kernel 1a: dS tile and the heads' dcs partial sums ---------------------
template <typename TX, bool BF16C>
__device__ void ds_block(const Args& a, int blk, float* smem) {
  float* sA = smem;                               // KT x LD: dy rows i, k = p
  float* sB = sA + KT * LD;                       // KT x LD: rnd(dt·x) cols j
  float* sS = sB + KT * LD;                       // TILE x SLD: S[j][i]
  double* sCi = reinterpret_cast<double*>(sS + TILE * SLD);  // cs at rows i
  double* sCj = sCi + TILE;                       // cs at columns j
  float* sDj = reinterpret_cast<float*>(sCj + TILE);         // dt at columns j
  float* sRow = sDj + TILE;                       // the row sums
  float* sCol = sRow + TILE;                      // 2 x TILE: each warp's column sums
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int lane = tid & 31, warp = tid >> 5;
  const int l = a.l, H = a.H, P = a.P, nt = a.nt;
  const int ntri = nt * (nt + 1) / 2;
  const int bc = blk / ntri;
  int rem = blk - bc * ntri, ti = 0;              // (ti, tj) in row order
  while (rem > ti) { rem -= ti + 1; ++ti; }
  const int tj = rem, i0 = ti * TILE, j0 = tj * TILE;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const size_t row0 = (size_t)bc * l;
  const TX* x = static_cast<const TX*>(a.x);
  const float* cb = a.cbt + row0 * l;
  for (int e = tid; e < TILE * TILE; e += THREADS) {  // S_ij, as the forward rounded it
    const int jl = e / TILE, il = e % TILE;
    const int j = j0 + jl, i = i0 + il;
    sS[jl * SLD + il] = (i < l && j <= i) ? cb[(size_t)j * l + i] : 0.f;
  }

  float M[8][8], acc[8][8];
  zero(M);
  for (int h = 0; h < H; ++h) {
    const double* csr = a.cs + head_row(a, bi, h, c) * l;
    __syncthreads();                              // the last head's sums are read
    for (int t = tid; t < TILE; t += THREADS) {
      sCi[t] = i0 + t < l ? csr[i0 + t] : 0.0;
      sCj[t] = j0 + t < l ? csr[j0 + t] : 0.0;
      sDj[t] = j0 + t < l ? a.dt[(row0 + j0 + t) * H + h] : 0.f;
    }
    zero(acc);
    for (int p0 = 0; p0 < P; p0 += KT) {
      __syncthreads();                            // also publishes sCi, sCj, sDj
      for (int g = tid; g < TILE * KT / 8; g += THREADS) {  // 8 p at a time, rows fastest
        const int r = g % TILE, k = g / TILE * 8;
        const int p = p0 + k, i = i0 + r, j = j0 + r;
        float dv[8], xv[8];
        load8(a.dy + ((row0 + i) * H + h) * P + p, i < l ? P - p : 0, a.vy, dv);
        load8(x + ((row0 + j) * H + h) * P + p, j < l ? P - p : 0, a.vx, xv);
        const float d = sDj[r];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          sA[(k + u) * LD + r] = dv[u];
          sB[(k + u) * LD + r] = rnd<BF16C>(xv[u] * d);
        }
      }
      __syncthreads();
      mma_step(sA, sB, ty, tx, acc);
    }
    // acc[r][c] = dy_i·u_j; M += acc·exp(cs_i − cs_j); the dcs terms
    // G∘(dy·uᵀ) by rows and by columns, where j <= i
    float rs[8], cl[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) rs[q] = cl[q] = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int il = frag(ty, r), i = i0 + il;
      const double ci = sCi[il];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int jl = frag(tx, q), j = j0 + jl;
        if (i < l && j <= i) {
          const float E = expf((float)(ci - sCj[jl]));
          const float w = sS[jl * SLD + il] * E * acc[r][q];
          M[r][q] = __fmaf_rn(acc[r][q], E, M[r][q]);
          rs[r] += w;
          cl[q] += w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = row_sum(rs[r]);
      if (tx == 0) sRow[frag(ty, r)] = v;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float v = xor_sum(cl[q], 8, 32);      // over the warp's four ty
      if (lane < 8) sCol[warp * TILE + frag(tx, q)] = v;
    }
    __syncthreads();
    // one writer per (slot, position): rows of tile ti to slot tj, columns
    // of tile tj (negated) to slot ti; the diagonal tile writes both at once
    float* pb = a.part + head_row(a, bi, h, c) * nt * l;
    for (int t = tid; t < TILE; t += THREADS) {
      const float col = sCol[t] + sCol[TILE + t];
      if (ti == tj) {
        if (i0 + t < l) pb[(size_t)ti * l + i0 + t] = sRow[t] - col;
      } else {
        if (i0 + t < l) pb[(size_t)tj * l + i0 + t] = sRow[t];
        if (j0 + t < l) pb[(size_t)ti * l + j0 + t] = -col;
      }
    }
  }
  float* out = a.dS + row0 * l;                   // zeros where j > i
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + frag(ty, r);
    if (i >= l) continue;
    float* o = out + (size_t)i * l + j0;
    store4(o + tx * 4, l - j0 - tx * 4, a.vl, M[r][0], M[r][1], M[r][2], M[r][3]);
    store4(o + 32 + tx * 4, l - j0 - 32 - tx * 4, a.vl, M[r][4], M[r][5], M[r][6],
           M[r][7]);
  }
}

// ---- kernel 1b: gst[b][c][h][n][p] = Σ_i C_i[n] · exp(cs_i)·dy_i[p] ---------
template <typename TX>
__device__ void dstate_block(const Args& a, int blk, float* smem) {
  float* sA = smem;                               // KT x LD: C[i][n]
  float* sB = sA + KT * LD;                       // KT x LD: weighted dy[i][p]
  float* sW = sB + KT * LD;                       // l: exp(cs_i)
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int l = a.l, H = a.H, P = a.P, N = a.N;
  const int n0 = (blk % a.ntn) * TILE;
  const int bch = blk / a.ntn;                    // (b·nc + c)·H + h
  const int h = bch % H, bc = bch / H;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const size_t row0 = (size_t)bc * l;
  const TX* Cm = static_cast<const TX*>(a.C);
  const double* csr = a.cs + head_row(a, bi, h, c) * l;
  for (int i = tid; i < l; i += THREADS) sW[i] = expf((float)csr[i]);

  float acc[8][8];
  zero(acc);
  for (int k0 = 0; k0 < l; k0 += KT) {
    __syncthreads();                              // also publishes sW
    for (int g = tid; g < KT * TILE / 8; g += THREADS) {  // 8 n or p at a time
      const int k = g / (TILE / 8), r = g % (TILE / 8) * 8;
      const int i = k0 + k, n = n0 + r;
      float cv[8], dv[8];
      load8(Cm + (row0 + i) * N + n, i < l ? N - n : 0, a.vn, cv);
      load8(a.dy + ((row0 + i) * H + h) * P + r, i < l ? P - r : 0, a.vy, dv);
      const float w = i < l ? sW[i] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) dv[u] *= w;
      store8(sA + k * LD + r, cv);
      store8(sB + k * LD + r, dv);
    }
    __syncthreads();
    mma_step(sA, sB, ty, tx, acc);
  }
  float* out = a.gst + (size_t)bch * N * P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + frag(ty, r);
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int p = frag(tx, q);
      if (p < P) out[(size_t)n * P + p] = acc[r][q];
    }
  }
}

template <typename TX, bool BF16C>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const Args a, int nds) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if ((int)blockIdx.x < nds)
    ds_block<TX, BF16C>(a, blockIdx.x, smem);
  else
    dstate_block<TX>(a, blockIdx.x - nds, smem);
}

// ---- kernel 2: g leaving each chunk, in place, from the last chunk ----------
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

// ---- kernel 3a: dC (which 0) or dB (which 1) for one tile of rows and n -----
template <typename TX, bool BF16C>
__device__ void dbc_block(const Args& a, int blk, float* smem) {
  float* sA = smem;
  float* sB = sA + KT * LD;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int l = a.l, H = a.H, P = a.P, N = a.N;
  const int tn = blk % a.ntn;
  int q = blk / a.ntn;
  const int tr = q % a.nt;
  q /= a.nt;
  const int bc = q % (a.b * a.nc), which = q / (a.b * a.nc);
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const int r0 = tr * TILE, n0 = tn * TILE;
  const size_t row0 = (size_t)bc * l;
  const TX* Bm = static_cast<const TX*>(a.B);
  const TX* Cm = static_cast<const TX*>(a.C);
  const TX* x = static_cast<const TX*>(a.x);
  const float* ds = a.dS + row0 * l;

  float acc[8][8];
  zero(acc);
  // dS·B (rows i, k = j <= i) or dSᵀ·C (rows j, k = i >= j), B and C rounded
  // as the forward's C·Bᵀ read them
  const TX* other = which == 0 ? Bm : Cm;
  const int kbeg = which == 0 ? 0 : r0;
  const int kend = which == 0 ? min(l, r0 + TILE) : l;
  for (int k0 = kbeg; k0 < kend; k0 += KT) {
    __syncthreads();
    if (which == 0) {
      for (int g = tid; g < TILE * KT / 4; g += THREADS) {  // 4 j of a row i
        const int r = g % TILE, k = g / TILE * 4;
        const int i = r0 + r, j = k0 + k;
        float v[4];
        load4(ds + (size_t)i * l + j, i < l ? kend - j : 0, a.vl, v);
#pragma unroll
        for (int u = 0; u < 4; ++u) sA[(k + u) * LD + r] = v[u];
      }
    } else {
      for (int g = tid; g < KT * TILE / 4; g += THREADS) {  // 4 rows j of dS row i
        const int k = g / (TILE / 4), r = g % (TILE / 4) * 4;
        const int i = k0 + k, j = r0 + r;
        float v[4];
        load4(ds + (size_t)i * l + j, i < l ? l - j : 0, a.vl, v);
        *reinterpret_cast<float4*>(sA + k * LD + r) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int g = tid; g < KT * TILE / 8; g += THREADS) {  // 8 n at a time
      const int k = g / (TILE / 8), n = g % (TILE / 8) * 8;
      const int t = k0 + k;
      float v[8];
      load8(other + (row0 + t) * N + n0 + n, t < kend ? N - n0 - n : 0, a.vn, v);
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = rnd<BF16C>(v[u]);
      store8(sB + k * LD + n, v);
    }
    __syncthreads();
    mma_step(sA, sB, ty, tx, acc);
  }
  // the head terms, k = (h, p) over H·P: dC gets exp(cs_i)·dy_i[p] against
  // h_in[n][p]; dB gets exp(cs_L − cs_j)·dt_j·x_j[p] against g[n][p]
  const int K2 = H * P;
  const bool grouped = P % 8 == 0;                // a group of 8 k stays in one head
  const float* state = which == 0 ? a.st : a.gst;
  const double* csb = a.cs + head_row(a, bi, 0, c) * l;   // + h·nc·l
  const size_t hstep = (size_t)a.nc * l;
  for (int k0 = 0; k0 < K2; k0 += KT) {
    __syncthreads();
    for (int g = tid; g < TILE * KT / 8; g += THREADS) {  // 8 k of a row, rows fastest
      const int r = g % TILE, k = g / TILE * 8;
      const int t = r0 + r, kk = k0 + k;
      const auto weight = [&](int h) {            // the head's factor at row t
        const double* csr = csb + h * hstep;
        return which == 0 ? expf((float)csr[t])
                          : expf((float)(csr[l - 1] - csr[t])) * a.dt[(row0 + t) * H + h];
      };
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (t < l && kk < K2) {
        const size_t at = (row0 + t) * (size_t)K2 + kk;   // dy or x at (t, h, p)
        if (which == 0) load8(a.dy + at, K2 - kk, a.vy, v);
        else load8(x + at, K2 - kk, a.vx, v);
        if (grouped) {
          const float w = weight(kk / P);
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] *= w;
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (kk + u < K2) v[u] *= weight((kk + u) / P);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) sA[(k + u) * LD + r] = v[u];
    }
    for (int g = tid; g < KT * TILE / 8; g += THREADS) {  // 8 k of a column n
      const int nl = g % TILE, k = g / TILE * 8;
      const int n = n0 + nl, kk = k0 + k;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (n < N && kk < K2) {
        if (grouped) {                            // 8 p of one head: 16-byte loads
          const int h = kk / P;
          load8(state + (((size_t)bc * H + h) * N + n) * P + (kk - h * P), v);
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int f = kk + u, h = f / P;
            if (f < K2) v[u] = state[(((size_t)bc * H + h) * N + n) * P + (f - h * P)];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) sB[(k + u) * LD + nl] = v[u];
    }
    __syncthreads();
    mma_step(sA, sB, ty, tx, acc);
  }
  TX* out = static_cast<TX*>(which == 0 ? a.dC : a.dB);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = r0 + frag(ty, r);
    if (t >= l) continue;
    TX* o = out + (row0 + t) * N + n0;
    store4(o + tx * 4, N - n0 - tx * 4, a.vn, acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    store4(o + 32 + tx * 4, N - n0 - 32 - tx * 4, a.vn, acc[r][4], acc[r][5],
           acc[r][6], acc[r][7]);
  }
}

// ---- kernel 3b: du for one head and 64-row tile; dx, x·du, s_j, y_off term --
template <typename TX, bool BF16C>
__device__ void dx_block(const Args& a, int blk, float* smem) {
  float* sA = smem;
  float* sB = sA + KT * LD;
  double* sCS = reinterpret_cast<double*>(sB + KT * LD);   // cs[0, l)
  float* sDT = reinterpret_cast<float*>(sCS + a.l);        // dt[0, l)
  float* sRed = sDT + a.l;                                 // 2: the warps' sums
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int lane = tid & 31, warp = tid >> 5;
  const int l = a.l, H = a.H, P = a.P, N = a.N;
  const int nbch = a.b * a.nc * H;
  const int tr = blk / nbch;                      // row tile 0, the heaviest, first
  const int bch = blk % nbch;                     // (b·nc + c)·H + h
  const int h = bch % H, bc = bch / H;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const int r0 = tr * TILE;
  const size_t row0 = (size_t)bc * l;
  const size_t hr = head_row(a, bi, h, c);
  const TX* x = static_cast<const TX*>(a.x);
  const TX* Bm = static_cast<const TX*>(a.B);
  const TX* Cm = static_cast<const TX*>(a.C);
  const double* csr = a.cs + hr * l;
  for (int t = tid; t < l; t += THREADS) {
    sCS[t] = csr[t];
    sDT[t] = a.dt[(row0 + t) * H + h];
  }
  const float* hin = a.st + (size_t)bch * N * P;
  const float* gc = a.gst + (size_t)bch * N * P;

  // the y_off term of dcs: exp(cs_i)·Σ_p dy_i[p]·(C_i·h_in)[p]
  float acc[8][8];
  zero(acc);
  rows_times_state(Cm, hin, row0, r0, l, N, P, a.vn, a.vx, sA, sB, acc);  // publishes sCS, sDT
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = r0 + frag(ty, r);
    float part = 0.f;
    if (i < l) {
      const float* dyr = a.dy + ((row0 + i) * H + h) * P;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = frag(tx, q);
        if (p < P) part += acc[r][q] * dyr[p];
      }
    }
    part = row_sum(part);
    if (tx == 0 && i < l) a.off[hr * l + i] = expf((float)sCS[i]) * part;
  }
  // g·B_j: s_j = exp(cs_L − cs_j)·dt_j·Σ_p x_j[p]·(g B_j)[p], and the state
  // part of du, exp(cs_L − cs_j)·(g B_j)
  zero(acc);
  rows_times_state(Bm, gc, row0, r0, l, N, P, a.vn, a.vx, sA, sB, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = r0 + frag(ty, r);
    const bool ok = j < l;
    const float e = ok ? expf((float)(sCS[l - 1] - sCS[j])) : 0.f;
    float part = 0.f;
    if (ok) {
      const TX* xr = x + ((row0 + j) * H + h) * P;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = frag(tx, q);
        if (p < P) part += acc[r][q] * to_f(xr[p]);
      }
    }
    part = row_sum(part);
    if (tx == 0 && ok) a.sj[hr * l + j] = e * sDT[j] * part;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] *= e;
  }
  // + Σ_{i >= j} rnd(rnd(C_i·B_j)·exp(cs_i − cs_j))·dy_i: rows j, k = i
  const float* cb = a.cbt + row0 * l;
  for (int k0 = r0; k0 < l; k0 += KT) {
    __syncthreads();
    for (int g = tid; g < TILE * KT / 4; g += THREADS) {  // 4 i of CBᵀ row j
      const int r = g % TILE, k = g / TILE * 4;
      const int j = r0 + r, i = k0 + k;
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < l && i < l && i + 3 >= j) {
        float cbv[4];
        load4(cb + (size_t)j * l + i, l - i, a.vl, cbv);
        const double cj = sCS[j];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i + u >= j && i + u < l)
            gv[u] = rnd<BF16C>(cbv[u] * expf((float)(sCS[i + u] - cj)));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) sA[(k + u) * LD + r] = gv[u];
    }
    for (int g = tid; g < KT * TILE / 8; g += THREADS) {  // 8 p at a time
      const int k = g / (TILE / 8), p = g % (TILE / 8) * 8;
      const int i = k0 + k;
      float v[8];
      load8(a.dy + ((row0 + i) * H + h) * P + p, i < l ? P - p : 0, a.vy, v);
      store8(sB + k * LD + p, v);
    }
    __syncthreads();
    mma_step(sA, sB, ty, tx, acc);
  }
  TX* dx = static_cast<TX*>(a.dx);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = r0 + frag(ty, r);
    const bool ok = j < l;
    float part = 0.f;
    if (ok) {
      const TX* xr = x + ((row0 + j) * H + h) * P;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = frag(tx, q);
        if (p < P) part += to_f(xr[p]) * acc[r][q];
      }
    }
    part = row_sum(part);
    if (tx == 0 && ok) a.ddt[(row0 + j) * H + h] = part;   // kernel 4 adds A·da
    if (ok) {
      const float d = sDT[j];
      TX* o = dx + ((row0 + j) * H + h) * P;
      store4(o + tx * 4, P - tx * 4, a.vx, d * acc[r][0], d * acc[r][1],
             d * acc[r][2], d * acc[r][3]);
      store4(o + 32 + tx * 4, P - 32 - tx * 4, a.vx, d * acc[r][4], d * acc[r][5],
             d * acc[r][6], d * acc[r][7]);
    }
  }
  if (tr == 0) {                                  // exp(cs_L)·⟨g, h_in⟩, once a chunk
    float v = 0.f;
    for (int e = tid; e < N * P; e += THREADS) v += gc[e] * hin[e];
    v = xor_sum(v, 1, 32);
    if (lane == 0) sRed[warp] = v;
    __syncthreads();
    if (tid == 0) a.gh[hr] = expf((float)sCS[l - 1]) * (sRed[0] + sRed[1]);
  }
}

template <typename TX, bool BF16C>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_grad_kernel(const Args a, int nbc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if ((int)blockIdx.x < nbc)
    dbc_block<TX, BF16C>(a, blockIdx.x, smem);
  else
    dx_block<TX, BF16C>(a, blockIdx.x - nbc, smem);
}

// ---- kernel 4: dcs, its reverse cumulative sum (f64), ddt += A·da, dA ------
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
// 64 floats: gst, dS, part, off, sj, gh.
struct Pieces {
  size_t n[6];
};

Pieces pieces(int b, int T, int H, int P, int N, int l) {
  const size_t nc = (size_t)T / l, nt = (l + TILE - 1) / TILE;
  Pieces s = {{(size_t)b * nc * H * N * P, (size_t)b * nc * l * l,
               (size_t)b * H * nc * nt * l, (size_t)b * H * nc * l,
               (size_t)b * H * nc * l, (size_t)b * H * nc}};
  for (size_t& v : s.n) v = (v + 63) / 64 * 64;
  return s;
}

template <typename TX, bool BF16C>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t tiles = sizeof(float) * 2 * KT * LD;
  const int bnc = a.b * a.nc;
  const int nds = bnc * a.nt * (a.nt + 1) / 2;
  const int nstate = bnc * a.H * a.ntn;
  const size_t ds_smem = tiles + sizeof(float) * (TILE * SLD + 4 * TILE) +
                         sizeof(double) * 2 * TILE;
  const size_t st_smem = tiles + sizeof(float) * a.l;
  cudaError_t err;
  ssd_bwd_chunk_kernel<TX, BF16C><<<nds + nstate, THREADS,
                                    ds_smem > st_smem ? ds_smem : st_smem, s>>>(a, nds);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = (size_t)a.b * a.H * a.N * a.P;
  ssd_bwd_pass_kernel<<<(unsigned)((total + PASS_THREADS - 1) / PASS_THREADS),
                        PASS_THREADS, 0, s>>>(a, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nbc = 2 * bnc * a.nt * a.ntn;
  const int ndx = bnc * a.H * a.nt;
  const size_t dx_smem = tiles + (sizeof(double) + sizeof(float)) * a.l + 4 * sizeof(float);
  ssd_bwd_grad_kernel<TX, BF16C><<<nbc + ndx, THREADS, dx_smem, s>>>(a, nbc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_cumsum_kernel<<<a.H, CS_THREADS, sizeof(double) * CS_THREADS / 32, s>>>(a);
  return cudaGetLastError();
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

// dtype: 0 = float32, 1 = bfloat16 (x, B and C, and dx, dB, dC alike); dt,
// A, dy, dh, ddt, dA and dh0 f32.  bf16_compute as in ssd_launch.  cs, cbt
// and st are the forward's scratch for the same inputs, after its pass 4.
// dh and dh0 may be null (a zero final-state gradient; no h0).  `work` holds
// ssd_bwd_workspace_floats(b, T, H, P, N, l) floats on the device of x.
// Launches the four kernels on `stream` and returns the first CUDA error.
extern "C" int ssd_bwd_launch(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* cs,
                              const void* cbt, const void* st, const void* dy,
                              const void* dh, void* dx, void* ddt, void* dA,
                              void* dB, void* dC, void* work, void* dh0,
                              int dtype, int bf16_compute, int b, int T, int H,
                              int P, int N, int l, void* stream) {
  if (b <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      l <= 0 || l > MAX_L || T % l)
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
  a.dS = a.gst + s.n[0];
  a.part = a.dS + s.n[1];
  a.off = a.part + s.n[2];
  a.sj = a.off + s.n[3];
  a.gh = a.sj + s.n[4];
  a.b = b; a.T = T; a.H = H; a.P = P; a.N = N; a.l = l;
  a.nc = T / l; a.nt = (l + TILE - 1) / TILE; a.ntn = (N + TILE - 1) / TILE;
  // 16-byte loads and stores where rows of x and dx (P), of B, C, dB and dC
  // (N) and of dy (P) come in whole groups of 8, and l-long rows in groups
  // of 4; the workspace and the scratch are aligned
  a.vx = P % 8 == 0 && aligned(x) && aligned(dx);
  a.vn = N % 8 == 0 && aligned(B) && aligned(C) && aligned(dB) && aligned(dC);
  a.vy = P % 8 == 0 && aligned(dy);
  a.vl = l % 4 == 0 && aligned(cbt) && aligned(work);
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && !bf16_compute)
    err = launch<float, false>(a, st_);
  else if (dtype == 0)
    err = launch<float, true>(a, st_);
  else if (dtype == 1 && !bf16_compute)
    err = launch<__nv_bfloat16, false>(a, st_);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, true>(a, st_);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
