// Flash attention forward (causal / sliding-window GQA) — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py (called through `flash_attention`)
// and computes what it computes: softmax(q·kᵀ·D^-0.5 + mask)·v with an
// online softmax, m, l and acc in f32, P rounded to v's dtype before P·V,
// masked scores set to NEG = -1e9, kv tiles that are entirely masked
// skipped, the GQA kv head h / group read in place, output in q's dtype.
// It adds `q_offset` (absolute position of q row 0 against k row 0), which
// the model's attention takes.  Any strides with a unit last axis: the
// model passes its (B, S, H, D) tensors as (B, H, S, D) views, and nothing
// is transposed or copied.
//
// What bounds it on an H100: operations.  4·D flops per (query, key) pair
// against 2·D·bytes per row of q, k, v and o: at D = 80 and S = T = 4096
// that is ~1000 flops per byte, far above the card's ~295 bf16 flops per
// byte, so the ceiling is the 989 TFLOP/s bf16 tensor-core rate and, next
// to it, the exponentials of the softmax (one per pair, on the 16-wide
// MUFU pipe of each SM).
//
// bfloat16: `fa_wgmma_kernel`, FlashAttention-3's layout.
//   * One block per (batch·head, 128-row q tile), 288 threads: two
//     consumer warpgroups of 64 q rows each and one producer warp.  Blocks
//     are issued heaviest q tile first (the q tile is the slow grid axis,
//     reversed), so the causal triangle does not end in a tail of long
//     blocks.
//   * The producer warp loads Q once and then K and V tiles of 128 rows by
//     TMA (cp.async.bulk.tensor, 4-d maps over (D, rows, heads, batch)
//     built on the host per call, so any 16-byte-aligned strides are taken
//     as they are) into a 3-stage ring; an mbarrier per stage and tensor
//     signals each arrival, another per stage says both consumers are done
//     with it.  TMA zero-fills rows past S and T; the kpos < T mask still
//     applies, because a zero key scores 0, not NEG.
//   * Both products run on the tensor cores as wgmma on bf16 with f32
//     accumulators: S = Q·Kᵀ as m64n128k16 with Q and K from shared
//     memory (D/16 k-steps, five at D = 80), O += P·V as m64nDk16 with P
//     from registers and V read in place, row-major, through wgmma's
//     transpose of B.
//   * S and P never touch shared memory.  The softmax runs on the
//     accumulator fragment (each thread holds 2 rows x 32 columns); row max
//     and row sum reduce over the 4 lanes that share a row by shuffles; P
//     is rounded to bf16 in registers (the reference's rounding of P to v's
//     dtype) and is, as laid out, the A fragment of the P·V wgmma.  The
//     softmax works in base 2 (scores times D^-0.5·log2 e, masked ones at
//     NEG·log2 e), which gives the same p and alpha.
//   * Shared memory layout: D = 80 is 160 bytes a row, which does not fill
//     a 128-byte swizzle atom.  Every tile is stored as D/16 column chunks
//     of 16 elements (32 bytes) x rows, each loaded by its own TMA box with
//     the 32-byte swizzle.  A wgmma k-step of 16 elements is exactly one
//     chunk, so the same layout is Q's and K's K-major operand and V's
//     MN-major one (chunk stride LBO, 8-row stride SBO = 256 bytes).  The
//     swizzle puts the 8 rows of a core matrix (8 x 16 bytes, 32 bytes
//     apart) on 8 different 16-byte bank groups, so the tensor cores read
//     without conflicts and nothing is padded: 20 KiB per 128-row tile at
//     D = 80, 140 KiB per block with the 3-stage ring (224 KiB at D = 128).
//     (The 128-byte swizzle, with D = 80 padded to 128 columns by TMA's
//     zero fill, measured no faster and needs 32 KiB a tile.)
//     The TMA, mbarrier and wgmma helpers live in csrc/fa_hopper.cuh,
//     shared with the backward kernels.
//   * Each warpgroup runs Q·Kᵀ, its softmax and P·V of a tile in turn,
//     waiting for each wgmma group; the two warpgroups of a block (one
//     block per SM, 167 registers a thread at D = 80) fill each other's
//     waits, one on the tensor cores while the other is in its softmax.
//   * Tiles that no row of a warpgroup can see are skipped by that
//     warpgroup (it still waits for them and releases them); masks are
//     computed only on tiles that cut the diagonal, the window edge or T.
//   * Given a `stats` buffer (training), the epilogue also writes each
//     row's softmax statistics for the backward kernel
//     (csrc/flash_attention_bwd.cu): two f32 planes of B·H·S values, row
//     (b·H + h)·S + s, the final running max m in the base-2 domain (the
//     score times D^-0.5·log2 e, NEG·log2 e where every visited key is
//     masked or no tile was visited) and 1/l, l = Σ 2^(score - m) over the
//     visited slots, 0 where l = 0.  m and 1/l stay apart: NEG + log l
//     would round back to NEG in f32.  The write is a template instance of
//     its own (STATS), so the kernel without it is the inference path's,
//     unchanged.
//
// float32: `fa_kernel`, on the f32 FMA pipes.  wgmma on f32 inputs would
// be TF32, which keeps 10 mantissa bits and cannot meet the reference's
// 2e-5 f32 tolerance; the model runs f32 only in the consistency check.
//   * One block per (batch·head, 64-row q tile), 256 threads, looping over
//     64-row kv tiles converted to f32 in shared memory (row stride D + 1
//     floats, so 16 threads reading 16 k rows hit 16 banks).
//   * Each thread owns a 4 x 4 micro-tile of the 64 x 64 score tile; row
//     max and sum reduce over the 16 lanes of a row by xor shuffles; P goes
//     through shared memory; each thread owns 4 rows x D/16 columns of acc.
//
// D is a template parameter, any multiple of 16 up to 128, in both; and
// D = 224 (Zamba2-7B's shared attention, 32 heads over 2 x 3584 inputs) in
// the bfloat16 kernel only.  There the kv tiles are 64 rows (`kv_rows`):
// S = Q·Kᵀ is m64n64k16 (32 scores a thread), P is 16 registers, and the
// warpgroup's 64 x 224 f32 output (112 registers a thread) takes P·V as two
// m64n112k16 halves; Q (56 KiB) and a 3-stage ring of 64-row K and V tiles
// (28 KiB each) fill 224 KiB of shared memory.  The skip rule then works on
// 64-key tiles, and the backward is told so (its `kv_tile`).  A block there
// has a producer warpgroup, which gives its registers to the consumers
// (`block_threads`).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fa_hopper.cuh"

namespace {

constexpr float NEG = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- float32
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;

struct Strides {  // elements, for (batch, head, row) of q, k, v, o
  long long q[3], k[3], v[3], o[3];
};

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

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, Strides st,
          int H, int group, int S, int Tk, float scale, int causal,
          int window, int q_offset) {
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
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];
  float* ob = o + b * st.o[0] + h * st.o[1];

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    sQ[r * LD + d] = q0 + r < S ? qb[(q0 + r) * st.q[2] + d] : 0.f;
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
      sK[r * LD + d] = ok ? kb[(k0 + r) * st.k[2] + d] : 0.f;
      sV[r * LD + d] = ok ? vb[(k0 + r) * st.v[2] + d] : 0.f;
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
        sP[(ty + 16 * a) * LDP + tx + 16 * c] = p;
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
    for (int j = 0; j < DJ; ++j) ob[r * st.o[2] + tx + 16 * j] = acc[a][j] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const Strides& st, int B, int H, int Hkv, int S, int Tk,
                       float scale, int causal, int window, int q_offset,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  fa_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, H, H / Hkv, S,
      Tk, scale, causal, window, q_offset);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16
constexpr int WBQ = 128;            // q rows per block: two warpgroups of 64
constexpr int WBK = 128;            // kv rows per tile up to D = 128
constexpr int STAGES = 3;           // K/V ring depth (224 KiB of shared memory at D = 128)
constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int WTHREADS = CONSUMERS + 32;   // + the producer warp
constexpr float NEG2 = NEG * LOG2E; // a masked score in the base-2 domain

// kv rows per tile: 128 up to D = 128; 64 above, so that a warpgroup's
// scores (32 f32 a thread) and P (16 registers) sit beside its D/2 f32
// accumulators (112 at D = 224) and the 3-stage ring fits shared memory
// (Q 56 KiB + 3 x 2 x 28 KiB at D = 224).  The skip rule's kv tile, and
// so the backward's `kv_tile`, is this size.
template <int D> __host__ __device__ constexpr int kv_rows() { return D > 128 ? 64 : WBK; }
// Threads a block: from D = 224 the producer is a whole warpgroup (one warp
// of it loads), so that it can hand its registers to the consumers with
// setmaxnreg (24 and 240 a thread, from 168): 112 f32 accumulators, 32
// scores and 16 P registers a thread spill at 168.
template <int D> __host__ __device__ constexpr int block_threads() {
  return D > 128 ? CONSUMERS + 128 : WTHREADS;
}

template <int D, bool STATS>
__global__ void __launch_bounds__(block_threads<D>(), 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, long long so_b, long long so_h,
                long long so_r, float* __restrict__ stats, int H, int group,
                int S, int Tk, float scale_log2, int causal, int window,
                int q_offset) {
  constexpr int BK = kv_rows<D>();
  constexpr uint32_t TILE = D * WBQ * 2;      // bytes of the 128-row Q tile
  constexpr uint32_t KTILE = D * BK * 2;      // bytes of one K or V tile
  constexpr int NCH = D / CHUNK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + TILE;                 // + stage * KTILE
  const uint32_t sV = sK + STAGES * KTILE;
  const uint32_t q_full = sV + STAGES * KTILE;   // then k_full, v_full, empty
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };

  const int qt = gridDim.y - 1 - blockIdx.y;     // heaviest q tile first
  const int q0 = qt * WBQ;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / group;

  // the kv tiles some row of this block can see
  const int qlo = q0 + q_offset, qhi = q0 + WBQ - 1 + q_offset;
  const int nk = (Tk + BK - 1) / BK;
  const int kt_end = causal ? min(nk, qhi / BK + 1) : nk;
  const int first = qlo - window + 1;           // first key row qlo may see
  const int kt_begin = (window > 0 && first > 0) ? first / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {                // ---- producer warp ----
    if constexpr (block_threads<D>() > WTHREADS) setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, TILE);
      tma_tile<D>(sQ, &tq, q_full, q0, h, b, WBQ);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        mbar_wait(empty(s), ph ^ 1);             // both warpgroups are done
        mbar_expect_tx(k_full(s), KTILE);
        tma_tile<D>(sK + s * KTILE, &tk, k_full(s), kt * BK, hk, b, BK);
        mbar_expect_tx(v_full(s), KTILE);
        tma_tile<D>(sV + s * KTILE, &tv, v_full(s), kt * BK, hk, b, BK);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each ----
  if constexpr (block_threads<D>() > WTHREADS) setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32, g = lane / 4, c = lane % 4;
  const int row0 = q0 + wg * 64 + (t / 32) * 16 + g;   // this thread's rows:
  const int qp0 = row0 + q_offset, qp1 = qp0 + 8;       // row0 and row0 + 8
  const int wlo = q0 + wg * 64 + q_offset, whi = wlo + 63;

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float m0 = NEG2, m1 = NEG2, l0 = 0.f, l1 = 0.f;   // l: this thread's part

  const uint64_t dq = smem_desc(sQ + wg * 64 * 32, 16, 256);
  mbar_wait(q_full, 0);
  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = kt * BK;
    const bool live = (!causal || k0 <= whi) &&
                      (window <= 0 || k0 + BK - 1 > wlo - window);
    mbar_wait(k_full(s), ph);
    if (live) {
      float sc[BK / 2];
      const uint64_t dk = smem_desc(sK + s * KTILE, 16, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NCH; ++kk) {
        if constexpr (BK == 128)
          wgmma_qk(sc, dq + ((kk * WBQ * 32) >> 4), dk + ((kk * BK * 32) >> 4),
                   kk > 0);
        else
          wgmma_ss64(sc, dq + ((kk * WBQ * 32) >> 4), dk + ((kk * BK * 32) >> 4),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // sc[j]: row row0 + 8·((j>>1)&1), key k0 + (j>>2)·8 + 2c + (j&1)
      const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > wlo) ||
                        (window > 0 && k0 <= whi - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int kpos = k0 + (j >> 2) * 8 + 2 * c + (j & 1);
          const int qp = (j & 2) ? qp1 : qp0;
          bool ok = kpos < Tk;
          if (causal) ok = ok && kpos <= qp;
          if (window > 0) ok = ok && kpos > qp - window;
          sc[j] = ok ? sc[j] * scale_log2 : NEG2;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] *= scale_log2;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        if (j & 2) mx1 = fmaxf(mx1, sc[j]);
        else mx0 = fmaxf(mx0, sc[j]);
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
      }
      const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      uint32_t pf[BK / 4];   // P in bf16: the A fragments of the P·V wgmma
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 2; j += 2) {
        const float mm = (j & 2) ? mx1 : mx0;
        const float p0 = ex2(sc[j] - mm), p1 = ex2(sc[j + 1] - mm);
        if (j & 2) s1 += p0 + p1;
        else s0 += p0 + p1;
        pf[j / 2] = pack_bf16(p0, p1);
      }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? a1 : a0;

      const uint64_t dv = smem_desc(sV + s * KTILE, BK * 32, 256);
      mbar_wait(v_full(s), ph);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<D>::run(acc, &pf[4 * kk], dv + ((kk * 16 * 32) >> 4));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    } else {
      mbar_wait(v_full(s), ph);
    }
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if constexpr (STATS) {
    if (c == 0) {   // m (base 2) and 1/l, one lane a row
      float* sm = stats + (long long)bh * S;
      float* sl = sm + (long long)gridDim.x * S;
      if (row0 < S) {
        sm[row0] = m0;
        sl[row0] = l0 > 0.f ? 1.f / l0 : 0.f;
      }
      if (row0 + 8 < S) {
        sm[row0 + 8] = m1;
        sl[row0 + 8] = l1 > 0.f ? 1.f / l1 : 0.f;
      }
    }
  }
  __nv_bfloat16* ob = o + b * so_b + h * so_h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * c;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * so_r + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * so_r + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* stats, const Strides& st, int B, int H, int Hkv, int S,
                int Tk, float scale, int causal, int window, int q_offset,
                cudaStream_t stream) {
  static const EncodeTiledFn encode =
      reinterpret_cast<EncodeTiledFn>(cu_entry_point("cuTensorMapEncodeTiled"));
  if (!encode) return (int)cudaErrorSymbolNotFound;
  constexpr int BK = kv_rows<D>();
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(encode, &tq, q, D, S, H, B, 2 * st.q[2], 2 * st.q[1],
                        2 * st.q[0], WBQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tk, k, D, Tk, Hkv, B, 2 * st.k[2], 2 * st.k[1],
                 2 * st.k[0], BK);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tv, v, D, Tk, Hkv, B, 2 * st.v[2], 2 * st.v[1],
                 2 * st.v[0], BK);
  if (r != CUDA_SUCCESS) return CU_ERR + (int)r;
  const size_t smem = 1024 + (size_t)D * 2 * (WBQ + 2 * STAGES * BK) +
                      8 * (1 + 3 * STAGES);
  // Without a stats buffer the kernel is compiled without the stats write.
  auto kernel = stats ? fa_wgmma_kernel<D, true> : fa_wgmma_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + WBQ - 1) / WBQ);
  constexpr int threads = block_threads<D>();
  kernel<<<grid, threads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st.o[0], st.o[1], st.o[2],
      stats, H, H / Hkv, S, Tk, scale * LOG2E, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <bool BF16, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* stats,
           const Strides& st, int B, int H, int Hkv, int S, int Tk, float scale,
           int causal, int window, int q_offset, cudaStream_t s) {
  if constexpr (BF16)
    return launch_bf16<D>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale,
                          causal, window, q_offset, s);
  else
    return (int)launch_f32<D>(q, k, v, o, st, B, H, Hkv, S, Tk, scale, causal,
                              window, q_offset, s);
}

template <bool BF16>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               float* stats, const Strides& st, int B, int H, int Hkv, int S, int Tk,
               float scale, int causal, int window, int q_offset,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<BF16, 16>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 32: return launch<BF16, 32>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 48: return launch<BF16, 48>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 64: return launch<BF16, 64>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 80: return launch<BF16, 80>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 96: return launch<BF16, 96>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 112: return launch<BF16, 112>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 128: return launch<BF16, 128>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
    case 224:   // Zamba2-7B's shared attention: the bfloat16 kernel only
      if constexpr (BF16)
        return launch<BF16, 224>(q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
      else
        return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the wgmma/TMA
// kernel); q, k, v and o alike.  strides: 12 int64 element strides,
// (batch, head, row) of q, k, v, o in that order; for bfloat16 those of
// q, k and v must be multiples of 8 elements (16 bytes) and the pointers
// 16-byte aligned, as TMA requires (the wrapper checks).  window <= 0
// means none.  Returns 0, a cudaError_t, or 1000 + a CUresult of the
// tensor-map encode.  stats: null, or (bfloat16 only) 2·B·H·S floats that
// receive each row's m (base 2) and 1/l for the backward kernel.
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         float* stats, int dtype, int B, int H, int Hkv, int S,
                         int Tk, int D, const long long* strides, float scale,
                         int causal, int window, int q_offset, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || Tk <= 0 ||
      (stats != nullptr && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<false>(D, q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
  if (dtype == 1)
    return dispatch_d<true>(D, q, k, v, o, stats, st, B, H, Hkv, S, Tk, scale, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int err) { return cu_error_string(err); }
