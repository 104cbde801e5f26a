// Smith-Waterman local alignment score, affine gaps — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel `_sw_kernel` in
// src/repro/kernels/smith_waterman.py (called through `sw_pallas`) and
// computes what it computes: the best local-alignment score of one query
// profile (A, Qp) against each subject, gap_open charged on the first gap
// residue, F in closed form as an exclusive prefix-max over the query axis
// (exact when gap_open >= gap_extend), subject chars >= A skipped.
//
// What bounds it on an H100: instruction issue.  Each subject is a
// sequential recurrence over its chars, each char one dependent step over
// the whole query column (about 15 f32 adds and maxes per cell, no FMA),
// reading a 24 x Qp f32 profile that stays on chip.  Bytes are negligible;
// the 67 TFLOP/s f32 rate counts an FMA as two operations, so adds and maxes
// alone reach at most about half of it.  The card fills only when many
// subjects run at once: the main path hands the kernel a length-sorted chunk
// of thousands of subjects per launch.
//
// Two kernels; sw_launch picks one by Qp alone:
//   * Qp <= 1024: sw_warp_kernel<L>, L = Qp / 32 in {4, 8, ..., 32}.  One
//     warp scores one subject end to end; a block holds WARPS warps
//     (independent subjects), the grid is ceil(B / WARPS) blocks.  Lane l
//     owns query rows l*L .. l*L+L-1 and keeps their H, E and h_hat in
//     registers.  Per char (the same c in every lane, so the padding branch
//     is uniform): e_new and h_hat from the profile, H[i-1] of the lane's
//     first row by one __shfl_up_sync; a running max of h_hat + i*ge over
//     the run; an exclusive __shfl_up_sync max-scan over the warp; a second
//     pass that rebuilds the lane-local prefix from h_hat and forms f and
//     h_new.  No shared-memory traffic but the profile, no barrier inside
//     the subject loop.  Rows at or past q_len never feed a row below it,
//     so they are left unmasked and only kept out of the best score.
//     The profile sits in shared memory once per block (A * Qp * 4 bytes,
//     96 KB at Qp = 1024, dynamic), striped so that element (c, l*L + k)
//     lies at c*Qp + (k/4)*128 + l*4 + k%4: each float4 read of the warp
//     covers 512 contiguous bytes, free of bank conflicts.
//   * Qp > 1024 (up to 8192): sw_kernel<L>, one 1024-thread block per
//     subject, each thread a run of L = Qp / 1024 rows, the prefix-max a
//     warp scan plus a scan of the warp totals in shared memory, two
//     barriers a char.
// Both keep the best score in a register and reduce it once, at the end:
// max commutes, so this equals the per-char max of the reference.
// Exactness: f32 with the reference's expression order (h_shift + s,
// p - go - (i-1)*ge, h_hat + i*ge) through __fadd_rn/__fsub_rn/__fmul_rn,
// which never contract into an FMA (the build also passes --fmad=false).
// The scores are integer-valued f32 for integer gaps and stay bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_QP = 1024;  // largest Qp of the warp kernel (L = 32)
// Subjects (warps) per block of the warp kernel: 4 and 8 time within a few
// percent of each other at a chunk of 4096 subjects; 4 is faster at Qp 1024.
constexpr int WARPS = 4;

__device__ __forceinline__ float warp_inclusive_max(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = fmaxf(v, o);
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

template <int L>
__global__ void __launch_bounds__(MAX_THREADS)
sw_kernel(const float* __restrict__ profile, const int32_t* __restrict__ subjects,
          const int32_t* __restrict__ lengths, float* __restrict__ out,
          int A, int Qp, int q_len, int Dp, float go, float ge) {
  __shared__ float s_wtot[32];   // per warp: max of h_hat + i*ge over its lanes
  __shared__ float s_wlast[32];  // per warp: H of its last lane, previous char
  __shared__ float s_best[32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;  // blockDim.x is a multiple of 128
  const int32_t* subj = subjects + (size_t)blockIdx.x * Dp;
  const int len = lengths ? min(lengths[blockIdx.x], Dp) : Dp;
  const int i0 = tid * L;  // this thread's first query lane

  float h[L], e[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    h[k] = 0.f;
    e[k] = NEG;
  }
  float best = 0.f;
  if (lane == 31) s_wlast[warp] = 0.f;
  __syncthreads();

  for (int j = 0; j < len; ++j) {
    const int c = __ldg(subj + j);
    if (c >= A) continue;  // padding; every thread reads the same c
    const float* prow = profile + (size_t)(c < 0 ? 0 : c) * Qp;

    // H[i-1] of the previous char for this thread's first lane
    float left = __shfl_up_sync(FULL, h[L - 1], 1);
    if (lane == 0) left = warp == 0 ? 0.f : s_wlast[warp - 1];

    float hh[L], pre[L];
    float run = NEG;  // max of h_hat + i*ge over this thread's earlier lanes
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + k;
      const float hs = k == 0 ? left : h[k - 1];
      const float en = fmaxf(__fsub_rn(h[k], go), __fsub_rn(e[k], ge));
      float v = 0.f;
      if (i < q_len) v = fmaxf(fmaxf(__fadd_rn(hs, __ldg(prow + i)), en), 0.f);
      e[k] = en;
      hh[k] = v;
      pre[k] = run;
      run = fmaxf(run, __fadd_rn(v, __fmul_rn((float)i, ge)));  // + idx*ge
    }

    // exclusive prefix-max across the block: warp scan, then warp totals
    const float incl = warp_inclusive_max(run, lane);
    float wexcl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) wexcl = NEG;
    if (lane == 31) s_wtot[warp] = incl;
    __syncthreads();
    float t = lane < nwarps ? s_wtot[lane] : NEG;
    t = warp_inclusive_max(t, lane);
    float cross = __shfl_sync(FULL, t, (warp + 31) & 31);
    if (warp == 0) cross = NEG;
    const float base = fmaxf(cross, wexcl);

#pragma unroll
    for (int k = 0; k < L; ++k) {
      const float p = fmaxf(base, pre[k]);
      const float f =  // p - go - (idx - 1) * ge
          __fsub_rn(__fsub_rn(p, go), __fmul_rn((float)(i0 + k - 1), ge));
      const float hn = i0 + k < q_len ? fmaxf(hh[k], f) : 0.f;
      h[k] = hn;
      best = fmaxf(best, hn);
    }
    if (lane == 31) s_wlast[warp] = h[L - 1];
    __syncthreads();
  }

  best = warp_max(best);
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = warp_max(lane < nwarps ? s_best[lane] : 0.f);
    if (lane == 0) out[blockIdx.x] = best;
  }
}

// One warp per subject, Qp = 32 * L query rows, lane l owning rows
// l*L .. l*L+L-1.  Dynamic shared memory: the striped profile, A*Qp floats.
template <int L>
__global__ void __launch_bounds__(WARPS * 32)
sw_warp_kernel(const float* __restrict__ profile,
               const int32_t* __restrict__ subjects,
               const int32_t* __restrict__ lengths, float* __restrict__ out,
               int A, int q_len, int B, int Dp, float go, float ge) {
  static_assert(L % 4 == 0 && L >= 4 && L <= 32, "L = Qp / 32, Qp % 128 == 0");
  constexpr int ROW4 = 8 * L;  // float4s in one profile row (Qp / 4)
  extern __shared__ float4 s_prof[];

  // Stage the profile (16-byte aligned, the wrapper checks), striped:
  // shared float4 d = c*ROW4 + kq*32 + l holds rows i = l*L + 4*kq .. +3
  // of code c.
  const float4* prof4 = reinterpret_cast<const float4*>(profile);
  for (int d = threadIdx.x; d < A * ROW4; d += blockDim.x) {
    const int c = d / ROW4, r = d - c * ROW4;
    s_prof[d] = __ldg(prof4 + c * ROW4 + (r & 31) * (L / 4) + (r >> 5));
  }
  __syncthreads();  // the only barrier: warps never meet again

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // tail warps of the last block
  const int32_t* subj = subjects + (size_t)b * Dp;
  const int len = lengths ? min(lengths[b], Dp) : Dp;
  const int i0 = lane * L;                       // this lane's first row
  const int nv = min(max(q_len - i0, 0), L);     // its rows below q_len

  float ig[L + 1];  // ig[k] = (i0 + k - 1) * ge, as the reference's idx products
#pragma unroll
  for (int k = 0; k <= L; ++k) ig[k] = __fmul_rn((float)(i0 + k - 1), ge);
  float h[L], e[L], hh[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    h[k] = 0.f;
    e[k] = NEG;
  }
  float best = 0.f;

  for (int j0 = 0; j0 < len; j0 += 32) {
    // 32 chars at a time, one per lane, handed out by shuffle
    const int cblk = j0 + lane < len ? __ldg(subj + j0 + lane) : A;
    const int n = min(32, len - j0);
    for (int jj = 0; jj < n; ++jj) {
      const int c = __shfl_sync(FULL, cblk, jj);
      if (c >= A) continue;  // padding: the same c in every lane
      const float4* prow = s_prof + (c < 0 ? 0 : c) * ROW4 + lane;

      // H[i-1] of the previous char for this lane's first row
      float left = __shfl_up_sync(FULL, h[L - 1], 1);
      if (lane == 0) left = 0.f;

      float run = NEG;  // max of h_hat + i*ge over this lane's rows
#pragma unroll
      for (int kq = 0; kq < L / 4; ++kq) {
        const float4 s4 = prow[kq * 32];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = 4 * kq + u;
          const float hs = k == 0 ? left : h[k - 1];
          const float en = fmaxf(__fsub_rn(h[k], go), __fsub_rn(e[k], ge));
          const float v = fmaxf(fmaxf(__fadd_rn(hs, sv[u]), en), 0.f);
          e[k] = en;
          hh[k] = v;
          run = fmaxf(run, __fadd_rn(v, ig[k + 1]));
        }
      }

      // exclusive prefix-max over the warp: max over the lanes before
      float p = __shfl_up_sync(FULL, run, 1);
      if (lane == 0) p = NEG;
      p = warp_inclusive_max(p, lane);

      // second pass: p before row k is the max over every earlier row
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float f = __fsub_rn(__fsub_rn(p, go), ig[k]);  // p - go - (i-1)*ge
        const float hn = fmaxf(hh[k], f);
        h[k] = hn;
        if (k < nv) best = fmaxf(best, hn);
        p = fmaxf(p, __fadd_rn(hh[k], ig[k + 1]));
      }
    }
  }

  best = warp_max(best);
  if (lane == 0) out[b] = best;
}

template <int L>
int launch_warp(const float* profile, const int32_t* subjects,
                const int32_t* lengths, float* out, int A, int q_len, int B,
                int Dp, float go, float ge, cudaStream_t s) {
  const size_t smem = (size_t)A * 32 * L * sizeof(float);
  if (smem > 48 * 1024) {  // above the default, opt in first
    const cudaError_t err = cudaFuncSetAttribute(
        sw_warp_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sw_warp_kernel<L><<<(B + WARPS - 1) / WARPS, WARPS * 32, smem, s>>>(
      profile, subjects, lengths, out, A, q_len, B, Dp, go, ge);
  return (int)cudaGetLastError();
}

}  // namespace

// Score every subject on `stream`.  profile (A, Qp) f32, subjects (B, Dp)
// int32, lengths (B,) int32 or null (every row is Dp long), out (B,) f32.
// Qp <= 1024 runs the warp kernel, Qp > 1024 the block kernel.  Returns
// cudaGetLastError() after the launch.
extern "C" int sw_launch(const float* profile, const int32_t* subjects,
                         const int32_t* lengths, float* out, int A, int Qp,
                         int q_len, int B, int Dp, float go, float ge,
                         void* stream) {
  if (B <= 0) return 0;
  if (Qp <= 0 || Qp % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (Qp <= WARP_QP) {
#define SW_WARP_CASE(n)                                                   \
  case n:                                                                 \
    return launch_warp<n>(profile, subjects, lengths, out, A, q_len, B,   \
                          Dp, go, ge, s);
    switch (Qp / 32) {
      SW_WARP_CASE(4) SW_WARP_CASE(8) SW_WARP_CASE(12) SW_WARP_CASE(16)
      SW_WARP_CASE(20) SW_WARP_CASE(24) SW_WARP_CASE(28) SW_WARP_CASE(32)
    }
#undef SW_WARP_CASE
  }
  const int L = (Qp + MAX_THREADS - 1) / MAX_THREADS;
#define SW_CASE(n)                                                          \
  case n:                                                                   \
    sw_kernel<n><<<B, MAX_THREADS, 0, s>>>(profile, subjects, lengths, out, \
                                           A, Qp, q_len, Dp, go, ge);       \
    break;
  switch (L) {
    SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5)
    SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SW_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
