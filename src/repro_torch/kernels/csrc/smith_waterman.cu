// Smith-Waterman local alignment score, affine gaps — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel `_sw_kernel` in
// src/repro/kernels/smith_waterman.py (called through `sw_pallas`) and
// computes what it computes: the best local-alignment score of one query
// profile (A, Qp) against each subject, gap_open charged on the first gap
// residue, F in closed form as an exclusive prefix-max over the query axis
// (exact when gap_open >= gap_extend), subject chars >= A skipped.
//
// What bounds it on an H100: neither bytes nor operations.  The work is a
// sequential recurrence over subject chars; each char is one dependent step
// over the whole query column (15 f32 operations per cell, reading a
// 24 x Qp f32 profile that stays in L1/L2), so the time is the latency of one
// step times the subject length: the block-wide scan and its barriers, not
// the 67 TFLOP/s f32 rate or the 3.35 TB/s memory rate.
//
// Design:
//   * One thread block per subject (grid = B), min(Qp, 1024) threads.  Each
//     thread owns a contiguous run of L = ceil(Qp / threads) query lanes and
//     keeps its H, E and running best in registers; the subject loop runs
//     inside the block, in place of the TPU's sequential grid axis.
//   * Per char: e_new and h_hat from the profile row; H[i-1] of a thread's
//     first lane comes from its neighbour by warp shuffle (across warps
//     through shared memory); the exclusive prefix-max of h_hat + i*ge is a
//     thread-local scan, a warp __shfl_up_sync max-scan, and a scan of the
//     warp totals in shared memory; then f and h_new.  Two barriers a char.
//   * The best score is reduced over the block once, at the end: max
//     commutes, so this equals the per-char max of the reference.
//   * Exactness: f32 with the reference's expression order
//     (h_shift + s, p - go - (i-1)*ge) through __fadd_rn/__fsub_rn/__fmul_rn,
//     which never contract into an FMA (the build also passes --fmad=false).
//   * Qp is limited to 8 * 1024 = 8192 lanes, the reference's documented
//     limit; the wrapper refuses more.
// One block fills one of the card's 132 SMs: batching subjects per launch
// is what fills the card, and what later work on this kernel does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

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

}  // namespace

// Launch one block per subject on `stream`.  profile (A, Qp) f32,
// subjects (B, Dp) int32, lengths (B,) int32 or null (every row is Dp
// long), out (B,) f32.  Returns cudaGetLastError() after the launch.
extern "C" int sw_launch(const float* profile, const int32_t* subjects,
                         const int32_t* lengths, float* out, int A, int Qp,
                         int q_len, int B, int Dp, float go, float ge,
                         void* stream) {
  if (B <= 0) return 0;
  if (Qp <= 0 || Qp % 128 != 0) return (int)cudaErrorInvalidValue;
  const int threads = Qp < MAX_THREADS ? Qp : MAX_THREADS;
  const int L = (Qp + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
#define SW_CASE(n)                                                          \
  case n:                                                                   \
    sw_kernel<n><<<B, threads, 0, s>>>(profile, subjects, lengths, out, A,  \
                                       Qp, q_len, Dp, go, ge);              \
    break;
  switch (L) {
    SW_CASE(1) SW_CASE(2) SW_CASE(3) SW_CASE(4)
    SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SW_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
