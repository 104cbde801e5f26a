// f32-accurate products on the tensor cores (3xTF32) and asynchronous
// staging, for the SSD scan's backward kernels (ssd_scan_bwd.cu).
//
// 3xTF32: an f32 operand a is split where it is read into fragments, into
// hi = rna.tf32(a) and lo = cvt.rna.tf32(a − hi) (a − hi is exact), and
// a product sums lo_a·hi_b + hi_a·lo_b + hi_a·hi_b with
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 into f32 registers.  Each TF32
// product is exact in f32, so what is lost is lo_a·lo_b (2^-22 of |a·b|)
// and the f32 sums, as in an f32 product.  An operand known to hold at
// most 10 mantissa bits (a bf16 value, or a value rounded to bf16) is its
// own hi part: its lo part is zero and that term is not issued.
//
// Fragments of m16n8k8 (PTX ISA, "Matrix fragments for mma.m16n8k8",
// .tf32): lane = 4·g + t;  A (16 x 8) a[e] at row g + 8·(e & 1), column
// t + 4·(e >> 1);  B (8 x 8) b[e] at row t + 4·e, column g;  C (16 x 8)
// c[e] at row g + 8·(e >> 1), column 2t + (e & 1).
//
// Staging: 16-byte cp.async.cg copies, zero-filled past a row's end, into
// a ring of shared-memory stages; a group is committed per stage, so that
// the next stage's copies are in flight while the current one multiplies.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---- PTX primitives --------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// d += a·b, one m16n8k8 TF32 product with f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global memory to shared memory, of which the first `bytes`
// (0..16) are read and the rest are zero.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}
// ---- end of PTX primitives -------------------------------------------------

struct Tf32 {
  uint32_t hi, lo;
};

// a as hi + lo; EXACT: a has at most 10 mantissa bits, so hi = a, lo = 0.
// hi rounds as cvt.rna does, by integer operations (two instructions; the
// cvt lowers to four, two of them a NaN test): the same bits for every
// finite a.  A NaN a may give a wrong hi, but lo = cvt.rna(a − hi) is NaN
// and carries it into the product.
template <bool EXACT>
__device__ __forceinline__ Tf32 split(float a) {
  if constexpr (EXACT) return {__float_as_uint(a), 0u};
  const uint32_t hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  return {hi, tf32_rna(a - __uint_as_float(hi))};
}

// Row and column, in a 16 x 8 tile, of accumulator entry e of this lane.
__device__ __forceinline__ int acc_row(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }

// acc[mt][nt] += A·B over the 8 columns k0..k0+7 of A, for the warp's
// (16·MT) x (8·NT) tile at rows wm.., columns wn.. of the block's tile.
// A(m, k) and B(k, n) return the operands as floats; EA / EB: the operand
// is exact in TF32, so its lo term is not issued.
template <int MT, int NT, bool EA, bool EB, class FA, class FB>
__device__ __forceinline__ void mma_k8(int k0, int wm, int wn, const FA& A, const FB& B,
                                       float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Tf32 s = split<EA>(A(wm + mt * 16 + g + 8 * (e & 1), k0 + t + 4 * (e >> 1)));
      ah[mt][e] = s.hi;
      al[mt][e] = s.lo;
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const Tf32 s = split<EB>(B(k0 + t + 4 * e, wn + nt * 8 + g));
      bh[nt][e] = s.hi;
      bl[nt][e] = s.lo;
    }
  // each term over all MT·NT tiles before the next, so that no product
  // waits on the one before it; every entry still sums lo·hi, hi·lo, hi·hi
#pragma unroll
  for (int term = 0; term < 3; ++term) {
    if ((term == 0 && EA) || (term == 1 && EB)) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[mt][nt], term == 0 ? al[mt] : ah[mt], term == 1 ? bl[nt] : bh[nt]);
  }
}

// KD columns of A (a multiple of 8) from k = 0.
template <int KD, int MT, int NT, bool EA, bool EB, class FA, class FB>
__device__ __forceinline__ void mma_tile(int wm, int wn, const FA& A, const FB& B,
                                         float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 8) mma_k8<MT, NT, EA, EB>(k0, wm, wn, A, B, acc);
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

template <typename T>
__device__ __forceinline__ T elem_zero() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 elem_zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// One 16-byte group of a row: 16 / sizeof(T) elements from src to dst, of
// which the first `valid` are read and the rest are zero.  vec: src is
// 16-byte aligned (a cp.async); else element by element, as plain stores,
// which the same barrier publishes.
template <typename T>
__device__ __forceinline__ void stage16(T* dst, const T* src, int valid, bool vec) {
  constexpr int E = 16 / sizeof(T);
  valid = valid < 0 ? 0 : valid > E ? E : valid;
  if (vec) {
    cp_async16(dst, src, valid * static_cast<int>(sizeof(T)));
    return;
  }
#pragma unroll
  for (int u = 0; u < E; ++u) dst[u] = u < valid ? src[u] : elem_zero<T>();
}

// rows x width elements (width a multiple of 16 bytes) into dst with a row
// stride of ld elements: row r from src + r·stride, its first cnt(r)
// elements (0 for a row past the data), zeros after.  All threads of the
// block take part.
template <typename T, int WIDTH, class Cnt>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, size_t stride,
                                           int rows, const Cnt& cnt, bool vec) {
  constexpr int E = 16 / sizeof(T), G = WIDTH / E;
  for (int q = threadIdx.x; q < rows * G; q += blockDim.x) {
    const int r = q / G, c = (q - r * G) * E;
    const int n = cnt(r);
    const T* s = n > c ? src + r * stride + c : src;
    stage16(dst + r * ld + c, s, n - c, vec);
  }
}

}  // namespace
