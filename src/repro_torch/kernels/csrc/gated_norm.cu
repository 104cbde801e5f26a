// The Mamba2 mixer's gated-norm epilogue (Zamba2's `_mixer`, after the
// SSD) — CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no Zamba2 at its published
// widths.  Its Mamba2 epilogue (`ssm_apply`, which the port's `ssm` and
// `hybrid` families copy) casts to bf16 before the gate and normalises over
// all of d_inner; it stays eager.  This kernel takes the place of the
// eager f32 passes of `models/zamba2.py:_mixer` (`gated_rmsnorm_plain` in
// kernels/gated_norm.py: 12 passes forward, about 30 in autograd's
// backward, every intermediate a full f32 tensor).  For each token row and
// each of G groups of W = H·P / G channels (channel c in head c / P):
//   forward   s = y + x·D[h],  v = s·silu(z),  r = rsqrt(mean_W(v²) + eps),
//             out = (v·r)·gnorm[c] in x's dtype; r (rows, G) in f32.
//   backward  from do: dn = do·gnorm, dv = r·dn − v·r³·mean_W(dn·v),
//             ds = dv·silu(z); dy = ds (f32), dx = ds·D[h],
//             dz = (dv·s)·σ(z)·(1 + z·(1 − σ(z))); dgnorm[c] = Σ_rows do·v·r
//             and dD[h] = Σ_rows Σ_p ds·x as one partial per strip of rows,
//             summed in strip order by gn_sum_kernel: no atomics, the same
//             bits every run.
// Every value is computed in f32 (`--fmad=false`: y + x·D rounds twice, as
// the eager expression does); only the order of the f32 sums differs.
//
// What bounds it on an H100: bytes.  Per element the forward reads y (f32),
// x and z and writes out (bf16), 10 bytes; the backward reads do, y, x, z and
// writes dy (f32), dx and dz, 18 bytes; a few flops a byte.  At Zamba2-7B's
// training shape (8 x 4096 tokens, 7168 channels) that is 2.35 GB and
// 4.23 GB: 0.70 ms and 1.26 ms at 3.35 TB/s.
//
// Design: a block owns one group of a strip of consecutive rows and walks
// them in order.  Its threads hold a row's W channels in registers, as
// loaded (bf16 two to a word), VEC consecutive channels a chunk and up to
// ITEMS chunks a thread; chunk k of thread t is t + k·blockDim, so a warp's
// loads are consecutive (16 bytes of y, 8 of bf16 x, z, do per thread).  The
// mean over the group is a shuffle sum in each warp, then the warps' sums
// through shared memory, read back by every thread in the same order.  x is
// read through its row strides: it is a slice of the in-projection's xBC,
// not copied.  The backward recomputes s and v from the row it holds
// instead of reading saved f32 copies; its first pass over a row (the dot
// product for the mean) keeps silu(z) and σ(z) in shared memory for the
// second, so an element costs one exp and two divisions.  Its sums over the
// strip's rows stay in shared memory too, each thread adding only into its
// own channels.
// P is a multiple of VEC = 4 and every row starts 16-byte (f32) or 8-byte
// (bf16) aligned: the wrapper checks, and allocates every output and the
// partials; nothing here allocates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int VEC = 4;            // consecutive channels a load: a chunk
constexpr int ITEMS = 4;          // chunks a thread holds
constexpr int MAX_THREADS = 512;  // a block; so W <= 512·ITEMS·VEC
constexpr int SUM_THREADS = 64;   // gn_sum_kernel's block
constexpr int FWD_STRIP = 8;      // rows a forward block walks
constexpr int BWD_STRIP = 128;    // rows a backward block walks: one partial of
                                  // dgnorm and dD each (kernels/gated_norm.py's
                                  // _BWD_STRIP sizes the partials)

struct Shape {
  int rows, T, W, G, P;           // rows = B·T
  long long xb, xt, zb, zt;       // x's and z's strides over (b, t), elements
  float eps;
};

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// A chunk of T as one load reads it: an f32 a word, bf16 two a word (the
// lower channel in the low half).
template <typename T>
struct Vals {
  unsigned w[sizeof(T) == 4 ? VEC : VEC / 2];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (sizeof(T) == 4) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x; w[1] = u.y;
    }
  }
  __device__ __forceinline__ float operator[](int j) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[j]);
    else return __uint_as_float(j & 1 ? w[j >> 1] & 0xffff0000u : w[j >> 1] << 16);
  }
};

template <typename T>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
}

// a chunk of shared memory
__device__ __forceinline__ void lds(const float* p, float (&v)[VEC]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

__device__ __forceinline__ void sts(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }

// Σ over the block of every thread's v, the same bits in every thread: the
// lanes by shuffle, then the warps' sums in warp order.  `buf` holds 32
// floats; callers alternate two buffers between consecutive sums, so that
// one barrier a sum suffices (a thread that writes the other buffer has
// passed a barrier that every reader of this one has passed too).
__device__ __forceinline__ float block_sum(float v, float* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) s += buf[w];
  return s;
}

// ---- forward: out and r, one block per (strip of rows, group) -------------
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
gn_fwd_kernel(const float* __restrict__ y, const T* __restrict__ x,
              const T* __restrict__ z, const float* __restrict__ D,
              const float* __restrict__ gnorm, T* __restrict__ out,
              float* __restrict__ rstd, const Shape sh) {
  __shared__ float red[2][32];
  const int g = blockIdx.y, W = sh.W, di = W * sh.G;
  const float inv_w = 1.f / (float)W;
  float dk[ITEMS];                                 // D of each chunk's head
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int c = (threadIdx.x + k * blockDim.x) * VEC;
    dk[k] = c < W ? __ldg(D + (g * W + c) / sh.P) : 0.f;
  }
  const int r0 = blockIdx.x * FWD_STRIP, r1 = min(sh.rows, r0 + FWD_STRIP);
  for (int row = r0, par = 0; row < r1; ++row, par ^= 1) {
    const int bi = row / sh.T, ti = row - bi * sh.T;
    const size_t base = (size_t)row * di + (size_t)g * W;
    const T* xr = x + bi * sh.xb + ti * sh.xt + (size_t)g * W;
    const T* zr = z + bi * sh.zb + ti * sh.zt + (size_t)g * W;
    Vals<float> yv[ITEMS];
    Vals<T> xv[ITEMS], zv[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c = (threadIdx.x + k * blockDim.x) * VEC;
      if (c < W) {
        yv[k].load(y + base + c);
        xv[k].load(xr + c);
        zv[k].load(zr + c);
      }
    }
    float v[ITEMS][VEC];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c = (threadIdx.x + k * blockDim.x) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[k][j] = 0.f;
      if (c < W) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float s = yv[k][j] + xv[k][j] * dk[k];
          v[k][j] = s * silu(zv[k][j]);
          ss += v[k][j] * v[k][j];
        }
      }
    }
    const float r = rsqrtf(block_sum(ss, red[par]) * inv_w + sh.eps);
    if (threadIdx.x == 0) rstd[(size_t)row * sh.G + g] = r;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c = (threadIdx.x + k * blockDim.x) * VEC;
      if (c < W) {
        Vals<float> gv;
        gv.load(gnorm + g * W + c);
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = (v[k][j] * r) * gv[j];
        store<T>(out + base + c, o);
      }
    }
  }
}

// ---- backward: dy, dx, dz and the strip's partials of dgnorm and dD --------
// part[strip][0, di) holds Σ do·v·r over the strip's rows by channel,
// part[strip][di, di + H) Σ ds·x by head.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
gn_bwd_kernel(const T* __restrict__ dout, const float* __restrict__ y,
              const T* __restrict__ x, const T* __restrict__ z,
              const float* __restrict__ D, const float* __restrict__ gnorm,
              const float* __restrict__ rstd, float* __restrict__ dy,
              T* __restrict__ dx, T* __restrict__ dz, float* __restrict__ part,
              const Shape sh) {
  // [0, W) Σ do·v·r, [W, 2W) Σ ds·x, [2W, 3W) silu(z), [3W, 4W) σ(z): each
  // thread reads and writes only its own channels' slots
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  float* sz_s = acc + 2 * sh.W;
  float* sg_s = acc + 3 * sh.W;
  __shared__ float red[2][32];
  const int g = blockIdx.y, W = sh.W, P = sh.P, di = W * sh.G;
  const float inv_w = 1.f / (float)W;
  float dk[ITEMS];                                 // D of each chunk's head
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int c = (threadIdx.x + k * blockDim.x) * VEC;
    dk[k] = c < W ? __ldg(D + (g * W + c) / P) : 0.f;
    if (c < W) {
      const float zero[VEC] = {};
      sts(acc + c, zero);
      sts(acc + W + c, zero);
    }
  }
  const int r0 = blockIdx.x * BWD_STRIP, r1 = min(sh.rows, r0 + BWD_STRIP);
  for (int row = r0, par = 0; row < r1; ++row, par ^= 1) {
    const int bi = row / sh.T, ti = row - bi * sh.T;
    const size_t base = (size_t)row * di + (size_t)g * W;
    const T* xr = x + bi * sh.xb + ti * sh.xt + (size_t)g * W;
    const T* zr = z + bi * sh.zb + ti * sh.zt + (size_t)g * W;
    const float r = __ldg(rstd + (size_t)row * sh.G + g);
    Vals<float> yv[ITEMS];
    Vals<T> xv[ITEMS], zv[ITEMS], ov[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c = (threadIdx.x + k * blockDim.x) * VEC;
      if (c < W) {
        yv[k].load(y + base + c);
        xv[k].load(xr + c);
        zv[k].load(zr + c);
        ov[k].load(dout + base + c);
      }
    }
    float dot = 0.f;                               // Σ dn·v over the group
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c = (threadIdx.x + k * blockDim.x) * VEC;
      if (c < W) {
        Vals<float> gv;
        gv.load(gnorm + g * W + c);
        float ga[VEC], szk[VEC], sgk[VEC];
        lds(acc + c, ga);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float zf = zv[k][j], e1 = 1.f + expf(-zf);
          szk[j] = zf / e1;                        // silu(z), as the forward has it
          sgk[j] = 1.f / e1;
          const float v = (yv[k][j] + xv[k][j] * dk[k]) * szk[j];
          dot += (ov[k][j] * gv[j]) * v;
          ga[j] += ov[k][j] * (v * r);
        }
        sts(acc + c, ga);
        sts(sz_s + c, szk);
        sts(sg_s + c, sgk);
      }
    }
    const float k3 = r * r * r * (block_sum(dot, red[par]) * inv_w);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c = (threadIdx.x + k * blockDim.x) * VEC;
      if (c < W) {
        Vals<float> gv;
        gv.load(gnorm + g * W + c);
        float szk[VEC], sgk[VEC], da[VEC], gy[VEC], gx[VEC], gz[VEC];
        lds(sz_s + c, szk);
        lds(sg_s + c, sgk);
        lds(acc + W + c, da);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float zf = zv[k][j], sig = sgk[j];
          const float s = yv[k][j] + xv[k][j] * dk[k];
          const float dv = r * (ov[k][j] * gv[j]) - (s * szk[j]) * k3;
          const float ds = dv * szk[j];
          gy[j] = ds;
          gx[j] = ds * dk[k];
          gz[j] = (dv * s) * (sig * (1.f + zf * (1.f - sig)));
          da[j] += ds * xv[k][j];
        }
        sts(acc + W + c, da);
        store<float>(dy + base + c, gy);
        store<T>(dx + base + c, gx);
        store<T>(dz + base + c, gz);
      }
    }
  }
  __syncthreads();
  float* prow = part + (size_t)blockIdx.x * (di + di / P);
  for (int c = threadIdx.x; c < W; c += blockDim.x) prow[g * W + c] = acc[c];
  const int heads = W / P;                         // a group's heads
  for (int h = threadIdx.x; h < heads; h += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += acc[W + h * P + p];
    prow[di + g * heads + h] = s;
  }
}

// ---- the strips' partials summed in strip order: dgnorm (di), dD (H) -------
__global__ void __launch_bounds__(SUM_THREADS)
gn_sum_kernel(const float* __restrict__ part, float* __restrict__ dgnorm,
              float* __restrict__ dD, int strips, int di, int H) {
  const int n = di + H, c = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (c >= n) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f};               // strips i ≡ u mod 4
  int i = 0;
  for (; i + 4 <= strips; i += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] += part[(size_t)(i + u) * n + c];
  }
  for (; i < strips; ++i) s[0] += part[(size_t)i * n + c];
  const float t = (s[0] + s[1]) + (s[2] + s[3]);
  if (c < di) dgnorm[c] = t;
  else dD[c - di] = t;
}

int block_threads(int W) {
  const int per = (W / VEC + ITEMS - 1) / ITEMS;
  return (per + 31) / 32 * 32;
}

bool valid(const Shape& sh) {
  return sh.rows > 0 && sh.T > 0 && sh.rows % sh.T == 0 && sh.G > 0 && sh.P > 0 &&
         sh.P % VEC == 0 && sh.W > 0 && sh.W % sh.P == 0 &&
         block_threads(sh.W) <= MAX_THREADS;
}

template <typename T>
cudaError_t forward(const void* y, const void* x, const void* z, const float* D,
                    const float* gnorm, void* out, float* rstd, const Shape& sh,
                    cudaStream_t s) {
  const dim3 grid((sh.rows + FWD_STRIP - 1) / FWD_STRIP, sh.G);
  const int threads = block_threads(sh.W);
  gn_fwd_kernel<T><<<grid, threads, 0, s>>>(
      static_cast<const float*>(y), static_cast<const T*>(x),
      static_cast<const T*>(z), D, gnorm, static_cast<T*>(out), rstd, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* dout, const void* y, const void* x, const void* z,
                     const float* D, const float* gnorm, const float* rstd,
                     float* dy, void* dx, void* dz, float* part, float* dD,
                     float* dgnorm, const Shape& sh, cudaStream_t s) {
  const int strips = (sh.rows + BWD_STRIP - 1) / BWD_STRIP;
  const size_t smem = sizeof(float) * 4 * sh.W;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(gn_bwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  const dim3 grid(strips, sh.G);
  const int threads = block_threads(sh.W);
  gn_bwd_kernel<T><<<grid, threads, smem, s>>>(
      static_cast<const T*>(dout), static_cast<const float*>(y),
      static_cast<const T*>(x), static_cast<const T*>(z), D, gnorm, rstd, dy,
      static_cast<T*>(dx), static_cast<T*>(dz), part, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int di = sh.W * sh.G, H = di / sh.P;
  const int sum_blocks = (di + H + SUM_THREADS - 1) / SUM_THREADS;
  gn_sum_kernel<<<sum_blocks, SUM_THREADS, 0, s>>>(
      part, dgnorm, dD, strips, di, H);
  return cudaGetLastError();
}

Shape make_shape(int rows, int T, long long xb, long long xt, long long zb,
                 long long zt, int W, int G, int P, float eps) {
  Shape sh;
  sh.rows = rows; sh.T = T; sh.W = W; sh.G = G; sh.P = P;
  sh.xb = xb; sh.xt = xt; sh.zb = zb; sh.zt = zt; sh.eps = eps;
  return sh;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, z, out alike; y, D, gnorm and r f32).
// y and out are contiguous (rows, G·W); x and z have unit stride over their
// channels and strides (xb, xt), (zb, zt) over (b, t), multiples of 4; P is
// a multiple of 4 and every pointer 16-byte (f32) or 8-byte (bf16) aligned.
// rstd (rows, G) f32.  Launches on `stream`; returns the first CUDA error.
extern "C" int gn_forward(const void* y, const void* x, const void* z,
                          const void* D, const void* gnorm, void* out, void* rstd,
                          int dtype, int rows, int T, long long xb, long long xt,
                          long long zb, long long zt, int W, int G, int P,
                          float eps, void* stream) {
  const Shape sh = make_shape(rows, T, xb, xt, zb, zt, W, G, P, eps);
  if (!valid(sh) || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Dp = static_cast<const float*>(D);
  const float* gp = static_cast<const float*>(gnorm);
  float* rp = static_cast<float*>(rstd);
  if (dtype == 0) return (int)forward<float>(y, x, z, Dp, gp, out, rp, sh, s);
  return (int)forward<__nv_bfloat16>(y, x, z, Dp, gp, out, rp, sh, s);
}

// The partials: (ceil(rows / BWD_STRIP), G·W + H) f32 scratch; dD (H,) and dgnorm
// (G·W,) f32; dy contiguous f32, dx and dz contiguous in x's dtype, dout
// contiguous in x's dtype.  Launches the backward and the partials' sum.
extern "C" int gn_backward(const void* dout, const void* y, const void* x,
                           const void* z, const void* D, const void* gnorm,
                           const void* rstd, void* dy, void* dx, void* dz,
                           void* part, void* dD, void* dgnorm, int dtype, int rows,
                           int T, long long xb, long long xt, long long zb,
                           long long zt, int W, int G, int P, void* stream) {
  const Shape sh = make_shape(rows, T, xb, xt, zb, zt, W, G, P, 0.f);
  if (!valid(sh) || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Dp = static_cast<const float*>(D);
  const float* gp = static_cast<const float*>(gnorm);
  const float* rp = static_cast<const float*>(rstd);
  float* dyp = static_cast<float*>(dy);
  float* pp = static_cast<float*>(part);
  float* dDp = static_cast<float*>(dD);
  float* dgp = static_cast<float*>(dgnorm);
  if (dtype == 0)
    return (int)backward<float>(dout, y, x, z, Dp, gp, rp, dyp, dx, dz, pp, dDp, dgp, sh, s);
  return (int)backward<__nv_bfloat16>(dout, y, x, z, Dp, gp, rp, dyp, dx, dz, pp, dDp, dgp,
                                      sh, s);
}

extern "C" const char* gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
