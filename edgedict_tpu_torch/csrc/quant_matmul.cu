// K11 — int8 weight-only matrix product.
//
// Replaces edgedict_tpu/ops/quant.py:_mm_kernel (launched by
// _quant_matmul): out = (x . q^T) * scale + bias, with x (R, K) in the
// compute dtype (fp32 or bf16), q (N, K) int8 (torch's (out, in) layout, one
// row per output channel), scale and bias (N) fp32, out (R, N) in x's dtype.
// The int8 values convert to the compute dtype exactly (|q| <= 127), the
// products accumulate in fp32, and the per-channel scale multiplies the
// ACCUMULATOR, then the fp32 bias is added, then the result is cast: the
// quantized product adds no rounding beyond the quantizer's. It serves every
// encoder layer's input projection (N = 4H or 3H) and the final projection.
//
// What bounds it on the H100: at streaming shapes it is a matrix-vector
// product (R = T*B rows: 2 at B=1, 512 for 256 streams) bound by reading
// the int8 weight once (4 MB for a 1024 x 4096 layer, against 16 MB fp32).
//
// Design: two launch shapes; the wrapper's plan (ops/quant.py:quant_plan)
// picks one and passes it as `tiled`.
//  * Up to 32 rows (tiled 0), one warp per output channel streams its
//    contiguous weight row (4 int8 per lane per load when K % 4 == 0),
//    multiplies it into up to kGemvRows rows of x read through L1, and
//    reduces with warp shuffles; a block holds 8 channels, a second grid
//    axis covers further row tiles.
//  * Above that, an output tile of 64 rows x 128 channels per block, bound
//    by operations. bf16 runs on the tensor cores:
//    x (bf16) and q (int8) tiles of 32 columns of K arrive through a
//    3-stage ring of 16-byte cp.async copies; x reaches the mma.sync
//    m16n8k16 fragments through ldmatrix, q is widened to bf16 (exact, |q|
//    <= 127) on its way from shared memory into the fragments; fp32
//    accumulators. fp32 stays on FFMA (never TF32, so fp32 tokens equal the
//    CPU's): 16 columns of K a step, both raw tiles double-buffered by
//    cp.async and widened once per step into shared memory, 4 x 8 outputs
//    per thread.
// Either way the epilogue is acc * scale[n] + bias[n], then the cast. The
// TPU kernel's padding (int8 sublane rows, batch rows, the column-block
// gates and the 4096-row cut to XLA) has no counterpart: the kernels mask
// their ragged edges (zero-filled tiles) and take any R, K and N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_tile.cuh"

namespace {

constexpr int kGemvWarps = 8;       // output channels per block
constexpr int kGemvRows = 8;        // rows of x per block
constexpr int kTileM = 64;         // tiled kernels: output rows per block
constexpr int kTileN = 128;        // tiled kernels: output channels per block
constexpr int kThreads = 256;      // tiled kernels: 8 warps
// bf16 tile: 32 columns of K per stage, 3 stages; shared rows padded so
// that ldmatrix (x, 80-byte rows) and the 16-bit q reads (48-byte rows)
// hit 8 different bank groups across a fragment's 8 rows
constexpr int kBk = 32;
constexpr int kStages = 3;
constexpr int kLdX = kBk + 8;      // bf16 elements
constexpr int kLdQ = kBk + 16;     // int8 elements
// fp32 tile: 16 columns of K per step
constexpr int kBk32 = 16;
constexpr int kLdT = kTileN + 4;   // widened [k][m] / [k][n] rows, floats

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename Elem>
__device__ __forceinline__ Elem from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename Elem, bool kVec4>
__global__ void __launch_bounds__(kGemvWarps * 32)
qmm_gemv_kernel(const Elem* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ scale,
                const float* __restrict__ bias, Elem* __restrict__ out,
                int R, int K, int N) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + warp;
  const int r0 = blockIdx.y * kGemvRows;
  const int nr = min(kGemvRows, R - r0);
  if (n >= N) return;
  const int8_t* wr = wq + (size_t)n * K;
  const Elem* xr = x + (size_t)r0 * K;
  float acc[kGemvRows];
#pragma unroll
  for (int rr = 0; rr < kGemvRows; ++rr) acc[rr] = 0.0f;
  if (kVec4) {
    const char4* w4 = reinterpret_cast<const char4*>(wr);
#pragma unroll 4
    for (int k4 = lane; k4 < K / 4; k4 += 32) {
      const char4 q = w4[k4];
      const float w0 = q.x, w1 = q.y, w2 = q.z, w3 = q.w;
#pragma unroll
      for (int rr = 0; rr < kGemvRows; ++rr) {
        if (rr < nr) {
          const Elem* xk = xr + (size_t)rr * K + 4 * k4;
          float a = acc[rr];
          a = fmaf(w0, to_f32(xk[0]), a);
          a = fmaf(w1, to_f32(xk[1]), a);
          a = fmaf(w2, to_f32(xk[2]), a);
          acc[rr] = fmaf(w3, to_f32(xk[3]), a);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float w = wr[k];
#pragma unroll
      for (int rr = 0; rr < kGemvRows; ++rr)
        if (rr < nr) acc[rr] = fmaf(w, to_f32(xr[(size_t)rr * K + k]), acc[rr]);
    }
  }
  const float s = scale[n];
  const float b = bias[n];
#pragma unroll
  for (int rr = 0; rr < kGemvRows; ++rr) {
    float v = acc[rr];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && rr < nr)
      out[(size_t)(r0 + rr) * N + n] = from_f32<Elem>(v * s + b);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// x rows m0 .. m0 + rows - 1 and q rows n0 .. n0 + 127, columns k0 ..
// k0 + kBk - 1, into one stage; zero past R, N or K. cp.async where the
// rows allow 16-byte copies (K % 8 == 0 for x, K % 16 == 0 for q).
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* xs, int8_t* qs,
                                           const __nv_bfloat16* x,
                                           const int8_t* wq, int m0, int n0,
                                           int k0, int R, int K, int N,
                                           bool x16, bool q16) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kTileM * (kBk / 8); i += kThreads) {
    const int r = i / (kBk / 8), c = (i % (kBk / 8)) * 8;
    const int m = m0 + r, k = k0 + c;
    __nv_bfloat16* dst = xs + r * kLdX + c;
    if (m < R && k < K && x16) {
      cp_async16(dst, x + (size_t)m * K + k);
    } else {
      for (int e = 0; e < 8; ++e)
        dst[e] = m < R && k + e < K ? x[(size_t)m * K + k + e]
                                    : __float2bfloat16(0.0f);
    }
  }
  for (int i = tid; i < kTileN * (kBk / 16); i += kThreads) {
    const int r = i / (kBk / 16), c = (i % (kBk / 16)) * 16;
    const int n = n0 + r, k = k0 + c;
    int8_t* dst = qs + r * kLdQ + c;
    if (n < N && k < K && q16) {
      cp_async16(dst, wq + (size_t)n * K + k);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = n < N && k + e < K ? wq[(size_t)n * K + k + e] : 0;
    }
  }
}

// two int8 (k, k + 1) of a shared q row → one bf16x2 fragment register,
// the lower k in the low half
__device__ __forceinline__ uint32_t widen2(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)v.x, (float)v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16 x (R, K) . int8 q (N, K)^T on the tensor cores: a 64 x 128 output
// tile per block; warp (wm, wn) owns rows wm * 32 .. + 32 and columns
// wn * 32 .. + 32 as 2 x 4 m16n8 accumulators.
__global__ void __launch_bounds__(kThreads)
qmm_tile_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int R, int K, int N) {
  constexpr int MI = kTileM / 32;
  extern __shared__ __align__(16) unsigned char sraw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sraw);
  int8_t* qs = reinterpret_cast<int8_t*>(xs + kStages * kTileM * kLdX);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const bool x16 = K % 8 == 0 && aligned16(x);
  const bool q16 = K % 16 == 0 && aligned16(wq);

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int nk = (K + kBk - 1) / kBk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      stage_bf16(xs + s * kTileM * kLdX, qs + s * kTileN * kLdQ, x, wq, m0,
                 n0, s * kBk, R, K, N, x16, q16);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is consumed
    const int pf = kt + kStages - 1;
    if (pf < nk)
      stage_bf16(xs + (pf % kStages) * kTileM * kLdX,
                 qs + (pf % kStages) * kTileN * kLdQ, x, wq, m0, n0,
                 pf * kBk, R, K, N, x16, q16);
    cp_async_commit();
    const __nv_bfloat16* xb = xs + (kt % kStages) * kTileM * kLdX;
    const int8_t* qb = qs + (kt % kStages) * kTileN * kLdQ;
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
      uint32_t a[MI][4], b[4][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], xb + (wm * 32 + i * 16 + (lane & 15)) * kLdX + kk +
                              (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = qb + (wn * 32 + j * 8 + gid) * kLdQ + kk + tig * 2;
        b[j][0] = widen2(p);
        b[j][1] = widen2(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
                   b[j][1]);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * 32 + j * 8 + tig * 2 + e;
      if (n >= N) continue;
      const float s = scale[n], b = bias[n];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 32 + i * 16 + gid + 8 * h;
          if (m < R)
            out[(size_t)m * N + n] =
                __float2bfloat16(acc[i][j][2 * h + e] * s + b);
        }
    }
  }
}

// fp32 x (R, K) . int8 q (N, K)^T on FFMA: a 64 x 128 output tile per
// block, 4 x 8 per thread (rows ty*4 .. +3; columns tx*4 .. +3 and 64 +
// tx*4 ..). The raw x and q tiles of step kt + 1 arrive by cp.async while
// step kt is widened into [k][m] / [k][n] fp32 tiles and multiplied.
__global__ void __launch_bounds__(kThreads)
qmm_tile_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int R, int K, int N) {
  extern __shared__ __align__(16) unsigned char sraw[];
  constexpr int MI = 4;
  float* xr = reinterpret_cast<float*>(sraw);        // 2 x kTileM x kBk32
  float* as = xr + 2 * kTileM * kBk32;               // kBk32 x kLdT
  float* bs = as + kBk32 * kLdT;                     // kBk32 x kLdT
  int8_t* qr = reinterpret_cast<int8_t*>(bs + kBk32 * kLdT);  // 2 x 128 x 16
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const bool x16 = K % 4 == 0 && aligned16(x);
  const bool q16 = K % 16 == 0 && aligned16(wq);

  auto stage = [&](int buf, int k0) {
    for (int i = tid; i < kTileM * (kBk32 / 4); i += kThreads) {
      const int r = i / (kBk32 / 4), c = (i % (kBk32 / 4)) * 4;
      const int m = m0 + r, k = k0 + c;
      float* dst = xr + (buf * kTileM + r) * kBk32 + c;
      if (m < R && k < K && x16) {
        cp_async16(dst, x + (size_t)m * K + k);
      } else {
        for (int e = 0; e < 4; ++e)
          dst[e] = m < R && k + e < K ? x[(size_t)m * K + k + e] : 0.0f;
      }
    }
    if (tid < kTileN) {
      const int n = n0 + tid;
      int8_t* dst = qr + (buf * kTileN + tid) * kBk32;
      if (n < N && k0 < K && q16) {
        cp_async16(dst, wq + (size_t)n * K + k0);
      } else {
        for (int e = 0; e < kBk32; ++e)
          dst[e] = n < N && k0 + e < K ? wq[(size_t)n * K + k0 + e] : 0;
      }
    }
  };

  float acc[MI][8];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = (K + kBk32 - 1) / kBk32;
  stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) stage((kt + 1) & 1, (kt + 1) * kBk32);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // raw step kt landed; step kt - 1's as / bs consumed
    const int buf = kt & 1;
    for (int i = tid; i < kTileN * kBk32; i += kThreads) {
      const int r = i / kBk32, k = i % kBk32;
      if (r < kTileM) as[k * kLdT + r] = xr[(buf * kTileM + r) * kBk32 + k];
      bs[k * kLdT + r] = (float)qr[(buf * kTileN + r) * kBk32 + k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBk32; ++k) {
      float a[MI], b[8];
      const float* ak = as + k * kLdT;
      const float* bk = bs + k * kLdT;
      const float4 a0 = *reinterpret_cast<const float4*>(ak + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bk + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bk + 64 + tx * 4);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    if (n >= N) continue;
    const float s = scale[n], b = bias[n];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < R) out[(size_t)m * N + n] = acc[i][j] * s + b;
    }
  }
}

constexpr size_t kTileBf16Smem =
    (size_t)kStages * (kTileM * kLdX * 2 + kTileN * kLdQ);
constexpr size_t kTileF32Smem = (size_t)2 * kTileM * kBk32 * 4 +
                                (size_t)2 * kBk32 * kLdT * 4 +
                                (size_t)2 * kTileN * kBk32;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t launch_tile(const void* x, const void* wq, const void* scale,
                        const void* bias, void* out, int R, int K, int N,
                        bool bf16, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (R + kTileM - 1) / kTileM);
  const int8_t* q = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaError_t e;
  if (bf16) {
    e = allow_smem(qmm_tile_bf16_kernel, kTileBf16Smem);
    if (e != cudaSuccess) return e;
    qmm_tile_bf16_kernel<<<grid, kThreads, kTileBf16Smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), q, s, b,
        static_cast<__nv_bfloat16*>(out), R, K, N);
  } else {
    e = allow_smem(qmm_tile_f32_kernel, kTileF32Smem);
    if (e != cudaSuccess) return e;
    qmm_tile_f32_kernel<<<grid, kThreads, kTileF32Smem, stream>>>(
        static_cast<const float*>(x), q, s, b, static_cast<float*>(out), R, K,
        N);
  }
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t launch_gemv(const void* x, const void* wq, const void* scale,
                        const void* bias, void* out, int R, int K, int N,
                        cudaStream_t stream) {
  const Elem* xe = static_cast<const Elem*>(x);
  const int8_t* q = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  Elem* o = static_cast<Elem*>(out);
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps,
                  (R + kGemvRows - 1) / kGemvRows);
  const bool vec4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  if (vec4)
    qmm_gemv_kernel<Elem, true><<<grid, kGemvWarps * 32, 0, stream>>>(
        xe, q, s, b, o, R, K, N);
  else
    qmm_gemv_kernel<Elem, false><<<grid, kGemvWarps * 32, 0, stream>>>(
        xe, q, s, b, o, R, K, N);
  return cudaGetLastError();
}

}  // namespace

// x (R, K) fp32 (bf16 == 0) or bf16, wq (N, K) int8, scale and bias (N)
// fp32; out (R, N) in x's dtype. tiled: 0 the matrix-vector kernel, 1 the
// 64 x 128 tiles.
extern "C" int edd_quant_matmul(const void* x, const void* wq,
                                const void* scale, const void* bias,
                                void* out, int R, int K, int N, int bf16,
                                int tiled, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      tiled ? launch_tile(x, wq, scale, bias, out, R, K, N, bf16 != 0, s)
      : bf16 ? launch_gemv<__nv_bfloat16>(x, wq, scale, bias, out, R, K, N, s)
             : launch_gemv<float>(x, wq, scale, bias, out, R, K, N, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
