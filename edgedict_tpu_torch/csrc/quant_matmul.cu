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
// Design: two launch shapes, picked by R. Up to kGemvMaxRows rows, one warp
// per output channel streams its contiguous weight row (4 int8 per lane per
// load when K % 4 == 0), multiplies it into up to kGemvRows rows of x read
// through L1, and reduces with warp shuffles; a block holds 8 channels, a
// second grid axis covers further row tiles. Above that, a 64 x 64 output
// tile per block, both operands staged in shared memory as fp32 16 columns
// of K at a time, each thread accumulating a 4 x 4 register tile on the CUDA
// cores. The TPU kernel's padding (int8 sublane rows, batch rows, the
// column-block gates and the 4096-row cut to XLA) has no counterpart: the
// kernel masks its ragged edges and takes any R, K and N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kGemvWarps = 8;       // output channels per block
constexpr int kGemvRows = 8;        // rows of x per block
constexpr int kGemvMaxRows = 32;    // above this, the tiled kernel
constexpr int kTile = 64;           // tiled kernel: 64 x 64 outputs
constexpr int kTileK = 16;          // ... 16 columns of K staged at once
constexpr int kPad = 4;             // keeps float4 rows 16-byte aligned

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

template <typename Elem>
__global__ void __launch_bounds__(256)
qmm_tiled_kernel(const Elem* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, Elem* __restrict__ out,
                 int R, int K, int N) {
  __shared__ __align__(16) float as[kTileK][kTile + kPad];  // x^T tile
  __shared__ __align__(16) float bs[kTileK][kTile + kPad];  // q^T tile
  const int tid = threadIdx.x;
  const int tx = tid % 16;            // 4 output columns
  const int ty = tid / 16;            // 4 output rows
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = tid; i < kTile * kTileK; i += 256) {
      const int m = i / kTileK;       // row of x, or output channel
      const int kk = i - m * kTileK;
      const int gk = k0 + kk;
      const int gr = row0 + m;
      const int gc = col0 + m;
      as[kk][m] = (gr < R && gk < K) ? to_f32(x[(size_t)gr * K + gk]) : 0.0f;
      bs[kk][m] =
          (gc < N && gk < K) ? static_cast<float>(wq[(size_t)gc * K + gk])
                             : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + tx * 4 + j;
    if (c >= N) continue;
    const float s = scale[c];
    const float b = bias[c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < R) out[(size_t)r * N + c] = from_f32<Elem>(acc[i][j] * s + b);
    }
  }
}

template <typename Elem>
cudaError_t run(const void* x, const void* wq, const void* scale,
                const void* bias, void* out, int R, int K, int N,
                cudaStream_t stream) {
  const Elem* xe = static_cast<const Elem*>(x);
  const int8_t* q = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  Elem* o = static_cast<Elem*>(out);
  if (R <= kGemvMaxRows) {
    const dim3 grid((N + kGemvWarps - 1) / kGemvWarps,
                    (R + kGemvRows - 1) / kGemvRows);
    const bool vec4 = K % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(wq) % 4 == 0;
    if (vec4)
      qmm_gemv_kernel<Elem, true><<<grid, kGemvWarps * 32, 0, stream>>>(
          xe, q, s, b, o, R, K, N);
    else
      qmm_gemv_kernel<Elem, false><<<grid, kGemvWarps * 32, 0, stream>>>(
          xe, q, s, b, o, R, K, N);
  } else {
    const dim3 grid((N + kTile - 1) / kTile, (R + kTile - 1) / kTile);
    qmm_tiled_kernel<Elem><<<grid, 256, 0, stream>>>(xe, q, s, b, o, R, K,
                                                     N);
  }
  return cudaGetLastError();
}

}  // namespace

// x (R, K) fp32 (bf16 == 0) or bf16, wq (N, K) int8, scale and bias (N)
// fp32; out (R, N) in x's dtype.
extern "C" int edd_quant_matmul(const void* x, const void* wq,
                                const void* scale, const void* bias,
                                void* out, int R, int K, int N, int bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? run<__nv_bfloat16>(x, wq, scale, bias, out, R, K, N, s)
           : run<float>(x, wq, scale, bias, out, R, K, N, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
