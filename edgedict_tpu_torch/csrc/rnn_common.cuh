// Device helpers shared by the recurrences' kernels: the persistent
// forward (rnn_fwd.cu, the int8 K12 and K13 included) and backward
// (rnn_bwd.cu) launches. Each source includes this header
// inside its own translation unit; the helpers live in an unnamed namespace,
// so each object file keeps its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_tile.cuh"

namespace {

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// coherent loads of data that other blocks of the same launch wrote before
// a grid barrier: through L2 only (ld.global.cg), never the read-only path
__device__ __forceinline__ uint32_t ldcg_u16(const __nv_bfloat16* p) {
  return __ldcg(reinterpret_cast<const unsigned short*>(p));
}

// 8 bf16 of row `row` of a (rows, K) matrix at k .. k+7 (k a multiple of
// 8), zero past `rows` or K, through L2 only; 16-byte loads where the rows
// are 16-byte aligned (`aligned`: K % 8 == 0 and an aligned base).
__device__ __forceinline__ uint4 ldcg8(const __nv_bfloat16* base, int row,
                                       int k, int rows, int K,
                                       bool aligned) {
  if (row >= rows || k >= K) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* p = base + (size_t)row * K + k;
  if (aligned) return __ldcg(reinterpret_cast<const uint4*>(p));
  uint32_t v[8];
  for (int e = 0; e < 8; ++e) v[e] = k + e < K ? ldcg_u16(p + e) : 0u;
  return make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                    v[6] | v[7] << 16);
}

// Sum 2 kOff values over the warp's lanes, halving each stage: a lane keeps
// the half its bit kOff selects and adds its partner's copy of that half.
// After fold<16>, v[0] of lane L is the warp's sum of value L.
template <int kOff>
__device__ __forceinline__ void fold(float* v, int lane) {
  const bool up = (lane & kOff) != 0;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = up ? v[i] : v[i + kOff];
    const float keep = up ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
  if constexpr (kOff > 1) fold<kOff / 2>(v, lane);
}

}  // namespace
