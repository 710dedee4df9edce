// K5 and K13 — GRU recurrence, forward (torch gates r, z, n).
//
// Replaces edgedict_tpu/ops/rnn_pallas.py:_gru_fwd_kernel (K5, launched by
// _gru_run_fwd) and edgedict_tpu/ops/quant.py:_gru_fwd_kernel_q (K13, the
// same with W_hh int8 + a per-output-channel fp32 scale, launched by
// _gru_run_fwd_q). Given the hoisted input projection x_proj = x W_ih^T +
// b_ih for every step, run
//   h_proj = h W_hh^T + b_hh                 (fp32 accumulate, b_hh fp32)
//   r = sigmoid(x_r + h_r)   z = sigmoid(x_z + h_z)
//   n = tanh(x_n + r * h_n)  h' = (1 - z) n + z h
// with fp32 h, and emit ys in x_proj's dtype. The n gate needs r times the
// recurrent part alone, so h_proj's n rows stay apart from x_proj's (the
// LSTM pre-sums them). h enters the dot in the compute dtype (x_proj's), as
// the TPU kernels cast it. For K13 each weight is dequantized as the TPU
// kernel does it once into VMEM: q * scale in fp32, rounded to the compute
// dtype, then multiplied by h; here that happens in registers as each
// weight is read (the scale is per gate row, i.e. per warp).
//
// What bounds it on the H100: the recurrent weight. Every step reads all of
// W_hh (3H x H: 12 MB fp32, 6 MB bf16, 3 MB int8 at H=1024) for a
// matrix-vector product at small B: bandwidth, not FLOPs.
//
// Design: K1's (csrc/lstm_fwd.cu). A block owns kUnits hidden units, i.e.
// the 3*kUnits gate rows of W_hh that feed them; one warp per gate row,
// lanes striding the contiguous row, the batch's h staged in shared memory
// kBatchTile rows at a time, fp32 FMAs and a warp shuffle reduction; the
// block then applies the cell update to its own units. h is read by every
// block, so the host loop ping-pongs it between two fp32 buffers, one
// launch per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kUnits = 4;             // hidden units per block
constexpr int kRows = 3 * kUnits;     // gate rows per block (r, z, n)
constexpr int kThreads = 128;         // 4 warps
constexpr int kBatchTile = 8;         // batch rows of h staged at once

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

// one recurrent weight as the product sees it: stored in the compute dtype,
// or int8 dequantized to it (q * scale in fp32, then rounded)
template <typename Elem>
__device__ __forceinline__ float weight(const Elem* wr, int k, float) {
  return to_f32(wr[k]);
}
template <typename Elem>
__device__ __forceinline__ float weight(const int8_t* wr, int k, float s) {
  return to_f32(from_f32<Elem>(static_cast<float>(wr[k]) * s));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename Elem, typename W>
__global__ void __launch_bounds__(kThreads)
gru_step_kernel(const Elem* __restrict__ xp,       // (B, 3H) this step
                const W* __restrict__ w_hh,        // (3H, H)
                const float* __restrict__ w_scale, // (3H) int8 only
                const float* __restrict__ b_hh,    // (3H)
                const float* __restrict__ h_in,    // (B, H)
                float* __restrict__ h_out,         // (B, H)
                Elem* __restrict__ y,              // (B, H)
                int B, int H) {
  extern __shared__ float smem[];
  float* hs = smem;                         // kBatchTile * H
  float* gs = smem + kBatchTile * H;        // kBatchTile * kRows
  const int unit0 = blockIdx.x * kUnits;
  const int nu = min(kUnits, H - unit0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int kWarps = kThreads / 32;

  for (int b0 = 0; b0 < B; b0 += kBatchTile) {
    const int nb = min(kBatchTile, B - b0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < nb * H; i += kThreads)
      hs[i] = to_f32(from_f32<Elem>(h_in[(size_t)b0 * H + i]));
    __syncthreads();

    for (int r = warp; r < 3 * nu; r += kWarps) {
      const int q = r / nu;            // gate
      const int j = r - q * nu;        // unit within the block
      const int row = q * H + unit0 + j;
      const W* wr = w_hh + (size_t)row * H;
      const float s = w_scale != nullptr ? w_scale[row] : 1.0f;
      float acc[kBatchTile];
#pragma unroll
      for (int bb = 0; bb < kBatchTile; ++bb) acc[bb] = 0.0f;
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        const float w = weight<Elem>(wr, k, s);
#pragma unroll
        for (int bb = 0; bb < kBatchTile; ++bb)
          if (bb < nb) acc[bb] = fmaf(w, hs[bb * H + k], acc[bb]);
      }
      const float bias = b_hh[row];
#pragma unroll
      for (int bb = 0; bb < kBatchTile; ++bb) {
        float v = acc[bb];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && bb < nb) gs[bb * kRows + r] = v + bias;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nb * nu; i += kThreads) {
      const int bb = i / nu;
      const int j = i - bb * nu;
      const size_t b = (size_t)(b0 + bb);
      const int u = unit0 + j;
      const Elem* x = xp + b * 3 * H;
      const float* g = gs + bb * kRows;
      const float rg = sigmoid(to_f32(x[u]) + g[j]);
      const float zg = sigmoid(to_f32(x[H + u]) + g[nu + j]);
      const float ng = tanhf(to_f32(x[2 * H + u]) + rg * g[2 * nu + j]);
      const float h = (1.0f - zg) * ng + zg * h_in[b * H + u];
      h_out[b * H + u] = h;
      y[b * H + u] = from_f32<Elem>(h);
    }
  }
}

template <typename Elem, typename W>
cudaError_t run(const void* xp, const void* w_hh, const float* w_scale,
                const void* b_hh, const void* h0, void* ys, void* hbuf,
                int T, int B, int H, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBatchTile * H + kBatchTile * kRows) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_step_kernel<Elem, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits);
  const size_t bh = (size_t)B * H;
  const Elem* x = static_cast<const Elem*>(xp);
  Elem* y = static_cast<Elem*>(ys);
  float* hb = static_cast<float*>(hbuf);
  for (int t = 0; t < T; ++t) {
    const float* h_in =
        t == 0 ? static_cast<const float*>(h0) : hb + ((t - 1) & 1) * bh;
    gru_step_kernel<Elem, W><<<grid, kThreads, smem, stream>>>(
        x + (size_t)t * 3 * bh, static_cast<const W*>(w_hh), w_scale,
        static_cast<const float*>(b_hh), h_in, hb + (t & 1) * bh,
        y + (size_t)t * bh, B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// K5. x_proj (T, B, 3H) incl. b_ih and w_hh (3H, H) in fp32 (bf16 == 0) or
// bf16; b_hh (3H) and h0 (B, H) fp32; outputs ys (T, B, H) in x_proj's
// dtype, hbuf (2, B, H) fp32 scratch.
extern "C" int edd_gru_fwd(const void* xp, const void* w_hh, const void* b_hh,
                           const void* h0, void* ys, void* hbuf, int T,
                           int B, int H, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? run<__nv_bfloat16, __nv_bfloat16>(xp, w_hh, nullptr, b_hh, h0,
                                               ys, hbuf, T, B, H, s)
           : run<float, float>(xp, w_hh, nullptr, b_hh, h0, ys, hbuf, T, B,
                               H, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K13. As K5 with w_q (3H, H) int8 and w_scale (3H) fp32.
extern "C" int edd_gru_fwd_q(const void* xp, const void* w_q,
                             const void* w_scale, const void* b_hh,
                             const void* h0, void* ys, void* hbuf, int T,
                             int B, int H, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(w_scale);
  const cudaError_t e =
      bf16 ? run<__nv_bfloat16, int8_t>(xp, w_q, sc, b_hh, h0, ys, hbuf, T,
                                        B, H, s)
           : run<float, int8_t>(xp, w_q, sc, b_hh, h0, ys, hbuf, T, B, H, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
