// K12 — the int8 LSTM recurrence, forward.
//
// Replaces edgedict_tpu/ops/quant.py:_fwd_kernel_q (launched by _run_fwd_q):
// given the hoisted input projection x_proj = x W_ih^T + (b_ih + b_hh) for
// every step, run gates = x_proj[t] + h W^T, the i,f,g,o cell with fp32 h/c,
// and emit ys (x_proj's dtype) and cs (fp32), with W_hh stored int8 beside a
// per-output-channel fp32 scale. The TPU kernel dequantizes W_hh once into
// VMEM as q * scale in fp32 rounded to the compute dtype and multiplies h by
// that (not scale-after-accumulate, which differs in bf16). The scale is per
// gate row, which is one warp here, so each weight is dequantized the same
// way in registers as it is read (4 MB of int8 a step at H=1024). K1, the
// same recurrence with W_hh in the compute dtype, is the persistent kernel of
// csrc/rnn_fwd.cu; this file holds only the int8 entry.
//
// What bounds it on the H100: the recurrent weight. Every step reads all of
// W_hh (4H x H int8: 4 MB at H=1024) for a matrix-vector product at small B
// (serving: T is 1-2 per streaming chunk), so a step is a bandwidth
// problem, not a FLOP problem.
//
// Design: W_hh is split across the grid. Each block owns kUnits hidden
// units, i.e. the 4*kUnits gate rows of W_hh that feed them, and computes
// those gates for every batch row: one warp per gate row, lanes striding the
// contiguous row (coalesced), the batch's h staged in shared memory
// kBatchTile rows at a time, fp32 FMAs and a warp shuffle reduction. The
// block then applies the cell update to the units it owns, so no other block
// ever reads its c. h is read by every block, so the host loop ping-pongs it
// between two buffers, one launch per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rnn_common.cuh"

namespace {

constexpr int kUnits = 4;             // hidden units per block
constexpr int kRows = 4 * kUnits;     // gate rows per block (i, f, g, o)
constexpr int kThreads = 128;         // 4 warps
constexpr int kBatchTile = 8;         // batch rows of h staged at once

// one recurrent weight as the product sees it: int8 dequantized to the
// compute dtype (q * scale in fp32, then rounded)
template <typename Elem>
__device__ __forceinline__ float weight(const int8_t* wr, int k, float s) {
  return to_f32(from_f32<Elem>(static_cast<float>(wr[k]) * s));
}

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const Elem* __restrict__ xp,     // (B, 4H) this step
                 const int8_t* __restrict__ w_q,  // (4H, H)
                 const float* __restrict__ w_scale,  // (4H)
                 const float* __restrict__ h_in,  // (B, H)
                 const float* __restrict__ c_in,  // (B, H)
                 float* __restrict__ h_out,       // (B, H)
                 float* __restrict__ c_out,       // (B, H)
                 Elem* __restrict__ y,            // (B, H)
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
    // h enters the dot in W_hh's dtype, as the TPU kernel casts it
    for (int i = threadIdx.x; i < nb * H; i += kThreads)
      hs[i] = to_f32(from_f32<Elem>(h_in[(size_t)b0 * H + i]));
    __syncthreads();

    for (int r = warp; r < 4 * nu; r += kWarps) {
      const int q = r / nu;            // gate
      const int j = r - q * nu;        // unit within the block
      const int row = q * H + unit0 + j;
      const int8_t* wr = w_q + (size_t)row * H;
      const float s = w_scale[row];
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
#pragma unroll
      for (int bb = 0; bb < kBatchTile; ++bb) {
        float v = acc[bb];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && bb < nb) gs[bb * kRows + r] = v;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nb * nu; i += kThreads) {
      const int bb = i / nu;
      const int j = i - bb * nu;
      const size_t b = (size_t)(b0 + bb);
      const int u = unit0 + j;
      const Elem* x = xp + b * 4 * H;
      const float* g = gs + bb * kRows;
      const float gi = to_f32(x[u]) + g[j];
      const float gf = to_f32(x[H + u]) + g[nu + j];
      const float gg = to_f32(x[2 * H + u]) + g[2 * nu + j];
      const float go = to_f32(x[3 * H + u]) + g[3 * nu + j];
      const float c = sigmoid(gf) * c_in[b * H + u] + sigmoid(gi) * tanhf(gg);
      const float h = sigmoid(go) * tanhf(c);
      c_out[b * H + u] = c;
      h_out[b * H + u] = h;
      y[b * H + u] = from_f32<Elem>(h);
    }
  }
}

template <typename Elem>
cudaError_t run(const void* xp, const void* w_q, const float* w_scale,
                const void* h0, const void* c0, void* ys, void* cs,
                void* hbuf, int T, int B, int H, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBatchTile * H + kBatchTile * kRows) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_step_kernel<Elem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits);
  const size_t bh = (size_t)B * H;
  const Elem* x = static_cast<const Elem*>(xp);
  Elem* y = static_cast<Elem*>(ys);
  float* c = static_cast<float*>(cs);
  float* hb = static_cast<float*>(hbuf);
  for (int t = 0; t < T; ++t) {
    const float* h_in =
        t == 0 ? static_cast<const float*>(h0) : hb + ((t - 1) & 1) * bh;
    const float* c_in =
        t == 0 ? static_cast<const float*>(c0) : c + (size_t)(t - 1) * bh;
    lstm_step_kernel<Elem><<<grid, kThreads, smem, stream>>>(
        x + (size_t)t * 4 * bh, static_cast<const int8_t*>(w_q), w_scale,
        h_in, c_in, hb + (t & 1) * bh, c + (size_t)t * bh,
        y + (size_t)t * bh, B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// K12. x_proj (T, B, 4H) in fp32 (bf16 == 0) or bf16, w_q (4H, H) int8,
// w_scale (4H), h0 and c0 (B, H) fp32; outputs ys (T, B, H) in x_proj's
// dtype, cs (T, B, H) fp32, hbuf (2, B, H) fp32 scratch whose slot (T-1)&1
// holds the final h.
extern "C" int edd_lstm_fwd_q(const void* xp, const void* w_q,
                              const void* w_scale, const void* h0,
                              const void* c0, void* ys, void* cs, void* hbuf,
                              int T, int B, int H, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(w_scale);
  const cudaError_t e =
      bf16 ? run<__nv_bfloat16>(xp, w_q, sc, h0, c0, ys, cs, hbuf, T, B, H, s)
           : run<float>(xp, w_q, sc, h0, c0, ys, cs, hbuf, T, B, H, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
