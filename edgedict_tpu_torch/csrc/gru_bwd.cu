// K6 — GRU recurrence, backward (the dh chain; torch gates r, z, n).
//
// Replaces edgedict_tpu/ops/rnn_pallas.py:_gru_bwd_kernel (launched by
// _gru_run_bwd under the custom-vjp gru_recurrence_tm): walk t = T-1 .. 0,
// rematerialise the forward's gates from the saved ys (h_{t-1} = ys[t-1] in
// x_proj's dtype, or h0 cast to it at t = 0: the rounding the forward fed
// its dot)
//   h_proj = h_{t-1} W_hh^T + b_hh   r = sigmoid(x_r + h_r)
//   z = sigmoid(x_z + h_z)   hn = h_n   n = tanh(x_n + r hn)
// and emit, in x_proj's dtype,
//   dgx[t] = (da_r, da_z, da_n)        (the pre-activations' grads)
//   dgh[t] = (da_r, da_z, da_n * r)    (the grads of h_proj)
// with da_n = dh (1-z)(1-n^2), da_r = da_n hn r(1-r), da_z = dh (h_{t-1}-n)
// z(1-z); the dh carried to t-1 is dh z + dgh[t] W_hh (dgh in W's dtype,
// fp32 accumulation); dh0 is the last one. dW_hh, db_hh and the input
// projection's grads are products or sums over all steps and stay outside
// (one matmul each), as rnn_pallas.py:651-659 leaves them to XLA.
//
// What bounds it on the H100: as K5, the recurrent weight. Each step reads
// W_hh twice (3H x H each: 6 MB in bf16 at H=1024): once by rows for the
// gate remat, once by columns for dh, for a product of small B. Both copies
// (W_hh and W_hh^T, as the TPU kernel also takes both) stay in the 50 MB L2
// across the steps of a call. Steps are sequential.
//
// Design: K4's (csrc/lstm_bwd.cu). One launch per step; block i owns kUnits
// hidden units. dh for unit j needs its own dh z of step t+1 (kept by the
// owning block in a (B, H) fp32 carry) and column j of W_hh against the
// whole of dgh[t+1], which the previous launch finished; so a block first
// forms dh for its own units (warp per unit, lanes striding the contiguous
// row j of W_hh^T, dgh[t+1] staged in shared memory kBatchTile rows at a
// time, shared by the block's warps), then rematerialises the 3*kUnits gate
// rows it owns (as K5), then applies the cell's backward to its units. A
// last launch forms dh0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kUnits = 4;             // hidden units per block
constexpr int kRows = 3 * kUnits;     // gate rows per block (r, z, n)
constexpr int kThreads = 128;         // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBatchTile = 4;         // batch rows staged at once

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One reverse step t. With dgx_out == nullptr this is the final launch: only
// dh = carry + dgh_next W_hh for the owned units, written to dh_out (dh0).
template <typename Elem>
__global__ void __launch_bounds__(kThreads)
gru_bwd_step_kernel(const Elem* __restrict__ xp,        // (B, 3H) step t
                    const Elem* __restrict__ w_hh,      // (3H, H)
                    const Elem* __restrict__ w_hh_t,    // (H, 3H)
                    const float* __restrict__ b_hh,     // (3H)
                    const Elem* __restrict__ h_prev,    // (B, H) h_{t-1}
                    const Elem* __restrict__ dy,        // (B, H) or null
                    const Elem* __restrict__ dgh_next,  // (B, 3H) or null
                    const float* __restrict__ dh_ext,   // (B, H) or null
                    float* __restrict__ carry,          // (B, H) dh z, in/out
                    Elem* __restrict__ dgx_out,         // (B, 3H) or null
                    Elem* __restrict__ dgh_out,         // (B, 3H) or null
                    float* __restrict__ dh_out,         // (B, H) or null
                    int B, int H) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  float* stage = smem;                           // kBatchTile * 3H
  float* gs = smem + kBatchTile * H3;            // kBatchTile * kRows
  float* dhs = gs + kBatchTile * kRows;          // kBatchTile * kUnits
  const int unit0 = blockIdx.x * kUnits;
  const int nu = min(kUnits, H - unit0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int b0 = 0; b0 < B; b0 += kBatchTile) {
    const int nb = min(kBatchTile, B - b0);
    __syncthreads();  // the previous tile is fully consumed

    // dgh[t+1] (W dtype) . W_hh[:, j] for the owned units, fp32 sum
    if (dgh_next != nullptr) {
      for (int i = threadIdx.x; i < nb * H3; i += kThreads)
        stage[i] = to_f32(dgh_next[(size_t)b0 * H3 + i]);
      __syncthreads();
      for (int j = warp; j < nu; j += kWarps) {
        const Elem* wr = w_hh_t + (size_t)(unit0 + j) * H3;
        float acc[kBatchTile];
#pragma unroll
        for (int bb = 0; bb < kBatchTile; ++bb) acc[bb] = 0.0f;
#pragma unroll 4
        for (int k = lane; k < H3; k += 32) {
          const float w = to_f32(wr[k]);
#pragma unroll
          for (int bb = 0; bb < kBatchTile; ++bb)
            if (bb < nb) acc[bb] = fmaf(w, stage[bb * H3 + k], acc[bb]);
        }
#pragma unroll
        for (int bb = 0; bb < kBatchTile; ++bb) {
          const float v = warp_sum(acc[bb]);
          if (lane == 0 && bb < nb) dhs[bb * kUnits + j] = v;
        }
      }
    } else {
      for (int i = threadIdx.x; i < nb * kUnits; i += kThreads) dhs[i] = 0.0f;
    }
    __syncthreads();

    if (dgx_out == nullptr) {  // final launch: dh0
      for (int i = threadIdx.x; i < nb * nu; i += kThreads) {
        const int bb = i / nu;
        const int j = i - bb * nu;
        const size_t o = (size_t)(b0 + bb) * H + unit0 + j;
        dh_out[o] = carry[o] + dhs[bb * kUnits + j];
      }
      continue;
    }

    // gate remat for the owned rows, exactly as the forward (K5) formed it
    for (int i = threadIdx.x; i < nb * H; i += kThreads)
      stage[i] = to_f32(h_prev[(size_t)b0 * H + i]);
    __syncthreads();
    for (int r = warp; r < 3 * nu; r += kWarps) {
      const int q = r / nu;            // gate
      const int j = r - q * nu;        // unit within the block
      const int row = q * H + unit0 + j;
      const Elem* wr = w_hh + (size_t)row * H;
      float acc[kBatchTile];
#pragma unroll
      for (int bb = 0; bb < kBatchTile; ++bb) acc[bb] = 0.0f;
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        const float w = to_f32(wr[k]);
#pragma unroll
        for (int bb = 0; bb < kBatchTile; ++bb)
          if (bb < nb) acc[bb] = fmaf(w, stage[bb * H + k], acc[bb]);
      }
      const float bias = b_hh[row];
#pragma unroll
      for (int bb = 0; bb < kBatchTile; ++bb) {
        const float v = warp_sum(acc[bb]);
        if (lane == 0 && bb < nb) gs[bb * kRows + r] = v + bias;
      }
    }
    __syncthreads();

    // the cell's backward for the owned units (rnn_pallas.py:548-571)
    for (int i = threadIdx.x; i < nb * nu; i += kThreads) {
      const int bb = i / nu;
      const int j = i - bb * nu;
      const size_t b = (size_t)(b0 + bb);
      const int u = unit0 + j;
      const Elem* x = xp + b * H3;
      const float* g = gs + bb * kRows;
      const float rg = sigmoid(to_f32(x[u]) + g[j]);
      const float zg = sigmoid(to_f32(x[H + u]) + g[nu + j]);
      const float hn = g[2 * nu + j];
      const float ng = tanhf(to_f32(x[2 * H + u]) + rg * hn);
      float dh = carry[b * H + u] + dhs[bb * kUnits + j];
      if (dh_ext != nullptr) dh += dh_ext[b * H + u];
      if (dy != nullptr) dh += to_f32(dy[b * H + u]);
      const float da_n = dh * (1.0f - zg) * (1.0f - ng * ng);
      const float da_r = da_n * hn * rg * (1.0f - rg);
      const float da_z =
          dh * (to_f32(h_prev[b * H + u]) - ng) * zg * (1.0f - zg);
      Elem* gx = dgx_out + b * H3;
      Elem* gh = dgh_out + b * H3;
      const Elem er = from_f32<Elem>(da_r);
      const Elem ez = from_f32<Elem>(da_z);
      gx[u] = er;
      gx[H + u] = ez;
      gx[2 * H + u] = from_f32<Elem>(da_n);
      gh[u] = er;
      gh[H + u] = ez;
      gh[2 * H + u] = from_f32<Elem>(da_n * rg);
      carry[b * H + u] = dh * zg;
    }
  }
}

template <typename Elem>
cudaError_t run(const void* xp_, const void* w_hh_, const void* w_hh_t_,
                const void* b_hh_, const void* h0e_, const void* ys_,
                const void* dys_, const void* dhT_, void* dgx_, void* dgh_,
                void* dh0_, void* carry_, int T, int B, int H,
                cudaStream_t stream) {
  const size_t smem = (size_t)(kBatchTile * 3 * H + kBatchTile * kRows +
                               kBatchTile * kUnits) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_bwd_step_kernel<Elem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits);
  const size_t bh = (size_t)B * H;
  const Elem* xp = static_cast<const Elem*>(xp_);
  const Elem* w = static_cast<const Elem*>(w_hh_);
  const Elem* wt = static_cast<const Elem*>(w_hh_t_);
  const float* bias = static_cast<const float*>(b_hh_);
  const Elem* ys = static_cast<const Elem*>(ys_);
  const Elem* dys = static_cast<const Elem*>(dys_);
  Elem* dgx = static_cast<Elem*>(dgx_);
  Elem* dgh = static_cast<Elem*>(dgh_);
  float* carry = static_cast<float*>(carry_);
  for (int t = T - 1; t >= 0; --t) {
    const Elem* h_prev =
        t == 0 ? static_cast<const Elem*>(h0e_) : ys + (size_t)(t - 1) * bh;
    gru_bwd_step_kernel<Elem><<<grid, kThreads, smem, stream>>>(
        xp + (size_t)t * 3 * bh, w, wt, bias, h_prev,
        dys ? dys + (size_t)t * bh : nullptr,
        t < T - 1 ? dgh + (size_t)(t + 1) * 3 * bh : nullptr,
        t == T - 1 ? static_cast<const float*>(dhT_) : nullptr, carry,
        dgx + (size_t)t * 3 * bh, dgh + (size_t)t * 3 * bh, nullptr, B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  gru_bwd_step_kernel<Elem><<<grid, kThreads, smem, stream>>>(
      xp, w, wt, bias, static_cast<const Elem*>(h0e_), nullptr, dgh, nullptr,
      carry, nullptr, nullptr, static_cast<float*>(dh0_), B, H);
  return cudaGetLastError();
}

}  // namespace

// x_proj (T, B, 3H), w_hh (3H, H), w_hh_t (H, 3H), h0e (B, H) = h0 in
// x_proj's dtype, ys (T, B, H) and dys (T, B, H, may be NULL) in fp32
// (bf16 == 0) or bf16; b_hh (3H) and dhT (B, H, may be NULL) fp32. Outputs
// dgx, dgh (T, B, 3H) in x_proj's dtype, dh0 (B, H) fp32; carry (B, H) fp32
// scratch must come in zeroed.
extern "C" int edd_gru_bwd(const void* xp, const void* w_hh,
                           const void* w_hh_t, const void* b_hh,
                           const void* h0e, const void* ys, const void* dys,
                           const void* dhT, void* dgx, void* dgh, void* dh0,
                           void* carry, int T, int B, int H, int bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? run<__nv_bfloat16>(xp, w_hh, w_hh_t, b_hh, h0e, ys, dys, dhT,
                                dgx, dgh, dh0, carry, T, B, H, s)
           : run<float>(xp, w_hh, w_hh_t, b_hh, h0e, ys, dys, dhT, dgx, dgh,
                        dh0, carry, T, B, H, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
