// K4 — LSTM recurrence, backward (the dh/dc chain).
//
// Replaces edgedict_tpu/ops/rnn_pallas.py:_bwd_kernel (launched by _run_bwd
// under the custom-vjp lstm_recurrence_tm): walk t = T-1 .. 0, rematerialise
// the forward's gates = x_proj[t] + h_{t-1} W_hh^T from the saved ys (h_{t-1}
// = ys[t-1] in x_proj's dtype, or h0 cast to it at t = 0: the same rounding
// the forward fed its dot), and emit
//   dgates[t] = d(i, f, g, o) in x_proj's dtype,
//   dh0 = dgates[0] W_hh (fp32 accumulation), dc0 = the carried dc.
// dW_hh and the input-projection grads are products over all steps and stay
// outside (one matmul each), as rnn_pallas.py:358-367 leaves them to XLA.
//
// What bounds it on the H100: as K1, the recurrent weight. Each step reads
// W_hh twice (4H x H each: 8 MB in bf16 at H=1024): once by rows for the
// gate remat, once by columns for dh, for a product of small B. Both copies
// (W_hh and W_hh^T, as the TPU kernel also takes both) stay in the 50 MB L2
// across the steps of a call. Steps are sequential.
//
// Design: one launch per step; block i owns kUnits hidden units. dh for
// unit j needs only column j of W_hh against the whole of dgates[t+1],
// which the previous launch finished, so a block first forms dh for its own
// units (warp per unit, lanes striding the contiguous row j of W_hh^T,
// dgates[t+1] staged in shared memory kBatchTile rows at a time, so that
// the block's warps share one read of it), then
// rematerialises the 4*kUnits gate rows it owns (as K1), then applies the
// cell's backward to its units. dc is carried per unit in a (B, H) fp32
// buffer that only the owning block touches. A last launch forms dh0 from
// dgates[0].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kUnits = 4;             // hidden units per block
constexpr int kRows = 4 * kUnits;     // gate rows per block (i, f, g, o)
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

// One reverse step t. With dg_out == nullptr this is the final launch: only
// dh = dg_next W_hh for the owned units, written to dh_out (dh0).
template <typename Elem>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step_kernel(const Elem* __restrict__ xp,       // (B, 4H) step t
                     const Elem* __restrict__ w_hh,     // (4H, H)
                     const Elem* __restrict__ w_hh_t,   // (H, 4H)
                     const Elem* __restrict__ h_prev,   // (B, H) h_{t-1}
                     const float* __restrict__ c_prev,  // (B, H) c_{t-1}
                     const float* __restrict__ c_cur,   // (B, H) c_t
                     const Elem* __restrict__ dy,       // (B, H) or null
                     const float* __restrict__ dc_ext,  // (B, H) or null
                     const Elem* __restrict__ dg_next,  // (B, 4H) or null
                     const float* __restrict__ dh_ext,  // (B, H) or null
                     float* __restrict__ dc_carry,      // (B, H) in/out
                     Elem* __restrict__ dg_out,         // (B, 4H) or null
                     float* __restrict__ dh_out,        // (B, H) or null
                     int B, int H) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  float* stage = smem;                           // kBatchTile * 4H
  float* gs = smem + kBatchTile * H4;            // kBatchTile * kRows
  float* dhs = gs + kBatchTile * kRows;          // kBatchTile * kUnits
  const int unit0 = blockIdx.x * kUnits;
  const int nu = min(kUnits, H - unit0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int b0 = 0; b0 < B; b0 += kBatchTile) {
    const int nb = min(kBatchTile, B - b0);
    __syncthreads();  // the previous tile is fully consumed

    // dh for the owned units: dgates[t+1] (W dtype) . W_hh[:, j], fp32 sum
    if (dg_next != nullptr) {
      for (int i = threadIdx.x; i < nb * H4; i += kThreads)
        stage[i] = to_f32(dg_next[(size_t)b0 * H4 + i]);
      __syncthreads();
      for (int j = warp; j < nu; j += kWarps) {
        const Elem* wr = w_hh_t + (size_t)(unit0 + j) * H4;
        float acc[kBatchTile];
#pragma unroll
        for (int bb = 0; bb < kBatchTile; ++bb) acc[bb] = 0.0f;
#pragma unroll 4
        for (int k = lane; k < H4; k += 32) {
          const float w = to_f32(wr[k]);
#pragma unroll
          for (int bb = 0; bb < kBatchTile; ++bb)
            if (bb < nb) acc[bb] = fmaf(w, stage[bb * H4 + k], acc[bb]);
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

    if (dg_out == nullptr) {  // final launch: dh0
      for (int i = threadIdx.x; i < nb * nu; i += kThreads) {
        const int bb = i / nu;
        const int j = i - bb * nu;
        dh_out[(size_t)(b0 + bb) * H + unit0 + j] = dhs[bb * kUnits + j];
      }
      continue;
    }

    // gate remat for the owned rows, exactly as the forward (K1) formed it
    for (int i = threadIdx.x; i < nb * H; i += kThreads)
      stage[i] = to_f32(h_prev[(size_t)b0 * H + i]);
    __syncthreads();
    for (int r = warp; r < 4 * nu; r += kWarps) {
      const int q = r / nu;            // gate
      const int j = r - q * nu;        // unit within the block
      const Elem* wr = w_hh + (size_t)(q * H + unit0 + j) * H;
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
#pragma unroll
      for (int bb = 0; bb < kBatchTile; ++bb) {
        const float v = warp_sum(acc[bb]);
        if (lane == 0 && bb < nb) gs[bb * kRows + r] = v;
      }
    }
    __syncthreads();

    // the cell's backward for the owned units (rnn_pallas.py:_bwd_step)
    for (int i = threadIdx.x; i < nb * nu; i += kThreads) {
      const int bb = i / nu;
      const int j = i - bb * nu;
      const size_t b = (size_t)(b0 + bb);
      const int u = unit0 + j;
      const Elem* x = xp + b * H4;
      const float* g = gs + bb * kRows;
      const float ai = sigmoid(to_f32(x[u]) + g[j]);
      const float af = sigmoid(to_f32(x[H + u]) + g[nu + j]);
      const float ag = tanhf(to_f32(x[2 * H + u]) + g[2 * nu + j]);
      const float ao = sigmoid(to_f32(x[3 * H + u]) + g[3 * nu + j]);
      const float tc = tanhf(c_cur[b * H + u]);
      float dh = dhs[bb * kUnits + j];
      if (dy != nullptr) dh += to_f32(dy[b * H + u]);
      if (dh_ext != nullptr) dh += dh_ext[b * H + u];
      float dc_in = dc_carry[b * H + u];
      if (dc_ext != nullptr) dc_in += dc_ext[b * H + u];
      const float d_o = dh * tc;
      const float dc = dh * ao * (1.0f - tc * tc) + dc_in;
      Elem* dg = dg_out + b * H4;
      dg[u] = from_f32<Elem>(dc * ag * ai * (1.0f - ai));
      dg[H + u] = from_f32<Elem>(dc * c_prev[b * H + u] * af * (1.0f - af));
      dg[2 * H + u] = from_f32<Elem>(dc * ai * (1.0f - ag * ag));
      dg[3 * H + u] = from_f32<Elem>(d_o * ao * (1.0f - ao));
      dc_carry[b * H + u] = dc * af;
    }
  }
}

template <typename Elem>
cudaError_t run(const void* xp_, const void* w_hh_, const void* w_hh_t_,
                const void* h0e_, const void* c0_, const void* ys_,
                const void* cs_, const void* dys_, const void* dcs_,
                const void* dhT_, void* dgates_, void* dh0_, void* dc_,
                int T, int B, int H, cudaStream_t stream) {
  const size_t smem = (size_t)(kBatchTile * 4 * H + kBatchTile * kRows +
                               kBatchTile * kUnits) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_step_kernel<Elem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits);
  const size_t bh = (size_t)B * H;
  const Elem* xp = static_cast<const Elem*>(xp_);
  const Elem* w = static_cast<const Elem*>(w_hh_);
  const Elem* wt = static_cast<const Elem*>(w_hh_t_);
  const Elem* ys = static_cast<const Elem*>(ys_);
  const float* cs = static_cast<const float*>(cs_);
  const Elem* dys = static_cast<const Elem*>(dys_);
  const float* dcs = static_cast<const float*>(dcs_);
  Elem* dg = static_cast<Elem*>(dgates_);
  float* dc = static_cast<float*>(dc_);
  for (int t = T - 1; t >= 0; --t) {
    const Elem* h_prev =
        t == 0 ? static_cast<const Elem*>(h0e_) : ys + (size_t)(t - 1) * bh;
    const float* c_prev =
        t == 0 ? static_cast<const float*>(c0_) : cs + (size_t)(t - 1) * bh;
    lstm_bwd_step_kernel<Elem><<<grid, kThreads, smem, stream>>>(
        xp + (size_t)t * 4 * bh, w, wt, h_prev, c_prev, cs + (size_t)t * bh,
        dys ? dys + (size_t)t * bh : nullptr,
        dcs ? dcs + (size_t)t * bh : nullptr,
        t < T - 1 ? dg + (size_t)(t + 1) * 4 * bh : nullptr,
        t == T - 1 ? static_cast<const float*>(dhT_) : nullptr, dc,
        dg + (size_t)t * 4 * bh, nullptr, B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  lstm_bwd_step_kernel<Elem><<<grid, kThreads, smem, stream>>>(
      xp, w, wt, static_cast<const Elem*>(h0e_),
      static_cast<const float*>(c0_), cs, nullptr, nullptr, dg, nullptr, dc,
      nullptr, static_cast<float*>(dh0_), B, H);
  return cudaGetLastError();
}

}  // namespace

// x_proj (T, B, 4H), w_hh (4H, H), w_hh_t (H, 4H), h0e (B, H) = h0 in x_proj's
// dtype, ys (T, B, H) and dys (T, B, H, may be NULL) in fp32 (bf16 == 0) or
// bf16; c0 (B, H), cs (T, B, H), dcs (T, B, H, may be NULL), dhT (B, H, may
// be NULL) fp32. Outputs dgates (T, B, 4H) in x_proj's dtype, dh0 (B, H)
// fp32; dc (B, H) fp32 must come in zeroed and leaves holding dc0.
extern "C" int edd_lstm_bwd(const void* xp, const void* w_hh,
                            const void* w_hh_t, const void* h0e,
                            const void* c0, const void* ys, const void* cs,
                            const void* dys, const void* dcs, const void* dhT,
                            void* dgates, void* dh0, void* dc, int T, int B,
                            int H, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? run<__nv_bfloat16>(xp, w_hh, w_hh_t, h0e, c0, ys, cs, dys, dcs,
                                dhT, dgates, dh0, dc, T, B, H, s)
           : run<float>(xp, w_hh, w_hh_t, h0e, c0, ys, cs, dys, dcs, dhT,
                        dgates, dh0, dc, T, B, H, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
