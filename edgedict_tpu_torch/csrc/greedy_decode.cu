// K3 — fused greedy frame loop.
//
// Replaces edgedict_tpu/ops/decode_pallas.py:_kernel (launched by
// _call_kernel, reached through maybe_greedy_frame_loop for streaming and
// maybe_greedy_decode for offline decode): for each encoder frame t,
//   g      = h_dec W_dec^T + b_joint
//   logits = tanh(f[t] + g) W_out^T + b_out
//   pred   = first argmax (a NaN row gives its first NaN), <unk> re-argmaxed
//            with logits[unk] = -inf; optional max log-prob -log sum exp(x-m)
//   on a non-blank pred: embedding row (PAD row pre-zeroed), the stacked
//   prediction-net LSTM (bias pre-summed), projection, and the new
//   (h_dec, hs, cs); on blank the state is left as it was.
// f = enc W_enc^T for all frames stays one torch.matmul outside, as in JAX
// (decode_pallas.py:427-431). Same state-in / state-out contract.
//
// What bounds it on the H100: every frame reads all of the decode weights
// (W_out 640x2048, W_dec, the 2-layer LSTM and the projection: ~9.5 MB
// fp32 at E6D2) for matrix-vector products — L2-resident (50 MB), but read
// by one SM per stream, so a frame is bound by one SM's L2 bandwidth and by
// the block-wide barriers between the dependent steps. Frames are
// sequential by construction (each token feeds the next frame).
//
// Design: one block per stream walks all T frames, so the whole loop is one
// launch; every intermediate (h_dec 256, the joint hidden 640, the logits
// 2048, the gates 1024, the LSTM states) lives in shared memory, and only
// the tokens, the optional log-probs and the final state are written to
// device memory. Threads own output columns of each matrix-vector product
// and read the right-multiply weights (build_decode_cache layout) row by
// row, neighbouring threads on neighbouring columns. The prediction net
// runs only on non-blank frames (its result would be discarded otherwise).
// At B=1 this uses one SM of 132; spreading a stream over several SMs is
// later work.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 4;

struct LayerPtrs {
  const float* w_ih_t[kMaxLayers];  // (in, 4H)
  const float* w_hh_t[kMaxLayers];  // (H, 4H)
  const float* bias[kMaxLayers];    // (4H) = b_ih + b_hh
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// (v, i) <- the better of (v, i) and (v2, i2): NaN beats numbers (first NaN
// wins), a larger value wins, equal values keep the smaller index.
__device__ __forceinline__ void combine(float& v, int& i, float v2, int i2) {
  const bool n1 = isnan(v), n2 = isnan(v2);
  if (n1 && n2) {
    if (i2 < i) i = i2;
  } else if (n2 || (!n1 && (v2 > v || (v2 == v && i2 < i)))) {
    v = v2;
    i = i2;
  }
}

// Index of the first maximum of x[0:V) (x[skip] read as -inf).
__device__ int block_argmax(const float* x, int V, int skip, float* red_v,
                            int* red_i) {
  const float neg_inf = -INFINITY;
  float v = neg_inf;
  int idx = INT_MAX;
  for (int k = threadIdx.x; k < V; k += kThreads)
    combine(v, idx, k == skip ? neg_inf : x[k], k);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, idx, off);
    combine(v, idx, v2, i2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : neg_inf;
    idx = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int i2 = __shfl_down_sync(0xffffffffu, idx, off);
      combine(v, idx, v2, i2);
    }
    if (lane == 0) red_i[kWarps] = idx;
  }
  __syncthreads();
  const int out = red_i[kWarps];
  __syncthreads();
  return out;
}

__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  const float out = red[kWarps];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
greedy_decode_kernel(const float* __restrict__ f,        // (T, B, J)
                     int T, int B, int J,
                     const float* __restrict__ w_dec_t,  // (D, J)
                     const float* __restrict__ b_joint,  // (J)
                     const float* __restrict__ w_out_t,  // (J, V)
                     const float* __restrict__ b_out,    // (V)
                     int V,
                     const float* __restrict__ table,    // (V, E)
                     int E, int L, LayerPtrs layers, int H,
                     const float* __restrict__ w_proj_t, // (H, D)
                     const float* __restrict__ b_proj,   // (D)
                     int D,
                     const float* __restrict__ h_dec0,   // (B, D)
                     const float* __restrict__ hs0,      // (L, B, H)
                     const float* __restrict__ cs0,      // (L, B, H)
                     int* __restrict__ tokens,           // (T, B)
                     float* __restrict__ logp,           // (T, B) or null
                     float* __restrict__ h_dec_out,      // (B, D)
                     float* __restrict__ hs_out,         // (L, B, H)
                     float* __restrict__ cs_out,         // (L, B, H)
                     int blank, int unk) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int H4 = 4 * H;
  float* hdec = smem;                    // D
  float* jh = hdec + D;                  // J
  float* logits = jh + J;                // V
  float* xs = logits + V;                // E (embedding row)
  float* gates = xs + E;                 // 4H
  float* hs = gates + H4;                // L*H
  float* cs = hs + L * H;                // L*H
  float* nh = cs + L * H;                // L*H
  float* nc = nh + L * H;                // L*H
  float* hnew = nc + L * H;              // D
  float* red_v = hnew + D;               // kWarps + 1
  int* red_i = reinterpret_cast<int*>(red_v + kWarps + 1);  // kWarps + 1

  for (int d = threadIdx.x; d < D; d += kThreads)
    hdec[d] = h_dec0[(size_t)b * D + d];
  for (int k = threadIdx.x; k < L * H; k += kThreads) {
    const int l = k / H, u = k - l * H;
    hs[k] = hs0[((size_t)l * B + b) * H + u];
    cs[k] = cs0[((size_t)l * B + b) * H + u];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* ft = f + ((size_t)t * B + b) * J;
    for (int j = threadIdx.x; j < J; j += kThreads) {
      float acc = 0.0f;
      for (int d = 0; d < D; ++d)
        acc = fmaf(hdec[d], w_dec_t[(size_t)d * J + j], acc);
      jh[j] = tanhf(ft[j] + (acc + b_joint[j]));
    }
    __syncthreads();
    for (int v = threadIdx.x; v < V; v += kThreads) {
      float acc = 0.0f;
      for (int j = 0; j < J; ++j)
        acc = fmaf(jh[j], w_out_t[(size_t)j * V + v], acc);
      logits[v] = acc + b_out[v];
    }
    __syncthreads();

    int pred = block_argmax(logits, V, -1, red_v, red_i);
    if (logp != nullptr) {
      const float m = logits[pred];
      float s = 0.0f;
      for (int v = threadIdx.x; v < V; v += kThreads)
        s += expf(logits[v] - m);
      s = block_sum(s, red_v);
      if (threadIdx.x == 0) logp[(size_t)t * B + b] = -logf(s);
    }
    if (unk >= 0 && pred == unk)
      pred = block_argmax(logits, V, unk, red_v, red_i);
    if (threadIdx.x == 0) tokens[(size_t)t * B + b] = pred;

    if (pred != blank) {  // block-uniform: pred came from a block reduction
      for (int e = threadIdx.x; e < E; e += kThreads)
        xs[e] = table[(size_t)pred * E + e];
      __syncthreads();
      const float* in = xs;
      int n_in = E;
      for (int l = 0; l < L; ++l) {
        const float* wi = layers.w_ih_t[l];
        const float* wh = layers.w_hh_t[l];
        const float* bias = layers.bias[l];
        const float* hp = hs + l * H;
        for (int c = threadIdx.x; c < H4; c += kThreads) {
          float a = 0.0f, r = 0.0f;
          for (int k = 0; k < n_in; ++k)
            a = fmaf(in[k], wi[(size_t)k * H4 + c], a);
          for (int k = 0; k < H; ++k)
            r = fmaf(hp[k], wh[(size_t)k * H4 + c], r);
          gates[c] = (a + bias[c]) + r;
        }
        __syncthreads();
        for (int u = threadIdx.x; u < H; u += kThreads) {
          const float c = sigmoid(gates[H + u]) * cs[l * H + u] +
                          sigmoid(gates[u]) * tanhf(gates[2 * H + u]);
          nc[l * H + u] = c;
          nh[l * H + u] = sigmoid(gates[3 * H + u]) * tanhf(c);
        }
        __syncthreads();
        in = nh + l * H;
        n_in = H;
      }
      for (int d = threadIdx.x; d < D; d += kThreads) {
        float acc = 0.0f;
        for (int k = 0; k < H; ++k)
          acc = fmaf(in[k], w_proj_t[(size_t)k * D + d], acc);
        hnew[d] = acc + b_proj[d];
      }
      __syncthreads();
      for (int d = threadIdx.x; d < D; d += kThreads) hdec[d] = hnew[d];
      for (int k = threadIdx.x; k < L * H; k += kThreads) {
        hs[k] = nh[k];
        cs[k] = nc[k];
      }
    }
    __syncthreads();
  }

  for (int d = threadIdx.x; d < D; d += kThreads)
    h_dec_out[(size_t)b * D + d] = hdec[d];
  for (int k = threadIdx.x; k < L * H; k += kThreads) {
    const int l = k / H, u = k - l * H;
    hs_out[((size_t)l * B + b) * H + u] = hs[k];
    cs_out[((size_t)l * B + b) * H + u] = cs[k];
  }
}

}  // namespace

// All tensors fp32 except tokens (int32); logp may be null. w_ih_t, w_hh_t
// and bias are host arrays of L device pointers. unk < 0 disables the
// <unk> re-argmax.
extern "C" int edd_greedy_decode(
    const void* f, int T, int B, int J, const void* w_dec_t,
    const void* b_joint, const void* w_out_t, const void* b_out, int V,
    const void* table, int E, int L, const void* const* w_ih_t,
    const void* const* w_hh_t, const void* const* bias, int H,
    const void* w_proj_t, const void* b_proj, int D, const void* h_dec0,
    const void* hs0, const void* cs0, void* tokens, void* logp, void* h_dec,
    void* hs, void* cs, int blank, int unk, void* stream) {
  if (L < 1 || L > kMaxLayers) return (int)cudaErrorInvalidValue;
  LayerPtrs layers = {};
  for (int l = 0; l < L; ++l) {
    layers.w_ih_t[l] = static_cast<const float*>(w_ih_t[l]);
    layers.w_hh_t[l] = static_cast<const float*>(w_hh_t[l]);
    layers.bias[l] = static_cast<const float*>(bias[l]);
  }
  const size_t smem =
      (size_t)(2 * D + J + V + E + 4 * H + 4 * L * H + 2 * (kWarps + 1)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_decode_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), T, B, J,
      static_cast<const float*>(w_dec_t), static_cast<const float*>(b_joint),
      static_cast<const float*>(w_out_t), static_cast<const float*>(b_out), V,
      static_cast<const float*>(table), E, L, layers, H,
      static_cast<const float*>(w_proj_t), static_cast<const float*>(b_proj),
      D, static_cast<const float*>(h_dec0), static_cast<const float*>(hs0),
      static_cast<const float*>(cs0), static_cast<int*>(tokens),
      static_cast<float*>(logp), static_cast<float*>(h_dec),
      static_cast<float*>(hs), static_cast<float*>(cs), blank, unk);
  return (int)cudaGetLastError();
}
