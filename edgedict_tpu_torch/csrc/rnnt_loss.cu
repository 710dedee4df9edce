// K9 + K10 — the RNN-T lattice: alpha + logZ, and beta fused with the
// occupancy gradients.
//
// Replaces edgedict_tpu/ops/rnnt_loss_pallas.py:_alpha_kernel (launched by
// _run_alpha) and :_beta_grad_kernel (launched by _run_beta_grad). Semantics
// as there and in ops/rnnt_loss.py: transitions masked by (xlen, ylen) to the
// finite NEG, no label transition at t = T, logZ = alpha[xlen, ylen] (xlen =
// 0 included), gradients = occupancies exp(alpha + lp + beta' - logZ), the
// cotangent's sign and scale applied by the caller.
//
// What bounds it on the H100: latency, not bytes or FLOPs. The lattice is
// (T+1) x (U+1) cells per utterance (215 x 65 at E6D2 training) with a
// dependency on the left and upper neighbour, so a cell can only be formed
// after its anti-diagonal predecessor; the work per cell is one logaddexp.
//
// Design: one block per utterance (the TPU kernel took 8 per grid step). The
// TPU solved each row's recurrence over u by lane-shift doubling; here the
// block walks the T+U+1 anti-diagonals t + u = d, one thread per u, with one
// __syncthreads per diagonal: every cell of a diagonal reads only cells of
// the previous one, which the block wrote to global memory before the
// barrier. The beta walk runs the diagonals backwards and forms both
// gradients of cell (t, u) as soon as beta[t+1, u] and beta[t, u+1] exist.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float log_add(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float blank_m(const float* blank, int t, int u,
                                         int U1, int xl, int yl) {
  return (t < xl && u <= yl) ? blank[(size_t)t * U1 + u] : kNeg;
}

__device__ __forceinline__ float label_m(const float* label, int t, int u,
                                         int U, int xl, int yl) {
  return (t < xl && u < yl) ? label[(size_t)t * U + u] : kNeg;
}

__global__ void lattice_alpha_kernel(const float* __restrict__ blank,
                                     const float* __restrict__ label,
                                     const int* __restrict__ xlen,
                                     const int* __restrict__ ylen,
                                     float* __restrict__ alpha,
                                     float* __restrict__ logz, int T,
                                     int U1) {
  const int b = blockIdx.x;
  const int U = U1 - 1;
  const float* bl = blank + (size_t)b * T * U1;
  const float* la = label + (size_t)b * T * U;
  float* al = alpha + (size_t)b * (T + 1) * U1;
  const int xl = xlen[b];
  const int yl = ylen[b];
  for (int d = 0; d <= T + U; ++d) {
    for (int u = threadIdx.x; u < U1; u += blockDim.x) {
      const int t = d - u;
      if (t < 0 || t > T) continue;
      float v;
      if (d == 0) {
        v = 0.0f;
      } else {
        const float from_blank =
            t > 0 ? al[(size_t)(t - 1) * U1 + u] +
                        blank_m(bl, t - 1, u, U1, xl, yl)
                  : kNeg;
        const float from_label =
            (u > 0 && t < T) ? al[(size_t)t * U1 + u - 1] +
                                   label_m(la, t, u - 1, U, xl, yl)
                             : kNeg;
        v = log_add(from_blank, from_label);
      }
      al[(size_t)t * U1 + u] = v;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int t = min(max(xl, 0), T);
    const int u = min(max(yl, 0), U);
    logz[b] = al[(size_t)t * U1 + u];
  }
}

__global__ void lattice_beta_grad_kernel(
    const float* __restrict__ blank, const float* __restrict__ label,
    const float* __restrict__ alpha, const float* __restrict__ logz,
    const int* __restrict__ xlen, const int* __restrict__ ylen,
    float* __restrict__ beta, float* __restrict__ gb, float* __restrict__ gl,
    int T, int U1) {
  const int b = blockIdx.x;
  const int U = U1 - 1;
  const size_t lat = (size_t)b * (T + 1) * U1;
  const float* bl = blank + (size_t)b * T * U1;
  const float* la = label + (size_t)b * T * U;
  const float* al = alpha + lat;
  float* be = beta + lat;
  float* gbb = gb + (size_t)b * T * U1;
  float* glb = gl + (size_t)b * T * U;
  const int xl = xlen[b];
  const int yl = ylen[b];
  const float z = logz[b];
  for (int d = T + U; d >= 0; --d) {
    for (int u = threadIdx.x; u < U1; u += blockDim.x) {
      const int t = d - u;
      if (t < 0 || t > T) continue;
      const float term = (t == xl && u == yl) ? 0.0f : kNeg;
      float v = term;
      if (t < T) {
        const float bm = blank_m(bl, t, u, U1, xl, yl);
        const float b_next = be[(size_t)(t + 1) * U1 + u];
        const float a = al[(size_t)t * U1 + u];
        gbb[(size_t)t * U1 + u] = expf(a + bm + b_next - z);
        v = log_add(v, bm + b_next);
        if (u < U) {
          const float lm = label_m(la, t, u, U, xl, yl);
          const float b_right = be[(size_t)t * U1 + u + 1];
          glb[(size_t)t * U + u] = expf(a + lm + b_right - z);
          v = log_add(v, lm + b_right);
        }
      }
      be[(size_t)t * U1 + u] = v;
    }
    __syncthreads();
  }
}

int threads_for(int U1) {
  const int n = ((U1 + 31) / 32) * 32;
  return n < 1024 ? n : 1024;
}

}  // namespace

// blank (B, T, U1), label (B, T, U1 - 1) fp32 raw log-probs (masked here),
// xlen/ylen (B) int32 → alpha (B, T + 1, U1), logz (B) fp32.
extern "C" int edd_lattice_alpha(const void* blank, const void* label,
                                 const void* xlen, const void* ylen,
                                 void* alpha, void* logz, int B, int T,
                                 int U1, void* stream) {
  lattice_alpha_kernel<<<B, threads_for(U1), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(label),
      static_cast<const int*>(xlen), static_cast<const int*>(ylen),
      static_cast<float*>(alpha), static_cast<float*>(logz), T, U1);
  return (int)cudaGetLastError();
}

// + alpha, logz from edd_lattice_alpha; beta (B, T + 1, U1) fp32 scratch →
// gb (B, T, U1), gl (B, T, U1 - 1) fp32 occupancies.
extern "C" int edd_lattice_beta_grad(const void* blank, const void* label,
                                     const void* alpha, const void* logz,
                                     const void* xlen, const void* ylen,
                                     void* beta, void* gb, void* gl, int B,
                                     int T, int U1, void* stream) {
  lattice_beta_grad_kernel<<<B, threads_for(U1), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(label),
      static_cast<const float*>(alpha), static_cast<const float*>(logz),
      static_cast<const int*>(xlen), static_cast<const int*>(ylen),
      static_cast<float*>(beta), static_cast<float*>(gb),
      static_cast<float*>(gl), T, U1);
  return (int)cudaGetLastError();
}
