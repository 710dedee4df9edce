// K2 — mel power featurizer.
//
// Replaces edgedict_tpu/ops/features_pallas.py:_kernel (launched by
// mel_power_pallas): frame the reflect-padded waveform at hop `hop`,
// window it, take the real DFT, form re^2 + im^2 and project onto the mel
// filterbank, without ever writing the (B, T, n_fft) frame tensor or the
// (B, T, n_freq) power spectrum to device memory.
//
// What bounds it on the H100: per frame it does 2*n_fft*n_freq + n_freq*
// n_mels multiply-adds (~0.28 MFLOP at n_fft 512, 257 bins, 80 mels) and
// reads the window-folded cos/sin tables (2 x 512 x 257 fp32 = 1 MB, L2-
// resident after the first frame). A streaming chunk has only B x 7 frames,
// so at serving sizes the kernel is latency-bound (one wave of blocks);
// at a 4 s utterance (321 frames) it is bound by the table reads from L2.
//
// Design: one block per (batch row, frame). The frame's n_fft samples go to
// shared memory; each thread owns DFT bins and walks the frame, reading the
// tables column-wise (neighbouring threads on neighbouring bins: coalesced).
// The power spectrum stays in shared memory, then threads over the mels do
// the filterbank dot against the transposed filterbank (coalesced again).
// Plain fp32 FMAs: the TPU kernel's 3-pass bf16 split (features_pallas.py:
// 37-54) emulates fp32 on the MXU and has no purpose here. Reflect padding
// and preemphasis stay outside the kernel, as in JAX.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mel_power_kernel(const float* __restrict__ audio,   // (B, Lp) padded
                 int Lp,
                 const float* __restrict__ wcos,    // (n_fft, n_freq)
                 const float* __restrict__ wsin,    // (n_fft, n_freq)
                 const float* __restrict__ mel_t,   // (n_freq, n_mels)
                 float* __restrict__ out,           // (B, T, n_mels)
                 int T, int n_fft, int hop, int n_freq, int n_mels) {
  extern __shared__ float smem[];
  float* frame = smem;              // n_fft
  float* power = smem + n_fft;      // n_freq
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const float* src = audio + (size_t)b * Lp + (size_t)t * hop;
  for (int n = threadIdx.x; n < n_fft; n += kThreads) frame[n] = src[n];
  __syncthreads();

  for (int k = threadIdx.x; k < n_freq; k += kThreads) {
    float re = 0.0f, im = 0.0f;
#pragma unroll 8
    for (int n = 0; n < n_fft; ++n) {
      const float x = frame[n];
      re = fmaf(x, wcos[(size_t)n * n_freq + k], re);
      im = fmaf(x, wsin[(size_t)n * n_freq + k], im);
    }
    power[k] = re * re + im * im;
  }
  __syncthreads();

  float* o = out + ((size_t)b * T + t) * n_mels;
  for (int m = threadIdx.x; m < n_mels; m += kThreads) {
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < n_freq; ++k)
      acc = fmaf(power[k], mel_t[(size_t)k * n_mels + m], acc);
    o[m] = acc;
  }
}

}  // namespace

// audio_p (B, Lp) fp32, already preemphasized and reflect-padded by
// n_fft/2 per side; frame t covers audio_p[b, t*hop : t*hop + n_fft].
extern "C" int edd_mel_power(const void* audio_p, int Lp, const void* wcos,
                             const void* wsin, const void* mel_t, void* out,
                             int B, int T, int n_fft, int hop, int n_freq,
                             int n_mels, void* stream) {
  const size_t smem = (size_t)(n_fft + n_freq) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mel_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(T, B);
  mel_power_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio_p), Lp, static_cast<const float*>(wcos),
      static_cast<const float*>(wsin), static_cast<const float*>(mel_t),
      static_cast<float*>(out), T, n_fft, hop, n_freq, n_mels);
  return (int)cudaGetLastError();
}
