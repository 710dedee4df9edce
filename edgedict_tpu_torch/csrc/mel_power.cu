// K2 — mel power featurizer.
//
// Replaces edgedict_tpu/ops/features_pallas.py:_kernel (launched by
// mel_power_pallas): frame the reflect-padded waveform at hop `hop`,
// window it, take the real DFT, form re^2 + im^2 and project onto the mel
// filterbank, without ever writing the (B, T, n_fft) frame tensor or the
// (B, T, n_freq) power spectrum to device memory.
//
// What bounds the function on the H100: bytes. A frame needs a real FFT
// (~11.5 kflop at n_fft 512), its power and the filterbank's ~500 nonzero
// weights, ~14 kflop against 4·hop bytes of audio and 4·n_mels of output.
// This kernel computes the DFT as a product instead, 2·n_fft·n_freq
// multiply-adds a frame (~0.53 MFLOP, ~40x an FFT's work), so its own floor
// is fp32 FFMA at 67 TFLOP/s (the table, 1 MB, stays in L2): it beats the
// plain version (cuFFT) at a chunk's few frames and loses to it at the
// train step's many, where an FFT in shared memory is the lever. A
// streaming chunk has only B x 7 frames, so there the work must be spread
// over the card or the call is one block's latency.
//
// Design (plan: ops/features_plan.py, which the wrapper passes in): one
// launch per call, any n_fft from 64 to 2048 and hop from 1 to n_fft. The
// DFT is a register-tiled fp32 product, FFMA and never TF32 (the TPU
// kernel's 3-pass bf16 split, features_pallas.py:37-54, only emulates fp32
// on the MXU): frames x the window-folded table dft (rows, 2 NBP), [cos |
// sin] of NBP bin pairs: the ceil(n_fft/2) real pairs (even n_fft: pair
// 0's sine column carries the Nyquist cosine), then zero pairs up to whole
// pair groups, and zero rows past n_fft up to whole stages. A block owns a
// tile of R consecutive frames of one batch row, staged once as one
// contiguous span of the padded row, (R-1)·hop + the rows read, from the
// unpadded audio with the reflection done by index arithmetic (no padded
// copy) and zeros past the padded row. Its threads are
// (row groups x column groups x depth splits); each sums 8 frames x 4
// pairs (cos and sin: 64 accumulators) over every S-th sample, the table's
// slice streaming through two shared stages of 4096 floats by cp.async.
// The splits are added in order in shared memory, squared into the power
// tile and multiplied into the block's mel tile in shared memory: nothing
// of size (frames x bins) reaches device memory. Many frames: 64-frame
// tiles, every block takes all bins in passes of 128 pairs and writes its
// mel tile. Few frames: 8-frame tiles, a block takes 16 pairs with a 64-way
// depth split, writes a partial mel tile to a scratch, and the last block
// of its tile (threadfence + a counter that block resets to 0) adds the
// partials in slice order into the output: one launch, no atomics on the
// output, the same bits on every call. The counters are the stream's own
// (the wrapper keeps one buffer per stream): two calls may overlap only on
// two streams.

#include <cuda_runtime.h>

#include <cstddef>

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 8;          // frames per thread
constexpr int kTP = 4;          // bin pairs per thread
constexpr int kStage = 4096;    // floats per table stage

struct MelArgs {
  const float* audio;   // (B, L) preemphasized
  const float* dft;     // (rows, 2 nbp)
  const float* mel_t;   // (n_fft/2 + 1, M)
  const int* band;      // (M, 2) the bins [lo, hi) of each mel's weights
  float* out;           // (B, T, M)
  float* part;          // (blocks, R, M) partial mel tiles (split)
  int* count;           // (tiles) finished slices, 0 between calls (split)
  int L, T, n_fft, hop, M;
  int nbp;              // the table's pairs (real ones, then zero ones)
  int passes, slices, kc, tiles_per_row, span;
};

// the padded row's sample i (reflect by n_fft/2, no edge repeat), 0 past it
__device__ __forceinline__ float padded(const float* row, int i, int L,
                                        int p) {
  if (i >= L + 2 * p) return 0.0f;
  int j = i - p;
  j = j < 0 ? -j : (j >= L ? 2 * (L - 1) - j : j);
  return __ldg(row + j);
}

// thread t's (column group, row group, depth split): up to 16 column groups
// are the fastest index, so a warp reads at most 16 column groups' table
// values (two 16-byte loads each) and 2 or more row groups' samples
struct Place {
  int cgi, rgi, s;
  __device__ Place(int t, int RG, int CG) {
    const int W = CG < 16 ? CG : 16;
    const int rest = t / (W * RG);
    cgi = t % W + W * (rest % (CG / W));
    rgi = t / W % RG;
    s = rest / (CG / W);
  }
};

// chunk c of the block's table slice (rows c·kc .., pairs pb .. pb+C-1 of
// both halves) into a stage laid out as kc rows of [cos C | sin C]
__device__ __forceinline__ void stage_chunk(const MelArgs& a, float* st,
                                            int c, int kc, int pb, int C,
                                            int NBP) {
  const int per_row = C / 2;              // 16-byte units of a stage row
  const int units = kc * per_row;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int r = u / per_row, w = u % per_row;
    const int half = w / (C / 4), col = (w % (C / 4)) * 4;
    cp_async16(st + r * 2 * C + half * C + col,
               a.dft + (size_t)(c * kc + r) * 2 * NBP + half * NBP + pb +
                   col);
  }
  cp_async_commit();
}

// One instantiation per split of the plan: the block's row groups, column
// groups and depth splits, and the table rows of a stage (0: a.kc), known
// to the compiler, so that the sample and table offsets of the product's
// loop are constants.
template <int RG, int CG, int S, int kKC>
__global__ void __launch_bounds__(kThreads, 2)
mel_power_kernel(MelArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kTR * RG, C = kTP * CG;
  // NB: the Nyquist bin (even n_fft), nbr: the pairs that carry bins
  const int NB = a.n_fft / 2, NBP = a.nbp, M = a.M;
  const int nbr = (a.n_fft + 1) / 2;
  const bool nyquist = (a.n_fft & 1) == 0;
  float* ring = smem;                     // 2 stages; then red, power
  float* span = smem + 2 * kStage;
  float* macc = span + (a.span + 3) / 4 * 4;   // (R, M)
  float* nyq = macc + R * M;              // (R) the Nyquist bin's power

  const int tid = threadIdx.x;
  const Place pl(tid, RG, CG);
  const int tile = blockIdx.x / a.slices, slice = blockIdx.x % a.slices;
  const int b = tile / a.tiles_per_row;
  const int t0 = tile % a.tiles_per_row * R;
  const float* row = a.audio + (size_t)b * a.L;
  const int p = a.n_fft / 2;
  for (int i = tid; i < a.span; i += kThreads)
    span[i] = padded(row, t0 * a.hop + i, a.L, p);
  for (int i = tid; i < R * M; i += kThreads) macc[i] = 0.0f;

  const int kc = kKC ? kKC : a.kc, nchunks = (a.n_fft + kc - 1) / kc;
  const int rows = kc / S;
  for (int pass = 0; pass < a.passes; ++pass) {
    const int pb = (slice * a.passes + pass) * C;
    float acc[kTR][kTP][2];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int e = 0; e < kTP; ++e) acc[i][e][0] = acc[i][e][1] = 0.0f;
    stage_chunk(a, ring, 0, kc, pb, C, NBP);
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) {
        stage_chunk(a, ring + ((c + 1) & 1) * kStage, c + 1, kc, pb, C,
                    NBP);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();                    // chunk c staged (and the span)
      const float* st = ring + (c & 1) * kStage + pl.cgi * kTP;
      const float* xs = span + pl.rgi * a.hop + c * kc + pl.s;
#pragma unroll(kKC ? kKC / S : 2)
      for (int rr = 0; rr < rows; ++rr) {
        const int nl = pl.s + rr * S;
        const float4 wc = *reinterpret_cast<const float4*>(st + nl * 2 * C);
        const float4 ws =
            *reinterpret_cast<const float4*>(st + nl * 2 * C + C);
        const float wcv[kTP] = {wc.x, wc.y, wc.z, wc.w};
        const float wsv[kTP] = {ws.x, ws.y, ws.z, ws.w};
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const float x = xs[RG * i * a.hop + rr * S];
#pragma unroll
          for (int e = 0; e < kTP; ++e) {
            acc[i][e][0] = fmaf(x, wcv[e], acc[i][e][0]);
            acc[i][e][1] = fmaf(x, wsv[e], acc[i][e][1]);
          }
        }
      }
      __syncthreads();                    // stage c & 1 free again
    }

    // the depth splits added in order, cos then sin through red (it
    // aliases the ring), into the power tile (R, C) and the Nyquist
    // column: re^2 + im^2, and for pair 0 re^2 (DC) and im^2 (Nyquist)
    float* power = ring;
    if (S > 1) {
      float* red = ring;                  // [32 values][256 threads]
      const int groups = RG * CG;         // the threads of one split
      const bool mine = tid < groups * kTR * kTP;
      const int x = tid % groups, ie = tid / groups;
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int e = 0; e < kTP; ++e)
            red[(i * kTP + e) * kThreads + tid] = acc[i][e][h];
        __syncthreads();
        if (mine)
          for (int k = 0; k < S; ++k)
            sum[h] += red[ie * kThreads + k * groups + x];
        __syncthreads();                  // red read
      }
      if (mine) {
        const Place px(x, RG, CG);
        const int f = px.rgi + RG * (ie / kTP), q = px.cgi * kTP + ie % kTP;
        const bool dc = pb + q == 0;
        power[f * C + q] = sum[0] * sum[0] + (dc ? 0.0f : sum[1] * sum[1]);
        if (q == 0) nyq[f] = dc ? sum[1] * sum[1] : 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int e = 0; e < kTP; ++e) {
          const int f = pl.rgi + RG * i, q = pl.cgi * kTP + e;
          const float re = acc[i][e][0], im = acc[i][e][1];
          const bool dc = pb + q == 0;
          power[f * C + q] = re * re + (dc ? 0.0f : im * im);
          if (q == 0) nyq[f] = dc ? im * im : 0.0f;
        }
    }
    __syncthreads();

    // the filterbank over the pass's real pairs inside each mel's band
    // (the triangular filters' other weights are zero), then the Nyquist
    // bin of an even n_fft (its power is 0 outside pair 0's pass)
    for (int o = tid; o < R * M; o += kThreads) {
      const int f = o / M, m = o % M;
      const int lo = max(__ldg(a.band + 2 * m), pb);
      const int hi = min(min(__ldg(a.band + 2 * m + 1), pb + C), nbr);
      const float* pr = power + f * C;
      float v = macc[o];
      for (int q = lo; q < hi; ++q)
        v = fmaf(pr[q - pb], __ldg(a.mel_t + (size_t)q * M + m), v);
      if (nyquist)
        v = fmaf(nyq[f], __ldg(a.mel_t + (size_t)NB * M + m), v);
      macc[o] = v;
    }
    __syncthreads();                      // power (the ring) free again
  }

  float* o = a.out + ((size_t)b * a.T + t0) * M;
  const int live = min(R, a.T - t0) * M;
  if (a.slices == 1) {
    for (int i = tid; i < live; i += kThreads) o[i] = macc[i];
    return;
  }
  float* part = a.part + (size_t)blockIdx.x * R * M;
  for (int i = tid; i < R * M; i += kThreads) part[i] = macc[i];
  __threadfence();
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(a.count + tile, 1) == a.slices - 1;
    if (last) a.count[tile] = 0;          // every slice has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = a.part + (size_t)tile * a.slices * R * M;
  for (int i = tid; i < live; i += kThreads) {
    float v = 0.0f;
    for (int j = 0; j < a.slices; ++j)
      v += __ldcg(parts + (size_t)j * R * M + i);
    o[i] = v;
  }
}

template <int RG, int CG, int S, int kKC>
cudaError_t launch(const MelArgs& a, int blocks, int smem,
                   cudaStream_t stream) {
  const void* fn =
      reinterpret_cast<const void*>(mel_power_kernel<RG, CG, S, kKC>);
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  mel_power_kernel<RG, CG, S, kKC><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// audio (B, L) fp32 preemphasized; dft (rows, 2 nbp) the window-folded
// [cos | sin] pair table (zero past the real pairs and past row n_fft),
// mel_t (n_fft/2 + 1, M), band (M, 2) int32 the bins [lo, hi) of each
// mel's nonzero weights; out (B, T, M). The plan
// (ops/features_plan.py): rg/cg/S the block's row groups, column groups
// and depth splits (8/32/1 with 16 table rows a stage: many frames;
// 1/4/64: few frames; any other is refused), `passes` and `slices` of
// 4·cg pairs, kc table rows a stage, `tiles_per_row` frame tiles of 8·rg
// frames a row, `span` staged samples, `blocks` and `smem`; part / count
// the split's scratch (else null).
extern "C" int edd_mel_power(const void* audio, const void* dft,
                             const void* mel_t, const void* band, void* out,
                             void* part, void* count, int L, int T,
                             int n_fft, int hop, int M, int nbp, int rg,
                             int cg,
                             int S, int passes, int slices, int kc,
                             int tiles_per_row, int span, int blocks,
                             int smem, void* stream) {
  const MelArgs a{static_cast<const float*>(audio),
                  static_cast<const float*>(dft),
                  static_cast<const float*>(mel_t),
                  static_cast<const int*>(band),
                  static_cast<float*>(out),
                  static_cast<float*>(part),
                  static_cast<int*>(count),
                  L, T, n_fft, hop, M, nbp, passes, slices, kc,
                  tiles_per_row, span};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rg == 8 && cg == 32 && S == 1 && kc == 16)
    return (int)launch<8, 32, 1, 16>(a, blocks, smem, s);
  if (rg == 1 && cg == 4 && S == 64)
    return (int)launch<1, 4, 64, 0>(a, blocks, smem, s);
  return (int)cudaErrorInvalidValue;
}
