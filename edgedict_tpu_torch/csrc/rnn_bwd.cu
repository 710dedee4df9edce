// K4 and K6 — the LSTM and GRU recurrences' backward (the dh chain).
//
// Replaces edgedict_tpu/ops/rnn_pallas.py:_bwd_kernel (K4, launched by
// _run_bwd under the custom-vjp lstm_recurrence_tm) and _gru_bwd_kernel (K6,
// _gru_run_bwd under gru_recurrence_tm). Both walk t = T-1 .. 0 from the
// saved ys and emit the gates' gradients and dh0:
//   LSTM: dgates[t] = d(i, f, g, o) in x_proj's dtype, dh0 = dgates[0] W_hh,
//         dc0 = the carried dc;
//   GRU (torch gates r, z, n, b_hh inside the reset gate):
//         dgx[t] = (da_r, da_z, da_n), dgh[t] = (da_r, da_z, da_n * r), the
//         dh carried to t-1 = dh z + dgh[t] W_hh, dh0 the last one.
// dW_hh, db_hh and the input projection's grads are products or sums over
// all steps and stay outside (one matmul each), as rnn_pallas.py leaves them
// to XLA.
//
// What bounds it on the H100: operations, 2 x 2·T·B·G·H·H (G = 4 gates for
// the LSTM, 3 for the GRU) at the tensor cores' rate in bf16; in practice the
// serial chain of T steps, each of which has to see every block's output of
// the step before.
//
// Design: two launches per call.
//  1. The gate remat leaves the chain. h_proj = h_prev W_hh^T (+ b_hh for the
//     GRU) for all T steps at once, into an fp32 scratch (T·B, G·H); h_prev
//     = [h0 in x_proj's dtype; ys[:-1]] is read by row without building the
//     concatenation. In bf16 a tiled tensor-core product (mma.sync m16n8k16,
//     128x128x32 tiles, cp.async double buffering); in fp32 a tiled FFMA
//     product (128x128x8 tiles, 8x8 per thread), never TF32. The TPU kernel
//     does this product in its own body, one batched matmul per block of
//     steps (rnn_pallas.py:244, :536).
//  2. The dh chain is one persistent cooperative launch. Block i owns
//     kUnits = 8 hidden units and keeps its column slice W_hh[:, units]
//     (G·H x 8) in shared memory for all T steps. Each reverse step it forms
//     dh for its units from dg[t+1] (the whole B x G·H, written by every
//     block in the step before: read with ld.global.cg, never through the
//     read-only path) on tensor cores in bf16 (m16n8k16 with N = the 8
//     units, warps splitting K, a reduction over warps in shared memory) or
//     on FFMA in fp32; applies the cell's backward to (B x 8) from h_proj[t]
//     and x_proj[t], loaded before the product; keeps its carry (dc, or
//     dh·z) in shared memory; writes dg[t] for its units; and passes a grid
//     barrier. The step after t = 0 forms dh0 in the same launch. The launch
//     plan (grid, shared memory) comes from the wrapper (ops/rnn_bwd.py); a
//     grid that cannot be co-resident is refused by the cooperative launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 8;                 // hidden units per chain block
constexpr int kThreads = 256;             // 8 warps, both kernels
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

// Row m of h_prev = [h0e; ys[:-1]] flattened to (T·B, H).
template <typename Elem>
__device__ __forceinline__ const Elem* h_prev_row(const Elem* h0e,
                                                  const Elem* ys, int m,
                                                  int B, int H) {
  return m < B ? h0e + (size_t)m * H : ys + (size_t)(m - B) * H;
}

struct LstmCell;
struct GruCell;

// ---------------------------------------------------------------------------
// 1. the gate remat: out (M, N) fp32 = h_prev (M, K) . W (N, K)^T [+ bias]
// ---------------------------------------------------------------------------

constexpr int kTile = 128;                 // M and N of a block's tile
constexpr int kBk = 32;                    // K of a bf16 stage
constexpr int kLd = kBk + 8;               // padded smem row: no conflicts

// 8 bf16 of row `src` at k .. k+7 into shared memory (zero past K or for a
// null row); cp.async where the rows are 16-byte aligned.
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, int k, int K,
                                       bool aligned) {
  if (src == nullptr || k >= K) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if (aligned) {
    cp_async16(dst, src + k);
  } else {
    for (int e = 0; e < 8; ++e)
      dst[e] = k + e < K ? src[k + e] : __float2bfloat16(0.0f);
  }
}

// Cell only names the kernel (LstmCell or GruCell) for a profiler's trace.
template <typename Cell>
__global__ void __launch_bounds__(kThreads)
remat_bf16_kernel(const __nv_bfloat16* __restrict__ h0e,
                  const __nv_bfloat16* __restrict__ ys,
                  const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int M, int N, int K, int B) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kTile * kLd];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile 64 x 32
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const bool aligned = K % 8 == 0 && aligned16(h0e, ys, w);

  auto load = [&](int buf, int k0) {
    for (int i = tid; i < kTile * 4; i += kThreads) {
      const int r = i >> 2, k = k0 + (i & 3) * 8;
      const int m = m0 + r, n = n0 + r;
      stage8(&As[buf][r * kLd + (i & 3) * 8],
             m < M ? h_prev_row(h0e, ys, m, B, K) : nullptr, k, K, aligned);
      stage8(&Bs[buf][r * kLd + (i & 3) * 8],
             n < N ? w + (size_t)n * K : nullptr, k, K, aligned);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int nk = (K + kBk - 1) / kBk;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * kBk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
    const __nv_bfloat16* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = as + (wm * 64 + i * 16 + gid) * kLd + kk +
                                 tig * 2;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = bs + (wn * 32 + j * 8 + gid) * kLd + kk +
                                 tig * 2;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
                   b[j][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + gid + h * 8;
        if (m >= M) continue;
        float* o = out + (size_t)m * N + n;
        for (int e = 0; e < 2; ++e)
          if (n + e < N)
            o[e] = acc[i][j][2 * h + e] + (bias ? bias[n + e] : 0.0f);
      }
    }
}

template <typename Cell>
__global__ void __launch_bounds__(kThreads)
remat_f32_kernel(const float* __restrict__ h0e, const float* __restrict__ ys,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int K, int B) {
  constexpr int kBk32 = 8, kLd32 = kTile + 4;
  __shared__ __align__(16) float As[kBk32 * kLd32];   // [k][m]
  __shared__ __align__(16) float Bs[kBk32 * kLd32];   // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const bool aligned = K % 4 == 0 && aligned16(h0e, ys, w);
  const int r = tid >> 1, kh = (tid & 1) * 4;     // this thread's loads
  const float* arow = m0 + r < M ? h_prev_row(h0e, ys, m0 + r, B, K) : nullptr;
  const float* brow = n0 + r < N ? w + (size_t)(n0 + r) * K : nullptr;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto fetch4 = [&](const float* row, int k, float* v) {
    if (row != nullptr && aligned && k + 4 <= K) {
      const float4 q = *reinterpret_cast<const float4*>(row + k);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      for (int e = 0; e < 4; ++e)
        v[e] = row != nullptr && k + e < K ? row[k + e] : 0.0f;
    }
  };

  for (int k0 = 0; k0 < K; k0 += kBk32) {
    float va[4], vb[4];
    fetch4(arow, k0 + kh, va);
    fetch4(brow, k0 + kh, vb);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      As[(kh + e) * kLd32 + r] = va[e];
      Bs[(kh + e) * kLd32 + r] = vb[e];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBk32; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k * kLd32 + ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[k * kLd32 + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k * kLd32 + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[k * kLd32 + 64 + tx * 4]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N)
        out[(size_t)m * N + n] = acc[i][j] + (bias ? bias[n] : 0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the dh chain: one persistent cooperative launch
// ---------------------------------------------------------------------------

struct ChainArgs {
  const void* xp;        // (T, B, G·H) x_proj's dtype
  const void* w;         // (G·H, H)
  const void* h0e;       // (B, H) h0 in x_proj's dtype (GRU)
  const float* c0;       // (B, H) (LSTM)
  const void* ys;        // (T, B, H) (GRU: h_prev)
  const float* cs;       // (T, B, H) (LSTM)
  const void* dys;       // (T, B, H) or null
  const float* dcs;      // (T, B, H) or null (LSTM)
  const float* dhT;      // (B, H) or null
  const float* hproj;    // (T, B, G·H) fp32, the remat
  void* dg;              // (T, B, G·H) out, read back by every block
  void* dgx;             // (T, B, 3H) out (GRU)
  float* dh0;            // (B, H) out
  float* dc0;            // (B, H) out (LSTM)
  int T, B, H;
};

// Where W_hh[k, unit0 + j] lives in the block's shared slice. bf16: in
// mma B-fragment order, chunk c = k / 32, lane (j, tig) holding k = 32c +
// 8 tig .. +7 as 16 bytes; the A side reads dg in the same permutation of k
// (the sum over k does not depend on the order). fp32: two (K32, 4) halves.
template <typename Elem>
__device__ __forceinline__ int ws_index(int k, int j, int K32);
template <>
__device__ __forceinline__ int ws_index<__nv_bfloat16>(int k, int j, int) {
  return (((k >> 5) * 32 + j * 4 + ((k & 31) >> 3)) << 3) + (k & 7);
}
template <>
__device__ __forceinline__ int ws_index<float>(int k, int j, int K32) {
  return (j >> 2) * K32 * 4 + k * 4 + (j & 3);
}

// dh_s[b * 8 + j] = sum_k dg[b, k] W_hh[k, unit0 + j] for every b < B.
// bf16: tensor cores, warps splitting K in chunks of 32, m tiles of 16 rows
// in passes of 32 rows, partial sums reduced over warps in `red`.
__device__ void chain_product(const __nv_bfloat16* dg,
                              const __nv_bfloat16* ws, float* red,
                              float* dh_s, int B, int K) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nchunks = (K + 31) / 32;
  const bool aligned = K % 8 == 0;
  constexpr int kDepth = 4;                 // chunks in flight per warp
  for (int p0 = 0; p0 < B; p0 += 32) {      // a pass of 32 rows
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int c0 = warp; c0 < nchunks; c0 += kDepth * kWarps) {
      uint4 xa[kDepth][2][2];               // [chunk][m tile][row gid, +8]
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int k = (c0 + u * kWarps) * 32 + tig * 8;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xa[u][mt][h] = ldcg8(dg, p0 + mt * 16 + gid + h * 8, k, B, K,
                                 aligned);
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int c = c0 + u * kWarps;
        if (c >= nchunks) break;
        const uint4 wv = reinterpret_cast<const uint4*>(ws)[c * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint4 x = xa[u][mt][0], y = xa[u][mt][1];
          mma_bf16(acc[mt], x.x, y.x, x.y, y.y, wv.x, wv.y);
          mma_bf16(acc[mt], x.z, y.z, x.w, y.w, wv.z, wv.w);
        }
      }
    }
    float* rw = red + warp * 32 * kUnits;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + gid + h * 8;
        rw[row * kUnits + tig * 2] = acc[mt][2 * h];
        rw[row * kUnits + tig * 2 + 1] = acc[mt][2 * h + 1];
      }
    __syncthreads();
    for (int i = tid; i < 32 * kUnits; i += kThreads) {
      const int b = p0 + i / kUnits;
      if (b >= B) continue;
      float s = 0.0f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) s += red[v * 32 * kUnits + i];
      dh_s[b * kUnits + (i % kUnits)] = s;
    }
    __syncthreads();
  }
}

// fp32: FFMA, a warp per group of 4 batch rows, lanes striding K; the 32
// sums of a group are folded over the warp so that lane L holds value L.
__device__ void chain_product(const float* dg, const float* ws, float*,
                              float* dh_s, int B, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K32 = (K + 31) / 32 * 32;
  const float4* w0 = reinterpret_cast<const float4*>(ws);
  const float4* w1 = reinterpret_cast<const float4*>(ws + K32 * 4);
  for (int b0 = warp * 4; b0 < B; b0 += kWarps * 4) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.0f;
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float4 wa = w0[k], wb = w1[k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = b0 + r < B ? __ldcg(dg + (size_t)(b0 + r) * K + k)
                                   : 0.0f;
        float* o = v + r * kUnits;
        o[0] = fmaf(a, wa.x, o[0]);
        o[1] = fmaf(a, wa.y, o[1]);
        o[2] = fmaf(a, wa.z, o[2]);
        o[3] = fmaf(a, wa.w, o[3]);
        o[4] = fmaf(a, wb.x, o[4]);
        o[5] = fmaf(a, wb.y, o[5]);
        o[6] = fmaf(a, wb.z, o[6]);
        o[7] = fmaf(a, wb.w, o[7]);
      }
    }
    fold<16>(v, lane);
    if (b0 + lane / kUnits < B) dh_s[b0 * kUnits + lane] = v[0];
  }
  __syncthreads();
}

// The cells' backward for one (b, unit) item: inputs loaded before the
// step's product (they do not depend on the chain), then applied.
struct LstmCell {
  static constexpr int G = 4;
  float x[4], c, cp, dy, dc_ext;
  template <typename Elem>
  __device__ void load(const ChainArgs& a, int t, int b, int u) {
    const size_t bh = (size_t)a.B * a.H, o = (size_t)b * a.H + u;
    const Elem* xp = static_cast<const Elem*>(a.xp) + (size_t)t * 4 * bh +
                     (size_t)b * 4 * a.H;
    const float* hp = a.hproj + (size_t)t * 4 * bh + (size_t)b * 4 * a.H;
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = to_f32(xp[q * a.H + u]) + hp[q * a.H + u];
    c = a.cs[t * bh + o];
    cp = t == 0 ? a.c0[o] : a.cs[(t - 1) * bh + o];
    dy = a.dys ? to_f32(static_cast<const Elem*>(a.dys)[t * bh + o]) : 0.0f;
    if (t == a.T - 1 && a.dhT) dy += a.dhT[o];
    dc_ext = a.dcs ? a.dcs[t * bh + o] : 0.0f;
  }
  // dh from the chain; carry = dc in, dc f out
  template <typename Elem>
  __device__ void apply(const ChainArgs& a, int t, int b, int u, float dh,
                        float* carry) const {
    const float ai = sigmoid(x[0]), af = sigmoid(x[1]);
    const float ag = tanhf(x[2]), ao = sigmoid(x[3]);
    const float tc = tanhf(c);
    dh += dy;
    const float d_o = dh * tc;
    const float dc = dh * ao * (1.0f - tc * tc) + (*carry + dc_ext);
    Elem* dg = static_cast<Elem*>(a.dg) + ((size_t)t * a.B + b) * 4 * a.H;
    dg[u] = from_f32<Elem>(dc * ag * ai * (1.0f - ai));
    dg[a.H + u] = from_f32<Elem>(dc * cp * af * (1.0f - af));
    dg[2 * a.H + u] = from_f32<Elem>(dc * ai * (1.0f - ag * ag));
    dg[3 * a.H + u] = from_f32<Elem>(d_o * ao * (1.0f - ao));
    *carry = dc * af;
  }
  __device__ static void finish(const ChainArgs& a, size_t o, float dh,
                                float carry) {
    a.dh0[o] = dh;
    a.dc0[o] = carry;
  }
};

struct GruCell {
  static constexpr int G = 3;
  float xr, xz, xn, hn, hprev, dy;
  template <typename Elem>
  __device__ void load(const ChainArgs& a, int t, int b, int u) {
    const size_t bh = (size_t)a.B * a.H, o = (size_t)b * a.H + u;
    const Elem* xp = static_cast<const Elem*>(a.xp) + (size_t)t * 3 * bh +
                     (size_t)b * 3 * a.H;
    const float* hp = a.hproj + (size_t)t * 3 * bh + (size_t)b * 3 * a.H;
    xr = to_f32(xp[u]) + hp[u];
    xz = to_f32(xp[a.H + u]) + hp[a.H + u];
    xn = to_f32(xp[2 * a.H + u]);
    hn = hp[2 * a.H + u];
    hprev = to_f32(t == 0 ? static_cast<const Elem*>(a.h0e)[o]
                          : static_cast<const Elem*>(a.ys)[(t - 1) * bh + o]);
    dy = a.dys ? to_f32(static_cast<const Elem*>(a.dys)[t * bh + o]) : 0.0f;
    if (t == a.T - 1 && a.dhT) dy += a.dhT[o];
  }
  // dh from the chain; carry = dh z of the step after, dh z out
  template <typename Elem>
  __device__ void apply(const ChainArgs& a, int t, int b, int u, float dhp,
                        float* carry) const {
    const float rg = sigmoid(xr), zg = sigmoid(xz);
    const float ng = tanhf(xn + rg * hn);
    const float dh = (*carry + dhp) + dy;
    const float da_n = dh * (1.0f - zg) * (1.0f - ng * ng);
    const float da_r = da_n * hn * rg * (1.0f - rg);
    const float da_z = dh * (hprev - ng) * zg * (1.0f - zg);
    const size_t row = ((size_t)t * a.B + b) * 3 * a.H;
    Elem* gx = static_cast<Elem*>(a.dgx) + row;
    Elem* gh = static_cast<Elem*>(a.dg) + row;
    const Elem er = from_f32<Elem>(da_r), ez = from_f32<Elem>(da_z);
    gx[u] = er;
    gx[a.H + u] = ez;
    gx[2 * a.H + u] = from_f32<Elem>(da_n);
    gh[u] = er;
    gh[a.H + u] = ez;
    gh[2 * a.H + u] = from_f32<Elem>(da_n * rg);
    *carry = dh * zg;
  }
  __device__ static void finish(const ChainArgs& a, size_t o, float dhp,
                                float carry) {
    a.dh0[o] = carry + dhp;
  }
};

template <typename Elem, typename Cell>
__global__ void __launch_bounds__(kThreads)
chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = a.T, B = a.B, H = a.H, K = Cell::G * H;
  const int K32 = (K + 31) / 32 * 32;
  Elem* ws = reinterpret_cast<Elem*>(smem);
  float* red = reinterpret_cast<float*>(smem + (size_t)K32 * kUnits *
                                                   sizeof(Elem));
  float* dh_s = red + kWarps * 32 * kUnits;
  float* carry = dh_s + B * kUnits;
  const int tid = threadIdx.x;
  const int unit0 = blockIdx.x * kUnits;
  const int items = B * kUnits;

  // the block's column slice of W_hh, once for all steps
  const Elem* w = static_cast<const Elem*>(a.w);
  for (int i = tid; i < K32 * kUnits; i += kThreads) {
    const int k = i / kUnits, j = i % kUnits;
    ws[ws_index<Elem>(k, j, K32)] = k < K && unit0 + j < H
                                        ? w[(size_t)k * H + unit0 + j]
                                        : from_f32<Elem>(0.0f);
  }
  for (int i = tid; i < items; i += kThreads) carry[i] = 0.0f;
  __syncthreads();

  Elem* dg = static_cast<Elem*>(a.dg);
  const size_t step = (size_t)B * K;
  for (int t = T - 1; t >= -1; --t) {       // t = -1: dh0
    Cell first;
    const bool own = tid < items && unit0 + tid % kUnits < H;
    if (t >= 0 && own)
      first.template load<Elem>(a, t, tid / kUnits, unit0 + tid % kUnits);
    if (t < T - 1) {
      chain_product(dg + (size_t)(t + 1) * step, ws, red, dh_s, B, K);
    } else {
      for (int i = tid; i < items; i += kThreads) dh_s[i] = 0.0f;
      __syncthreads();
    }
    for (int i = tid; i < items; i += kThreads) {
      const int b = i / kUnits, u = unit0 + i % kUnits;
      if (u >= H) continue;
      if (t < 0) {
        Cell::finish(a, (size_t)b * H + u, dh_s[i], carry[i]);
        continue;
      }
      Cell cell = first;
      if (i != tid) cell.template load<Elem>(a, t, b, u);
      cell.template apply<Elem>(a, t, b, u, dh_s[i], &carry[i]);
    }
    if (t >= 0) grid.sync();                // dg[t] complete for every block
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename Elem, typename Cell>
cudaError_t run(const ChainArgs& a, const float* b_hh, float* hproj,
                int grid, int smem, cudaStream_t stream) {
  const int M = a.T * a.B, N = Cell::G * a.H, K = a.H;
  const dim3 rgrid(ceil_div(M, kTile), ceil_div(N, kTile));
  if constexpr (sizeof(Elem) == 2) {
    remat_bf16_kernel<Cell><<<rgrid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a.h0e),
        static_cast<const __nv_bfloat16*>(a.ys),
        static_cast<const __nv_bfloat16*>(a.w), b_hh, hproj, M, N, K, a.B);
  } else {
    remat_f32_kernel<Cell><<<rgrid, kThreads, 0, stream>>>(
        static_cast<const float*>(a.h0e), static_cast<const float*>(a.ys),
        static_cast<const float*>(a.w), b_hh, hproj, M, N, K, a.B);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(chain_kernel<Elem, Cell>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ChainArgs args = a;
  args.hproj = hproj;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(chain_kernel<Elem, Cell>), dim3(grid),
      dim3(kThreads), params, (size_t)smem, stream);
}

template <typename Cell>
cudaError_t blocks_per_sm(int bf16, int smem, int* out) {
  const void* fn =
      bf16 ? reinterpret_cast<const void*>(chain_kernel<__nv_bfloat16, Cell>)
           : reinterpret_cast<const void*>(chain_kernel<float, Cell>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads,
                                                       (size_t)smem);
}

}  // namespace

// How many chain blocks of `smem` dynamic bytes one SM holds at once
// (gru != 0: the GRU's kernel). → *out.
extern "C" int edd_rnn_bwd_blocks_per_sm(int gru, int bf16, int smem,
                                         void* out) {
  int* n = static_cast<int*>(out);
  return (int)(gru ? blocks_per_sm<GruCell>(bf16, smem, n)
                   : blocks_per_sm<LstmCell>(bf16, smem, n));
}

extern "C" const char* edd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x_proj (T, B, 4H), w_hh (4H, H), ys (T, B, H), dys (T, B, H, may be
// NULL) in fp32 (bf16 == 0) or bf16; c0 (B, H), cs (T, B, H), dcs (T, B, H,
// may be NULL), dhT (B, H, may be NULL) fp32; hproj (T, B, 4H) fp32
// scratch. h0e is h0 in x_proj's dtype. Outputs dgates (T, B, 4H) in
// x_proj's dtype, dh0 and dc0 (B, H) fp32. `grid` blocks of kUnits units
// (grid * kUnits >= H) and `smem` bytes from the wrapper's plan.
extern "C" int edd_lstm_bwd(const void* xp, const void* w_hh,
                            const void* h0e, const void* c0, const void* ys,
                            const void* cs, const void* dys, const void* dcs,
                            const void* dhT, void* hproj, void* dgates,
                            void* dh0, void* dc0, int T, int B, int H,
                            int bf16, int grid, int smem, void* stream) {
  ChainArgs a{xp, w_hh, h0e, static_cast<const float*>(c0), ys,
              static_cast<const float*>(cs), dys,
              static_cast<const float*>(dcs), static_cast<const float*>(dhT),
              nullptr, dgates, nullptr, static_cast<float*>(dh0),
              static_cast<float*>(dc0), T, B, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hp = static_cast<float*>(hproj);
  const cudaError_t e =
      bf16 ? run<__nv_bfloat16, LstmCell>(a, nullptr, hp, grid, smem, s)
           : run<float, LstmCell>(a, nullptr, hp, grid, smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// x_proj (T, B, 3H), w_hh (3H, H), h0e (B, H), ys (T, B, H), dys (T, B, H,
// may be NULL) in fp32 (bf16 == 0) or bf16; b_hh (3H) and dhT (B, H, may be
// NULL) fp32; hproj (T, B, 3H) fp32 scratch. Outputs dgx, dgh (T, B, 3H) in
// x_proj's dtype, dh0 (B, H) fp32. `grid` and `smem` as edd_lstm_bwd's.
extern "C" int edd_gru_bwd(const void* xp, const void* w_hh,
                           const void* b_hh, const void* h0e, const void* ys,
                           const void* dys, const void* dhT, void* hproj,
                           void* dgx, void* dgh, void* dh0, int T, int B,
                           int H, int bf16, int grid, int smem,
                           void* stream) {
  ChainArgs a{xp, w_hh, h0e, nullptr, ys, nullptr, dys, nullptr,
              static_cast<const float*>(dhT), nullptr, dgh, dgx,
              static_cast<float*>(dh0), nullptr, T, B, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b_hh);
  float* hp = static_cast<float*>(hproj);
  const cudaError_t e =
      bf16 ? run<__nv_bfloat16, GruCell>(a, bias, hp, grid, smem, s)
           : run<float, GruCell>(a, bias, hp, grid, smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
