// K7 + K8 — fused joint + logsumexp + blank/label gather, and its backward.
//
// Replaces edgedict_tpu/ops/joint_lse_pallas.py:_fwd_kernel /
// _fwd_kernel_split (launched by _run_fwd) and :_bwd_kernel (launched by
// _run_bwd). For every lattice cell (b, t, u), a "row":
//   h      = tanh(f[b,t,:] + g[b,u,:])            fp32, then in W's dtype
//   logits = h . W^T + bias                       fp32 accumulation
//   lse    = logsumexp(logits over V)
//   out    = logits[blank] - lse, logits[label[b,u]] - lse (label = blank
//            in the padded slot u = U)
// and backward, from the saved lse and the cotangents d_b, d_l:
//   dlogits = d_b [c == blank] + d_l [c == label] - (d_b + d_l) softmax
//   dW^T += h^T dlogits, dbias += sum dlogits, dh = dlogits . W,
//   da = dh (1 - h^2) (fp32 h), df[b,t] += sum_u da, dg[b,u] += sum_t da,
// with dlogits rounded to W's dtype for the two products, as the TPU kernel
// feeds its MXU. The (B, T, U+1, V) logits and dlogits never reach device
// memory: each kernel recomputes them tile by tile.
//
// What bounds it on the H100: arithmetic. At E6D2 training (B=32, T=214,
// U+1=65, J=640, V=2048) the forward is 445k rows x J x V = 5.8e11 FMAs and
// the backward three times that (recompute, dh, dW); bytes are small (f, g,
// W stay in L2). In bf16, the training dtype, every product runs on the
// tensor cores (wmma 16x16x16, fp32 accumulate) where J and V are multiples
// of 16; fp32, and other shapes, run the CUDA-core kernels.
//
// Design:
//  * forward: a block takes 32 rows, holds their h in shared memory, and
//    walks V in 128-column chunks: the chunk's logits (wmma into shared
//    memory, or a warp's rows x a lane's 4 columns on CUDA cores), then a
//    running max / sum of exp and the two gathered logits per row (online
//    softmax, as _fwd_kernel_split).
//  * backward dh: the same row tiling recomputes each logits chunk, forms
//    dlogits (rounded to W's dtype) and accumulates dh = dlogits . W (W in
//    its (V, J) layout), in wmma accumulators across the chunks or in
//    shared memory; the epilogue forms da and adds it to df (summed over
//    the block's rows of one (b, t) first) and dg with fp32 atomics.
//  * backward dW: the TPU carried dW in one VMEM accumulator across its
//    ordered grid; blocks here run in no order, so a separate kernel owns a
//    32-column strip of dW^T per block (a J x 32 fp32 accumulator, in wmma
//    registers or shared memory) over a contiguous share of the rows,
//    recomputing h and the strip's logits, and adds the strip to dW^T and
//    dbias with fp32 atomics once at its end.
// The atomics make the summation order of df, dg, dW and dbias differ from
// run to run (fp32 rounding only). Shared-memory rows read by wmma are
// padded by 16 bytes against bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;       // logits columns per chunk (4 per lane)
constexpr int kStrip = 32;       // dW^T columns per block
constexpr int kStripRows = 32;   // rows per step of the dW kernel
// shared-memory rows of the tensor-core kernels are padded by 16 bytes (8
// bf16, 4 fp32) so that the 16 rows of a wmma tile fall on different banks
constexpr int kPadB = 8;
constexpr int kPadF = 4;
constexpr int kStripLd = kStrip + kPadB;    // bf16 W^T strip / dlogits rows
constexpr int kStageLdW = kStrip + kPadF;   // fp32 logits rows, dW kernel
constexpr int kColsLd = kCols + kPadB;      // bf16 dlogits rows, dh kernel
constexpr int kStageLd = kCols + kPadF;     // fp32 logits rows, fwd / dh

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
template <typename Elem>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<Elem>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct Dims {
  int B, T, U1, U, J, V, blank;
  long long N;  // rows = B * T * U1
};

struct Row {
  int b, t, u;
  long long bt;  // b * T + t
};

__device__ __forceinline__ Row split_row(long long r, const Dims& d) {
  Row w;
  w.u = (int)(r % d.U1);
  w.bt = r / d.U1;
  w.t = (int)(w.bt % d.T);
  w.b = (int)(w.bt / d.T);
  return w;
}

template <typename Elem>
__device__ __forceinline__ float h_fp32(const Elem* f, const Elem* g,
                                        const Row& w, int k, const Dims& d) {
  return tanhf(to_f32(f[(size_t)w.bt * d.J + k]) +
               to_f32(g[((size_t)w.b * d.U1 + w.u) * d.J + k]));
}

// hs[rr * J + k] = h of rows r0 .. r0 + R - 1 (rows >= end read as 0), in
// W's dtype as the products take it.
template <typename Elem>
__device__ void fill_h(float* hs, const Elem* f, const Elem* g, long long r0,
                       int R, long long end, const Dims& d) {
  for (int i = threadIdx.x; i < R * d.J; i += blockDim.x) {
    const int rr = i / d.J;
    const int k = i - rr * d.J;
    const long long r = r0 + rr;
    hs[i] = r < end ? round_to<Elem>(h_fp32(f, g, split_row(r, d), k, d))
                    : 0.0f;
  }
}

// logits of RPW rows (hs rows row0 ..) at columns c0 + lane + 32 j
template <typename Elem, int RPW>
__device__ __forceinline__ void warp_logits(const float* hs, int row0,
                                            const Elem* wt,
                                            const float* bias, int c0,
                                            const Dims& d,
                                            float acc[RPW][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k = 0; k < d.J; ++k) {
    float wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + lane + 32 * j;
      wv[j] = c < d.V ? to_f32(wt[(size_t)k * d.V + c]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float hv = hs[(row0 + i) * d.J + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv, wv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + lane + 32 * j;
    const float bv = c < d.V ? bias[c] : 0.0f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i][j] += bv;
  }
}

__device__ __forceinline__ int row_label(const int* labels, const Row& w,
                                         const Dims& d) {
  return w.u < d.U ? labels[(size_t)w.b * d.U + w.u] : d.blank;
}

// ---------------------------------------------------------------------------
// K7 forward
// ---------------------------------------------------------------------------

template <typename Elem, int RPW>
__global__ void __launch_bounds__(kThreads)
joint_lse_fwd_kernel(const Elem* __restrict__ f, const Elem* __restrict__ g,
                     const Elem* __restrict__ wt,
                     const float* __restrict__ bias,
                     const int* __restrict__ labels,
                     float* __restrict__ blank_out,
                     float* __restrict__ label_out,
                     float* __restrict__ lse_out, Dims d) {
  extern __shared__ float hs[];
  constexpr int R = kWarps * RPW;
  const long long r0 = (long long)blockIdx.x * R;
  fill_h(hs, f, g, r0, R, d.N, d);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * RPW;
  int lbl[RPW];
  float m[RPW], s[RPW], bv[RPW], lv[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const long long r = r0 + row0 + i;
    lbl[i] = r < d.N ? row_label(labels, split_row(r, d), d) : d.blank;
    m[i] = -CUDART_INF_F;
    s[i] = 0.0f;
    bv[i] = 0.0f;
    lv[i] = 0.0f;
  }
  for (int c0 = 0; c0 < d.V; c0 += kCols) {
    float acc[RPW][4];
    warp_logits<Elem, RPW>(hs, row0, wt, bias, c0, d, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float cm = -CUDART_INF_F, pb = 0.0f, pl = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < d.V) {
          cm = fmaxf(cm, acc[i][j]);
          if (c == d.blank) pb += acc[i][j];
          if (c == lbl[i]) pl += acc[i][j];
        }
      }
      const float mn = fmaxf(m[i], warp_max(cm));
      float cs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + lane + 32 * j < d.V) cs += expf(acc[i][j] - mn);
      s[i] = s[i] * expf(m[i] - mn) + warp_sum(cs);
      m[i] = mn;
      bv[i] += warp_sum(pb);
      lv[i] += warp_sum(pl);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long r = r0 + row0 + i;
      if (r >= d.N) continue;
      const Row w = split_row(r, d);
      const float lse = m[i] + logf(s[i]);
      blank_out[r] = bv[i] - lse;
      lse_out[r] = lse;
      if (w.u < d.U) label_out[(size_t)w.bt * d.U + w.u] = lv[i] - lse;
    }
  }
}

// da = dh (1 - h^2) with fp32 h for rows r0 .. r0 + R - 1 (dhs[rr * J + k]);
// df summed over the tile's rows of one (b, t) before its atomic, dg one
// atomic per row
template <typename Elem>
__device__ void dh_epilogue(const float* dhs, const Elem* f, const Elem* g,
                            long long r0, int R, const Dims& d, float* df,
                            float* dg) {
  for (int k = threadIdx.x; k < d.J; k += blockDim.x) {
    float run = 0.0f;
    long long cur = -1;
    for (int rr = 0; rr < R; ++rr) {
      const long long r = r0 + rr;
      if (r >= d.N) break;
      const Row rw = split_row(r, d);
      const float h = h_fp32(f, g, rw, k, d);
      const float da = dhs[rr * d.J + k] * (1.0f - h * h);
      atomicAdd(&dg[((size_t)rw.b * d.U1 + rw.u) * d.J + k], da);
      if (rw.bt != cur) {
        if (cur >= 0) atomicAdd(&df[(size_t)cur * d.J + k], run);
        run = 0.0f;
        cur = rw.bt;
      }
      run += da;
    }
    if (cur >= 0) atomicAdd(&df[(size_t)cur * d.J + k], run);
  }
}

// h of rows r0 .. r0 + R - 1 in bf16, columns 0 .. width - 1 of rows ld
// apart (rows >= end and k >= J read as 0): one warp per row, lanes along J
__device__ void fill_h_bf16(__nv_bfloat16* hs, const __nv_bfloat16* f,
                            const __nv_bfloat16* g, long long r0, int R,
                            long long end, int width, int ld, const Dims& d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int rr = warp; rr < R; rr += blockDim.x >> 5) {
    const long long r = r0 + rr;
    const bool ok = r < end;
    const Row rw = split_row(ok ? r : 0, d);
    for (int k = lane; k < width; k += 32)
      hs[rr * ld + k] = __float2bfloat16(
          ok && k < d.J ? h_fp32(f, g, rw, k, d) : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// K8 backward: dh → df, dg
// ---------------------------------------------------------------------------

template <typename Elem, int RPW>
__global__ void __launch_bounds__(kThreads)
joint_lse_bwd_dh_kernel(const Elem* __restrict__ f,
                        const Elem* __restrict__ g,
                        const Elem* __restrict__ wt,
                        const Elem* __restrict__ w,
                        const float* __restrict__ bias,
                        const int* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ d_blank,
                        const float* __restrict__ d_label,
                        float* __restrict__ df, float* __restrict__ dg,
                        Dims d) {
  extern __shared__ float smem[];
  constexpr int R = kWarps * RPW;
  float* hs = smem;                       // R * J
  float* dhs = hs + R * d.J;              // R * J
  float* dls = dhs + R * d.J;             // R * kCols
  const long long r0 = (long long)blockIdx.x * R;
  fill_h(hs, f, g, r0, R, d.N, d);
  for (int i = threadIdx.x; i < R * d.J; i += kThreads) dhs[i] = 0.0f;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * RPW;
  int lbl[RPW];
  float z[RPW], db[RPW], dl[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const long long r = r0 + row0 + i;
    lbl[i] = d.blank;
    z[i] = 0.0f;
    db[i] = 0.0f;
    dl[i] = 0.0f;
    if (r < d.N) {
      const Row rw = split_row(r, d);
      lbl[i] = row_label(labels, rw, d);
      z[i] = lse[r];
      db[i] = d_blank[r];
      if (rw.u < d.U) dl[i] = d_label[(size_t)rw.bt * d.U + rw.u];
    }
  }
  for (int c0 = 0; c0 < d.V; c0 += kCols) {
    float acc[RPW][4];
    warp_logits<Elem, RPW>(hs, row0, wt, bias, c0, d, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + lane + 32 * j;
        float v = 0.0f;
        if (c < d.V && (db[i] != 0.0f || dl[i] != 0.0f)) {
          const float p = expf(acc[i][j] - z[i]);
          v = (c == d.blank ? db[i] : 0.0f) + (c == lbl[i] ? dl[i] : 0.0f) -
              (db[i] + dl[i]) * p;
        }
        dls[(row0 + i) * kCols + lane + 32 * j] = round_to<Elem>(v);
      }
    }
    __syncwarp();
    const int ncol = min(kCols, d.V - c0);
    for (int k = lane; k < d.J; k += 32) {
      float a[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = 0.0f;
      for (int cc = 0; cc < ncol; ++cc) {
        const float wv = to_f32(w[(size_t)(c0 + cc) * d.J + k]);
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          a[i] = fmaf(dls[(row0 + i) * kCols + cc], wv, a[i]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) dhs[(row0 + i) * d.J + k] += a[i];
    }
    __syncwarp();
  }
  __syncthreads();
  dh_epilogue(dhs, f, g, r0, R, d, df, dg);
}

// ---------------------------------------------------------------------------
// K8 backward: dW^T, dbias
// ---------------------------------------------------------------------------

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
joint_lse_bwd_dw_kernel(const Elem* __restrict__ f,
                        const Elem* __restrict__ g,
                        const Elem* __restrict__ wt,
                        const float* __restrict__ bias,
                        const int* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ d_blank,
                        const float* __restrict__ d_label,
                        float* __restrict__ dw, float* __restrict__ dbias,
                        Dims d, long long rows_per_split) {
  extern __shared__ float smem[];
  constexpr int R = kStripRows;
  constexpr int RPW = R / kWarps;
  float* hs = smem;                          // R * J
  float* dws = hs + R * d.J;                 // J * kStrip
  float* dls = dws + d.J * kStrip;           // R * kStrip
  float* red = dls + R * kStrip;             // kWarps * 32
  float* m_z = red + kWarps * 32;            // R
  float* m_db = m_z + R;                     // R
  float* m_dl = m_db + R;                    // R
  int* m_lbl = reinterpret_cast<int*>(m_dl + R);  // R
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kStrip + lane;
  const long long start = (long long)blockIdx.y * rows_per_split;
  const long long end =
      start + rows_per_split < d.N ? start + rows_per_split : d.N;
  for (int i = threadIdx.x; i < d.J * kStrip; i += kThreads) dws[i] = 0.0f;
  float db_acc = 0.0f;
  const float bcol = col < d.V ? bias[col] : 0.0f;
  for (long long r0 = start; r0 < end; r0 += R) {
    __syncthreads();  // the previous step's hs / dls are consumed
    fill_h(hs, f, g, r0, R, end, d);
    if (threadIdx.x < R) {
      const long long r = r0 + threadIdx.x;
      float z = 0.0f, db = 0.0f, dl = 0.0f;
      int lb = d.blank;
      if (r < end) {
        const Row rw = split_row(r, d);
        lb = row_label(labels, rw, d);
        z = lse[r];
        db = d_blank[r];
        if (rw.u < d.U) dl = d_label[(size_t)rw.bt * d.U + rw.u];
      }
      m_z[threadIdx.x] = z;
      m_db[threadIdx.x] = db;
      m_dl[threadIdx.x] = dl;
      m_lbl[threadIdx.x] = lb;
    }
    __syncthreads();
    float acc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i] = 0.0f;
    for (int k = 0; k < d.J; ++k) {
      const float wv = col < d.V ? to_f32(wt[(size_t)k * d.V + col]) : 0.0f;
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        acc[i] = fmaf(hs[(warp * RPW + i) * d.J + k], wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rr = warp * RPW + i;
      const float db = m_db[rr], dl = m_dl[rr];
      float v = 0.0f;
      if (col < d.V && (db != 0.0f || dl != 0.0f)) {
        const float p = expf(acc[i] + bcol - m_z[rr]);
        v = (col == d.blank ? db : 0.0f) + (col == m_lbl[rr] ? dl : 0.0f) -
            (db + dl) * p;
      }
      db_acc += v;
      dls[rr * kStrip + lane] = round_to<Elem>(v);
    }
    __syncthreads();
    for (int k = warp; k < d.J; k += kWarps) {
      float a = dws[k * kStrip + lane];
      for (int rr = 0; rr < R; ++rr)
        a = fmaf(hs[rr * d.J + k], dls[rr * kStrip + lane], a);
      dws[k * kStrip + lane] = a;
    }
  }
  __syncthreads();
  if (col < d.V)
    for (int k = warp; k < d.J; k += kWarps)
      atomicAdd(&dw[(size_t)k * d.V + col], dws[k * kStrip + lane]);
  red[warp * 32 + lane] = db_acc;
  __syncthreads();
  if (warp == 0 && col < d.V) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += red[i * 32 + lane];
    atomicAdd(&dbias[col], s);
  }
}

// bf16 dW^T, dbias on the tensor cores: rows r0 .. r0 + 31 of the block's
// share at a time; KTW = 16-row tiles of dW^T per warp (J <= 128 KTW).
template <int KTW>
__global__ void __launch_bounds__(kThreads, 2)
joint_lse_bwd_dw_wmma_kernel(const __nv_bfloat16* __restrict__ f,
                             const __nv_bfloat16* __restrict__ g,
                             const __nv_bfloat16* __restrict__ wt,
                             const float* __restrict__ bias,
                             const int* __restrict__ labels,
                             const float* __restrict__ lse,
                             const float* __restrict__ d_blank,
                             const float* __restrict__ d_label,
                             float* __restrict__ dw,
                             float* __restrict__ dbias, Dims d,
                             long long rows_per_split, int Jp) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  constexpr int R = kStripRows;
  extern __shared__ __align__(128) unsigned char sraw[];
  const int ldh = Jp + kPadB;
  bf16* hs = reinterpret_cast<bf16*>(sraw);        // R x Jp, rows ldh apart
  bf16* ws = hs + R * ldh;                         // Jp x kStrip (W^T strip)
  bf16* dls = ws + Jp * kStripLd;                  // R x kStrip
  float* stage = reinterpret_cast<float*>(dls + R * kStripLd);  // 2 x R x 32
  float* red = stage + 2 * R * kStageLdW;          // kWarps x 32
  float* m_z = red + kWarps * 32;                  // R
  float* m_db = m_z + R;
  float* m_dl = m_db + R;
  int* m_lbl = reinterpret_cast<int*>(m_dl + R);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kStrip;
  const int col = c0 + lane;
  const int KT = Jp / 16;
  const long long start = (long long)blockIdx.y * rows_per_split;
  const long long end =
      start + rows_per_split < d.N ? start + rows_per_split : d.N;
  for (int i = threadIdx.x; i < Jp * kStrip; i += kThreads) {
    const int k = i / kStrip;
    const int c = i - k * kStrip;
    ws[k * kStripLd + c] = (k < d.J && c0 + c < d.V)
                               ? wt[(size_t)k * d.V + c0 + c]
                               : __float2bfloat16(0.0f);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[KTW][2];
#pragma unroll
  for (int i = 0; i < KTW; ++i) {
    wmma::fill_fragment(acc[i][0], 0.0f);
    wmma::fill_fragment(acc[i][1], 0.0f);
  }
  float db_acc = 0.0f;
  const float bcol = col < d.V ? bias[col] : 0.0f;
  const int mi = (warp & 3) >> 1, ni = warp & 1, half = warp >> 2;
  for (long long r0 = start; r0 < end; r0 += R) {
    __syncthreads();  // the previous step's hs / dls / stage are consumed
    fill_h_bf16(hs, f, g, r0, R, end, Jp, ldh, d);
    if (threadIdx.x < R) {
      const long long r = r0 + threadIdx.x;
      float z = 0.0f, db = 0.0f, dl = 0.0f;
      int lb = d.blank;
      if (r < end) {
        const Row rw = split_row(r, d);
        lb = row_label(labels, rw, d);
        z = lse[r];
        db = d_blank[r];
        if (rw.u < d.U) dl = d_label[(size_t)rw.bt * d.U + rw.u];
      }
      m_z[threadIdx.x] = z;
      m_db[threadIdx.x] = db;
      m_dl[threadIdx.x] = dl;
      m_lbl[threadIdx.x] = lb;
    }
    __syncthreads();
    {  // logits (R x 32) = h (R x Jp) . W^T strip: tile (mi, ni), k half
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> lg;
      wmma::fill_fragment(lg, 0.0f);
      for (int kt = half; kt < KT; kt += 2) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, hs + mi * 16 * ldh + kt * 16, ldh);
        wmma::load_matrix_sync(b, ws + kt * 16 * kStripLd + ni * 16,
                               kStripLd);
        wmma::mma_sync(lg, a, b, lg);
      }
      wmma::store_matrix_sync(stage + half * R * kStageLdW +
                                  mi * 16 * kStageLdW + ni * 16,
                              lg, kStageLdW, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R / kWarps; ++i) {
      const int rr = warp * (R / kWarps) + i;
      const float db = m_db[rr], dl = m_dl[rr];
      float v = 0.0f;
      if (col < d.V && (db != 0.0f || dl != 0.0f)) {
        const float logit = stage[rr * kStageLdW + lane] +
                            stage[(R + rr) * kStageLdW + lane] + bcol;
        const float p = expf(logit - m_z[rr]);
        v = (col == d.blank ? db : 0.0f) + (col == m_lbl[rr] ? dl : 0.0f) -
            (db + dl) * p;
      }
      db_acc += v;
      dls[rr * kStripLd + lane] = __float2bfloat16(v);
    }
    __syncthreads();
    // dW^T strip += h^T (Jp x R) . dlogits (R x 32)
#pragma unroll
    for (int i = 0; i < KTW; ++i) {
      const int kt = warp + kWarps * i;
      if (kt < KT) {
#pragma unroll
        for (int rs = 0; rs < R / 16; ++rs) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, hs + rs * 16 * ldh + kt * 16, ldh);
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                b;
            wmma::load_matrix_sync(b, dls + rs * 16 * kStripLd + nj * 16,
                                   kStripLd);
            wmma::mma_sync(acc[i][nj], a, b, acc[i][nj]);
          }
        }
      }
    }
  }
  __syncthreads();
  float* slot = stage + warp * 256;   // one 16 x 16 tile per warp
#pragma unroll
  for (int i = 0; i < KTW; ++i) {
    const int kt = warp + kWarps * i;
    if (kt < KT) {
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        wmma::store_matrix_sync(slot, acc[i][nj], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int k = kt * 16 + e / 16;
          const int c = c0 + nj * 16 + (e & 15);
          if (k < d.J && c < d.V) atomicAdd(&dw[(size_t)k * d.V + c], slot[e]);
        }
        __syncwarp();
      }
    }
  }
  red[warp * 32 + lane] = db_acc;
  __syncthreads();
  if (warp == 0 && col < d.V) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += red[i * 32 + lane];
    atomicAdd(&dbias[col], s);
  }
}

// logits of rows 0..31 (hs, R x J bf16) at columns c0 .. c0 + 127 into
// stage (R x kCols fp32) on the tensor cores: warp w takes the 16-row tile
// w & 1 and the 16-column tiles w >> 1 and (w >> 1) + 4; tiles at or past V
// are skipped (their stage entries are never read)
__device__ __forceinline__ void wmma_logits_chunk(
    const __nv_bfloat16* hs, int ldh, const __nv_bfloat16* wt, int c0,
    float* stage, const Dims& d) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  const int warp = threadIdx.x >> 5;
  const int rt = warp & 1;
  const int ct[2] = {warp >> 1, (warp >> 1) + 4};
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> lg[2];
  wmma::fill_fragment(lg[0], 0.0f);
  wmma::fill_fragment(lg[1], 0.0f);
  const bool on[2] = {c0 + ct[0] * 16 < d.V, c0 + ct[1] * 16 < d.V};
  for (int kt = 0; kt < d.J / 16; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, hs + rt * 16 * ldh + kt * 16, ldh);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!on[q]) continue;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, wt + (size_t)kt * 16 * d.V + c0 + ct[q] * 16,
                             d.V);
      wmma::mma_sync(lg[q], a, b, lg[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (on[q])
      wmma::store_matrix_sync(stage + rt * 16 * kStageLd + ct[q] * 16, lg[q],
                              kStageLd, wmma::mem_row_major);
}

// K7 in bf16 on the tensor cores (J and V multiples of 16): 32 rows per
// block, each 128-column logits chunk through wmma into shared memory, then
// the same online logsumexp and gathers as joint_lse_fwd_kernel
__global__ void __launch_bounds__(kThreads)
joint_lse_fwd_wmma_kernel(const __nv_bfloat16* __restrict__ f,
                          const __nv_bfloat16* __restrict__ g,
                          const __nv_bfloat16* __restrict__ wt,
                          const float* __restrict__ bias,
                          const int* __restrict__ labels,
                          float* __restrict__ blank_out,
                          float* __restrict__ label_out,
                          float* __restrict__ lse_out, Dims d) {
  constexpr int R = 32;
  constexpr int RPW = R / kWarps;
  extern __shared__ __align__(128) unsigned char sraw[];
  const int ldh = d.J + kPadB;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(sraw);  // R x J
  float* stage = reinterpret_cast<float*>(hs + R * ldh);        // R x kCols
  const long long r0 = (long long)blockIdx.x * R;
  fill_h_bf16(hs, f, g, r0, R, d.N, d.J, ldh, d);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int lbl[RPW];
  float m[RPW], s[RPW], bv[RPW], lv[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const long long r = r0 + warp * RPW + i;
    lbl[i] = r < d.N ? row_label(labels, split_row(r, d), d) : d.blank;
    m[i] = -CUDART_INF_F;
    s[i] = 0.0f;
    bv[i] = 0.0f;
    lv[i] = 0.0f;
  }
  __syncthreads();
  for (int c0 = 0; c0 < d.V; c0 += kCols) {
    wmma_logits_chunk(hs, ldh, wt, c0, stage, d);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rr = warp * RPW + i;
      float x[4];
      float cm = -CUDART_INF_F, pb = 0.0f, pl = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + lane + 32 * j;
        x[j] = c < d.V ? stage[rr * kStageLd + lane + 32 * j] + bias[c]
                       : -CUDART_INF_F;
        cm = fmaxf(cm, x[j]);
        if (c == d.blank) pb += x[j];
        if (c == lbl[i]) pl += x[j];
      }
      const float mn = fmaxf(m[i], warp_max(cm));
      float cs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + lane + 32 * j < d.V) cs += expf(x[j] - mn);
      s[i] = s[i] * expf(m[i] - mn) + warp_sum(cs);
      m[i] = mn;
      bv[i] += warp_sum(pb);
      lv[i] += warp_sum(pl);
    }
    __syncthreads();
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long r = r0 + warp * RPW + i;
      if (r >= d.N) continue;
      const Row w = split_row(r, d);
      const float lse = m[i] + logf(s[i]);
      blank_out[r] = bv[i] - lse;
      lse_out[r] = lse;
      if (w.u < d.U) label_out[(size_t)w.bt * d.U + w.u] = lv[i] - lse;
    }
  }
}

// K8's dh in bf16 on the tensor cores (J and V multiples of 16; KTW 16-col
// tiles of dh per warp, J <= 128 KTW): per 128-column chunk the logits
// through wmma, dlogits to shared memory in bf16, dh += dlogits . W with the
// dh tiles in registers across the chunks; then joint_lse_bwd_dh_kernel's
// epilogue
template <int KTW>
__global__ void __launch_bounds__(kThreads, 2)
joint_lse_bwd_dh_wmma_kernel(const __nv_bfloat16* __restrict__ f,
                             const __nv_bfloat16* __restrict__ g,
                             const __nv_bfloat16* __restrict__ wt,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ bias,
                             const int* __restrict__ labels,
                             const float* __restrict__ lse,
                             const float* __restrict__ d_blank,
                             const float* __restrict__ d_label,
                             float* __restrict__ df, float* __restrict__ dg,
                             Dims d) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  constexpr int R = 32;
  constexpr int RPW = R / kWarps;
  extern __shared__ __align__(128) unsigned char sraw[];
  const int ldh = d.J + kPadB;
  bf16* hs = reinterpret_cast<bf16*>(sraw);                   // R x J
  bf16* dls = hs + R * ldh;                                   // R x kCols
  float* stage = reinterpret_cast<float*>(dls + R * kColsLd);  // R x kCols
  float* m_z = stage + R * kStageLd;                          // R
  float* m_db = m_z + R;
  float* m_dl = m_db + R;
  int* m_lbl = reinterpret_cast<int*>(m_dl + R);
  float* dhs = reinterpret_cast<float*>(sraw);   // R x J, after the chunks
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int KT = d.J / 16;
  const long long r0 = (long long)blockIdx.x * R;
  fill_h_bf16(hs, f, g, r0, R, d.N, d.J, ldh, d);
  if (threadIdx.x < R) {
    const long long r = r0 + threadIdx.x;
    float z = 0.0f, db = 0.0f, dl = 0.0f;
    int lb = d.blank;
    if (r < d.N) {
      const Row rw = split_row(r, d);
      lb = row_label(labels, rw, d);
      z = lse[r];
      db = d_blank[r];
      if (rw.u < d.U) dl = d_label[(size_t)rw.bt * d.U + rw.u];
    }
    m_z[threadIdx.x] = z;
    m_db[threadIdx.x] = db;
    m_dl[threadIdx.x] = dl;
    m_lbl[threadIdx.x] = lb;
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[KTW][2];
#pragma unroll
  for (int i = 0; i < KTW; ++i) {
    wmma::fill_fragment(acc[i][0], 0.0f);
    wmma::fill_fragment(acc[i][1], 0.0f);
  }
  __syncthreads();
  for (int c0 = 0; c0 < d.V; c0 += kCols) {
    wmma_logits_chunk(hs, ldh, wt, c0, stage, d);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rr = warp * RPW + i;
      const float db = m_db[rr], dl = m_dl[rr];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + lane + 32 * j;
        float v = 0.0f;
        if (c < d.V && (db != 0.0f || dl != 0.0f)) {
          const float p =
              expf(stage[rr * kStageLd + lane + 32 * j] + bias[c] - m_z[rr]);
          v = (c == d.blank ? db : 0.0f) + (c == m_lbl[rr] ? dl : 0.0f) -
              (db + dl) * p;
        }
        dls[rr * kColsLd + lane + 32 * j] = __float2bfloat16(v);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int kc = 0; kc < kCols / 16; ++kc) {
      const int cb = c0 + kc * 16;
      if (cb >= d.V) break;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, dls + kc * 16, kColsLd);
      wmma::load_matrix_sync(a1, dls + 16 * kColsLd + kc * 16, kColsLd);
#pragma unroll
      for (int i = 0; i < KTW; ++i) {
        const int kt = warp + kWarps * i;
        if (kt < KT) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, w + (size_t)cb * d.J + kt * 16, d.J);
          wmma::mma_sync(acc[i][0], a0, b, acc[i][0]);
          wmma::mma_sync(acc[i][1], a1, b, acc[i][1]);
        }
      }
    }
    __syncthreads();  // stage and dls are rewritten by the next chunk
  }
#pragma unroll
  for (int i = 0; i < KTW; ++i) {
    const int kt = warp + kWarps * i;
    if (kt < KT) {
      wmma::store_matrix_sync(dhs + kt * 16, acc[i][0], d.J,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dhs + 16 * d.J + kt * 16, acc[i][1], d.J,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  dh_epilogue(dhs, f, g, r0, R, d, df, dg);
}

size_t fwd_wmma_smem(int J) {
  return (size_t)32 * (J + kPadB) * 2 + (size_t)32 * kStageLd * sizeof(float);
}

size_t dh_wmma_smem(int J) {
  const size_t a = (size_t)32 * (J + kPadB) * 2 + 32 * kColsLd * 2 +
                   (32 * kStageLd + 4 * 32) * sizeof(float);
  const size_t b = (size_t)32 * J * sizeof(float);
  return a > b ? a : b;
}

size_t dw_wmma_smem(int Jp) {
  return (size_t)kStripRows * (Jp + kPadB) * 2 + (size_t)Jp * kStripLd * 2 +
         kStripRows * kStripLd * 2 +
         (2 * kStripRows * kStageLdW + kWarps * 32 + 4 * kStripRows) *
             sizeof(float);
}

size_t fwd_smem(int rpw, int J) {
  return (size_t)kWarps * rpw * J * sizeof(float);
}

size_t dh_smem(int rpw, int J) {
  return (size_t)kWarps * rpw * (2 * J + kCols) * sizeof(float);
}

size_t dw_smem(int J) {
  return ((size_t)kStripRows * J + (size_t)J * kStrip +
          kStripRows * kStrip + kWarps * 32 + 4 * kStripRows) *
         sizeof(float);
}

constexpr size_t kMaxSmem = 227 * 1024;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Dims make_dims(int B, int T, int U1, int J, int V, int blank) {
  Dims d;
  d.B = B;
  d.T = T;
  d.U1 = U1;
  d.U = U1 - 1;
  d.J = J;
  d.V = V;
  d.blank = blank;
  d.N = (long long)B * T * U1;
  return d;
}

template <typename Elem, int RPW>
cudaError_t launch_fwd(const void* f, const void* g, const void* wt,
                       const void* bias, const void* labels, void* blank_out,
                       void* label_out, void* lse_out, const Dims& d,
                       cudaStream_t s) {
  const size_t smem = fwd_smem(RPW, d.J);
  cudaError_t e = allow_smem(joint_lse_fwd_kernel<Elem, RPW>, smem);
  if (e != cudaSuccess) return e;
  const long long rows = kWarps * RPW;
  const unsigned grid = (unsigned)((d.N + rows - 1) / rows);
  joint_lse_fwd_kernel<Elem, RPW><<<grid, kThreads, smem, s>>>(
      static_cast<const Elem*>(f), static_cast<const Elem*>(g),
      static_cast<const Elem*>(wt), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<float*>(blank_out),
      static_cast<float*>(label_out), static_cast<float*>(lse_out), d);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t run_fwd(const void* f, const void* g, const void* wt,
                    const void* bias, const void* labels, void* blank_out,
                    void* label_out, void* lse_out, const Dims& d,
                    cudaStream_t s) {
  if (fwd_smem(4, d.J) <= kMaxSmem)
    return launch_fwd<Elem, 4>(f, g, wt, bias, labels, blank_out, label_out,
                               lse_out, d, s);
  return launch_fwd<Elem, 1>(f, g, wt, bias, labels, blank_out, label_out,
                             lse_out, d, s);
}

template <typename Elem, int RPW>
cudaError_t launch_dh(const void* f, const void* g, const void* wt,
                      const void* w, const void* bias, const void* labels,
                      const void* lse, const void* d_blank,
                      const void* d_label, void* df, void* dg, const Dims& d,
                      cudaStream_t s) {
  const size_t smem = dh_smem(RPW, d.J);
  cudaError_t e = allow_smem(joint_lse_bwd_dh_kernel<Elem, RPW>, smem);
  if (e != cudaSuccess) return e;
  const long long rows = kWarps * RPW;
  const unsigned grid = (unsigned)((d.N + rows - 1) / rows);
  joint_lse_bwd_dh_kernel<Elem, RPW><<<grid, kThreads, smem, s>>>(
      static_cast<const Elem*>(f), static_cast<const Elem*>(g),
      static_cast<const Elem*>(wt), static_cast<const Elem*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(d_blank),
      static_cast<const float*>(d_label), static_cast<float*>(df),
      static_cast<float*>(dg), d);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t run_dh(const void* f, const void* g, const void* wt,
                   const void* w, const void* bias, const void* labels,
                   const void* lse, const void* d_blank, const void* d_label,
                   void* df, void* dg, const Dims& d, cudaStream_t s) {
  return dh_smem(4, d.J) <= kMaxSmem
             ? launch_dh<Elem, 4>(f, g, wt, w, bias, labels, lse, d_blank,
                                  d_label, df, dg, d, s)
             : launch_dh<Elem, 1>(f, g, wt, w, bias, labels, lse, d_blank,
                                  d_label, df, dg, d, s);
}

bool wmma_shapes(const Dims& d) {
  return d.J % 16 == 0 && d.V % 16 == 0 && d.J <= 1024;
}

template <int KTW>
cudaError_t launch_dh_wmma(const void* f, const void* g, const void* wt,
                           const void* w, const void* bias,
                           const void* labels, const void* lse,
                           const void* d_blank, const void* d_label,
                           void* df, void* dg, const Dims& d,
                           cudaStream_t s) {
  typedef __nv_bfloat16 bf16;
  const size_t smem = dh_wmma_smem(d.J);
  const cudaError_t e = allow_smem(joint_lse_bwd_dh_wmma_kernel<KTW>, smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((d.N + 31) / 32);
  joint_lse_bwd_dh_wmma_kernel<KTW><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(g),
      static_cast<const bf16*>(wt), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(d_blank),
      static_cast<const float*>(d_label), static_cast<float*>(df),
      static_cast<float*>(dg), d);
  return cudaGetLastError();
}

// bf16: the tensor-core kernel where the shapes allow it
template <>
cudaError_t run_dh<__nv_bfloat16>(const void* f, const void* g,
                                  const void* wt, const void* w,
                                  const void* bias, const void* labels,
                                  const void* lse, const void* d_blank,
                                  const void* d_label, void* df, void* dg,
                                  const Dims& d, cudaStream_t s) {
  typedef __nv_bfloat16 bf16;
  if (wmma_shapes(d))
    return d.J <= 640 ? launch_dh_wmma<5>(f, g, wt, w, bias, labels, lse,
                                          d_blank, d_label, df, dg, d, s)
                      : launch_dh_wmma<8>(f, g, wt, w, bias, labels, lse,
                                          d_blank, d_label, df, dg, d, s);
  return dh_smem(4, d.J) <= kMaxSmem
             ? launch_dh<bf16, 4>(f, g, wt, w, bias, labels, lse, d_blank,
                                  d_label, df, dg, d, s)
             : launch_dh<bf16, 1>(f, g, wt, w, bias, labels, lse, d_blank,
                                  d_label, df, dg, d, s);
}

template <>
cudaError_t run_fwd<__nv_bfloat16>(const void* f, const void* g,
                                   const void* wt, const void* bias,
                                   const void* labels, void* blank_out,
                                   void* label_out, void* lse_out,
                                   const Dims& d, cudaStream_t s) {
  typedef __nv_bfloat16 bf16;
  if (!wmma_shapes(d))
    return fwd_smem(4, d.J) <= kMaxSmem
               ? launch_fwd<bf16, 4>(f, g, wt, bias, labels, blank_out,
                                     label_out, lse_out, d, s)
               : launch_fwd<bf16, 1>(f, g, wt, bias, labels, blank_out,
                                     label_out, lse_out, d, s);
  const size_t smem = fwd_wmma_smem(d.J);
  const cudaError_t e = allow_smem(joint_lse_fwd_wmma_kernel, smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((d.N + 31) / 32);
  joint_lse_fwd_wmma_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(g),
      static_cast<const bf16*>(wt), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<float*>(blank_out),
      static_cast<float*>(label_out), static_cast<float*>(lse_out), d);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t launch_dw(const void* f, const void* g, const void* wt,
                      const void* bias, const void* labels, const void* lse,
                      const void* d_blank, const void* d_label, void* dw,
                      void* dbias, const Dims& d, int n_split,
                      cudaStream_t s) {
  const size_t smem = dw_smem(d.J);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(joint_lse_bwd_dw_kernel<Elem>, smem);
  if (e != cudaSuccess) return e;
  const long long per = (d.N + n_split - 1) / n_split;
  const dim3 grid((d.V + kStrip - 1) / kStrip, n_split);
  joint_lse_bwd_dw_kernel<Elem><<<grid, kThreads, smem, s>>>(
      static_cast<const Elem*>(f), static_cast<const Elem*>(g),
      static_cast<const Elem*>(wt), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(d_blank), static_cast<const float*>(d_label),
      static_cast<float*>(dw), static_cast<float*>(dbias), d, per);
  return cudaGetLastError();
}

template <int KTW>
cudaError_t launch_dw_wmma(const void* f, const void* g, const void* wt,
                           const void* bias, const void* labels,
                           const void* lse, const void* d_blank,
                           const void* d_label, void* dw, void* dbias,
                           const Dims& d, int n_split, cudaStream_t s) {
  const int Jp = (d.J + 15) / 16 * 16;
  const size_t smem = dw_wmma_smem(Jp);
  const cudaError_t e = allow_smem(joint_lse_bwd_dw_wmma_kernel<KTW>, smem);
  if (e != cudaSuccess) return e;
  const long long per = (d.N + n_split - 1) / n_split;
  const dim3 grid((d.V + kStrip - 1) / kStrip, n_split);
  typedef __nv_bfloat16 bf16;
  joint_lse_bwd_dw_wmma_kernel<KTW><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(g),
      static_cast<const bf16*>(wt), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(d_blank), static_cast<const float*>(d_label),
      static_cast<float*>(dw), static_cast<float*>(dbias), d, per, Jp);
  return cudaGetLastError();
}

// bf16: the tensor-core kernel where its accumulator fits (J <= 1024)
template <>
cudaError_t launch_dw<__nv_bfloat16>(const void* f, const void* g,
                                     const void* wt, const void* bias,
                                     const void* labels, const void* lse,
                                     const void* d_blank, const void* d_label,
                                     void* dw, void* dbias, const Dims& d,
                                     int n_split, cudaStream_t s) {
  if (d.J <= 640)
    return launch_dw_wmma<5>(f, g, wt, bias, labels, lse, d_blank, d_label,
                             dw, dbias, d, n_split, s);
  if (d.J <= 1024)
    return launch_dw_wmma<8>(f, g, wt, bias, labels, lse, d_blank, d_label,
                             dw, dbias, d, n_split, s);
  const size_t smem = dw_smem(d.J);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e =
      allow_smem(joint_lse_bwd_dw_kernel<__nv_bfloat16>, smem);
  if (e != cudaSuccess) return e;
  const long long per = (d.N + n_split - 1) / n_split;
  const dim3 grid((d.V + kStrip - 1) / kStrip, n_split);
  typedef __nv_bfloat16 bf16;
  joint_lse_bwd_dw_kernel<bf16><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(g),
      static_cast<const bf16*>(wt), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(d_blank), static_cast<const float*>(d_label),
      static_cast<float*>(dw), static_cast<float*>(dbias), d, per);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t run_bwd(const void* f, const void* g, const void* wt,
                    const void* w, const void* bias, const void* labels,
                    const void* lse, const void* d_blank,
                    const void* d_label, void* df, void* dg, void* dw,
                    void* dbias, const Dims& d, int n_split,
                    cudaStream_t s) {
  cudaError_t e = run_dh<Elem>(f, g, wt, w, bias, labels, lse, d_blank,
                               d_label, df, dg, d, s);
  if (e != cudaSuccess) return e;
  return launch_dw<Elem>(f, g, wt, bias, labels, lse, d_blank, d_label, dw,
                         dbias, d, n_split, s);
}

}  // namespace

// f (B, T, J), g (B, U1, J), wt = W^T (J, V) in fp32 (bf16 == 0) or bf16;
// bias (V) fp32; labels (B, U1 - 1) int32 → blank_lp (B, T, U1), label_lp
// (B, T, U1 - 1), lse (B, T, U1) fp32.
extern "C" int edd_joint_lse_fwd(const void* f, const void* g, const void* wt,
                                 const void* bias, const void* labels,
                                 void* blank_out, void* label_out,
                                 void* lse_out, int B, int T, int U1, int J,
                                 int V, int blank, int bf16, void* stream) {
  const Dims d = make_dims(B, T, U1, J, V, blank);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? run_fwd<__nv_bfloat16>(f, g, wt, bias, labels, blank_out,
                                    label_out, lse_out, d, s)
           : run_fwd<float>(f, g, wt, bias, labels, blank_out, label_out,
                            lse_out, d, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// + w = W (V, J) in the same dtype, lse from the forward, d_blank (B, T, U1)
// and d_label (B, T, U1 - 1) fp32 cotangents → accumulates into df (B, T, J),
// dg (B, U1, J), dw = dW^T (J, V), dbias (V), all fp32 and zeroed by the
// caller. n_split: row shares of the dW kernel (its grid's second axis).
extern "C" int edd_joint_lse_bwd(const void* f, const void* g, const void* wt,
                                 const void* w, const void* bias,
                                 const void* labels, const void* lse,
                                 const void* d_blank, const void* d_label,
                                 void* df, void* dg, void* dw, void* dbias,
                                 int B, int T, int U1, int J, int V,
                                 int blank, int bf16, int n_split,
                                 void* stream) {
  const Dims d = make_dims(B, T, U1, J, V, blank);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? run_bwd<__nv_bfloat16>(f, g, wt, w, bias, labels, lse, d_blank,
                                    d_label, df, dg, dw, dbias, d, n_split,
                                    s)
           : run_bwd<float>(f, g, wt, w, bias, labels, lse, d_blank, d_label,
                            df, dg, dw, dbias, d, n_split, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
