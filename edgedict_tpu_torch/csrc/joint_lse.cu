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
// memory whole: the forward and the CUDA-core backward recompute them tile
// by tile, the tensor-core backward holds one slab's dlogits at a time.
//
// What bounds it on the H100: arithmetic. At E6D2 training (B=32, T=214,
// U+1=65, J=640, V=2048) the forward is 445k rows x J x V = 5.8e11 FMAs and
// the backward three times that (logits, dh, dW); bytes are small (f, g, W
// stay in L2). In bf16, the training dtype, every product runs on the
// tensor cores (the wrapper pads J and V to multiples of 16); fp32 runs the
// CUDA-core kernels.
//
// Design. The lattice is cut into tiles of 64 cells (r_t frames x r_u label
// slots; ops/joint_lse_plan.py picks the shape), and all three tensor-core
// products share one block product, gemm_block: 128 x 128 outputs (two
// tiles), a 3-stage cp.async ring of 64-deep stages, ldmatrix (.trans for
// transposed operands) into mma.sync m16n8k16 with fp32 accumulators.
//  * forward (K7), bf16: a block takes two whole tiles (128 rows). Where
//    their h fits in shared memory beside the ring (J up to 640: 128 x 648
//    bf16 = 166 KB + 54 KB of W^T stages), the block loads the tiles' r_t
//    f-rows and r_u g-rows once, takes tanh once per cell into shared
//    memory, then streams only W^T, 128 columns at a time, through the ring
//    (gemm_block with A resident) — one pass over W per 128 rows, no
//    scratch. Wider J stages h through a bounded slab scratch with the h
//    launch the backward uses, and the same kernel reads A from it. After
//    each 128-column chunk a thread folds its 8 rows x 8 columns of fp32
//    accumulators (+ bias; -inf past V) into per-row running (max, sum of
//    exp) and the blank and label logits where they fall (the online
//    logsumexp of _fwd_kernel_split); at the end the 4 lanes and the 4
//    column warps that share a row combine in a fixed order through a small
//    shared-memory reduction, and each row's three outputs are written
//    once: no atomics, no partials, the same bits from run to run.
//  * forward, fp32: a block takes 32 rows, holds their h in shared memory
//    and walks V in 128-column chunks on CUDA cores (a warp's rows x a
//    lane's 4 columns), with the same online logsumexp.
//  * backward (K8), bf16: the TPU kernel takes r_t x r_u lattice cells a
//    grid step, computes h once and runs the three products on it. Here
//    consecutive tiles form slabs whose h and dlogits fit a scratch of
//    fixed size; per slab, four launches: h (one block per tile: its r_t
//    f-rows and r_u g-rows loaded once, kHCols columns at a time, tanh once
//    per cell, bf16 into the scratch), dlogits (h . W^T + bias, the softmax
//    gradient, bf16 into the scratch, fp32 column sums into per-row-block
//    dbias partials), dh (dlogits . W, then da = dh (1 - h^2) with fp32 h
//    summed inside each tile: one df atomic per (tile, t, k) and one dg
//    atomic per (tile, u, k)), dW (h^T . dlogits over row shares, each into
//    its own fp32 partial, no atomics). One last launch sums the partials
//    in a fixed order: dW^T and dbias are the same bits from run to run, df
//    and dg (fp32 atomics) are not.
//  * backward, fp32: the forward's row tiling recomputes each logits chunk,
//    forms dlogits and accumulates dh = dlogits . W; the epilogue forms da
//    and adds it to df (summed over the block's rows of one (b, t) first)
//    and dg with fp32 atomics. A second kernel owns a 32-column strip of
//    dW^T per block over a share of the rows, recomputing h and the strip's
//    logits, and adds the strip to dW^T and dbias with fp32 atomics at its
//    end.
// Shared-memory rows read by ldmatrix are padded by 16 bytes against bank
// conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;       // logits columns per chunk (4 per lane)
constexpr int kStrip = 32;       // dW^T columns per block
constexpr int kStripRows = 32;   // rows per step of the dW kernel

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

__device__ __forceinline__ float h_fp32(const float* f, const float* g,
                                        const Row& w, int k, const Dims& d) {
  return tanhf(f[(size_t)w.bt * d.J + k] +
               g[((size_t)w.b * d.U1 + w.u) * d.J + k]);
}

// hs[rr * J + k] = h of rows r0 .. r0 + R - 1 (rows >= end read as 0)
__device__ void fill_h(float* hs, const float* f, const float* g, long long r0,
                       int R, long long end, const Dims& d) {
  for (int i = threadIdx.x; i < R * d.J; i += blockDim.x) {
    const int rr = i / d.J;
    const int k = i - rr * d.J;
    const long long r = r0 + rr;
    hs[i] = r < end ? h_fp32(f, g, split_row(r, d), k, d) : 0.0f;
  }
}

// logits of RPW rows (hs rows row0 ..) at columns c0 + lane + 32 j
template <int RPW>
__device__ __forceinline__ void warp_logits(const float* hs, int row0,
                                            const float* wt,
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
      wv[j] = c < d.V ? wt[(size_t)k * d.V + c] : 0.0f;
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

template <int RPW>
__global__ void __launch_bounds__(kThreads)
joint_lse_fwd_kernel(const float* __restrict__ f, const float* __restrict__ g,
                     const float* __restrict__ wt,
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
    warp_logits<RPW>(hs, row0, wt, bias, c0, d, acc);
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
__device__ void dh_epilogue(const float* dhs, const float* f, const float* g,
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

// ---------------------------------------------------------------------------
// K8 backward: dh → df, dg
// ---------------------------------------------------------------------------

template <int RPW>
__global__ void __launch_bounds__(kThreads)
joint_lse_bwd_dh_kernel(const float* __restrict__ f,
                        const float* __restrict__ g,
                        const float* __restrict__ wt,
                        const float* __restrict__ w,
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
    warp_logits<RPW>(hs, row0, wt, bias, c0, d, acc);
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
        dls[(row0 + i) * kCols + lane + 32 * j] = v;
      }
    }
    __syncwarp();
    const int ncol = min(kCols, d.V - c0);
    for (int k = lane; k < d.J; k += 32) {
      float a[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = 0.0f;
      for (int cc = 0; cc < ncol; ++cc) {
        const float wv = w[(size_t)(c0 + cc) * d.J + k];
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

__global__ void __launch_bounds__(kThreads)
joint_lse_bwd_dw_kernel(const float* __restrict__ f,
                        const float* __restrict__ g,
                        const float* __restrict__ wt,
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
      const float wv = col < d.V ? wt[(size_t)k * d.V + col] : 0.0f;
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
      dls[rr * kStrip + lane] = v;
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

// ---------------------------------------------------------------------------
// K8 in bf16 on the tensor cores (J and V multiples of 16): the lattice in
// 2D tiles, slab by slab (launch plan: ops/joint_lse_plan.py)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kTileCells = 64;     // r_t x r_u cells per lattice tile
constexpr int kHCols = 1024;       // columns of f, g staged at a time (h)
constexpr int kGm = 128;           // rows of a product's block (two tiles)
constexpr int kGn = 128;           // columns of a product's block
constexpr int kGk = 64;            // depth of one cp.async stage
constexpr int kGStages = 3;
constexpr int kGThreads = 256;     // 8 warps of 64 x 32 outputs
constexpr int kLdMk = kGk + 8;     // [row][k] stage rows: 144 bytes
constexpr int kLdKm = kGn + 8;     // [k][row] stage rows: 272 bytes
constexpr int kStageElems = kGm * kLdMk;   // >= kGk * kLdKm
constexpr int kLdE = kGn + 4;      // fp32 da rows of the dh epilogue
constexpr int kLdD = kGn + 8;      // bf16 dlogits rows of the dl epilogue

struct Lattice {
  int B, T, U1, U, J, V, blank;
  int r_t, r_u, n_tt, n_tu;
  long long tiles;
};

struct Cell {
  int b, t, u;
  bool ok;
};

// row `lr` of lattice tile `tile` (the plan's tile_cells)
__device__ __forceinline__ Cell tile_cell(const Lattice& L, long long tile,
                                          int lr) {
  Cell c;
  const int tu = (int)(tile % L.n_tu);
  const long long rest = tile / L.n_tu;
  const int tt = (int)(rest % L.n_tt);
  c.b = (int)(rest / L.n_tt);
  c.t = tt * L.r_t + lr / L.r_u;
  c.u = tu * L.r_u + lr % L.r_u;
  c.ok = tile < L.tiles && c.t < L.T && c.u < L.U1;
  return c;
}

// ROWS x COLS bf16 tile of a row-major matrix (leading dim src_ld), rows r0
// .., columns c0 .., into shared memory rows `ld` apart, by 16-byte cp.async
// copies; zero at rows >= row_end or columns >= col_end (both multiples of
// 8, as are c0 and src_ld).
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(bf16* dst, int ld, const bf16* src,
                                           size_t src_ld, long long r0,
                                           long long row_end, int c0,
                                           int col_end) {
  constexpr int kChunks = ROWS * (COLS / 8);
  for (int i = threadIdx.x; i < kChunks; i += kGThreads) {
    const int r = i / (COLS / 8), c = (i % (COLS / 8)) * 8;
    bf16* d = dst + r * ld + c;
    if (r0 + r < row_end && c0 + c < col_end)
      cp_async16(d, src + (size_t)(r0 + r) * src_ld + c0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// One block's 128 x 128 product, acc += A . B over k in [k0, k_end), on
// mma.sync m16n8k16 through ldmatrix from a 3-stage cp.async ring in `sm`.
// A is (M, K): stored [m][k] (A_KM false, element (m, k) at a[m * lda + k])
// or [k][m] (A_KM true, at a[k * lda + m]); B is (K, N): stored [n][k]
// (B_KN false) or [k][n] (B_KN true). With A_RES, A is the block's own 128
// rows already in shared memory ([m][k], rows lda apart, m0 and m_end
// unused, zero up to k0 + a whole number of stages) and the ring holds B
// alone. Warp (wm, wn) owns rows wm * 64 .. + 64 and columns wn * 32 ..
// + 32: acc[i][j] is the m16n8 tile at rows wm * 64 + 16 i, columns wn * 32
// + 8 j, element 2 h + e at row + gid + 8 h, column + 2 tig + e.
template <bool A_KM, bool B_KN, bool A_RES = false>
__device__ __forceinline__ void gemm_block(
    float (&acc)[4][4][4], const bf16* a, int lda, long long m0,
    long long m_end, const bf16* b, int ldb, int n0, int n_end,
    long long k0, long long k_end, bf16* sm) {
  static_assert(!(A_RES && A_KM), "a resident A is stored [m][k]");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  bf16* as = sm;
  bf16* bs = A_RES ? sm : sm + kGStages * kStageElems;
  auto stage = [&](int buf, long long k) {
    bf16* ad = as + buf * kStageElems;
    bf16* bd = bs + buf * kStageElems;
    if constexpr (A_KM)
      stage_tile<kGk, kGm>(ad, kLdKm, a, lda, k, k_end, (int)m0, (int)m_end);
    else if constexpr (!A_RES)
      stage_tile<kGm, kGk>(ad, kLdMk, a, lda, m0, m_end, (int)k, (int)k_end);
    if (B_KN)
      stage_tile<kGk, kGn>(bd, kLdKm, b, ldb, k, k_end, n0, n_end);
    else
      stage_tile<kGn, kGk>(bd, kLdMk, b, ldb, n0, n_end, (int)k, (int)k_end);
  };
  const int nk = (int)((k_end - k0 + kGk - 1) / kGk);
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < nk) stage(s, k0 + (long long)s * kGk);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is consumed
    const int pf = kt + kGStages - 1;
    if (pf < nk) stage(pf % kGStages, k0 + (long long)pf * kGk);
    cp_async_commit();
    const bf16* ab = as + (kt % kGStages) * kStageElems;
    const bf16* bb = bs + (kt % kGStages) * kStageElems;
#pragma unroll
    for (int kk = 0; kk < kGk; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mo = wm * 64 + i * 16;
        if constexpr (A_RES)
          ldmatrix_x4(af[i], a + (mo + (lane & 15)) * lda + k0 +
                                 (long long)kt * kGk + kk + (lane >> 4) * 8);
        else if constexpr (A_KM)
          ldmatrix_x4_trans(af[i], ab + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                            kLdKm +
                                        mo + ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4(af[i], ab + (mo + (lane & 15)) * kLdMk + kk +
                                 (lane >> 4) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < 4; jj += 2) {
        const int no = wn * 32 + jj * 8;
        uint32_t r[4];
        if (B_KN)
          ldmatrix_x4_trans(r, bb + (kk + (lane & 7) +
                                     (((lane >> 3) & 1) << 3)) * kLdKm +
                                   no + ((lane >> 4) << 3));
        else
          ldmatrix_x4(r, bb + (no + (lane & 7) + ((lane >> 4) << 3)) * kLdMk +
                             kk + ((lane >> 3) & 1) * 8);
        bfr[jj][0] = r[0];
        bfr[jj][1] = r[1];
        bfr[jj + 1][0] = r[2];
        bfr[jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                   bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring may be reused by the epilogue
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
}

// h of the slab's tiles (one block each) in bf16, rows of invalid cells
// zero: the tile's r_t f-rows and r_u g-rows are loaded once into shared
// memory, kHCols columns at a time, and tanh(f + g) is taken once per cell
// in fp32. Tile tile0 + blockIdx.x is written to rows blockIdx.x * 64 ..
// of hs.
__device__ __forceinline__ void tile_h(const bf16* __restrict__ f,
                                       const bf16* __restrict__ g,
                                       bf16* __restrict__ hs,
                                       const Lattice& L, long long tile0,
                                       bf16* fs) {
  const long long tile = tile0 + blockIdx.x;
  const Cell c0 = tile_cell(L, tile, 0);
  for (int k0 = 0; k0 < L.J; k0 += kHCols) {
    const int kc = min(kHCols, L.J - k0);
    bf16* gs = fs + L.r_t * kc;
    if (k0 > 0) __syncthreads();   // the previous chunk is consumed
    for (int i = threadIdx.x; i < (L.r_t + L.r_u) * kc; i += kThreads) {
      const int r = i / kc, k = k0 + i - r * kc;
      bf16 v = __float2bfloat16(0.0f);
      if (c0.b < L.B) {
        if (r < L.r_t) {
          const int t = c0.t + r;
          if (t < L.T) v = f[((size_t)c0.b * L.T + t) * L.J + k];
        } else {
          const int u = c0.u + r - L.r_t;
          if (u < L.U1) v = g[((size_t)c0.b * L.U1 + u) * L.J + k];
        }
      }
      fs[i] = v;
    }
    __syncthreads();
    const int groups = kc / 8;
    for (int i = threadIdx.x; i < kTileCells * groups; i += kThreads) {
      const int lr = i / groups, k = (i - lr * groups) * 8;
      const Cell c = tile_cell(L, tile, lr);
      __align__(16) bf16 out[8];
      const bf16* fr = fs + (lr / L.r_u) * kc + k;
      const bf16* gr = gs + (lr % L.r_u) * kc + k;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = __float2bfloat16(
            c.ok ? tanhf(__bfloat162float(fr[e]) + __bfloat162float(gr[e]))
                 : 0.0f);
      *reinterpret_cast<uint4*>(
          hs + ((size_t)blockIdx.x * kTileCells + lr) * L.J + k0 + k) =
          *reinterpret_cast<const uint4*>(out);
    }
  }
}

// 1. K8's h launch (tile_h)
__global__ void __launch_bounds__(kThreads)
joint_lse_bwd_h_kernel(const bf16* __restrict__ f, const bf16* __restrict__ g,
                       bf16* __restrict__ hs, Lattice L, long long tile0) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  tile_h(f, g, hs, L, tile0, reinterpret_cast<bf16*>(k8_smem));
}

// 2. dlogits (rows, V) = softmax gradient of h . W^T + bias, in bf16, rows
// of invalid cells zero; the column sums of the fp32 dlogits over the
// block's rows are added to dbias_part[blockIdx.y].
__global__ void __launch_bounds__(kGThreads)
joint_lse_bwd_dl_kernel(const bf16* __restrict__ hs,
                        const bf16* __restrict__ w,
                        const float* __restrict__ bias,
                        const int* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ d_blank,
                        const float* __restrict__ d_label,
                        bf16* __restrict__ dls, float* __restrict__ dbias_part,
                        Lattice L, long long tile0, long long rows) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  bf16* sm = reinterpret_cast<bf16*>(k8_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.y * kGm;
  const int n0 = blockIdx.x * kGn;
  float acc[4][4][4];
  zero_acc(acc);
  gemm_block<false, false>(acc, hs, L.J, m0, rows, w, L.J, n0, L.V, 0, L.J,
                           sm);
  // the thread's 8 rows: cotangents, label and lse of their cells
  float z[4][2], db[4][2], dl[4][2];
  int lbl[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 64 + i * 16 + gid + 8 * h;
      const Cell c = tile_cell(L, tile0 + m / kTileCells,
                               (int)(m % kTileCells));
      z[i][h] = db[i][h] = dl[i][h] = 0.0f;
      lbl[i][h] = L.blank;
      if (m < rows && c.ok) {
        const size_t cell = ((size_t)c.b * L.T + c.t) * L.U1 + c.u;
        z[i][h] = lse[cell];
        db[i][h] = d_blank[cell];
        if (c.u < L.U) {
          dl[i][h] = d_label[((size_t)c.b * L.T + c.t) * L.U + c.u];
          lbl[i][h] = labels[(size_t)c.b * L.U + c.u];
        }
      }
    }
  bf16* ds = sm;                                  // kGm x kLdD
  float* red = reinterpret_cast<float*>(ds + kGm * kLdD);   // 2 x kGn
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = wn * 32 + j * 8 + tig * 2 + e;
      const int col = n0 + cl;
      const float bc = col < L.V ? bias[col] : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = 0.0f;
          if (col < L.V && (db[i][h] != 0.0f || dl[i][h] != 0.0f)) {
            const float p = expf(acc[i][j][2 * h + e] + bc - z[i][h]);
            v = (col == L.blank ? db[i][h] : 0.0f) +
                (col == lbl[i][h] ? dl[i][h] : 0.0f) -
                (db[i][h] + dl[i][h]) * p;
          }
          sum += v;
          ds[(wm * 64 + i * 16 + gid + 8 * h) * kLdD + cl] =
              __float2bfloat16(v);
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      if (gid == 0) red[wm * kGn + cl] = sum;
    }
  __syncthreads();
  if (threadIdx.x < kGn && n0 + (int)threadIdx.x < L.V) {
    float* p = dbias_part + (size_t)blockIdx.y * L.V + n0 + threadIdx.x;
    *p += red[threadIdx.x] + red[kGn + threadIdx.x];
  }
  for (int i = threadIdx.x; i < kGm * (kGn / 8); i += kGThreads) {
    const int r = i / (kGn / 8), c = (i % (kGn / 8)) * 8;
    if (m0 + r < rows && n0 + c < L.V)
      *reinterpret_cast<uint4*>(dls + (size_t)(m0 + r) * L.V + n0 + c) =
          *reinterpret_cast<const uint4*>(ds + r * kLdD + c);
  }
}

// 3. dh (rows, J) = dlogits . W on 128 rows (two tiles) x 128 columns; da =
// dh (1 - h^2) with fp32 h, then inside each tile df[b, t, k] += the sum
// over its r_u cells and dg[b, u, k] += the sum over its r_t cells: one
// atomic per tile and (b, t, k) or (b, u, k).
__global__ void __launch_bounds__(kGThreads)
joint_lse_bwd_dh_mma_kernel(const bf16* __restrict__ f,
                            const bf16* __restrict__ g,
                            const bf16* __restrict__ wt,
                            const bf16* __restrict__ dls,
                            float* __restrict__ df, float* __restrict__ dg,
                            Lattice L, long long tile0, long long rows) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  bf16* sm = reinterpret_cast<bf16*>(k8_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.y * kGm;
  const int n0 = blockIdx.x * kGn;
  float acc[4][4][4];
  zero_acc(acc);
  gemm_block<false, false>(acc, dls, L.V, m0, rows, wt, L.V, n0, L.J, 0, L.V,
                           sm);
  float* es = reinterpret_cast<float*>(k8_smem);     // kGm x kLdE da
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lm = wm * 64 + i * 16 + gid + 8 * h;
      const Cell c = tile_cell(L, tile0 + (m0 + lm) / kTileCells,
                               (int)((m0 + lm) % kTileCells));
      const bool ok = m0 + lm < rows && c.ok;
      const bf16* fr = f + ((size_t)c.b * L.T + c.t) * L.J;
      const bf16* gr = g + ((size_t)c.b * L.U1 + c.u) * L.J;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = wn * 32 + j * 8 + tig * 2 + e;
          const int k = n0 + cl;
          float da = 0.0f;
          if (ok && k < L.J) {
            const float hv = tanhf(__bfloat162float(fr[k]) +
                                   __bfloat162float(gr[k]));
            da = acc[i][j][2 * h + e] * (1.0f - hv * hv);
          }
          es[lm * kLdE + cl] = da;
        }
    }
  __syncthreads();
  // one (tile, column) pair a thread: 2 tiles x 128 columns
  for (int pair = threadIdx.x; pair < 2 * kGn; pair += kGThreads) {
    const int half = pair / kGn, cl = pair % kGn;
    const int k = n0 + cl;
    const Cell c0 = tile_cell(L, tile0 + (m0 >> 6) + half, 0);
    if (k >= L.J || m0 + half * kTileCells >= rows || c0.b >= L.B) continue;
    const float* et = es + half * kTileCells * kLdE + cl;
    for (int ti = 0; ti < L.r_t && c0.t + ti < L.T; ++ti) {
      float s = 0.0f;
      for (int ui = 0; ui < L.r_u; ++ui) s += et[(ti * L.r_u + ui) * kLdE];
      atomicAdd(&df[((size_t)c0.b * L.T + c0.t + ti) * L.J + k], s);
    }
    for (int ui = 0; ui < L.r_u && c0.u + ui < L.U1; ++ui) {
      float s = 0.0f;
      for (int ti = 0; ti < L.r_t; ++ti) s += et[(ti * L.r_u + ui) * kLdE];
      atomicAdd(&dg[((size_t)c0.b * L.U1 + c0.u + ui) * L.J + k], s);
    }
  }
}

// 4. dW^T partial `blockIdx.z` += h^T . dlogits over its share of the slab's
// rows: a 128 x 128 tile of (J, V) per block, both operands read
// transposed ([k][m] and [k][n] stages), each partial element owned by one
// block of the launch (no atomics).
__global__ void __launch_bounds__(kGThreads)
joint_lse_bwd_dw_mma_kernel(const bf16* __restrict__ hs,
                            const bf16* __restrict__ dls,
                            float* __restrict__ dw_part, Lattice L,
                            long long rows, long long share) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  bf16* sm = reinterpret_cast<bf16*>(k8_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kGm, n0 = blockIdx.x * kGn;
  const long long k0 = (long long)blockIdx.z * share;
  const long long k_end = k0 + share < rows ? k0 + share : rows;
  if (k0 >= k_end) return;
  float acc[4][4][4];
  zero_acc(acc);
  gemm_block<true, true>(acc, hs, L.J, m0, L.J, dls, L.V, n0, L.V, k0, k_end,
                         sm);
  float* part = dw_part + (size_t)blockIdx.z * L.J * L.V;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + gid + 8 * h;
      if (m >= L.J) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + tig * 2;
        if (n >= L.V) continue;   // V is even: n + 1 < V too
        float2* p = reinterpret_cast<float2*>(part + (size_t)m * L.V + n);
        float2 v = *p;
        v.x += acc[i][j][2 * h];
        v.y += acc[i][j][2 * h + 1];
        *p = v;
      }
    }
}

// 5. after the last slab: dw = the sum of the dW^T partials, dbias the sum
// of the dbias partials, each in a fixed order
__global__ void __launch_bounds__(kThreads)
joint_lse_bwd_reduce_kernel(const float* __restrict__ dw_part,
                            const float* __restrict__ dbias_part,
                            float* __restrict__ dw, float* __restrict__ dbias,
                            int JV, int V, int n_split, int n_rb) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < JV) {
    float s = 0.0f;
    for (int p = 0; p < n_split; ++p) s += dw_part[(size_t)p * JV + i];
    dw[i] = s;
  } else if (i < (long long)JV + V) {
    const int v = (int)(i - JV);
    float s = 0.0f;
    for (int p = 0; p < n_rb; ++p) s += dbias_part[(size_t)p * V + v];
    dbias[v] = s;
  }
}

// ---------------------------------------------------------------------------
// K7 in bf16 on the tensor cores (J and V multiples of 16): two lattice
// tiles (128 rows) a block, one pass over W^T (launch plan:
// ops/joint_lse_plan.py fwd_plan)
// ---------------------------------------------------------------------------

constexpr int kRingElems = kGStages * kStageElems;   // one operand's ring

// h of the block's two tiles (first tile t0) into hs (128 rows, ldh apart,
// columns J .. ldh - 8 zero), rows of invalid cells zero: each tile's r_t
// f-rows and r_u g-rows are staged once in `buf` (bf16, `buf_elems`), as
// many columns at a time as fit, and tanh(f + g) is taken once per cell in
// fp32.
__device__ void fill_h_resident(bf16* hs, int ldh, bf16* buf, int buf_elems,
                                const bf16* __restrict__ f,
                                const bf16* __restrict__ g, const Lattice& L,
                                long long t0) {
  const int rows = L.r_t + L.r_u;            // staged rows per tile
  const int kc = min(L.J, buf_elems / (2 * rows) / 8 * 8);
  for (int k0 = 0; k0 < L.J; k0 += kc) {
    const int w = min(kc, L.J - k0), groups = w / 8;
    if (k0 > 0) __syncthreads();             // the previous chunk is consumed
    for (int i = threadIdx.x; i < 2 * rows * groups; i += kGThreads) {
      const int r = i / groups, c = (i - r * groups) * 8;
      const int q = r / rows, rr = r - q * rows;
      const Cell c0 = tile_cell(L, t0 + q, 0);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (c0.b < L.B) {
        if (rr < L.r_t) {
          if (c0.t + rr < L.T)
            v = *reinterpret_cast<const uint4*>(
                f + ((size_t)c0.b * L.T + c0.t + rr) * L.J + k0 + c);
        } else if (c0.u + rr - L.r_t < L.U1) {
          v = *reinterpret_cast<const uint4*>(
              g + ((size_t)c0.b * L.U1 + c0.u + rr - L.r_t) * L.J + k0 + c);
        }
      }
      *reinterpret_cast<uint4*>(buf + r * kc + c) = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kGm * groups; i += kGThreads) {
      const int lm = i / groups, c = (i - lm * groups) * 8;
      const int q = lm / kTileCells, lr = lm - q * kTileCells;
      const Cell cell = tile_cell(L, t0 + q, lr);
      const bf16* fr = buf + (q * rows + lr / L.r_u) * kc + c;
      const bf16* gr = buf + (q * rows + L.r_t + lr % L.r_u) * kc + c;
      __align__(16) bf16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = __float2bfloat16(
            cell.ok ? tanhf(__bfloat162float(fr[e]) + __bfloat162float(gr[e]))
                    : 0.0f);
      *reinterpret_cast<uint4*>(hs + lm * ldh + k0 + c) =
          *reinterpret_cast<const uint4*>(out);
    }
  }
  const int pad = (ldh - 8 - L.J) / 8;      // columns J .. : read as zero
  for (int i = threadIdx.x; i < kGm * pad; i += kGThreads)
    *reinterpret_cast<uint4*>(hs + (i / pad) * ldh + L.J + (i % pad) * 8) =
        make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// (m, s) <- the logsumexp pair of (m, s) and (m2, s2): s is a sum of
// exp(x - m); a pair with m = -inf is empty
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -CUDART_INF_F) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// K7: block x takes tiles t0 = tile0 + 2x and t0 + 1. RES: their h is
// formed here and stays in shared memory (ldh = J rounded up to 64, + 8);
// else h comes from the slab scratch hsg (rows of the slab, `rows` of them,
// the block's from 128 x on). Then, for every 128 columns of V: the block
// product with W^T (B [k][n]), and each thread folds its 8 rows x 8 columns
// into running (max, sum of exp, blank logit, label logit).
template <bool RES>
__global__ void __launch_bounds__(kGThreads)
joint_lse_fwd_mma_kernel(const bf16* __restrict__ f,
                         const bf16* __restrict__ g,
                         const bf16* __restrict__ wt,
                         const float* __restrict__ bias,
                         const int* __restrict__ labels,
                         const bf16* __restrict__ hsg,
                         float* __restrict__ blank_out,
                         float* __restrict__ label_out,
                         float* __restrict__ lse_out, Lattice L,
                         long long tile0, long long rows, int ldh) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  bf16* hs = reinterpret_cast<bf16*>(k7_smem);
  bf16* ring = RES ? hs + kGm * ldh : hs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const long long t0 = tile0 + 2LL * blockIdx.x;
  const long long m0 = (long long)blockIdx.x * kGm;
  if constexpr (RES) fill_h_resident(hs, ldh, ring, kRingElems, f, g, L, t0);
  // the thread's 8 rows (i, h): row wm * 64 + 16 i + gid + 8 h
  int lbl[4][2];
  float m[4][2], s[4][2], bl[4][2], la[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lm = wm * 64 + i * 16 + gid + 8 * h;
      const Cell c = tile_cell(L, t0 + lm / kTileCells, lm % kTileCells);
      lbl[i][h] = c.ok && c.u < L.U ? labels[(size_t)c.b * L.U + c.u]
                                    : L.blank;
      m[i][h] = -CUDART_INF_F;
      s[i][h] = bl[i][h] = la[i][h] = 0.0f;
    }
  for (int n0 = 0; n0 < L.V; n0 += kGn) {
    float acc[4][4][4];
    zero_acc(acc);
    if constexpr (RES)
      gemm_block<false, true, true>(acc, hs, ldh, 0, kGm, wt, L.V, n0, L.V,
                                    0, L.J, ring);
    else
      gemm_block<false, true>(acc, hsg, L.J, m0, rows, wt, L.V, n0, L.V, 0,
                              L.J, ring);
    // the bias of the thread's 8 columns, -inf past V (their accumulators
    // are 0: W^T is staged as zero there)
    float bc[4][2];
    int col[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        col[j][e] = n0 + wn * 32 + j * 8 + tig * 2 + e;
        bc[j][e] = col[j][e] < L.V ? bias[col[j][e]] : -CUDART_INF_F;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[4][2], cm = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[j][e] = acc[i][j][2 * h + e] + bc[j][e];
            cm = fmaxf(cm, x[j][e]);
            if (col[j][e] == L.blank) bl[i][h] += x[j][e];
            if (col[j][e] == lbl[i][h]) la[i][h] += x[j][e];
          }
        const float mn = fmaxf(m[i][h], cm);
        if (mn == -CUDART_INF_F) continue;
        float cs = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) cs += expf(x[j][e] - mn);
        s[i][h] = s[i][h] * expf(m[i][h] - mn) + cs;
        m[i][h] = mn;
      }
  }
  // the 4 lanes of a row (tig), then the 4 column warps (wn) in order
  float4* red = reinterpret_cast<float4*>(ring);   // kGm x 4: (m, s, bl, la)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[i][h], off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s[i][h], off);
        bl[i][h] += __shfl_xor_sync(0xffffffffu, bl[i][h], off);
        la[i][h] += __shfl_xor_sync(0xffffffffu, la[i][h], off);
        lse_merge(m[i][h], s[i][h], m2, s2);
      }
      if (tig == 0)
        red[(wm * 64 + i * 16 + gid + 8 * h) * 4 + wn] =
            make_float4(m[i][h], s[i][h], bl[i][h], la[i][h]);
    }
  __syncthreads();
  if (threadIdx.x < kGm) {
    const int lm = threadIdx.x;
    const Cell c = tile_cell(L, t0 + lm / kTileCells, lm % kTileCells);
    if (c.ok && (RES || m0 + lm < rows)) {
      float4 a = red[lm * 4];
      for (int q = 1; q < 4; ++q) {
        const float4 p = red[lm * 4 + q];
        lse_merge(a.x, a.y, p.x, p.y);
        a.z += p.z;
        a.w += p.w;
      }
      const float lse = a.x + logf(a.y);
      const size_t cell = ((size_t)c.b * L.T + c.t) * L.U1 + c.u;
      blank_out[cell] = a.z - lse;
      lse_out[cell] = lse;
      if (c.u < L.U)
        label_out[((size_t)c.b * L.T + c.t) * L.U + c.u] = a.w - lse;
    }
  }
}

// K7's h launch where h is not resident (tile_h, as K8's)
__global__ void __launch_bounds__(kThreads)
joint_lse_fwd_h_kernel(const bf16* __restrict__ f, const bf16* __restrict__ g,
                       bf16* __restrict__ hs, Lattice L, long long tile0) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  tile_h(f, g, hs, L, tile0, reinterpret_cast<bf16*>(k7_smem));
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

template <int RPW>
cudaError_t launch_fwd(const void* f, const void* g, const void* wt,
                       const void* bias, const void* labels, void* blank_out,
                       void* label_out, void* lse_out, const Dims& d,
                       cudaStream_t s) {
  const size_t smem = fwd_smem(RPW, d.J);
  cudaError_t e = allow_smem(joint_lse_fwd_kernel<RPW>, smem);
  if (e != cudaSuccess) return e;
  const long long rows = kWarps * RPW;
  const unsigned grid = (unsigned)((d.N + rows - 1) / rows);
  joint_lse_fwd_kernel<RPW><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(f), static_cast<const float*>(g),
      static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<float*>(blank_out),
      static_cast<float*>(label_out), static_cast<float*>(lse_out), d);
  return cudaGetLastError();
}

cudaError_t run_fwd(const void* f, const void* g, const void* wt,
                    const void* bias, const void* labels, void* blank_out,
                    void* label_out, void* lse_out, const Dims& d,
                    cudaStream_t s) {
  if (fwd_smem(4, d.J) <= kMaxSmem)
    return launch_fwd<4>(f, g, wt, bias, labels, blank_out, label_out,
                               lse_out, d, s);
  return launch_fwd<1>(f, g, wt, bias, labels, blank_out, label_out,
                             lse_out, d, s);
}

template <int RPW>
cudaError_t launch_dh(const void* f, const void* g, const void* wt,
                      const void* w, const void* bias, const void* labels,
                      const void* lse, const void* d_blank,
                      const void* d_label, void* df, void* dg, const Dims& d,
                      cudaStream_t s) {
  const size_t smem = dh_smem(RPW, d.J);
  cudaError_t e = allow_smem(joint_lse_bwd_dh_kernel<RPW>, smem);
  if (e != cudaSuccess) return e;
  const long long rows = kWarps * RPW;
  const unsigned grid = (unsigned)((d.N + rows - 1) / rows);
  joint_lse_bwd_dh_kernel<RPW><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(f), static_cast<const float*>(g),
      static_cast<const float*>(wt), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(d_blank),
      static_cast<const float*>(d_label), static_cast<float*>(df),
      static_cast<float*>(dg), d);
  return cudaGetLastError();
}

cudaError_t run_dh(const void* f, const void* g, const void* wt,
                   const void* w, const void* bias, const void* labels,
                   const void* lse, const void* d_blank, const void* d_label,
                   void* df, void* dg, const Dims& d, cudaStream_t s) {
  return dh_smem(4, d.J) <= kMaxSmem
             ? launch_dh<4>(f, g, wt, w, bias, labels, lse, d_blank,
                                  d_label, df, dg, d, s)
             : launch_dh<1>(f, g, wt, w, bias, labels, lse, d_blank,
                                  d_label, df, dg, d, s);
}

cudaError_t launch_dw(const void* f, const void* g, const void* wt,
                      const void* bias, const void* labels, const void* lse,
                      const void* d_blank, const void* d_label, void* dw,
                      void* dbias, const Dims& d, int n_split,
                      cudaStream_t s) {
  const size_t smem = dw_smem(d.J);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(joint_lse_bwd_dw_kernel, smem);
  if (e != cudaSuccess) return e;
  const long long per = (d.N + n_split - 1) / n_split;
  const dim3 grid((d.V + kStrip - 1) / kStrip, n_split);
  joint_lse_bwd_dw_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(f), static_cast<const float*>(g),
      static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(d_blank), static_cast<const float*>(d_label),
      static_cast<float*>(dw), static_cast<float*>(dbias), d, per);
  return cudaGetLastError();
}

cudaError_t run_bwd(const void* f, const void* g, const void* wt,
                    const void* w, const void* bias, const void* labels,
                    const void* lse, const void* d_blank,
                    const void* d_label, void* df, void* dg, void* dw,
                    void* dbias, const Dims& d, int n_split,
                    cudaStream_t s) {
  cudaError_t e = run_dh(f, g, wt, w, bias, labels, lse, d_blank,
                               d_label, df, dg, d, s);
  if (e != cudaSuccess) return e;
  return launch_dw(f, g, wt, bias, labels, lse, d_blank, d_label, dw,
                         dbias, d, n_split, s);
}

size_t gemm_smem() { return (size_t)kGStages * 2 * kStageElems * 2; }

size_t dh_mma_smem() {
  const size_t e = (size_t)kGm * kLdE * sizeof(float);
  return e > gemm_smem() ? e : gemm_smem();
}

// the slabs of the plan, four launches each, then the reduction
cudaError_t run_bwd_mma(const bf16* f, const bf16* g, const bf16* wt,
                        const bf16* w, const float* bias, const int* labels,
                        const float* lse, const float* d_blank,
                        const float* d_label, float* df, float* dg,
                        float* dw, float* dbias, bf16* hs, bf16* dls,
                        float* dw_part, float* dbias_part, const Lattice& L,
                        int slab_tiles, int dw_split, cudaStream_t s) {
  const size_t smem_h =
      (size_t)(L.r_t + L.r_u) * (L.J < kHCols ? L.J : kHCols) * 2;
  if (smem_h > kMaxSmem || slab_tiles < 2 || slab_tiles % 2 || dw_split < 1)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(joint_lse_bwd_h_kernel, smem_h);
  if (e == cudaSuccess) e = allow_smem(joint_lse_bwd_dl_kernel, gemm_smem());
  if (e == cudaSuccess)
    e = allow_smem(joint_lse_bwd_dh_mma_kernel, dh_mma_smem());
  if (e == cudaSuccess)
    e = allow_smem(joint_lse_bwd_dw_mma_kernel, gemm_smem());
  if (e != cudaSuccess) return e;
  const unsigned vb = (L.V + kGn - 1) / kGn, jb = (L.J + kGn - 1) / kGn;
  for (long long t0 = 0; t0 < L.tiles; t0 += slab_tiles) {
    const long long n = L.tiles - t0 < slab_tiles ? L.tiles - t0 : slab_tiles;
    const long long rows = n * kTileCells;
    const unsigned mb = (unsigned)((rows + kGm - 1) / kGm);
    joint_lse_bwd_h_kernel<<<(unsigned)n, kThreads, smem_h, s>>>(f, g, hs, L,
                                                                  t0);
    joint_lse_bwd_dl_kernel<<<dim3(vb, mb), kGThreads, gemm_smem(), s>>>(
        hs, w, bias, labels, lse, d_blank, d_label, dls, dbias_part, L, t0,
        rows);
    joint_lse_bwd_dh_mma_kernel<<<dim3(jb, mb), kGThreads, dh_mma_smem(),
                                  s>>>(f, g, wt, dls, df, dg, L, t0, rows);
    const long long share =
        (rows + (long long)dw_split * kGk - 1) / ((long long)dw_split * kGk) *
        kGk;
    joint_lse_bwd_dw_mma_kernel<<<dim3(vb, jb, dw_split), kGThreads,
                                  gemm_smem(), s>>>(hs, dls, dw_part, L, rows,
                                                    share);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long n_out = (long long)L.J * L.V + L.V;
  joint_lse_bwd_reduce_kernel<<<(unsigned)((n_out + kThreads - 1) / kThreads),
                                kThreads, 0, s>>>(
      dw_part, dbias_part, dw, dbias, L.J * L.V, L.V, dw_split,
      slab_tiles / 2);
  return cudaGetLastError();
}

size_t fwd_res_smem(int ldh) {
  return ((size_t)kGm * ldh + kRingElems) * 2;
}

// K7, bf16: resident (ldh > 0), one launch over every tile pair; else slab
// by slab, K8's h kernel into the scratch hs, then the same product reading
// it
cudaError_t run_fwd_mma(const bf16* f, const bf16* g, const bf16* wt,
                        const float* bias, const int* labels, bf16* hs,
                        float* blank_out, float* label_out, float* lse_out,
                        const Lattice& L, int ldh, int slab_tiles,
                        cudaStream_t s) {
  if (ldh > 0) {
    const size_t smem = fwd_res_smem(ldh);
    if (smem > kMaxSmem || ldh % 8 || ldh - 8 < L.J)
      return cudaErrorInvalidValue;
    const cudaError_t e = allow_smem(joint_lse_fwd_mma_kernel<true>, smem);
    if (e != cudaSuccess) return e;
    joint_lse_fwd_mma_kernel<true>
        <<<(unsigned)((L.tiles + 1) / 2), kGThreads, smem, s>>>(
            f, g, wt, bias, labels, nullptr, blank_out, label_out, lse_out, L,
            0, 0, ldh);
    return cudaGetLastError();
  }
  const size_t smem_h =
      (size_t)(L.r_t + L.r_u) * (L.J < kHCols ? L.J : kHCols) * 2;
  if (smem_h > kMaxSmem || slab_tiles < 2 || slab_tiles % 2)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(joint_lse_fwd_h_kernel, smem_h);
  if (e == cudaSuccess)
    e = allow_smem(joint_lse_fwd_mma_kernel<false>, gemm_smem());
  if (e != cudaSuccess) return e;
  for (long long t0 = 0; t0 < L.tiles; t0 += slab_tiles) {
    const long long n = L.tiles - t0 < slab_tiles ? L.tiles - t0 : slab_tiles;
    joint_lse_fwd_h_kernel<<<(unsigned)n, kThreads, smem_h, s>>>(f, g, hs, L,
                                                                  t0);
    joint_lse_fwd_mma_kernel<false>
        <<<(unsigned)((n + 1) / 2), kGThreads, gemm_smem(), s>>>(
            f, g, wt, bias, labels, hs, blank_out, label_out, lse_out, L, t0,
            n * kTileCells, 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

Lattice make_lattice(int B, int T, int U1, int J, int V, int blank, int r_t,
                     int r_u) {
  Lattice L;
  L.B = B;
  L.T = T;
  L.U1 = U1;
  L.U = U1 - 1;
  L.J = J;
  L.V = V;
  L.blank = blank;
  L.r_t = r_t;
  L.r_u = r_u;
  L.n_tt = (T + r_t - 1) / r_t;
  L.n_tu = (U1 + r_u - 1) / r_u;
  L.tiles = (long long)B * L.n_tt * L.n_tu;
  return L;
}

}  // namespace

// K7 in fp32, on the CUDA cores: f (B, T, J), g (B, U1, J), wt = W^T (J, V)
// fp32; bias (V) fp32; labels (B, U1 - 1) int32 → blank_lp (B, T, U1),
// label_lp (B, T, U1 - 1), lse (B, T, U1) fp32.
extern "C" int edd_joint_lse_fwd(const void* f, const void* g, const void* wt,
                                 const void* bias, const void* labels,
                                 void* blank_out, void* label_out,
                                 void* lse_out, int B, int T, int U1, int J,
                                 int V, int blank, void* stream) {
  const Dims d = make_dims(B, T, U1, J, V, blank);
  const cudaError_t e =
      run_fwd(f, g, wt, bias, labels, blank_out, label_out, lse_out, d,
                     static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K7 in bf16 with J, V multiples of 16 (ops/joint_lse_plan.py fwd_plan): f,
// g, wt bf16 (16-byte aligned), the rest as edd_joint_lse_fwd; lattice
// tiles of r_t x r_u = 64 cells. ldh > 0: h resident in shared memory, rows
// ldh bf16 apart (hs unused); ldh = 0: slabs of slab_tiles tiles through
// the scratch hs (slab_tiles * 64, J) bf16.
extern "C" int edd_joint_lse_fwd_mma(const void* f, const void* g,
                                     const void* wt, const void* bias,
                                     const void* labels, void* blank_out,
                                     void* label_out, void* lse_out, void* hs,
                                     int B, int T, int U1, int J, int V,
                                     int blank, int r_t, int r_u, int ldh,
                                     int slab_tiles, void* stream) {
  if (r_t * r_u != kTileCells || J % 16 || V % 16)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = run_fwd_mma(
      static_cast<const bf16*>(f), static_cast<const bf16*>(g),
      static_cast<const bf16*>(wt), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<bf16*>(hs),
      static_cast<float*>(blank_out), static_cast<float*>(label_out),
      static_cast<float*>(lse_out),
      make_lattice(B, T, U1, J, V, blank, r_t, r_u), ldh, slab_tiles,
      static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K8 in fp32, on the CUDA cores: f, g, wt as edd_joint_lse_fwd (fp32), w =
// W (V, J), lse from the forward, d_blank (B, T, U1) and d_label (B, T, U1 -
// 1) cotangents → accumulates into df (B, T, J), dg (B, U1, J), dw = dW^T
// (J, V), dbias (V), all fp32 and zeroed by the caller. n_split: row shares
// of the dW kernel (its grid's second axis).
extern "C" int edd_joint_lse_bwd(const void* f, const void* g, const void* wt,
                                 const void* w, const void* bias,
                                 const void* labels, const void* lse,
                                 const void* d_blank, const void* d_label,
                                 void* df, void* dg, void* dw, void* dbias,
                                 int B, int T, int U1, int J, int V,
                                 int blank, int n_split, void* stream) {
  const Dims d = make_dims(B, T, U1, J, V, blank);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      run_bwd(f, g, wt, w, bias, labels, lse, d_blank, d_label, df,
                     dg, dw, dbias, d, n_split, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K8 in bf16 with J, V multiples of 16 (ops/joint_lse_plan.py): f, g, wt, w,
// bias, labels, lse, d_blank, d_label, df, dg, dw, dbias as
// edd_joint_lse_bwd (df, dg zeroed by the caller; dw, dbias written), plus
// the slab scratch hs (slab_tiles * 64, J) and dls (slab_tiles * 64, V)
// bf16, dw_part (dw_split, J, V) and dbias_part (slab_tiles / 2, V) fp32
// zeroed by the caller; lattice tiles of r_t x r_u = 64 cells.
extern "C" int edd_joint_lse_bwd_mma(
    const void* f, const void* g, const void* wt, const void* w,
    const void* bias, const void* labels, const void* lse,
    const void* d_blank, const void* d_label, void* df, void* dg, void* dw,
    void* dbias, void* hs, void* dls, void* dw_part, void* dbias_part, int B,
    int T, int U1, int J, int V, int blank, int r_t, int r_u, int slab_tiles,
    int dw_split, void* stream) {
  if (r_t * r_u != kTileCells || J % 16 || V % 16)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = run_bwd_mma(
      static_cast<const bf16*>(f), static_cast<const bf16*>(g),
      static_cast<const bf16*>(wt), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(d_blank),
      static_cast<const float*>(d_label), static_cast<float*>(df),
      static_cast<float*>(dg), static_cast<float*>(dw),
      static_cast<float*>(dbias), static_cast<bf16*>(hs),
      static_cast<bf16*>(dls), static_cast<float*>(dw_part),
      static_cast<float*>(dbias_part),
      make_lattice(B, T, U1, J, V, blank, r_t, r_u), slab_tiles, dw_split,
      static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
