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
// feeds its MXU (bf16; in fp32 nothing is rounded). The (B, T, U+1, V)
// logits and dlogits never reach device memory whole: the forward folds
// them chunk by chunk, the backward holds one slab's dlogits at a time.
//
// What bounds it on the H100: arithmetic. At E6D2 training (B=32, T=214,
// U+1=65, J=640, V=2048) the forward is 445k rows x J x V = 5.8e11 FMAs and
// the backward three times that (logits, dh, dW); bytes are small (f, g, W
// stay in L2). bf16, the training dtype, runs every product on the tensor
// cores (989 TFLOP/s); fp32 (every eval's loss, the --bf16 false steps) on
// the CUDA cores (67 TFLOP/s of FFMA: the fine-tune eval's forward, B=4
// T=1437 U+1=33, is bound at 7.4 ms). The wrapper pads J and V to multiples
// of 16 for both.
//
// Design. The lattice is cut into tiles of 64 cells (r_t frames x r_u label
// slots; ops/joint_lse_plan.py picks the shape). Every product is one block
// product of 8 warps in which a thread owns 8 x 8 fp32 accumulators
// (frag_row, frag_col), fed by a 3-stage cp.async ring:
//  * gemm_block (bf16): 128 x 128 outputs (two tiles), 64-deep stages,
//    ldmatrix (.trans for transposed operands) into mma.sync m16n8k16;
//  * ffma_block (fp32): 64 x 256 (K7: one tile, 16-deep stages) or 128 x
//    128 outputs (K8, 32-deep), the chunks a thread copies worked out once
//    per product, a register-tiled outer product: per k a thread reads
//    its 8 A and 8 B values as float4s from shared memory (conflict-free:
//    A rows 8 apart at an odd number of 16-byte words, or 4 consecutive
//    rows along m; B 4 consecutive columns) and issues 64 FFMAs.
// The kernels around the products are templates over the element type, so
// both dtypes run the same cell order, epilogues and reductions.
//  * forward (K7): a block takes whole tiles, bf16 two lattice tiles, fp32
//    64 consecutive cells (no tile padding: 6.3 % of the rows at the E6D2
//    eval's T=214 U+1=65; it has no df / dg for tiles to sum). Where
//    their h fits in shared memory beside the ring (bf16 up to J = 640: 128
//    x 648 bf16 = 166 KB + 54 KB of W^T stages; fp32 up to J = 704: 64 x
//    708 fp32 = 181 KB + 48 KB), the block loads the tiles' r_t f-rows and
//    r_u g-rows once (fp32: each cell's f and g rows from L2), takes tanh
//    once per cell into shared memory, then streams only W^T, 128 (bf16) or
//    256 (fp32) columns at a time, through the ring — one pass over W per
//    block, no scratch. Wider J stages h through a bounded slab scratch with
//    an h launch (bf16: the backward's), and the same kernel reads A from
//    it. After each column chunk a thread folds
//    its 8 rows x 8 columns of fp32 accumulators (+ bias; -inf past V) into
//    per-row running (max, sum of exp) and the blank and label logits where
//    they fall (the online logsumexp of _fwd_kernel_split; a row whose
//    columns were all -inf so far is skipped, so a chunk of -inf bias —
//    padding, a vocabulary slice's sentinel — gives no NaN); at the end the
//    4 lanes and the column warps that share a row combine in a fixed order
//    through a small shared-memory reduction, and each row's three outputs
//    are written once: no atomics, no partials, the same bits from run to
//    run.
//  * backward (K8): the TPU kernel takes r_t x r_u lattice cells a grid
//    step, computes h once and runs the three products on it. Here
//    lattice tiles (fp32: the shape that pads least; bf16: fewer df / dg
//    partial rows within a slack) form slabs whose h and dlogits (input dtype)
//    fit a scratch of fixed size; per slab, four launches: h (one block per
//    tile: its r_t f-rows and r_u g-rows loaded once, 2 KB of each row at a
//    time, tanh once per cell, into the scratch), dlogits (h . W^T + bias,
//    the softmax gradient, into the scratch, fp32 column sums into
//    per-row-block dbias partials), dh (dlogits . W, then da = dh (1 - h^2)
//    with fp32 h summed inside each tile into per-tile df / dg partials,
//    added to df and dg in tile order by a sum launch), dW (h^T . dlogits
//    over row shares, each into its own fp32 partial). One last launch sums
//    the dW^T and dbias partials in a fixed order. No atomics: df, dg, dW^T
//    and dbias are the same bits from run to run.
// Shared-memory rows read by ldmatrix are padded by 16 bytes against bank
// conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // every block: 8 warps
constexpr int kTileCells = 64;     // r_t x r_u cells per lattice tile
constexpr int kHBytes = 2048;      // bytes of an f / g row staged at a time
constexpr int kGm = 128;           // rows of a K8 product's block (two tiles)
constexpr int kGn = 128;           // columns of a K8 product's block
constexpr int kGStages = 3;        // cp.async ring of every product
// bf16 products (mma.sync)
constexpr int kGk = 64;            // depth of one stage
constexpr int kLdMk = kGk + 8;     // [row][k] stage rows: 144 bytes
constexpr int kLdKm = kGn + 8;     // [k][row] stage rows: 272 bytes
constexpr int kStageElems = kGm * kLdMk;   // >= kGk * kLdKm
// fp32 products (FFMA): stage depth of K7's (64 x 256, beside a resident
// h) and of K8's (128 x 128); [m][k] stage rows are BK + 4 fp32 apart
constexpr int kFk7 = 16;
constexpr int kFk8 = 32;
constexpr int kLdE = kGn + 4;      // fp32 da rows of the dh epilogue

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;
template <typename T>
constexpr int kVec = 16 / sizeof(T);       // elements in 16 bytes
// K7: tiles a block takes (bf16 128 rows, fp32 64)
template <typename T>
constexpr int kFwdWm = kF32<T> ? 1 : 2;
// K8's product kernels: bf16 two blocks an SM (at most 128 registers a
// thread), fp32 one (its 8 x 8 accumulators and fragments need more)
template <typename T>
constexpr int kK8Blocks = kF32<T> ? 1 : 2;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

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

// cell m of the lattice in (b, t, u) order (fp32 K7's rows; ok: m < N)
__device__ __forceinline__ Cell flat_cell(const Lattice& L, long long m) {
  Cell c;
  c.u = (int)(m % L.U1);
  const long long bt = m / L.U1;
  c.t = (int)(bt % L.T);
  c.b = (int)(bt / L.T);
  c.ok = m < (long long)L.B * L.T * L.U1;
  return c;
}

// The 8 x 8 accumulators acc[r][c] of a thread (warp wm along rows, wn along
// columns; lane = 4 gid + tig) lie at row frag_row(r), column frag_col(c) of
// the block's product. mma.sync (bf16): rows gid + 8 r (m16n8 tile r / 2,
// half r % 2), columns 8 (c / 2) + 2 tig + c % 2. FFMA (fp32): the same
// rows where A is read [m][k], rows 4 gid + r % 4 + 32 (r / 4) where it is
// read [k][m] (float4s along m); columns 4 tig + c % 4 + 16 (c / 4)
// (float4s along n). Either way a row is shared by the 4 lanes of one gid
// and by the warps of one wm.
template <typename T, bool A_KM = false>
__device__ __forceinline__ int frag_row(int wm, int r) {
  const int gid = (threadIdx.x & 31) >> 2;
  if constexpr (kF32<T> && A_KM)
    return wm * 64 + gid * 4 + (r & 3) + 32 * (r >> 2);
  return wm * 64 + gid + 8 * r;
}

template <typename T>
__device__ __forceinline__ int frag_col(int wn, int c) {
  const int tig = threadIdx.x & 3;
  if constexpr (kF32<T>) return wn * 32 + tig * 4 + (c & 3) + 16 * (c >> 2);
  return wn * 32 + 8 * (c >> 1) + 2 * tig + (c & 1);
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
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
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int r = i / (COLS / 8), c = (i % (COLS / 8)) * 8;
    bf16* d = dst + r * ld + c;
    if (r0 + r < row_end && c0 + c < col_end)
      cp_async16(d, src + (size_t)(r0 + r) * src_ld + c0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// One block's 128 x 128 bf16 product, acc += A . B over k in [k0, k_end),
// on mma.sync m16n8k16 through ldmatrix from a 3-stage cp.async ring in
// `sm`. A is (M, K): stored [m][k] (A_KM false, element (m, k) at
// a[m * lda + k]) or [k][m] (A_KM true, at a[k * lda + m]); B is (K, N):
// stored [n][k] (B_KN false) or [k][n] (B_KN true). With A_RES, A is the
// block's own 128 rows already in shared memory ([m][k], rows lda apart, m0
// and m_end unused, zero up to k0 + a whole number of stages) and the ring
// holds B alone. Warp (wm, wn) = (warp / 4, warp % 4) owns rows wm * 64 ..
// + 64 and columns wn * 32 .. + 32 (frag_row, frag_col).
template <bool A_KM, bool B_KN, bool A_RES = false>
__device__ __forceinline__ void gemm_block(
    float (&acc)[8][8], const bf16* a, int lda, long long m0,
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
          mma_bf16(acc[2 * i][2 * j], acc[2 * i][2 * j + 1],
                   acc[2 * i + 1][2 * j], acc[2 * i + 1][2 * j + 1],
                   af[i][0], af[i][1], af[i][2], af[i][3], bfr[j][0],
                   bfr[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring may be reused by the epilogue
}

__device__ __forceinline__ void ld4(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// fp32 stage of ffma_block in elements: A (none where resident) and B
__host__ __device__ constexpr int ffma_stage_elems(int wm, int bk, bool a_km,
                                                   bool a_res) {
  return (a_res ? 0 : a_km ? bk * 64 * wm : 64 * wm * (bk + 4)) +
         bk * 32 * (8 / wm);
}

// The 16-byte chunks a thread copies of one fp32 stage, ROWS x COLS of a
// row-major matrix (leading dim ld), k running down its rows (K_ROWS: A or
// B stored [k][..]) or along its columns (A stored [m][k]): each chunk's
// source offset at k = 0 and its mask on the other coordinate (in [o0,
// o_end)) are worked out once per product, a stage adds k's offset.
// Offsets are 32-bit: an operand (a slab's scratch, W) holds under 2^31
// elements.
template <int ROWS, int COLS, bool K_ROWS>
struct Stager {
  static constexpr int kRowChunks = COLS / 4;
  static constexpr int kN = ROWS * kRowChunks / kThreads;
  static_assert(kN * kThreads == ROWS * kRowChunks, "whole chunks a thread");
  int src[kN];
  unsigned ok;             // bit j: chunk j inside [o0, o_end)
  int ld;
  __device__ __forceinline__ Stager(int ld_, int o0, int o_end)
      : ok(0), ld(ld_) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kRowChunks, c = (i % kRowChunks) * 4;
      const int o = K_ROWS ? o0 + c : o0 + r;
      src[j] = K_ROWS ? r * ld + o : o * ld + c;
      if (o < o_end) ok |= 1u << j;
    }
  }
  // the stage at k into dst (rows dld apart): zero past k_end or the mask
  __device__ __forceinline__ void copy(float* dst, int dld, const float* base,
                                      int k, int k_end) const {
    const float* from = base + (K_ROWS ? k * ld : k);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kRowChunks, c = (i % kRowChunks) * 4;
      float* d = dst + r * dld + c;
      if ((ok >> j & 1u) && (K_ROWS ? k + r : k + c) < k_end)
        cp_async16(d, from + src[j]);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
};

// One block's fp32 product on the CUDA cores, acc += A . B over k in [k0,
// k_end), through a 3-stage cp.async ring of BK-deep stages in `sm`: WM
// warps along M (64 rows each) by 8 / WM along N (32 columns each), warp
// (wm, wn) = (warp / WN, warp % WN). A is (M, K) stored [m][k] (A_KM false)
// or [k][m]; B is (K, N) stored [k][n]. With A_RES, A is the block's own
// rows already in shared memory ([m][k], rows lda apart, lda / 4 odd, m0 and
// m_end unused, K a whole number of stages) and the ring holds B alone. Per
// k a thread reads its 8 A and 8 B values as float4s (A [m][k]: its 8 rows'
// next 4 k at once) and issues 64 FFMAs into acc (frag_row<float, A_KM>,
// frag_col<float>).
template <int WM, int BK, bool A_KM, bool A_RES = false>
__device__ __forceinline__ void ffma_block(
    float (&acc)[8][8], const float* a, int lda, long long m0,
    long long m_end, const float* b, int ldb, int n0, int n_end,
    long long k0, long long k_end, float* sm) {
  static_assert(!(A_RES && A_KM), "a resident A is stored [m][k]");
  constexpr int WN = 8 / WM, BM = 64 * WM, BN = 32 * WN;
  constexpr int kLdA = A_KM ? BM : BK + 4;
  constexpr int kStage = ffma_stage_elems(WM, BK, A_KM, A_RES);
  constexpr int kA = kStage - BK * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int gid = lane >> 2, tig = lane & 3;
  const Stager<A_KM ? BK : BM, A_KM ? BM : BK, A_KM> sa(lda, (int)m0,
                                                        (int)m_end);
  const Stager<BK, BN, true> sb(ldb, n0, n_end);
  const int k_stop = (int)k_end;
  auto stage = [&](int buf, int k) {
    float* ad = sm + buf * kStage;
    if constexpr (!A_RES) sa.copy(ad, kLdA, a, k, k_stop);
    sb.copy(ad + kA, BN, b, k, k_stop);
  };
  const int nk = (int)((k_end - k0 + BK - 1) / BK);
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < nk) stage(s, (int)k0 + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is consumed
    const int pf = kt + kGStages - 1;
    if (pf < nk) stage(pf % kGStages, (int)k0 + pf * BK);
    cp_async_commit();
    const float* ab = sm + (kt % kGStages) * kStage;
    const float* bb = ab + kA + wn * 32 + tig * 4;
    if constexpr (A_KM) {
      const float* ap = ab + wm * 64 + gid * 4;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[8];
        ld4(av, ap + kk * BM);
        ld4(av + 4, ap + kk * BM + 32);
        ld4(bv, bb + kk * BN);
        ld4(bv + 4, bb + kk * BN + 16);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    } else {
      const float* ap =
          A_RES ? a + (size_t)(wm * 64 + gid) * lda + k0 + (long long)kt * BK
                : ab + (wm * 64 + gid) * kLdA;
      const int step = 8 * (A_RES ? lda : kLdA);   // 8 rows apart
#pragma unroll
      for (int kq = 0; kq < BK; kq += 4) {
        float av[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r) ld4(av[r], ap + r * step + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[8];
          ld4(bv, bb + (kq + kk) * BN);
          ld4(bv + 4, bb + (kq + kk) * BN + 16);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[r][c] = fmaf(av[r][kk], bv[c], acc[r][c]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring may be reused by the epilogue
}

// A K8 product of 128 x 128 in the element type: bf16 on the tensor cores,
// B stored [n][k]; fp32 on the CUDA cores, B stored [k][n] (the kernels hand
// over W or W^T accordingly)
template <typename T, bool A_KM>
__device__ __forceinline__ void k8_product(float (&acc)[8][8], const T* a,
                                           int lda, long long m0,
                                           long long m_end, const T* b,
                                           int ldb, int n0, int n_end,
                                           long long k0, long long k_end,
                                           unsigned char* sm) {
  if constexpr (kF32<T>)
    ffma_block<2, kFk8, A_KM>(acc, a, lda, m0, m_end, b, ldb, n0, n_end, k0,
                              k_end, reinterpret_cast<float*>(sm));
  else
    gemm_block<A_KM, A_KM>(acc, a, lda, m0, m_end, b, ldb, n0, n_end, k0,
                           k_end, reinterpret_cast<bf16*>(sm));
}

// h of the slab's tiles (one block each), rows of invalid cells zero: the
// tile's r_t f-rows and r_u g-rows are loaded once into shared memory,
// kHBytes of each at a time, and tanh(f + g) is taken once per cell in fp32.
// Tile tile0 + blockIdx.x is written to rows blockIdx.x * 64 .. of hs.
template <typename T>
__device__ __forceinline__ void tile_h(const T* __restrict__ f,
                                       const T* __restrict__ g,
                                       T* __restrict__ hs, const Lattice& L,
                                       long long tile0, T* fs) {
  constexpr int kCols = kHBytes / sizeof(T);
  const long long tile = tile0 + blockIdx.x;
  const Cell c0 = tile_cell(L, tile, 0);
  for (int k0 = 0; k0 < L.J; k0 += kCols) {
    const int kc = min(kCols, L.J - k0);
    T* gs = fs + L.r_t * kc;
    if (k0 > 0) __syncthreads();   // the previous chunk is consumed
    for (int i = threadIdx.x; i < (L.r_t + L.r_u) * kc; i += kThreads) {
      const int r = i / kc, k = k0 + i - r * kc;
      T v = from_f<T>(0.0f);
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
    const int groups = kc / kVec<T>;
    for (int i = threadIdx.x; i < kTileCells * groups; i += kThreads) {
      const int lr = i / groups, k = (i - lr * groups) * kVec<T>;
      const Cell c = tile_cell(L, tile, lr);
      __align__(16) T out[kVec<T>];
      const T* fr = fs + (lr / L.r_u) * kc + k;
      const T* gr = gs + (lr % L.r_u) * kc + k;
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e)
        out[e] = from_f<T>(c.ok ? tanhf(to_f(fr[e]) + to_f(gr[e])) : 0.0f);
      *reinterpret_cast<uint4*>(
          hs + ((size_t)blockIdx.x * kTileCells + lr) * L.J + k0 + k) =
          *reinterpret_cast<const uint4*>(out);
    }
  }
}

// 1. K8's h launch (tile_h)
template <typename T>
__global__ void __launch_bounds__(kThreads)
joint_lse_bwd_h_kernel(const T* __restrict__ f, const T* __restrict__ g,
                       T* __restrict__ hs, Lattice L, long long tile0) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  tile_h<T>(f, g, hs, L, tile0, reinterpret_cast<T*>(k8_smem));
}

// 2. dlogits (rows, V) = softmax gradient of h . W^T + bias, in T, rows of
// invalid cells zero; the column sums of the fp32 dlogits over the block's
// rows are added to dbias_part[blockIdx.y]. bf16 takes B = W (V, J), fp32
// W^T (J, V).
template <typename T, int kBlocks = kK8Blocks<T>>
__global__ void __launch_bounds__(kThreads, kBlocks)
joint_lse_bwd_dl_kernel(const T* __restrict__ hs, const T* __restrict__ w,
                        const T* __restrict__ wt,
                        const float* __restrict__ bias,
                        const int* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ d_blank,
                        const float* __restrict__ d_label,
                        T* __restrict__ dls, float* __restrict__ dbias_part,
                        Lattice L, long long tile0, long long rows) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.y * kGm;
  const int n0 = blockIdx.x * kGn;
  float acc[8][8];
  zero_acc(acc);
  if constexpr (kF32<T>)
    k8_product<T, false>(acc, hs, L.J, m0, rows, wt, L.V, n0, L.V, 0, L.J,
                         k8_smem);
  else
    k8_product<T, false>(acc, hs, L.J, m0, rows, w, L.J, n0, L.V, 0, L.J,
                         k8_smem);
  // the thread's 8 rows: cotangents, label and lse of their cells
  float z[8], db[8], dl[8];
  int lbl[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long m = m0 + frag_row<T>(wm, r);
    const Cell c = tile_cell(L, tile0 + m / kTileCells,
                             (int)(m % kTileCells));
    z[r] = db[r] = dl[r] = 0.0f;
    lbl[r] = L.blank;
    if (m < rows && c.ok) {
      const size_t cell = ((size_t)c.b * L.T + c.t) * L.U1 + c.u;
      z[r] = lse[cell];
      db[r] = d_blank[cell];
      if (c.u < L.U) {
        dl[r] = d_label[((size_t)c.b * L.T + c.t) * L.U + c.u];
        lbl[r] = labels[(size_t)c.b * L.U + c.u];
      }
    }
  }
  constexpr int kLdD = kGn + kVec<T>;               // dlogits rows
  T* ds = reinterpret_cast<T*>(k8_smem);            // kGm x kLdD
  float* red = reinterpret_cast<float*>(ds + kGm * kLdD);   // 2 x kGn
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cl = frag_col<T>(wn, c);
    const int col = n0 + cl;
    const float bc = col < L.V ? bias[col] : 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float v = 0.0f;
      if (col < L.V && (db[r] != 0.0f || dl[r] != 0.0f)) {
        const float p = expf(acc[r][c] + bc - z[r]);
        v = (col == L.blank ? db[r] : 0.0f) + (col == lbl[r] ? dl[r] : 0.0f) -
            (db[r] + dl[r]) * p;
      }
      sum += v;
      ds[frag_row<T>(wm, r) * kLdD + cl] = from_f<T>(v);
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
  constexpr int kRowChunks = kGn / kVec<T>;
  for (int i = threadIdx.x; i < kGm * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks, c = (i % kRowChunks) * kVec<T>;
    if (m0 + r < rows && n0 + c < L.V)
      *reinterpret_cast<uint4*>(dls + (size_t)(m0 + r) * L.V + n0 + c) =
          *reinterpret_cast<const uint4*>(ds + r * kLdD + c);
  }
}

// 3. dh (rows, J) = dlogits . W on 128 rows (two tiles) x 128 columns; da =
// dh (1 - h^2) with fp32 h, then inside each tile the sums over its r_u
// cells (frame t) and over its r_t cells (label slot u) into the slab's
// partials dfp (slab tile, ti, k) and dgp (slab tile, ui, k). bf16 takes
// B = W^T (J, V), fp32 W (V, J).
template <typename T, int kBlocks = kK8Blocks<T>>
__global__ void __launch_bounds__(kThreads, kBlocks)
joint_lse_bwd_dh_kernel(const T* __restrict__ f, const T* __restrict__ g,
                        const T* __restrict__ w, const T* __restrict__ wt,
                        const T* __restrict__ dls, float* __restrict__ dfp,
                        float* __restrict__ dgp, Lattice L, long long tile0,
                        long long rows) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.y * kGm;
  const int n0 = blockIdx.x * kGn;
  float acc[8][8];
  zero_acc(acc);
  if constexpr (kF32<T>)
    k8_product<T, false>(acc, dls, L.V, m0, rows, w, L.J, n0, L.J, 0, L.V,
                         k8_smem);
  else
    k8_product<T, false>(acc, dls, L.V, m0, rows, wt, L.V, n0, L.J, 0, L.V,
                         k8_smem);
  float* es = reinterpret_cast<float*>(k8_smem);     // kGm x kLdE da
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int lm = frag_row<T>(wm, r);
    const Cell c = tile_cell(L, tile0 + (m0 + lm) / kTileCells,
                             (int)((m0 + lm) % kTileCells));
    const bool ok = m0 + lm < rows && c.ok;
    const T* fr = f + ((size_t)c.b * L.T + c.t) * L.J;
    const T* gr = g + ((size_t)c.b * L.U1 + c.u) * L.J;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int cl = frag_col<T>(wn, q);
      const int k = n0 + cl;
      float da = 0.0f;
      if (ok && k < L.J) {
        const float hv = tanhf(to_f(fr[k]) + to_f(gr[k]));
        da = acc[r][q] * (1.0f - hv * hv);
      }
      es[lm * kLdE + cl] = da;
    }
  }
  __syncthreads();
  // one (tile, column) pair a thread: 2 tiles x 128 columns (invalid
  // cells' da is 0)
  for (int pair = threadIdx.x; pair < 2 * kGn; pair += kThreads) {
    const int half = pair / kGn, cl = pair % kGn;
    const int k = n0 + cl;
    const long long tl = (m0 >> 6) + half;          // the slab's tile
    if (k >= L.J || tl * kTileCells >= rows) continue;
    const float* et = es + half * kTileCells * kLdE + cl;
    for (int ti = 0; ti < L.r_t; ++ti) {
      float s = 0.0f;
      for (int ui = 0; ui < L.r_u; ++ui) s += et[(ti * L.r_u + ui) * kLdE];
      dfp[((size_t)tl * L.r_t + ti) * L.J + k] = s;
    }
    for (int ui = 0; ui < L.r_u; ++ui) {
      float s = 0.0f;
      for (int ti = 0; ti < L.r_t; ++ti) s += et[(ti * L.r_u + ui) * kLdE];
      dgp[((size_t)tl * L.r_u + ui) * L.J + k] = s;
    }
  }
}

// 3b. df[b, t, k] += the sum of the slab's partials for frame row (b, t)
// (tiles of one run b n_tt + tt, consecutive), dg[b, u, k] += that for
// label slot (b, u) (tiles n_tu apart), each in tile order and once a slab,
// so df and dg are the same bits from run to run. Item i: df's (run of the
// slab, ti, k) for i < runs r_t J, else dg's (b of the slab, tu, ui, k).
__global__ void __launch_bounds__(kThreads)
joint_lse_bwd_dh_sum_kernel(const float* __restrict__ dfp,
                            const float* __restrict__ dgp,
                            float* __restrict__ df, float* __restrict__ dg,
                            Lattice L, int tile0, int n) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  const int run0 = tile0 / L.n_tu;
  const int n_df = ((tile0 + n - 1) / L.n_tu - run0 + 1) * L.r_t * L.J;
  if (i < n_df) {
    const int k = i % L.J, q = i / L.J, ti = q % L.r_t;
    const int run = run0 + q / L.r_t;
    const int t = run % L.n_tt * L.r_t + ti;
    if (t >= L.T) return;
    const int hi = min(tile0 + n, (run + 1) * L.n_tu);
    float s = 0.0f;
    for (int x = max(tile0, run * L.n_tu); x < hi; ++x)
      s += dfp[((size_t)(x - tile0) * L.r_t + ti) * L.J + k];
    df[((size_t)(run / L.n_tt) * L.T + t) * L.J + k] += s;
    return;
  }
  i -= n_df;
  const int per_b = L.n_tt * L.n_tu;                   // tiles of a b
  const int b0 = tile0 / per_b;
  if (i >= ((tile0 + n - 1) / per_b - b0 + 1) * L.n_tu * L.r_u * L.J) return;
  const int k = i % L.J, q = i / L.J, ui = q % L.r_u;
  const int tu = q / L.r_u % L.n_tu, b = b0 + q / L.r_u / L.n_tu;
  const int u = tu * L.r_u + ui;
  if (u >= L.U1) return;
  int x = b * per_b + tu;                                 // tt = 0
  if (x < tile0) x += (tile0 - x + L.n_tu - 1) / L.n_tu * L.n_tu;
  const int end = min(tile0 + n, (b + 1) * per_b);
  if (x >= end) return;                      // no tile of (b, tu) here
  float s = 0.0f;
  for (; x < end; x += L.n_tu)
    s += dgp[((size_t)(x - tile0) * L.r_u + ui) * L.J + k];
  dg[((size_t)b * L.U1 + u) * L.J + k] += s;
}

// 4. dW^T partial `blockIdx.z` += h^T . dlogits over its share of the slab's
// rows: a 128 x 128 tile of (J, V) per block, both operands read
// transposed ([k][m] and [k][n] stages), each partial element owned by one
// block of the launch (no atomics).
template <typename T, int kBlocks = kK8Blocks<T>>
__global__ void __launch_bounds__(kThreads, kBlocks)
joint_lse_bwd_dw_kernel(const T* __restrict__ hs, const T* __restrict__ dls,
                        float* __restrict__ dw_part, Lattice L,
                        long long rows, long long share) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kGm, n0 = blockIdx.x * kGn;
  const long long k0 = (long long)blockIdx.z * share;
  const long long k_end = k0 + share < rows ? k0 + share : rows;
  if (k0 >= k_end) return;
  float acc[8][8];
  zero_acc(acc);
  k8_product<T, true>(acc, hs, L.J, m0, L.J, dls, L.V, n0, L.V, k0, k_end,
                      k8_smem);
  float* part = dw_part + (size_t)blockIdx.z * L.J * L.V;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + frag_row<T, true>(wm, r);
    if (m >= L.J) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + frag_col<T>(wn, c);
      if (n < L.V) part[(size_t)m * L.V + n] += acc[r][c];
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
// K7: whole tiles a block, bf16 lattice tiles, fp32 64 consecutive cells
// (launch plan: ops/joint_lse_plan.py fwd_plan)
// ---------------------------------------------------------------------------

// the ring of K7's product, in T: bf16 one operand's (RES) or both; fp32 B's
// 256-column stages (RES) or A's 64-row and B's
template <typename T>
__host__ __device__ constexpr int fwd_ring_elems(bool res) {
  return kF32<T> ? kGStages * ffma_stage_elems(1, kFk7, false, res)
                 : (res ? 1 : 2) * kGStages * kStageElems;
}

// h of the block's TILES tiles (first tile t0) into hs (64 TILES rows, ldh
// apart, columns J .. ldh - kVec zero), rows of invalid cells zero: each
// tile's r_t f-rows and r_u g-rows are staged once in `buf` (`buf_elems`
// of T), as many columns at a time as fit, and tanh(f + g) is taken once
// per cell in fp32.
template <typename T, int TILES>
__device__ void fill_h_resident(T* hs, int ldh, T* buf, int buf_elems,
                                const T* __restrict__ f,
                                const T* __restrict__ g, const Lattice& L,
                                long long t0) {
  constexpr int kV = kVec<T>;
  const int rows = L.r_t + L.r_u;            // staged rows per tile
  const int kc = min(L.J, buf_elems / (TILES * rows) / kV * kV);
  for (int k0 = 0; k0 < L.J; k0 += kc) {
    const int w = min(kc, L.J - k0), groups = w / kV;
    if (k0 > 0) __syncthreads();             // the previous chunk is consumed
    for (int i = threadIdx.x; i < TILES * rows * groups; i += kThreads) {
      const int r = i / groups, c = (i - r * groups) * kV;
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
    for (int i = threadIdx.x; i < TILES * kTileCells * groups;
         i += kThreads) {
      const int lm = i / groups, c = (i - lm * groups) * kV;
      const int q = lm / kTileCells, lr = lm - q * kTileCells;
      const Cell cell = tile_cell(L, t0 + q, lr);
      const T* fr = buf + (q * rows + lr / L.r_u) * kc + c;
      const T* gr = buf + (q * rows + L.r_t + lr % L.r_u) * kc + c;
      __align__(16) T out[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e)
        out[e] = from_f<T>(cell.ok ? tanhf(to_f(fr[e]) + to_f(gr[e]))
                                   : 0.0f);
      *reinterpret_cast<uint4*>(hs + lm * ldh + k0 + c) =
          *reinterpret_cast<const uint4*>(out);
    }
  }
  const int pad = (ldh - kV - L.J) / kV;    // columns J .. : read as zero
  for (int i = threadIdx.x; i < TILES * kTileCells * pad; i += kThreads)
    *reinterpret_cast<uint4*>(hs + (i / pad) * ldh + L.J + (i % pad) * kV) =
        make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// fp32 h of the 64 consecutive cells from m0 into hs (rows ldh apart, ldh
// a multiple of 4; cells past the lattice zero), read straight from f and g
__device__ void fill_h_flat(float* hs, int ldh, const float* __restrict__ f,
                            const float* __restrict__ g, const Lattice& L,
                            long long m0) {
  const int q = L.J / 4;
  for (int i = threadIdx.x; i < kTileCells * q; i += kThreads) {
    const int lm = i / q, k = (i - lm * q) * 4;
    const Cell c = flat_cell(L, m0 + lm);
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c.ok) {
      const float4 a = *reinterpret_cast<const float4*>(
          f + ((size_t)c.b * L.T + c.t) * L.J + k);
      const float4 b = *reinterpret_cast<const float4*>(
          g + ((size_t)c.b * L.U1 + c.u) * L.J + k);
      o = make_float4(tanhf(a.x + b.x), tanhf(a.y + b.y), tanhf(a.z + b.z),
                      tanhf(a.w + b.w));
    }
    *reinterpret_cast<float4*>(hs + lm * ldh + k) = o;
  }
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

// K7: block x takes kFwdWm tiles from t0 = tile0 + kFwdWm x: bf16 lattice
// tiles, fp32 blocks of 64 consecutive cells (cells t0 64 ..; no tile
// padding, and without df / dg to sum nothing gains from sharing f and g
// rows). RES: their h is formed here and stays in shared memory (ldh: bf16
// J rounded up to 64, + 8; fp32 J + 4); else h comes from the slab scratch
// hsg (rows of the slab, `rows` of them, the block's from 64 kFwdWm x on).
// Then, for every BN columns of V: the block product with W^T (B [k][n]),
// and each thread folds its 8 rows x 8 columns into running (max, sum of
// exp, blank logit, label logit).
template <typename T, bool RES>
__device__ __forceinline__ void fwd_block(
    const T* __restrict__ f, const T* __restrict__ g,
    const T* __restrict__ wt, const float* __restrict__ bias,
    const int* __restrict__ labels, const T* __restrict__ hsg,
    float* __restrict__ blank_out, float* __restrict__ label_out,
    float* __restrict__ lse_out, const Lattice& L, long long tile0,
    long long rows, int ldh, unsigned char* smem) {
  constexpr int WM = kFwdWm<T>, WN = 8 / WM, BM = 64 * WM, BN = 32 * WN;
  T* hs = reinterpret_cast<T*>(smem);
  T* ring = RES ? hs + BM * ldh : hs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const long long t0 = tile0 + (long long)WM * blockIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  auto cell_of = [&](int lm) {
    return kF32<T> ? flat_cell(L, t0 * kTileCells + lm)
                   : tile_cell(L, t0 + lm / kTileCells, lm % kTileCells);
  };
  if constexpr (RES && kF32<T>) {
    fill_h_flat(hs, ldh, f, g, L, t0 * kTileCells);
    __syncthreads();
  } else if constexpr (RES) {
    fill_h_resident<T, WM>(hs, ldh, ring, fwd_ring_elems<T>(true), f, g, L,
                           t0);
  }
  // the thread's 8 rows
  int lbl[8];
  float m[8], s[8], bl[8], la[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const Cell c = cell_of(frag_row<T>(wm, r));
    lbl[r] = c.ok && c.u < L.U ? labels[(size_t)c.b * L.U + c.u] : L.blank;
    m[r] = -CUDART_INF_F;
    s[r] = bl[r] = la[r] = 0.0f;
  }
  for (int n0 = 0; n0 < L.V; n0 += BN) {
    float acc[8][8];
    zero_acc(acc);
    if constexpr (kF32<T>) {
      if constexpr (RES)
        ffma_block<1, kFk7, false, true>(acc, hs, ldh, 0, BM, wt, L.V, n0,
                                         L.V, 0, L.J, ring);
      else
        ffma_block<1, kFk7, false>(acc, hsg, L.J, m0, rows, wt, L.V, n0,
                                   L.V, 0, L.J, ring);
    } else {
      if constexpr (RES)
        gemm_block<false, true, true>(acc, hs, ldh, 0, BM, wt, L.V, n0, L.V,
                                      0, L.J, ring);
      else
        gemm_block<false, true>(acc, hsg, L.J, m0, rows, wt, L.V, n0, L.V, 0,
                                L.J, ring);
    }
    // the bias of the thread's 8 columns, -inf past V (their accumulators
    // are 0: W^T is staged as zero there)
    float bc[8];
    int col[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      col[c] = n0 + frag_col<T>(wn, c);
      bc[c] = col[c] < L.V ? bias[col[c]] : -CUDART_INF_F;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float x[8], cm = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        x[c] = acc[r][c] + bc[c];
        cm = fmaxf(cm, x[c]);
        if (col[c] == L.blank) bl[r] += x[c];
        if (col[c] == lbl[r]) la[r] += x[c];
      }
      const float mn = fmaxf(m[r], cm);
      if (mn == -CUDART_INF_F) continue;
      float cs = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) cs += expf(x[c] - mn);
      s[r] = s[r] * expf(m[r] - mn) + cs;
      m[r] = mn;
    }
  }
  // the 4 lanes of a row (tig), then the WN column warps (wn) in order
  float4* red = reinterpret_cast<float4*>(ring);   // BM x WN: (m, s, bl, la)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[r], off);
      bl[r] += __shfl_xor_sync(0xffffffffu, bl[r], off);
      la[r] += __shfl_xor_sync(0xffffffffu, la[r], off);
      lse_merge(m[r], s[r], m2, s2);
    }
    if (tig == 0)
      red[frag_row<T>(wm, r) * WN + wn] = make_float4(m[r], s[r], bl[r],
                                                      la[r]);
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    const int lm = threadIdx.x;
    const Cell c = cell_of(lm);
    if (c.ok && (RES || m0 + lm < rows)) {
      float4 a = red[lm * WN];
      for (int q = 1; q < WN; ++q) {
        const float4 p = red[lm * WN + q];
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

// K7 in bf16 on the tensor cores: two tiles (128 rows) a block
template <bool RES>
__global__ void __launch_bounds__(kThreads)
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
  fwd_block<bf16, RES>(f, g, wt, bias, labels, hsg, blank_out, label_out,
                       lse_out, L, tile0, rows, ldh, k7_smem);
}

// K7 in fp32 on the CUDA cores: one tile (64 rows) a block, 256 columns a
// chunk
template <bool RES>
__global__ void __launch_bounds__(kThreads)
joint_lse_fwd_ffma_kernel(const float* __restrict__ f,
                          const float* __restrict__ g,
                          const float* __restrict__ wt,
                          const float* __restrict__ bias,
                          const int* __restrict__ labels,
                          const float* __restrict__ hsg,
                          float* __restrict__ blank_out,
                          float* __restrict__ label_out,
                          float* __restrict__ lse_out, Lattice L,
                          long long tile0, long long rows, int ldh) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  fwd_block<float, RES>(f, g, wt, bias, labels, hsg, blank_out, label_out,
                        lse_out, L, tile0, rows, ldh, k7_smem);
}

// K7's h launch where h is not resident: bf16 tile_h, as K8's; fp32 the
// block's 64 consecutive cells
template <typename T>
__global__ void __launch_bounds__(kThreads)
joint_lse_fwd_h_kernel(const T* __restrict__ f, const T* __restrict__ g,
                       T* __restrict__ hs, Lattice L, long long tile0) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  if constexpr (kF32<T>)
    fill_h_flat(hs + (size_t)blockIdx.x * kTileCells * L.J, L.J, f, g, L,
                (tile0 + blockIdx.x) * kTileCells);
  else
    tile_h<T>(f, g, hs, L, tile0, reinterpret_cast<T*>(k7_smem));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr size_t kMaxSmem = 227 * 1024;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t max_size(size_t a, size_t b) { return a > b ? a : b; }

// a K8 product's ring
template <typename T>
size_t prod_smem(bool a_km) {
  return kF32<T> ? (size_t)kGStages * ffma_stage_elems(2, kFk8, a_km, false) *
                       4
                 : (size_t)kGStages * 2 * kStageElems * 2;
}

template <typename T>
size_t dl_smem() {
  return max_size(prod_smem<T>(false),
                  (size_t)kGm * (kGn + kVec<T>) * sizeof(T) + 2 * kGn * 4);
}

template <typename T>
size_t dh_smem() {
  return max_size(prod_smem<T>(false), (size_t)kGm * kLdE * 4);
}

template <typename T>
size_t h_smem(const Lattice& L) {
  constexpr int kCols = kHBytes / sizeof(T);
  return (size_t)(L.r_t + L.r_u) * (L.J < kCols ? L.J : kCols) * sizeof(T);
}

template <typename T>
size_t fwd_smem(int ldh) {
  return ((size_t)(ldh > 0 ? 64 * kFwdWm<T> * ldh : 0) +
          fwd_ring_elems<T>(ldh > 0)) *
         sizeof(T);
}

// the slabs of the plan, five launches each, then the reduction
template <typename T>
cudaError_t run_bwd(const T* f, const T* g, const T* wt, const T* w,
                    const float* bias, const int* labels, const float* lse,
                    const float* d_blank, const float* d_label, float* df,
                    float* dg, float* dw, float* dbias, T* hs, T* dls,
                    float* dw_part, float* dbias_part, float* dfdg_part,
                    const Lattice& L, int slab_tiles, int dw_split,
                    cudaStream_t s) {
  const size_t smem_h = h_smem<T>(L);
  if (smem_h > kMaxSmem || slab_tiles < 2 || slab_tiles % 2 || dw_split < 1)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(joint_lse_bwd_h_kernel<T>, smem_h);
  if (e == cudaSuccess)
    e = allow_smem(joint_lse_bwd_dl_kernel<T>, dl_smem<T>());
  if (e == cudaSuccess)
    e = allow_smem(joint_lse_bwd_dh_kernel<T>, dh_smem<T>());
  if (e == cudaSuccess)
    e = allow_smem(joint_lse_bwd_dw_kernel<T>, prod_smem<T>(true));
  if (e != cudaSuccess) return e;
  const unsigned vb = (L.V + kGn - 1) / kGn, jb = (L.J + kGn - 1) / kGn;
  for (long long t0 = 0; t0 < L.tiles; t0 += slab_tiles) {
    const long long n = L.tiles - t0 < slab_tiles ? L.tiles - t0 : slab_tiles;
    const long long rows = n * kTileCells;
    const unsigned mb = (unsigned)((rows + kGm - 1) / kGm);
    joint_lse_bwd_h_kernel<T><<<(unsigned)n, kThreads, smem_h, s>>>(f, g, hs,
                                                                    L, t0);
    joint_lse_bwd_dl_kernel<T><<<dim3(vb, mb), kThreads, dl_smem<T>(), s>>>(
        hs, w, wt, bias, labels, lse, d_blank, d_label, dls, dbias_part, L,
        t0, rows);
    float* dfp = dfdg_part;
    float* dgp = dfdg_part + (size_t)slab_tiles * L.r_t * L.J;
    joint_lse_bwd_dh_kernel<T><<<dim3(jb, mb), kThreads, dh_smem<T>(), s>>>(
        f, g, w, wt, dls, dfp, dgp, L, t0, rows);
    const int first = (int)t0, last = (int)(t0 + n - 1);
    const int items =
        ((last / L.n_tu - first / L.n_tu + 1) * L.r_t +
         (last / (L.n_tt * L.n_tu) - first / (L.n_tt * L.n_tu) + 1) *
             L.n_tu * L.r_u) *
        L.J;
    joint_lse_bwd_dh_sum_kernel<<<(items + kThreads - 1) / kThreads,
                                  kThreads, 0, s>>>(dfp, dgp, df, dg, L,
                                                    first, (int)n);
    const long long share =
        (rows + (long long)dw_split * kGk - 1) / ((long long)dw_split * kGk) *
        kGk;
    joint_lse_bwd_dw_kernel<T><<<dim3(vb, jb, dw_split), kThreads,
                                 prod_smem<T>(true), s>>>(hs, dls, dw_part, L,
                                                          rows, share);
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

// one launch of K7's product (the kernel of T's name)
template <typename T, bool RES>
cudaError_t launch_fwd(unsigned grid, size_t smem, cudaStream_t s,
                       const T* f, const T* g, const T* wt,
                       const float* bias, const int* labels, const T* hs,
                       float* blank_out, float* label_out, float* lse_out,
                       const Lattice& L, long long tile0, long long rows,
                       int ldh) {
  cudaError_t e;
  if constexpr (kF32<T>) {
    e = allow_smem(joint_lse_fwd_ffma_kernel<RES>, smem);
    if (e != cudaSuccess) return e;
    joint_lse_fwd_ffma_kernel<RES><<<grid, kThreads, smem, s>>>(
        f, g, wt, bias, labels, hs, blank_out, label_out, lse_out, L, tile0,
        rows, ldh);
  } else {
    e = allow_smem(joint_lse_fwd_mma_kernel<RES>, smem);
    if (e != cudaSuccess) return e;
    joint_lse_fwd_mma_kernel<RES><<<grid, kThreads, smem, s>>>(
        f, g, wt, bias, labels, hs, blank_out, label_out, lse_out, L, tile0,
        rows, ldh);
  }
  return cudaGetLastError();
}

// K7: resident (ldh > 0), one launch over every block of tiles; else slab by
// slab, the h launch into the scratch hs, then the same product reading it
template <typename T>
cudaError_t run_fwd(const T* f, const T* g, const T* wt, const float* bias,
                    const int* labels, T* hs, float* blank_out,
                    float* label_out, float* lse_out, const Lattice& L,
                    int ldh, int slab_tiles, cudaStream_t s) {
  constexpr int WM = kFwdWm<T>;
  const size_t smem = fwd_smem<T>(ldh);
  if (ldh > 0) {
    // fp32: J + 4 (an odd number of 16-byte words: conflict-free rows)
    if (smem > kMaxSmem || ldh % kVec<T> || ldh < L.J + kVec<T> ||
        (kF32<T> && (ldh / 4) % 2 == 0))
      return cudaErrorInvalidValue;
    return launch_fwd<T, true>((unsigned)((L.tiles + WM - 1) / WM), smem, s,
                               f, g, wt, bias, labels, nullptr, blank_out,
                               label_out, lse_out, L, 0, 0, ldh);
  }
  const size_t smem_h = kF32<T> ? 0 : h_smem<T>(L);
  if (smem_h > kMaxSmem || slab_tiles < WM || slab_tiles % WM)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(joint_lse_fwd_h_kernel<T>, smem_h);
  if (e != cudaSuccess) return e;
  for (long long t0 = 0; t0 < L.tiles; t0 += slab_tiles) {
    const long long n = L.tiles - t0 < slab_tiles ? L.tiles - t0 : slab_tiles;
    joint_lse_fwd_h_kernel<T><<<(unsigned)n, kThreads, smem_h, s>>>(f, g, hs,
                                                                    L, t0);
    e = launch_fwd<T, false>((unsigned)((n + WM - 1) / WM), smem, s, f, g, wt,
                             bias, labels, hs, blank_out, label_out, lse_out,
                             L, t0, n * kTileCells, 0);
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
  if (r_t == 0) {      // blocks of 64 consecutive cells (fp32 K7)
    L.n_tt = L.n_tu = 0;
    L.tiles = ((long long)B * T * U1 + kTileCells - 1) / kTileCells;
    return L;
  }
  L.n_tt = (T + r_t - 1) / r_t;
  L.n_tu = (U1 + r_u - 1) / r_u;
  L.tiles = (long long)B * L.n_tt * L.n_tu;
  return L;
}

}  // namespace

// K7 with J, V multiples of 16 (ops/joint_lse_plan.py fwd_plan): f (B, T,
// J), g (B, U1, J), wt = W^T (J, V) in one dtype (bf16 != 0: bf16, else
// fp32; 16-byte aligned), bias (V) fp32, labels (B, U1 - 1) int32 →
// blank_lp (B, T, U1), label_lp (B, T, U1 - 1), lse (B, T, U1) fp32;
// bf16 in lattice tiles of r_t x r_u = 64 cells, fp32 (r_t = r_u = 0) in
// blocks of 64 consecutive cells. ldh > 0: h resident in shared memory,
// rows ldh elements apart (hs unused); ldh = 0: slabs of slab_tiles tiles
// through the scratch hs (slab_tiles * 64, J) in f's dtype.
extern "C" int edd_joint_lse_fwd(const void* f, const void* g,
                                 const void* wt, const void* bias,
                                 const void* labels, void* blank_out,
                                 void* label_out, void* lse_out, void* hs,
                                 int B, int T, int U1, int J, int V,
                                 int blank, int r_t, int r_u, int ldh,
                                 int slab_tiles, int bf16_in, void* stream) {
  if ((bf16_in ? r_t * r_u != kTileCells : r_t != 0 || r_u != 0) || J % 16 ||
      V % 16)
    return (int)cudaErrorInvalidValue;
  const Lattice L = make_lattice(B, T, U1, J, V, blank, r_t, r_u);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* lb = static_cast<const int*>(labels);
  float* bo = static_cast<float*>(blank_out);
  float* lo = static_cast<float*>(label_out);
  float* zo = static_cast<float*>(lse_out);
  const cudaError_t e =
      bf16_in ? run_fwd(static_cast<const bf16*>(f),
                        static_cast<const bf16*>(g),
                        static_cast<const bf16*>(wt), b, lb,
                        static_cast<bf16*>(hs), bo, lo, zo, L, ldh,
                        slab_tiles, s)
              : run_fwd(static_cast<const float*>(f),
                        static_cast<const float*>(g),
                        static_cast<const float*>(wt), b, lb,
                        static_cast<float*>(hs), bo, lo, zo, L, ldh,
                        slab_tiles, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K8 with J, V multiples of 16 (ops/joint_lse_plan.py bwd_plan): f, g, wt as
// edd_joint_lse_fwd, w = W (V, J) in their dtype, bias, labels as there,
// lse from the forward, d_blank (B, T, U1) and d_label (B, T, U1 - 1)
// cotangents fp32 → df (B, T, J), dg (B, U1, J) (fp32, zeroed by the
// caller, accumulated), dw = dW^T (J, V), dbias (V) (fp32, written); the
// slab scratch hs (slab_tiles * 64, J) and dls (slab_tiles * 64, V) in f's
// dtype, dw_part (dw_split, J, V) and dbias_part (slab_tiles / 2, V) fp32
// zeroed by the caller, dfdg_part (slab_tiles * (r_t + r_u), J) fp32;
// lattice tiles of r_t x r_u = 64 cells.
extern "C" int edd_joint_lse_bwd(
    const void* f, const void* g, const void* wt, const void* w,
    const void* bias, const void* labels, const void* lse,
    const void* d_blank, const void* d_label, void* df, void* dg, void* dw,
    void* dbias, void* hs, void* dls, void* dw_part, void* dbias_part,
    void* dfdg_part, int B, int T, int U1, int J, int V, int blank, int r_t,
    int r_u, int slab_tiles, int dw_split, int bf16_in, void* stream) {
  if (r_t * r_u != kTileCells || J % 16 || V % 16)
    return (int)cudaErrorInvalidValue;
  const Lattice L = make_lattice(B, T, U1, J, V, blank, r_t, r_u);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* lb = static_cast<const int*>(labels);
  const float* z = static_cast<const float*>(lse);
  const float* db = static_cast<const float*>(d_blank);
  const float* dl = static_cast<const float*>(d_label);
  float* o[7] = {static_cast<float*>(df), static_cast<float*>(dg),
                 static_cast<float*>(dw), static_cast<float*>(dbias),
                 static_cast<float*>(dw_part),
                 static_cast<float*>(dbias_part),
                 static_cast<float*>(dfdg_part)};
  const cudaError_t e =
      bf16_in
          ? run_bwd(static_cast<const bf16*>(f), static_cast<const bf16*>(g),
                    static_cast<const bf16*>(wt),
                    static_cast<const bf16*>(w), b, lb, z, db, dl, o[0],
                    o[1], o[2], o[3], static_cast<bf16*>(hs),
                    static_cast<bf16*>(dls), o[4], o[5], o[6], L,
                    slab_tiles, dw_split, s)
          : run_bwd(static_cast<const float*>(f),
                    static_cast<const float*>(g),
                    static_cast<const float*>(wt),
                    static_cast<const float*>(w), b, lb, z, db, dl, o[0],
                    o[1], o[2], o[3], static_cast<float*>(hs),
                    static_cast<float*>(dls), o[4], o[5], o[6], L,
                    slab_tiles, dw_split, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
