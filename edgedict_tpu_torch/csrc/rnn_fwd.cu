// K1, K5, K12 and K13 — the LSTM and GRU recurrences, forward, and their
// int8 counterparts.
//
// Replaces edgedict_tpu/ops/rnn_pallas.py:_fwd_kernel (K1, launched by
// _run_fwd under the custom-vjp lstm_recurrence_tm), _gru_fwd_kernel (K5,
// _gru_run_fwd under gru_recurrence_tm) and edgedict_tpu/ops/quant.py:
// _fwd_kernel_q (K12, _run_fwd_q) and _gru_fwd_kernel_q (K13,
// _gru_run_fwd_q): K12 / K13 hold W_hh int8 beside one fp32 scale per gate
// row, dequantized once as q * scale in fp32 rounded to the compute dtype,
// then K1's / K5's recurrence; not scale-after-accumulate, which differs in
// bf16. Given the hoisted input projection
// x_proj for every step (LSTM: x W_ih^T + b_ih + b_hh; GRU: x W_ih^T + b_ih),
// run t = 0 .. T-1 with fp32 carries and fp32 accumulation:
//   LSTM: gates = x_proj[t] + h W_hh^T (i, f, g, o); c = σ(f) c + σ(i) tanh(g),
//         h = σ(o) tanh(c); emit ys[t] in x_proj's dtype and cs[t] in fp32;
//   GRU:  hp = h W_hh^T + b_hh (b_hh joins in fp32, inside the reset gate);
//         r = σ(x_r + hp_r), z = σ(x_z + hp_z), n = tanh(x_n + r hp_n),
//         h = (1 - z) n + z h; emit ys[t] in x_proj's dtype;
// and hT (fp32) after the last step (LSTM). h enters the recurrent product
// in the compute dtype (rnn_pallas.py:128-130, :472-473), so the product's
// operand at step t is ys[t-1] itself, and h0 rounded to x_proj's dtype
// (h0e) at t = 0.
//
// What bounds it on the H100: operations, 2·T·B·G·H·H (G = 4 gates for the
// LSTM, 3 for the GRU) at the tensor cores' rate in bf16 or the FFMA rate
// in fp32; in practice the serial chain of T steps, each of which needs
// every block's h of the step before.
//
// Design: one persistent cooperative launch per call, as the dh chain of
// csrc/rnn_bwd.cu. Block i owns kUnits = 8 hidden units and keeps the G·8
// gate rows of W_hh that feed them (G·8 x H: 64 KB in bf16 for the LSTM at
// H=1024) in shared memory for all T steps, in mma B-fragment order. Each
// step, for each slab of 32 batch rows, the block
//  1. loads its (32 x 8) cells' x_proj[t] into registers before the product;
//  2. forms the (32 x G·8) recurrent products ys[t-1] · W_slice^T: in bf16 on
//     tensor cores (mma.sync m16n8k16, N = one gate's 8 units, warps
//     splitting K = H in chunks of 32, then a reduction over warps in shared
//     memory); in fp32 on FFMA, never TF32 (warps splitting K, lanes folding
//     the sums). Every block wrote its units of ys[t-1] in the step before:
//     they are read with ld.global.cg (L2 only), never the read-only path;
//  3. applies the cell to its own units, with the carries (the LSTM's c, the
//     GRU's fp32 h) in shared memory for all steps, and writes ys[t] (cs[t]);
// then passes a grid barrier. The launch plan (grid, shared memory) comes
// from the wrapper (ops/rnn_fwd.py); a grid that cannot be co-resident is
// refused by the cooperative launch. The kernel is named recur_fwd_kernel so
// that the profilers' patterns for K4/K6 ('chain_kernel', 'remat_', the
// cells LstmCell / GruCell) do not catch it.
//
// K12 and K13 are the same kernel body under names of their own,
// recur_fwd_q_kernel (LSTM) and recur_fwd_gru_q_kernel (GRU), so that the
// profilers' K1 / K5 patterns do not catch them and neither name holds the
// other: only the prologue that fills the shared slice differs. It reads
// the block's G x 8 int8 gate rows (32 KB for the LSTM at H=1024, 24 KB for
// the GRU; the whole W_hh once per call instead of once per step) with
// 16-byte loads and their G·8 scales, forms q * scale in fp32, rounds it to
// the compute dtype and writes it into the layout ws_index gives K1 / K5,
// the stores spread over the banks. K13 fills both b_hh and w_scale of
// FwdArgs, the only entry that does.
//
// Host work per launch: cudaFuncSetAttribute (the dynamic shared memory
// ceiling) runs once per kernel, device and larger size, not on every call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 8;                 // hidden units per block
constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = kThreads / kUnits;  // batch rows per pass: 32

struct FwdArgs {
  const void* xp;        // (T, B, G·H) x_proj's dtype
  const void* w;         // (G·H, H) x_proj's dtype
  const float* b_hh;     // (G·H) fp32 (GRU)
  const void* h0e;       // (B, H) h0 in x_proj's dtype
  const float* carry0;   // (B, H) fp32: c0 (LSTM) or h0 (GRU)
  void* ys;              // (T, B, H) out, read back by every block
  float* cs;             // (T, B, H) out (LSTM)
  float* hT;             // (B, H) out, or null
  int T, B, H;
  const float* w_scale;  // (G·H) fp32 scale of each int8 row of w (K12)
};

// The cells' forward for one (b, unit) item: x = its G x_proj values, hp =
// its G recurrent products (fp32), carry = its carried state in shared
// memory; o = the item's offset in (T, B, H). → h (fp32).
struct LstmStep {
  static constexpr int G = 4;
  static constexpr int kLd = 40;          // padded row of the partial sums
  __device__ void init(const FwdArgs&, int) {}
  __device__ float apply(const FwdArgs& a, size_t o, const float* x,
                         const float* hp, float* carry) const {
    const float gi = x[0] + hp[0], gf = x[1] + hp[1];
    const float gg = x[2] + hp[2], go = x[3] + hp[3];
    const float c = sigmoid(gf) * *carry + sigmoid(gi) * tanhf(gg);
    *carry = c;
    a.cs[o] = c;
    return sigmoid(go) * tanhf(c);
  }
};

struct GruStep {
  static constexpr int G = 3;
  static constexpr int kLd = 24;
  float bias[3];                          // b_hh of the thread's unit
  __device__ void init(const FwdArgs& a, int u) {
#pragma unroll
    for (int q = 0; q < 3; ++q) bias[q] = a.b_hh[q * a.H + u];
  }
  __device__ float apply(const FwdArgs&, size_t, const float* x,
                         const float* hp, float* carry) const {
    const float rg = sigmoid(x[0] + (hp[0] + bias[0]));
    const float zg = sigmoid(x[1] + (hp[1] + bias[1]));
    const float ng = tanhf(x[2] + rg * (hp[2] + bias[2]));
    const float h = (1.0f - zg) * ng + zg * *carry;
    *carry = h;
    return h;
  }
};

// Where W_hh[q·H + unit0 + j, k] (n = q·8 + j) lives in the block's shared
// slice. bf16: in mma B-fragment order, chunk c = k / 32 of gate q, lane
// (j, tig) holding k = 32c + 8 tig .. +7 as 16 bytes; the A side reads h in
// the same permutation of k (the sum over k does not depend on the order).
// fp32: G·2 (K32, 4) slabs, one float4 per k for 4 of the G·8 columns.
template <typename Elem>
__device__ __forceinline__ int ws_index(int k, int n, int G, int K32);
template <>
__device__ __forceinline__ int ws_index<__nv_bfloat16>(int k, int n, int G,
                                                       int) {
  return ((((k >> 5) * G + n / kUnits) * 32 + (n % kUnits) * 4 +
           ((k & 31) >> 3)) << 3) + (k & 7);
}
template <>
__device__ __forceinline__ int ws_index<float>(int k, int n, int, int K32) {
  return (n >> 2) * K32 * 4 + k * 4 + (n & 3);
}

// red[warp][row][n] = warp's part of sum_k h[p0 + row, k] W_hh[n-th row, k]
// for the slab's 32 rows. bf16: tensor cores, warps splitting K in chunks
// of 32, 4 chunks in flight per warp; rows past B read as zero.
template <int G, int kLd>
__device__ void fwd_product(const __nv_bfloat16* h, const __nv_bfloat16* ws,
                            float* red, int p0, int B, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nchunks = (K + 31) / 32;
  const bool aligned = K % 8 == 0;
  constexpr int kDepth = 4;
  float acc[2][G][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.0f;
  for (int c0 = warp; c0 < nchunks; c0 += kDepth * kWarps) {
    uint4 xa[kDepth][2][2];               // [chunk][m tile][row gid, +8]
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int k = (c0 + u * kWarps) * 32 + tig * 8;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          xa[u][mt][hh] = ldcg8(h, p0 + mt * 16 + gid + hh * 8, k, B, K,
                                aligned);
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int c = c0 + u * kWarps;
      if (c >= nchunks) break;
      const uint4* wc = reinterpret_cast<const uint4*>(ws) + c * G * 32 + lane;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const uint4 wv = wc[q * 32];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint4 x = xa[u][mt][0], y = xa[u][mt][1];
          mma_bf16(acc[mt][q], x.x, y.x, x.y, y.y, wv.x, wv.y);
          mma_bf16(acc[mt][q], x.z, y.z, x.w, y.w, wv.z, wv.w);
        }
      }
    }
  }
  float* rw = red + warp * kSlab * kLd;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mt * 16 + gid + hh * 8;
        *reinterpret_cast<float2*>(&rw[row * kLd + q * kUnits + tig * 2]) =
            make_float2(acc[mt][q][2 * hh], acc[mt][q][2 * hh + 1]);
      }
  __syncthreads();
}

// fp32: FFMA, never TF32. The slab's rows go kRows at a time: each warp
// takes the k of its 32-wide chunks (lanes striding k), the kRows rows' loads
// are in flight together and share each W read, and each row's G·8 sums are
// folded over the warp so that lane n holds the warp's part of column n.
template <int G, int kLd>
__device__ void fwd_product(const float* h, const float* ws, float* red,
                            int p0, int B, int K) {
  constexpr int N = G * kUnits, kRows = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K32 = (K + 31) / 32 * 32;
  const int rows = min(kSlab, B - p0);
  for (int r0 = 0; r0 < rows; r0 += kRows) {
    float v[kRows][32];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int i = 0; i < 32; ++i) v[rr][i] = 0.0f;
#pragma unroll 2
    for (int k = warp * 32 + lane; k < K; k += kThreads) {
      float a[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        a[rr] = r0 + rr < rows ? __ldcg(h + (size_t)(p0 + r0 + rr) * K + k)
                               : 0.0f;
#pragma unroll
      for (int s = 0; s < N / 4; ++s) {
        const float4 wv =
            reinterpret_cast<const float4*>(ws + (size_t)s * K32 * 4)[k];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          v[rr][4 * s] = fmaf(a[rr], wv.x, v[rr][4 * s]);
          v[rr][4 * s + 1] = fmaf(a[rr], wv.y, v[rr][4 * s + 1]);
          v[rr][4 * s + 2] = fmaf(a[rr], wv.z, v[rr][4 * s + 2]);
          v[rr][4 * s + 3] = fmaf(a[rr], wv.w, v[rr][4 * s + 3]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      if (r0 + rr >= rows) break;         // block-uniform
      fold<16>(v[rr], lane);
      if (lane < N) red[(warp * kSlab + r0 + rr) * kLd + lane] = v[rr][0];
    }
  }
  __syncthreads();
}

// The block's G·8 gate rows of W_hh into its shared slice, once for all
// steps, zero past H. Rows of 16-byte multiples go in 16-byte loads, four in
// flight per thread: at B=1 and T=2 (a streaming chunk) this load is most
// of the call.
template <typename Elem, int G>
__device__ void load_slice(const Elem* w, Elem* ws, int unit0, int H,
                           int K32) {
  constexpr int N = G * kUnits, kVec = 16 / sizeof(Elem);
  if (H % kVec == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    const int nv = K32 / kVec;
#pragma unroll 4
    for (int i = threadIdx.x; i < N * nv; i += kThreads) {
      const int n = i / nv, k = i % nv * kVec, un = unit0 + n % kUnits;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < H && un < H)
        v = __ldg(reinterpret_cast<const uint4*>(
            w + ((size_t)(n / kUnits) * H + un) * H + k));
      const Elem* e = reinterpret_cast<const Elem*>(&v);
#pragma unroll
      for (int q = 0; q < kVec; ++q)
        ws[ws_index<Elem>(k + q, n, G, K32)] = e[q];
    }
    return;
  }
  for (int i = threadIdx.x; i < N * K32; i += kThreads) {
    const int n = i / K32, k = i % K32, un = unit0 + n % kUnits;
    ws[ws_index<Elem>(k, n, G, K32)] =
        k < H && un < H ? w[((size_t)(n / kUnits) * H + un) * H + k]
                        : from_f32<Elem>(0.0f);
  }
}

// K12's and K13's prologue: the block's G·8 int8 gate rows of W_hh, dequantized as
// q * scale in fp32 and rounded to Elem, into the slice K1's load_slice
// fills (zero past H). Rows of 16-byte multiples go in 16-byte loads.
// bf16: a thread takes 16 k of one row (two 16-byte units of the slice),
// storing them in an order that puts a quarter warp's stores on distinct
// banks. fp32: a thread takes 16 k of 4 rows (the 4 columns of a float4 of
// the slice) and stores its 16 float4 rotated by its k chunk.
__device__ __forceinline__ float dq(uint32_t word, int byte, float sc) {
  return static_cast<float>(static_cast<int8_t>(word >> (8 * byte))) * sc;
}
// two floats rounded to bf16 (as from_f32), a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <typename Elem, int G>
__device__ void load_slice_q(const int8_t* w, const float* scale, Elem* ws,
                             int unit0, int H, int K32) {
  constexpr int N = G * kUnits;
  if (H % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    if constexpr (sizeof(Elem) == 2) {
      const int items = K32 / 32 * G * 16;
#pragma unroll 4
      for (int i = threadIdx.x; i < items; i += kThreads) {
        const int h = i & 1, j = (i >> 1) & 7, q = (i >> 4) % G;
        const int c = (i >> 4) / G, un = unit0 + j, k = 32 * c + 16 * h;
        uint4 v = make_uint4(0, 0, 0, 0);
        float sc = 0.0f;
        if (k < H && un < H) {
          v = __ldg(reinterpret_cast<const uint4*>(
              w + ((size_t)q * H + un) * H + k));
          sc = __ldg(scale + q * H + un);
        }
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
        uint32_t pk[8];                   // bf16 pairs, k ascending
#pragma unroll
        for (int e = 0; e < 8; ++e)
          pk[e] = pack_bf16(dq(words[e / 2], 2 * (e % 2), sc),
                            dq(words[e / 2], 2 * (e % 2) + 1, sc));
        const uint4 lo = make_uint4(pk[0], pk[1], pk[2], pk[3]);
        const uint4 hi = make_uint4(pk[4], pk[5], pk[6], pk[7]);
        uint4* dst = reinterpret_cast<uint4*>(ws) + (c * G + q) * 32 +
                     j * 4 + 2 * h;
        if ((j >> 1) & 1) {
          dst[1] = hi;
          dst[0] = lo;
        } else {
          dst[0] = lo;
          dst[1] = hi;
        }
      }
    } else {
      const int nm = K32 / 16, items = N / 4 * nm;
      for (int i = threadIdx.x; i < items; i += kThreads) {
        const int m = i % nm, grp = i / nm, k = 16 * m;
        uint32_t words[4][4];
        float sc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 4 * grp + r, q = n / kUnits;
          const int un = unit0 + n % kUnits;
          uint4 v = make_uint4(0, 0, 0, 0);
          sc[r] = 0.0f;
          if (k < H && un < H) {
            v = __ldg(reinterpret_cast<const uint4*>(
                w + ((size_t)q * H + un) * H + k));
            sc[r] = __ldg(scale + q * H + un);
          }
          words[r][0] = v.x, words[r][1] = v.y, words[r][2] = v.z;
          words[r][3] = v.w;
        }
        float4* dst = reinterpret_cast<float4*>(ws) + (size_t)grp * K32 + k;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int ee = (e + m) & 15, wd = ee >> 2, by = ee & 3;
          float col[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t word = wd == 0 ? words[r][0]
                                  : wd == 1 ? words[r][1]
                                  : wd == 2 ? words[r][2] : words[r][3];
            col[r] = dq(word, by, sc[r]);
          }
          dst[ee] = make_float4(col[0], col[1], col[2], col[3]);
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < N * K32; i += kThreads) {
    const int n = i / K32, k = i % K32, un = unit0 + n % kUnits;
    const int row = (n / kUnits) * H + un;
    ws[ws_index<Elem>(k, n, G, K32)] =
        k < H && un < H
            ? from_f32<Elem>(static_cast<float>(w[(size_t)row * H + k]) *
                             scale[row])
            : from_f32<Elem>(0.0f);
  }
}

// The recurrence of K1 / K5 (kQuant false: W_hh in the compute dtype) and
// K12 / K13 (kQuant: int8 W_hh and its scales): the block's slice into shared
// memory, then T steps with a grid barrier between them.
template <typename Elem, typename Cell, bool kQuant>
__device__ __forceinline__ void recur_fwd(const FwdArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  constexpr int G = Cell::G, N = G * kUnits;
  const int T = a.T, B = a.B, H = a.H;
  const int K32 = (H + 31) / 32 * 32;
  Elem* ws = reinterpret_cast<Elem*>(smem);
  float* red = reinterpret_cast<float*>(smem + (size_t)K32 * N *
                                                   sizeof(Elem));
  float* carry = red + kWarps * kSlab * Cell::kLd;
  const int tid = threadIdx.x, r = tid / kUnits, j = tid % kUnits;
  const int unit0 = blockIdx.x * kUnits, u = unit0 + j;

  if constexpr (kQuant)
    load_slice_q<Elem, G>(static_cast<const int8_t*>(a.w), a.w_scale, ws,
                          unit0, H, K32);
  else
    load_slice<Elem, G>(static_cast<const Elem*>(a.w), ws, unit0, H, K32);
  for (int i = tid; i < B * kUnits; i += kThreads) {
    const int un = unit0 + i % kUnits;
    carry[i] = un < H ? a.carry0[(size_t)(i / kUnits) * H + un] : 0.0f;
  }
  Cell cell;
  if (u < H) cell.init(a, u);
  __syncthreads();

  const Elem* xp = static_cast<const Elem*>(a.xp);
  Elem* ys = static_cast<Elem*>(a.ys);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const Elem* hprev = t == 0 ? static_cast<const Elem*>(a.h0e)
                               : ys + (size_t)(t - 1) * bh;
    for (int p0 = 0; p0 < B; p0 += kSlab) {
      const int b = p0 + r;
      const bool live = b < B && u < H;
      float x[G];
      if (live) {
        const Elem* xr = xp + ((size_t)t * B + b) * G * H + u;
#pragma unroll
        for (int q = 0; q < G; ++q) x[q] = to_f32(xr[(size_t)q * H]);
      }
      fwd_product<G, Cell::kLd>(hprev, ws, red, p0, B, H);
      if (live) {
        float hp[G];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          float s = 0.0f;
#pragma unroll
          for (int v = 0; v < kWarps; ++v)
            s += red[(v * kSlab + r) * Cell::kLd + q * kUnits + j];
          hp[q] = s;
        }
        const size_t o = (size_t)t * bh + (size_t)b * H + u;
        const float h = cell.apply(a, o, x, hp, &carry[b * kUnits + j]);
        ys[o] = from_f32<Elem>(h);
        if (t == T - 1 && a.hT) a.hT[(size_t)b * H + u] = h;
      }
      __syncthreads();                    // red is free for the next slab
    }
    if (t < T - 1) grid.sync();           // ys[t] complete for every block
  }
}

template <typename Elem, typename Cell>
__global__ void __launch_bounds__(kThreads)
recur_fwd_kernel(FwdArgs a) {
  recur_fwd<Elem, Cell, false>(a);
}

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
recur_fwd_q_kernel(FwdArgs a) {
  recur_fwd<Elem, LstmStep, true>(a);
}

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
recur_fwd_gru_q_kernel(FwdArgs a) {
  recur_fwd<Elem, GruStep, true>(a);
}

template <typename Elem, typename Cell, bool kQuant>
const void* kernel_fn() {
  if constexpr (!kQuant)
    return reinterpret_cast<const void*>(recur_fwd_kernel<Elem, Cell>);
  else if constexpr (Cell::G == 4)
    return reinterpret_cast<const void*>(recur_fwd_q_kernel<Elem>);
  else
    return reinterpret_cast<const void*>(recur_fwd_gru_q_kernel<Elem>);
}

// Raise fn's dynamic shared memory ceiling to `smem` on the current device,
// once per kernel, device and larger size: the calls after the first skip
// cudaFuncSetAttribute. The lock keeps two host threads from lowering a
// ceiling the other has just raised.
constexpr int kMaxDevices = 64;

template <typename Elem, typename Cell, bool kQuant>
cudaError_t reserve_smem(const void* fn, int smem) {
  static std::mutex mu;
  static int ceiling[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  std::lock_guard<std::mutex> lock(mu);
  if (cached && smem <= ceiling[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && cached) ceiling[dev] = smem;
  return e;
}

template <typename Elem, typename Cell, bool kQuant = false>
cudaError_t launch(const FwdArgs& a, int grid, int smem,
                   cudaStream_t stream) {
  const void* fn = kernel_fn<Elem, Cell, kQuant>();
  const cudaError_t e = reserve_smem<Elem, Cell, kQuant>(fn, smem);
  if (e != cudaSuccess) return e;
  FwdArgs args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params,
                                     (size_t)smem, stream);
}

template <typename Cell, bool kQuant = false>
cudaError_t blocks_per_sm(int bf16, int smem, int* out) {
  const void* fn = bf16 ? kernel_fn<__nv_bfloat16, Cell, kQuant>()
                        : kernel_fn<float, Cell, kQuant>();
  const cudaError_t e =
      bf16 ? reserve_smem<__nv_bfloat16, Cell, kQuant>(fn, smem)
           : reserve_smem<float, Cell, kQuant>(fn, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads,
                                                       (size_t)smem);
}

}  // namespace

// How many forward blocks of `smem` dynamic bytes one SM holds at once, of
// the kernel of `cell`: 0 K1 (LSTM), 1 K5 (GRU), 2 K12 (int8 LSTM), 3 K13
// (int8 GRU). → *out.
extern "C" int edd_rnn_fwd_blocks_per_sm(int cell, int bf16, int smem,
                                         void* out) {
  int* n = static_cast<int*>(out);
  return (int)(cell == 3   ? blocks_per_sm<GruStep, true>(bf16, smem, n)
               : cell == 2 ? blocks_per_sm<LstmStep, true>(bf16, smem, n)
               : cell == 1 ? blocks_per_sm<GruStep>(bf16, smem, n)
                           : blocks_per_sm<LstmStep>(bf16, smem, n));
}

// K1. x_proj (T, B, 4H) incl. both biases, w_hh (4H, H) and h0e (B, H, h0
// in x_proj's dtype) in fp32 (bf16 == 0) or bf16; c0 (B, H) fp32. Outputs
// ys (T, B, H) in x_proj's dtype, cs (T, B, H) and hT (B, H) fp32. `grid`
// blocks of kUnits units (grid * kUnits >= H) and `smem` bytes from the
// wrapper's plan.
extern "C" int edd_lstm_fwd(const void* xp, const void* w_hh, const void* h0e,
                            const void* c0, void* ys, void* cs, void* hT,
                            int T, int B, int H, int bf16, int grid, int smem,
                            void* stream) {
  const FwdArgs a{xp, w_hh, nullptr, h0e, static_cast<const float*>(c0), ys,
                  static_cast<float*>(cs), static_cast<float*>(hT), T, B, H,
                  nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16, LstmStep>(a, grid, smem, s)
           : launch<float, LstmStep>(a, grid, smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K5. x_proj (T, B, 3H) incl. b_ih, w_hh (3H, H) and h0e (B, H) in fp32
// (bf16 == 0) or bf16; b_hh (3H) and h0 (B, H) fp32. Output ys (T, B, H) in
// x_proj's dtype. `grid` and `smem` as edd_lstm_fwd's.
extern "C" int edd_gru_fwd(const void* xp, const void* w_hh, const void* b_hh,
                           const void* h0e, const void* h0, void* ys, int T,
                           int B, int H, int bf16, int grid, int smem,
                           void* stream) {
  const FwdArgs a{xp, w_hh, static_cast<const float*>(b_hh), h0e,
                  static_cast<const float*>(h0), ys, nullptr, nullptr, T, B,
                  H, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16, GruStep>(a, grid, smem, s)
           : launch<float, GruStep>(a, grid, smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K12. x_proj (T, B, 4H) incl. both biases and h0e (B, H, h0 in x_proj's
// dtype) in fp32 (bf16 == 0) or bf16, w_q (4H, H) int8, w_scale (4H) and
// c0 (B, H) fp32. Outputs as edd_lstm_fwd's; `grid` and `smem` from the
// same plan (ops/rnn_fwd.py, its int8 case).
extern "C" int edd_lstm_fwd_q(const void* xp, const void* w_q,
                              const void* w_scale, const void* h0e,
                              const void* c0, void* ys, void* cs, void* hT,
                              int T, int B, int H, int bf16, int grid,
                              int smem, void* stream) {
  const FwdArgs a{xp, w_q, nullptr, h0e, static_cast<const float*>(c0), ys,
                  static_cast<float*>(cs), static_cast<float*>(hT), T, B, H,
                  static_cast<const float*>(w_scale)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16, LstmStep, true>(a, grid, smem, s)
           : launch<float, LstmStep, true>(a, grid, smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K13. x_proj (T, B, 3H) incl. b_ih and h0e (B, H, h0 in x_proj's dtype) in
// fp32 (bf16 == 0) or bf16, w_q (3H, H) int8, w_scale (3H), b_hh (3H) and
// h0 (B, H) fp32. Output ys (T, B, H) in x_proj's dtype; `grid` and `smem`
// from K5's plan (ops/rnn_fwd.py, its int8 GRU case).
extern "C" int edd_gru_fwd_q(const void* xp, const void* w_q,
                             const void* w_scale, const void* b_hh,
                             const void* h0e, const void* h0, void* ys,
                             int T, int B, int H, int bf16, int grid,
                             int smem, void* stream) {
  const FwdArgs a{xp, w_q, static_cast<const float*>(b_hh), h0e,
                  static_cast<const float*>(h0), ys, nullptr, nullptr, T, B,
                  H, static_cast<const float*>(w_scale)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16, GruStep, true>(a, grid, smem, s)
           : launch<float, GruStep, true>(a, grid, smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
