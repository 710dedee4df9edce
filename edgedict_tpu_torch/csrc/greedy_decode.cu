// K3 — fused greedy frame loop.
//
// Replaces edgedict_tpu/ops/decode_pallas.py:_kernel (launched by
// _call_kernel, reached through maybe_greedy_frame_loop for streaming and
// maybe_greedy_decode for offline decode): for each encoder frame t and
// every stream b,
//   g      = h_dec W_dec^T + b_joint
//   logits = tanh(f[t] + g) W_out^T + b_out
//   pred   = first argmax (a NaN row gives its first NaN), <unk> re-argmaxed
//            with logits[unk] = -inf; optional max log-prob -log sum exp(x-m)
//   on a non-blank pred: embedding row (PAD row pre-zeroed), the stacked
//   prediction-net LSTM (bias pre-summed), projection, and the new
//   (h_dec, hs, cs); on blank the stream's state is left as it was.
// f = enc W_enc^T for all frames stays one torch.matmul outside, as in JAX
// (decode_pallas.py:427-431). Same state-in / state-out contract. fp32 FFMA
// throughout, never TF32.
//
// What bounds it on the H100: every frame reads all of the decode weights
// (W_out 640x2048, W_dec, the 2-layer LSTM and the projection: ~9.6 MB fp32
// at E6D2) for products with a few vectors, and frames are sequential by
// construction (each token feeds the next frame). So a frame is a chain of
// small dependent products: latency, not bytes (9.6 MB over 3.35 TB/s is
// 2.9 us; at B = 256 the FFMAs take ~10 us a frame).
//
// Design: one cooperative launch per call over the whole card (one block
// per SM, plan ops/decode_plan.py). Block g owns a balanced slice of the
// output columns of every product: J of W_dec, V of W_out, the 4 gate
// columns of its hidden units in each LSTM layer (so it applies the cell
// itself, with no barrier between gates and cell) and D of the projection.
// It loads those weight slices into shared memory once per launch and keeps
// them for all T frames (~75 KB at E6D2 on 132 SMs); the embedding table
// stays in device memory, one row read per stream. Per frame, for all B
// streams:
//   1. jh = tanh(f[t] + h_dec W_dec^T + b_joint), the block's J columns;
//      grid barrier;
//   2. the block's logits columns, and per stream a 16-byte partial: the
//      first max (NaN first), the first max without <unk>, and the sum of
//      exp relative to the first; grid barrier;
//   3. every block combines all blocks' partials in one fixed order (the
//      same bits in every block; a tie keeps the smaller column and a NaN
//      the first NaN, across slices too) into each stream's token and
//      log-prob: a chunk of streams' partials is staged in shared memory by
//      all threads at once, then w lanes per stream each fold a share in
//      block order and a butterfly over the w lanes merges the shares;
//      block 0 writes the tokens. No barrier;
//   4. only where some stream emits: each LSTM layer (the gate product over
//      [input, h] for the block's units, then the cell), a grid barrier per
//      layer; then the projection, a grid barrier. A stream's state moves
//      only where its token is not blank.
// Grid barriers: 2 per frame where no stream emits, 3 + L (5 at E6D2) where
// one does; none at the launch's start or end.
// Activations that cross blocks (h_dec, jh, the partials, each layer's h)
// go through a device scratch the wrapper allocates, h_dec and h double-
// buffered by emitting frame, and are read with ld.global.cg (L2 only),
// never the read-only path. The block's own units' (h, c) and h_dec columns
// also stay in its shared memory for the whole launch, and are written out
// at its end. Each product is the block's weight slice (rows k, columns c,
// swizzled against bank conflicts) times the streams' input vectors read
// from L2, 4 streams x 16 columns a warp pass, lanes along k, the warps also
// splitting k where fewer than 8 passes exist (small B), folded over lanes
// by shuffles and over warps in shared memory. Streams go through the
// products in chunks of at most `bc` (the plan's) so that the staged
// outputs fit shared memory.
// Why not a thread-block cluster: its distributed shared memory (at most
// 16 x 227 KB = 3.6 MB) cannot hold the 9.6 MB of weights, so a cluster
// would re-read them from L2 every frame.
// A weight slice's row is whole float4s with its float4 columns
// XOR-swizzled by row (swizzle_bits), so a warp's float4 loads fall on 8
// bank groups without padding the rows; the partials' chunk `pc` and the
// stream chunk `bc` are the plan's, cut to the bytes left.
// E6D2_LARGE_Batch (2 x 512 prediction net, projection 640: 21.3 MB of
// weights) needs the unpadded rows: its slices are 180,224 bytes a block,
// and would be 234,496 with each row padded off multiples of 8 floats, over
// the 232,448 the H100 gives one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 4;
constexpr int kSB = 4;             // streams of a warp pass
constexpr int kNC = 16;            // columns of a warp pass
constexpr int kNone = 0xFFFF;      // a partial's offset: the slice is empty
constexpr int kPartChunk = 16;     // most streams whose partials are staged

// first column of slice g of n columns over G blocks (balanced)
__host__ __device__ __forceinline__ int split(int n, int g, int G) {
  return (int)((long long)n * g / G);
}
// the most columns any block owns
__host__ __device__ __forceinline__ int most(int n, int G) {
  return (n + G - 1) / G;
}
// a weight slice's row: whole float4s
__host__ __device__ __forceinline__ int pitch(int nc) {
  return (nc + 3) / 4 * 4;
}
// A row of p floats stores float4 column q of row k at
// q ^ ((k >> (3 - a)) & ((1 << a) - 1)), with p / 4 = 2^a x odd (a capped
// at 3): rows 2^(3-a) apart differ in the low a bits, rows closer in k p/4
// mod 8, so the 8 rows one phase of a warp's float4 load reads (lanes along
// k) fall on 8 different 16-byte bank groups. → a.
__host__ __device__ __forceinline__ int swizzle_bits(int p) {
  int a = 0;
  while (a < 3 && !((p >> (2 + a)) & 1)) ++a;
  return a;
}
// what row k's float4 columns are XORed with (bits: swizzle_bits(pitch))
__device__ __forceinline__ int swizzle(int k, int bits) {
  return (k >> (3 - bits)) & ((1 << bits) - 1);
}

// The block's shared memory (float offsets) and the scratch (floats) for a
// plan's stream chunk bc and partials' chunk pc; the same numbers as
// ops/decode_plan.py.
struct Layout {
  int cj, cv, cu, cd;              // most J columns / V columns / units / D
  int pj, pv, pg, pd, po;          // row pitches
  int pc;                          // streams of a partials chunk
  size_t pst, wdec, wout, wl[kMaxLayers], wproj, own_h, own_c, own_d, stage,
      red, tok, total;
  size_t s_part, s_jh, s_hbuf, s_hdec, s_total;
};

__host__ __device__ inline Layout make_layout(int B, int J, int V, int E,
                                              int L, int H, int D, int G,
                                              int bc, int pc) {
  Layout y;
  y.cj = most(J, G);
  y.cv = most(V, G);
  y.cu = most(H, G);
  y.cd = most(D, G);
  y.pj = pitch(y.cj);
  y.pv = pitch(y.cv);
  y.pg = pitch(4 * y.cu);
  y.pd = pitch(y.cd);
  y.po = y.cv > 4 * y.cu ? y.cv : 4 * y.cu;
  if (y.po < 1) y.po = 1;
  y.pc = pc;
  size_t o = 0;                    // float4 regions first: 16-byte aligned
  y.pst = o;
  o += (size_t)4 * y.pc * G;
  y.wdec = o;
  o += (size_t)D * y.pj;
  y.wout = o;
  o += (size_t)J * y.pv;
  for (int l = 0; l < kMaxLayers; ++l) {
    y.wl[l] = o;
    if (l < L) o += (size_t)((l == 0 ? E : H) + H) * y.pg;
  }
  y.wproj = o;
  o += (size_t)H * y.pd;
  y.own_h = o;
  o += (size_t)L * B * y.cu;
  y.own_c = o;
  o += (size_t)L * B * y.cu;
  y.own_d = o;
  o += (size_t)B * y.cd;
  y.stage = o;
  o += (size_t)bc * y.po;
  y.red = o;
  o += (size_t)kWarps * kSB * kNC;
  y.tok = o;
  o += (size_t)B;
  y.total = o;
  y.s_part = 0;                                   // float4 (G, B)
  y.s_jh = (size_t)4 * G * B;                     // (B, J)
  y.s_hbuf = y.s_jh + (size_t)B * J;              // (2, L, B, H)
  y.s_hdec = y.s_hbuf + (size_t)2 * L * B * H;    // (2, B, D)
  y.s_total = y.s_hdec + (size_t)2 * B * D;
  return y;
}

struct Args {
  const float* f;                   // (T, B, J)
  const float* w_dec_t;             // (D, J)
  const float* b_joint;             // (J)
  const float* w_out_t;             // (J, V)
  const float* b_out;               // (V)
  const float* table;               // (V, E)
  const float* w_ih_t[kMaxLayers];  // (in, 4H)
  const float* w_hh_t[kMaxLayers];  // (H, 4H)
  const float* bias[kMaxLayers];    // (4H) = b_ih + b_hh
  const float* w_proj_t;            // (H, D)
  const float* b_proj;              // (D)
  const float* h_dec0;              // (B, D)
  const float* hs0;                 // (L, B, H)
  const float* cs0;                 // (L, B, H)
  int* tokens;                      // (T, B)
  float* logp;                      // (T, B) or null
  float* h_dec_out;                 // (B, D)
  float* hs_out;                    // (L, B, H)
  float* cs_out;                    // (L, B, H)
  float* scratch;                   // Layout::s_total floats
  int T, B, J, V, E, L, H, D, blank, unk, bc, pc;
};

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

// ws[k * p + c] = w(k, c) for k < K, c < nc, 0 for nc <= c < p, the float4
// columns of each row swizzled (swizzle_bits)
template <typename W>
__device__ void load_slice(float* ws, int K, int nc, int p, W w) {
  const int bits = swizzle_bits(p);
  for (int i = threadIdx.x; i < K * p; i += kThreads) {
    const int k = i / p;
    int c = i - k * p;
    c = ((c >> 2) ^ swizzle(k, bits)) << 2 | (c & 3);
    ws[i] = c < nc ? w(k, c) : 0.0f;
  }
}

// out(b, c) = sum_k x(b, k) ws[k * p + c] for streams b < nb and columns
// c < nc, handed to emit(b, c, out) once each. Warp passes of kSB streams x
// kNC columns with lanes along k; where the passes are fewer than the warps,
// ks warps share one pass, splitting k, and are summed in a fixed order
// through `red`. ws as load_slice lays it out. Block-uniform arguments: it
// holds __syncthreads.
template <typename X, typename Emit>
__device__ void product(int nb, int K, int nc, const float* ws, int p, X x,
                        Emit emit, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bits = swizzle_bits(p);
  const int groups = (nb + kSB - 1) / kSB;
  int ks = 1;
  while (ks < kWarps && groups * ks * 2 <= kWarps) ks *= 2;
  const int per_round = kWarps / ks;
  for (int c0 = 0; c0 < nc; c0 += kNC) {
    for (int g0 = 0; g0 < groups; g0 += per_round) {
      const int grp = g0 + warp / ks, wk = warp % ks, b0 = grp * kSB;
      float acc[kSB * kNC];
#pragma unroll
      for (int i = 0; i < kSB * kNC; ++i) acc[i] = 0.0f;
      if (grp < groups) {
        for (int k = wk * 32 + lane; k < K; k += ks * 32) {
          float xv[kSB];
#pragma unroll
          for (int s = 0; s < kSB; ++s)
            xv[s] = b0 + s < nb ? x(b0 + s, k) : 0.0f;
          const float4* wr =
              reinterpret_cast<const float4*>(ws + (size_t)k * p);
          const int swz = swizzle(k, bits);
#pragma unroll
          for (int q = 0; q < kNC / 4; ++q) {
            if (c0 + 4 * q >= nc) break;
            const float4 w = wr[((c0 >> 2) + q) ^ swz];
#pragma unroll
            for (int s = 0; s < kSB; ++s) {
              float* a = acc + s * kNC + 4 * q;
              a[0] = fmaf(xv[s], w.x, a[0]);
              a[1] = fmaf(xv[s], w.y, a[1]);
              a[2] = fmaf(xv[s], w.z, a[2]);
              a[3] = fmaf(xv[s], w.w, a[3]);
            }
          }
        }
      }
      // lane L: value L (stream L / 16, column L % 16) and 32 + L
      fold<16>(acc, lane);
      fold<16>(acc + 32, lane);
      float v0 = acc[0], v1 = acc[32];
      if (ks > 1) {
        red[warp * 64 + lane] = v0;
        red[warp * 64 + 32 + lane] = v1;
      }
      __syncthreads();
      if (grp < groups && wk == 0) {
        if (ks > 1) {
          v0 = v1 = 0.0f;
          for (int w = warp; w < warp + ks; ++w) {
            v0 += red[w * 64 + lane];
            v1 += red[w * 64 + 32 + lane];
          }
        }
        const int c = c0 + (lane & 15), s0 = b0 + (lane >> 4);
        if (c < nc) {
          if (s0 < nb) emit(s0, c, v0);
          if (s0 + 2 < nb) emit(s0 + 2, c, v1);
        }
      }
      __syncthreads();
    }
  }
}

// A stream's partial over the block's nv logits x (columns v0 ..): the
// first max, the first max with <unk> read as -inf (values; their column
// offsets packed 16 bits each, kNone for an empty slice) and the sum of
// exp(x - first max).
__device__ float4 slice_partial(const float* x, int nv, int v0, int unk) {
  float bv = -INFINITY, b2v = -INFINITY;
  int bi = INT_MAX, b2i = INT_MAX;
  for (int c = 0; c < nv; ++c) {
    combine(bv, bi, x[c], c);
    combine(b2v, b2i, v0 + c == unk ? -INFINITY : x[c], c);
  }
  float s = 0.0f;
  if (bv != -INFINITY)
    for (int c = 0; c < nv; ++c) s += expf(x[c] - bv);
  const unsigned off = (unsigned)(bi == INT_MAX ? kNone : bi) |
                       (unsigned)(b2i == INT_MAX ? kNone : b2i) << 16;
  return make_float4(bv, b2v, s, __uint_as_float(off));
}

// A stream's running pick over partials: the first max (NaN first), the
// first max without <unk>, and (m, s) with s the sum of exp(x - m) over the
// numbers seen (a NaN anywhere shows as bv = NaN).
struct Pick {
  float bv = -INFINITY, b2v = -INFINITY, m = -INFINITY, s = 0.0f;
  int bi = INT_MAX, b2i = INT_MAX;

  __device__ void add(float4 p, int base) {
    const unsigned off = __float_as_uint(p.w);
    const int o1 = off & 0xFFFF, o2 = off >> 16;
    combine(bv, bi, p.x, o1 == kNone ? INT_MAX : base + o1);
    combine(b2v, b2i, p.y, o2 == kNone ? INT_MAX : base + o2);
    lse(p.x, p.z);
  }
  __device__ void lse(float m2, float s2) {
    if (isnan(m2) || m2 == -INFINITY) return;
    const float mn = fmaxf(m, m2);
    s = s * expf(m - mn) + s2 * expf(m2 - mn);
    m = mn;
  }
  // merge with the lane `off` away (xor): both end with the same bits
  __device__ void merge_lane(int off) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, off);
    const int i = __shfl_xor_sync(0xffffffffu, bi, off);
    const float v2 = __shfl_xor_sync(0xffffffffu, b2v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, b2i, off);
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    combine(bv, bi, v, i);
    combine(b2v, b2i, v2, i2);
    lse(m2, s2);
  }
};

// lanes per stream in step 3: a power of two, at most a warp, with a
// chunk's streams in one pass of the block
__device__ __forceinline__ int part_lanes(int pc) {
  int w = 32;
  while (w > 1 && w * pc > kThreads) w >>= 1;
  return w;
}

__global__ void __launch_bounds__(kThreads) greedy_frame_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, g = blockIdx.x, tid = threadIdx.x;
  const int B = a.B, J = a.J, V = a.V, E = a.E, L = a.L, H = a.H, D = a.D;
  const Layout y = make_layout(B, J, V, E, L, H, D, G, a.bc, a.pc);
  float* w_dec = smem + y.wdec;
  float* w_out = smem + y.wout;
  float* w_proj = smem + y.wproj;
  float* own_h = smem + y.own_h;      // (L, B, cu) the block's units
  float* own_c = smem + y.own_c;
  float* own_d = smem + y.own_d;      // (B, cd) the block's h_dec columns
  float* stage = smem + y.stage;      // (bc, po) a chunk's product outputs
  float* red = smem + y.red;
  int* tok = reinterpret_cast<int*>(smem + y.tok);
  float4* pst = reinterpret_cast<float4*>(smem + y.pst);  // (pc, G)
  float4* part = reinterpret_cast<float4*>(a.scratch + y.s_part);
  float* jh = a.scratch + y.s_jh;
  float* hbuf = a.scratch + y.s_hbuf;
  float* hdec = a.scratch + y.s_hdec;
  const int j0 = split(J, g, G), nj = split(J, g + 1, G) - j0;
  const int v0 = split(V, g, G), nv = split(V, g + 1, G) - v0;
  const int u0 = split(H, g, G), nu = split(H, g + 1, G) - u0;
  const int d0 = split(D, g, G), nd = split(D, g + 1, G) - d0;

  // the weight slices (gate columns unit-major: c = 4 unit + gate)
  load_slice(w_dec, D, nj, y.pj,
             [&](int k, int c) { return a.w_dec_t[(size_t)k * J + j0 + c]; });
  load_slice(w_out, J, nv, y.pv,
             [&](int k, int c) { return a.w_out_t[(size_t)k * V + v0 + c]; });
  for (int l = 0; l < L; ++l) {
    const int n_in = l == 0 ? E : H;
    const float* wi = a.w_ih_t[l];
    const float* wh = a.w_hh_t[l];
    load_slice(smem + y.wl[l], n_in + H, 4 * nu, y.pg, [&](int k, int c) {
      const size_t col = (size_t)(c & 3) * H + u0 + (c >> 2);
      return k < n_in ? wi[(size_t)k * 4 * H + col]
                      : wh[(size_t)(k - n_in) * 4 * H + col];
    });
  }
  load_slice(w_proj, H, nd, y.pd,
             [&](int k, int c) { return a.w_proj_t[(size_t)k * D + d0 + c]; });
  for (int i = tid; i < L * B * nu; i += kThreads) {
    const int lb = i / nu, c = i - lb * nu;
    own_h[(size_t)lb * y.cu + c] = a.hs0[(size_t)lb * H + u0 + c];
    own_c[(size_t)lb * y.cu + c] = a.cs0[(size_t)lb * H + u0 + c];
  }
  for (int i = tid; i < B * nd; i += kThreads) {
    const int b = i / nd, c = i - b * nd;
    own_d[(size_t)b * y.cd + c] = a.h_dec0[(size_t)b * D + d0 + c];
  }
  __syncthreads();

  int gen = 0;   // emitting frames so far: the state lives in the inputs
                 // (gen 0) or in buffer gen & 1
  for (int t = 0; t < a.T; ++t) {
    const float* hd_cur =
        gen ? hdec + (size_t)(gen & 1) * B * D : a.h_dec0;
    const float* ft = a.f + (size_t)t * B * J;
    // 1. jh
    for (int b0 = 0; b0 < B; b0 += a.bc) {
      const int nb = min(a.bc, B - b0);
      product(
          nb, D, nj, w_dec, y.pj,
          [&](int b, int k) {
            return __ldcg(hd_cur + (size_t)(b0 + b) * D + k);
          },
          [&](int b, int c, float v) {
            const size_t o = (size_t)(b0 + b) * J + j0 + c;
            jh[o] = tanhf(ft[o] + (v + a.b_joint[j0 + c]));
          },
          red);
    }
    grid.sync();
    // 2. logits and the partials
    for (int b0 = 0; b0 < B; b0 += a.bc) {
      const int nb = min(a.bc, B - b0);
      product(
          nb, J, nv, w_out, y.pv,
          [&](int b, int k) { return __ldcg(jh + (size_t)(b0 + b) * J + k); },
          [&](int b, int c, float v) {
            stage[b * y.po + c] = v + a.b_out[v0 + c];
          },
          red);
      for (int b = tid; b < nb; b += kThreads)
        part[(size_t)g * B + b0 + b] =
            slice_partial(stage + b * y.po, nv, v0, a.unk);
      __syncthreads();
    }
    grid.sync();
    // 3. every stream's token (and log-prob) from all blocks' partials: a
    // chunk of streams' partials staged in shared memory, then w lanes per
    // stream each fold theirs in block order and a butterfly over the w
    // lanes merges them, the same tree in every block
    int emits = 0;
    const int w = part_lanes(y.pc);
    for (int b0 = 0; b0 < B; b0 += y.pc) {
      const int nb = min(y.pc, B - b0);
      for (int i = tid; i < G * nb; i += kThreads) {
        const int q = i / nb, s = i - q * nb;
        pst[s * G + q] = __ldcg(part + (size_t)q * B + b0 + s);
      }
      __syncthreads();
      const int s = tid / w, ln = tid % w;
      Pick pk;
      if (s < nb)
        for (int q = ln; q < G; q += w) pk.add(pst[s * G + q], split(V, q, G));
      for (int off = 1; off < w; off <<= 1) pk.merge_lane(off);
      if (s < nb && ln == 0) {
        const int b = b0 + s;
        const int pred = a.unk >= 0 && pk.bi == a.unk ? pk.b2i : pk.bi;
        tok[b] = pred;
        emits |= pred != a.blank;
        if (g == 0) {
          a.tokens[(size_t)t * B + b] = pred;
          if (a.logp)
            a.logp[(size_t)t * B + b] =
                isnan(pk.bv) || pk.m == -INFINITY ? NAN : -logf(pk.s);
        }
      }
      __syncthreads();                 // pst is free for the next chunk
    }
    if (!__syncthreads_or(emits)) continue;   // the same in every block
    // 4. the prediction net and the projection, state gen -> gen + 1
    const int nxt = (gen + 1) & 1;
    for (int l = 0; l < L; ++l) {
      const int n_in = l == 0 ? E : H;
      const float* h_cur = gen ? hbuf + ((size_t)(gen & 1) * L + l) * B * H
                               : a.hs0 + (size_t)l * B * H;
      const float* x_in =
          l ? hbuf + ((size_t)nxt * L + l - 1) * B * H : nullptr;
      float* h_nxt = hbuf + ((size_t)nxt * L + l) * B * H;
      const float* bl = a.bias[l];
      for (int b0 = 0; b0 < B; b0 += a.bc) {
        const int nb = min(a.bc, B - b0);
        product(
            nb, n_in + H, 4 * nu, smem + y.wl[l], y.pg,
            [&](int b, int k) {
              const size_t bb = b0 + b;
              if (k >= n_in) return __ldcg(h_cur + bb * H + k - n_in);
              return l == 0 ? a.table[(size_t)tok[bb] * E + k]
                            : __ldcg(x_in + bb * H + k);
            },
            [&](int b, int c, float v) { stage[b * y.po + c] = v; }, red);
        for (int i = tid; i < nb * nu; i += kThreads) {
          const int b = i / nu, c = i - b * nu, bb = b0 + b, u = u0 + c;
          float* hh = own_h + ((size_t)l * B + bb) * y.cu + c;
          float* cc = own_c + ((size_t)l * B + bb) * y.cu + c;
          if (tok[bb] != a.blank) {
            const float* gt = stage + b * y.po + 4 * c;
            const float gi = gt[0] + bl[u], gf = gt[1] + bl[H + u];
            const float gg = gt[2] + bl[2 * H + u], go = gt[3] + bl[3 * H + u];
            const float cn = sigmoid(gf) * *cc + sigmoid(gi) * tanhf(gg);
            *cc = cn;
            *hh = sigmoid(go) * tanhf(cn);
          }
          h_nxt[(size_t)bb * H + u] = *hh;
        }
        __syncthreads();
      }
      grid.sync();
    }
    const float* top = hbuf + ((size_t)nxt * L + L - 1) * B * H;
    float* hd_nxt = hdec + (size_t)nxt * B * D;
    for (int b0 = 0; b0 < B; b0 += a.bc) {
      const int nb = min(a.bc, B - b0);
      product(
          nb, H, nd, w_proj, y.pd,
          [&](int b, int k) { return __ldcg(top + (size_t)(b0 + b) * H + k); },
          [&](int b, int c, float v) {
            const int bb = b0 + b;
            float* o = own_d + (size_t)bb * y.cd + c;
            if (tok[bb] != a.blank) *o = v + a.b_proj[d0 + c];
            hd_nxt[(size_t)bb * D + d0 + c] = *o;
          },
          red);
    }
    grid.sync();
    ++gen;
  }

  for (int i = tid; i < L * B * nu; i += kThreads) {
    const int lb = i / nu, c = i - lb * nu;
    a.hs_out[(size_t)lb * H + u0 + c] = own_h[(size_t)lb * y.cu + c];
    a.cs_out[(size_t)lb * H + u0 + c] = own_c[(size_t)lb * y.cu + c];
  }
  for (int i = tid; i < B * nd; i += kThreads) {
    const int b = i / nd, c = i - b * nd;
    a.h_dec_out[(size_t)b * D + d0 + c] = own_d[(size_t)b * y.cd + c];
  }
}

}  // namespace

// How many blocks of `smem` dynamic bytes one SM holds at once → *out (the
// first two arguments are unused: the signature of the recurrences' query).
extern "C" int edd_greedy_decode_blocks_per_sm(int, int, int smem,
                                               void* out) {
  const void* fn = reinterpret_cast<const void*>(greedy_frame_kernel);
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(out), fn, kThreads, (size_t)smem);
}

// All tensors fp32 except tokens (int32); logp may be null. w_ih_t, w_hh_t
// and bias are host arrays of L device pointers. unk < 0 disables the
// <unk> re-argmax; T = 0 copies the state. From the plan
// (ops/decode_plan.py): `grid` blocks, streams in chunks of `bc` through
// the products and of `pc` through the partials, `smem` bytes of dynamic
// shared memory and the scratch (`scratch_floats` floats, 16-byte aligned);
// a plan that disagrees with this file's layout is refused.
extern "C" int edd_greedy_decode(
    const void* f, int T, int B, int J, const void* w_dec_t,
    const void* b_joint, const void* w_out_t, const void* b_out, int V,
    const void* table, int E, int L, const void* const* w_ih_t,
    const void* const* w_hh_t, const void* const* bias, int H,
    const void* w_proj_t, const void* b_proj, int D, const void* h_dec0,
    const void* hs0, const void* cs0, void* tokens, void* logp, void* h_dec,
    void* hs, void* cs, int blank, int unk, void* scratch, long long
    scratch_floats, int grid, int bc, int pc, int smem, void* stream) {
  if (L < 1 || L > kMaxLayers || grid < 1 || bc < 1 || T < 0 || pc < 1 ||
      pc > kPartChunk || pc > B)
    return (int)cudaErrorInvalidValue;
  const Layout y = make_layout(B, J, V, E, L, H, D, grid, bc, pc);
  if ((size_t)smem < y.total * sizeof(float) ||
      (size_t)scratch_floats < y.s_total || most(V, grid) >= kNone)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.f = static_cast<const float*>(f);
  a.w_dec_t = static_cast<const float*>(w_dec_t);
  a.b_joint = static_cast<const float*>(b_joint);
  a.w_out_t = static_cast<const float*>(w_out_t);
  a.b_out = static_cast<const float*>(b_out);
  a.table = static_cast<const float*>(table);
  for (int l = 0; l < L; ++l) {
    a.w_ih_t[l] = static_cast<const float*>(w_ih_t[l]);
    a.w_hh_t[l] = static_cast<const float*>(w_hh_t[l]);
    a.bias[l] = static_cast<const float*>(bias[l]);
  }
  a.w_proj_t = static_cast<const float*>(w_proj_t);
  a.b_proj = static_cast<const float*>(b_proj);
  a.h_dec0 = static_cast<const float*>(h_dec0);
  a.hs0 = static_cast<const float*>(hs0);
  a.cs0 = static_cast<const float*>(cs0);
  a.tokens = static_cast<int*>(tokens);
  a.logp = static_cast<float*>(logp);
  a.h_dec_out = static_cast<float*>(h_dec);
  a.hs_out = static_cast<float*>(hs);
  a.cs_out = static_cast<float*>(cs);
  a.scratch = static_cast<float*>(scratch);
  a.T = T;
  a.B = B;
  a.J = J;
  a.V = V;
  a.E = E;
  a.L = L;
  a.H = H;
  a.D = D;
  a.blank = blank;
  a.unk = unk;
  a.bc = bc;
  a.pc = pc;
  const void* fn = reinterpret_cast<const void*>(greedy_frame_kernel);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params,
                                  (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
