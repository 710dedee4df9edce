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
// Both kernels walk the T+U+1 anti-diagonals t + u = d one after another.
//
// Both are register wavefronts, with no block barrier on the chain and no
// lattice scratch. A block of W warps takes one utterance; lane l of warp w
// owns the K columns u = 32 K w + 32 k + l (k < K; K = 1 up to 512 columns,
// so that the warps share out a diagonal's work over the SM's four
// schedulers), keeps in a register the value of each of its cells on the
// diagonal before, and gets its neighbour column's by one __shfl_sync per k.
// Across warps the edge column's value goes through a ring in shared memory
// (a flag per warp says how far it got; the warps of one utterance run a
// diagonal or more apart, and a producer never overwrites a slot its
// consumer has yet to read). Each lane loads its cells' inputs a few
// diagonals ahead of the chain into registers, and the cell is branch-free.
// The plan (ops/rnnt_loss_kernel.py beta_plan) picks (W, K) from U+1 for
// both; tests/test_torch_port_lattice_plan.py models both walks with the ring
// and the lane wrap on the CPU.
//
// K9 (alpha + logZ) walks the diagonals forwards: step s forms t + u = s.
// alpha[t-1, u] is the lane's own register, alpha[t, u-1] lane l-1's (lane 0
// takes lane 31's item k-1 and, for k = 0, the value warp w-1 handed over).
// Every cell of the (T+1) x (U+1) lattice is stored in fp32, the masked ones
// NEG-ish as the plain version gives them (K10 reads every row t < T), and
// the lane owning column ylen writes logZ at t = xlen from the same fp32
// value it stores, so logZ is alpha[xlen, ylen] bit for bit. A call
// allocates only alpha and logz.
//
// K10 (beta + gradients) walks them backwards, keeping beta[t+1, u] for its
// cell (t, u); beta[t, u+1] comes from lane l+1 (lane 31 takes lane 0's item
// k+1, and for k = K-1 the value warp w+1 handed over). blank, label and
// alpha of each cell are loaded ahead, and the two occupancies of a cell are
// written as soon as its two betas are known. No beta is stored: a call
// allocates only gb and gl. The cell is log_add(log_add(term, bm + b'), lm +
// b_right).
//
// Both carry the chain in fp64, with log_add = max + log1pf(expf(-|a - b|))
// whose correction term (and the occupancies' expf) stays fp32: a serial
// fp32 chain over U+1 = 1100 columns drifts ~1e-3 in an occupancy near 1,
// ten times the row-doubling plain version's error and over the 1e-6 |logZ|
// it is held to; fp64 sums keep it below the plain version's. alpha is
// stored in fp32, which K10 reads.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNeg = -1e30f;

constexpr int kRing = 32;      // diagonals of edge values in flight
constexpr int kMaxWarps = 16;  // warps along u in one block
constexpr int kMaxThreads = 32 * kMaxWarps;

template <typename V>
__device__ __forceinline__ V ld_volatile(const V* p) {
  return *static_cast<const volatile V*>(p);
}

// log_add on alpha and beta in fp64 (see the note at the top), the
// correction term log1pf(expf(-|a - b|)) of the fp32 difference
__device__ __forceinline__ double log_add_d(double a, double b) {
  const double m = fmax(a, b);
  return m + (double)log1pf(expf((float)(-fabs(a - b))));
}

// One cell (t, u) of the beta walk, t < T: b_next = beta[t+1, u], b_right =
// beta[t, u+1], the cell's raw blank / label / alpha (masked here) →
// beta[t, u] and its two occupancies ob / ol (ol formed but not kept at
// u = U). No branch: the scheduler can fill the chain's stalls with the
// occupancies. log_add(term, x) is max(term, x) to the bit: where term is
// NEG, expf of the difference is 0 or log1pf(1) is lost in NEG; at (xl,
// yl), where term is 0, the blank is masked and beta[xl+1, yl] is NEG, so
// x is -2e30. The chain takes one log_add a cell.
struct BetaCell {
  int U, xl, yl;
  double z;
  __device__ __forceinline__ double operator()(int t, int u, float blank,
                                               float label, float a,
                                               double b_next, double b_right,
                                               float& ob, float& ol) const {
    const float bm = (t < xl && u <= yl) ? blank : kNeg;
    const float lm = (t < xl && u < yl) ? label : kNeg;
    ob = expf((float)((double)a + bm + b_next - z));
    ol = expf((float)((double)a + lm + b_right - z));
    const double term = (t == xl && u == yl) ? 0.0 : (double)kNeg;
    const double v = fmax(term, bm + b_next);
    return u < U ? log_add_d(v, lm + b_right) : v;
  }
};

// Each lane loads its cells' inputs Depth diagonals ahead into registers.
template <int K>
struct Depth {
  static constexpr int value = K >= 8 ? 2 : 4;
};

// One cell (t, u) of the alpha walk, 0 <= t <= T: up = alpha[t-1, u] (NEG
// above the lattice), left = alpha[t, u-1] (NEG left of it), the cell's raw
// blank[t-1, u] and label[t, u-1] (masked here as masked_transitions masks
// them: blank at t - 1 < xl, u <= yl; label at t < xl, u - 1 < yl, so no
// label transition at t = T) → alpha[t, u]. No branch. A masked transition
// adds nothing to the bit: log_add(x, NEG-ish) is x, expf of the difference
// being 0. The chain takes one log_add a cell.
struct AlphaCell {
  int xl, yl;
  __device__ __forceinline__ double operator()(int t, int u, float blank,
                                               float label, double up,
                                               double left) const {
    const float bm = (t >= 1 && t <= xl && u <= yl) ? blank : kNeg;
    const float lm = (t < xl && u >= 1 && u <= yl) ? label : kNeg;
    const double v = log_add_d(up + bm, left + lm);
    return (t == 0 && u == 0) ? 0.0 : v;
  }
};

// K9, the alpha walk: K10's wavefront run forwards (see the note at the top)
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
lattice_alpha_kernel(const float* __restrict__ blank,
                     const float* __restrict__ label,
                     const int* __restrict__ xlen,
                     const int* __restrict__ ylen,
                     float* __restrict__ alpha, float* __restrict__ logz,
                     int T, int U1) {
  // diagonals loaded ahead: two steps of the chain (~1 us) outlast the
  // loads, and ran 4 % faster than four at the E6D2 lattice on the H100
  // (PERF.md §6)
  constexpr int P = 2;
  __shared__ double ring[kMaxWarps][kRing];
  __shared__ int done[kMaxWarps];
  const int b = blockIdx.x;
  const int U = U1 - 1;
  const int W = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // one utterance's lattice: int offsets within it
  const float* bl = blank + (size_t)b * T * U1;
  const float* la = label + (size_t)b * T * U;
  float* al = alpha + (size_t)b * (T + 1) * U1;
  // clamped as logZ's index is; the masks are the same as the raw lengths'
  const int xl = min(max(xlen[b], 0), T), yl = min(max(ylen[b], 0), U);
  const AlphaCell cell{xl, yl};
  const int u0 = 32 * K * w + lane;       // the lane's item k: u0 + 32 k
  const int steps = T + U + 1;            // step s forms diagonal t + u = s
  if (lane == 0) done[w] = 0;
  __syncthreads();

  int ahead = 0, behind = 0;  // the neighbours' flags as last read
  // this warp's items that exist at all (warp-uniform)
  int live = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) live += 32 * K * w + 32 * k <= U;
  // item k: whether its column exists, its row t on the current step (one
  // more each step), the offsets of its cell's blank[t-1, u] and label[t,
  // u-1], and alpha[t-1, u]
  bool col[K];
  int t[K], ob_off[K], ol_off[K];
  double up[K];
  float pb[P][K] = {}, pl[P][K] = {};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int u = u0 + 32 * k;
    col[k] = u <= U;
    t[k] = -u;
    ob_off[k] = (t[k] - 1) * U1 + u;
    ol_off[k] = t[k] * U + u - 1;
    up[k] = kNeg;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int tf = t[k] + p;
      if (col[k] && tf >= 1 && tf <= T)
        pb[p][k] = __ldg(bl + ob_off[k] + p * U1);
      if (col[k] && u >= 1 && tf >= 0 && tf < T)
        pl[p][k] = __ldg(la + ol_off[k] + p * U);
    }
  }

  for (int s0 = 0; s0 < steps; s0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int s = s0 + p;
      if (s >= steps) break;
      // warp w-1's lane-31 item-(K-1) alpha of the diagonal before; the flag
      // is read again only when the steps it last showed are used up
      double edge = kNeg;
      if (w > 0 && s > 0) {
        while (ahead < s) ahead = ld_volatile(&done[w - 1]);
        __threadfence_block();
        edge = ld_volatile(&ring[w - 1][(s - 1) & (kRing - 1)]);
      }
      // alpha[t, u-1]: lane l-1's item k, lane 0 lane 31's item k-1
      double left[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const double prev = k > 0 ? up[k - 1] : edge;
        const double send = lane == 31 ? prev : up[k];
        left[k] = __shfl_sync(0xffffffffu, send, (lane + 31) & 31);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= live) break;             // warp-uniform
        // the item's 32 columns from c have cells (0 <= t <= T) on steps
        // c .. c + 31 + T only (warp-uniform)
        const int c = 32 * K * w + 32 * k, u = u0 + 32 * k, tk = t[k];
        if (s >= c && s <= c + 31 + T) {
          const bool in = col[k] && tk >= 0 && tk <= T;
          const double v = cell(tk, u, pb[p][k], pl[p][k], up[k], left[k]);
          if (in) {
            const float v32 = (float)v;
            al[ob_off[k] + U1] = v32;
            // logZ is the stored alpha[xl, yl], bit for bit
            if (tk == xl && u == yl) logz[b] = v32;
          }
          up[k] = in ? v : up[k];
        }
        // the inputs of the cell P steps on, into this step's slot
        const int tf = tk + P;
        if (col[k] && tf >= 1 && tf <= T)
          pb[p][k] = __ldg(bl + ob_off[k] + P * U1);
        if (col[k] && u >= 1 && tf >= 0 && tf < T)
          pl[p][k] = __ldg(la + ol_off[k] + P * U);
        t[k] = tk + 1;
        ob_off[k] += U1;
        ol_off[k] += U;
      }
      if (W > 1) {
        if (lane == 31) {
          if (w + 1 < W) {
            // the slot's last reader, warp w+1 at step s - kRing + 1, is done
            while (behind < s - kRing + 2) behind = ld_volatile(&done[w + 1]);
            ring[w][s & (kRing - 1)] = up[K - 1];
          }
          __threadfence_block();
          *static_cast<volatile int*>(&done[w]) = s + 1;
        }
        __syncwarp();
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
lattice_beta_grad_kernel(const float* __restrict__ blank,
                         const float* __restrict__ label,
                         const float* __restrict__ alpha,
                         const float* __restrict__ logz,
                         const int* __restrict__ xlen,
                         const int* __restrict__ ylen,
                         float* __restrict__ gb, float* __restrict__ gl,
                         int T, int U1) {
  constexpr int P = Depth<K>::value;      // diagonals loaded ahead
  __shared__ double ring[kMaxWarps][kRing];
  __shared__ int done[kMaxWarps];
  const int b = blockIdx.x;
  const int U = U1 - 1;
  const int W = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // one utterance's lattice: int offsets within it
  const float* bl = blank + (size_t)b * T * U1;
  const float* la = label + (size_t)b * T * U;
  const float* al = alpha + (size_t)b * (T + 1) * U1;
  float* gbb = gb + (size_t)b * T * U1;
  float* glb = gl + (size_t)b * T * U;
  const int xl = xlen[b], yl = ylen[b];
  const BetaCell cell{U, xl, yl, (double)logz[b]};
  const int u0 = 32 * K * w + lane;       // the lane's item k: u0 + 32 k
  const int steps = T + U + 1;            // step s walks diagonal T + U - s
  if (lane == 0) done[w] = 0;
  __syncthreads();

  int ahead = 0, behind = 0;  // the neighbours' flags as last read
  // this warp's items that exist at all (warp-uniform)
  int live = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) live += 32 * K * w + 32 * k <= U;
  // item k: whether its column exists, its row t on the current step (one
  // less each step) and its cell's offsets in blank / alpha and in label
  bool col[K];
  int t[K], ob_off[K], ol_off[K];
  double be[K];
  float pb[P][K] = {}, pl[P][K] = {}, pa[P][K] = {};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int u = u0 + 32 * k;
    col[k] = u <= U;
    t[k] = T + U - u;
    ob_off[k] = t[k] * U1 + u;
    ol_off[k] = t[k] * U + u;
    be[k] = kNeg;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int tf = t[k] - p;
      if (col[k] && tf >= 0 && tf < T) {
        pb[p][k] = __ldg(bl + ob_off[k] - p * U1);
        pa[p][k] = __ldg(al + ob_off[k] - p * U1);
        if (u < U) pl[p][k] = __ldg(la + ol_off[k] - p * U);
      }
    }
  }

  for (int s0 = 0; s0 < steps; s0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int s = s0 + p;
      if (s >= steps) break;
      // warp w+1's item-0 lane-0 beta of the diagonal before; the flag is
      // read again only when the steps it last showed are used up
      double edge = kNeg;
      if (w + 1 < W && s > 0) {
        while (ahead < s) ahead = ld_volatile(&done[w + 1]);
        __threadfence_block();
        edge = ld_volatile(&ring[w + 1][(s - 1) & (kRing - 1)]);
      }
      // beta[t, u+1]: lane l+1's item k, lane 31 lane 0's item k+1
      double right[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const double next = k + 1 < K ? be[k + 1] : edge;
        const double send = lane == 0 ? next : be[k];
        right[k] = __shfl_sync(0xffffffffu, send, (lane + 1) & 31);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= live) break;             // warp-uniform
        // the item's 32 columns from c have cells (0 <= t <= T) on steps
        // U - c - 31 .. T + U - c only (warp-uniform)
        const int c = 32 * K * w + 32 * k, u = u0 + 32 * k, tk = t[k];
        if (s >= U - c - 31 && s <= T + U - c) {
          const bool inner = col[k] && tk >= 0 && tk < T;
          float ob, ol;
          const double v = cell(tk, u, pb[p][k], pl[p][k], pa[p][k], be[k],
                                right[k], ob, ol);
          if (inner) gbb[ob_off[k]] = ob;
          if (inner && u < U) glb[ol_off[k]] = ol;
          // the terminal row t = T holds the term alone
          const double top = (tk == xl && u == yl) ? 0.0 : (double)kNeg;
          be[k] = inner ? v : (col[k] && tk == T ? top : be[k]);
        }
        // the inputs of the cell P steps on, into this step's slot
        const int tf = tk - P;
        if (s + P >= U - c - 31 && col[k] && tf >= 0 && tf < T) {
          pb[p][k] = __ldg(bl + ob_off[k] - P * U1);
          pa[p][k] = __ldg(al + ob_off[k] - P * U1);
          if (u < U) pl[p][k] = __ldg(la + ol_off[k] - P * U);
        }
        t[k] = tk - 1;
        ob_off[k] -= U1;
        ol_off[k] -= U;
      }
      if (W > 1) {
        if (lane == 0) {
          if (w > 0) {
            // the slot's last reader, warp w-1 at step s - kRing + 1, is done
            while (behind < s - kRing + 2) behind = ld_volatile(&done[w - 1]);
            ring[w][s & (kRing - 1)] = be[0];
          }
          __threadfence_block();
          *static_cast<volatile int*>(&done[w]) = s + 1;
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// blank (B, T, U1), label (B, T, U1 - 1) fp32 raw log-probs (masked here),
// xlen/ylen (B) int32 → alpha (B, T + 1, U1), logz (B) fp32. `warps` x 32 x
// `items` >= U1 columns per block, from the wrapper's plan (ops/
// rnnt_loss_kernel.py beta_plan, K10's).
extern "C" int edd_lattice_alpha(const void* blank, const void* label,
                                 const void* xlen, const void* ylen,
                                 void* alpha, void* logz, int B, int T,
                                 int U1, int warps, int items, void* stream) {
  if (warps < 1 || warps > kMaxWarps || 32 * warps * items < U1)
    return (int)cudaErrorInvalidValue;
  const float* bl = static_cast<const float*>(blank);
  const float* la = static_cast<const float*>(label);
  const int* xl = static_cast<const int*>(xlen);
  const int* yl = static_cast<const int*>(ylen);
  float* al = static_cast<float*>(alpha);
  float* lz = static_cast<float*>(logz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B), block(32 * warps);
  switch (items) {
    case 1:
      lattice_alpha_kernel<1><<<grid, block, 0, s>>>(bl, la, xl, yl, al, lz,
                                                      T, U1);
      break;
    case 2:
      lattice_alpha_kernel<2><<<grid, block, 0, s>>>(bl, la, xl, yl, al, lz,
                                                      T, U1);
      break;
    case 4:
      lattice_alpha_kernel<4><<<grid, block, 0, s>>>(bl, la, xl, yl, al, lz,
                                                      T, U1);
      break;
    case 8:
      lattice_alpha_kernel<8><<<grid, block, 0, s>>>(bl, la, xl, yl, al, lz,
                                                      T, U1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// + alpha, logz from edd_lattice_alpha → gb (B, T, U1), gl (B, T, U1 - 1)
// fp32 occupancies. `warps` x 32 x `items` >= U1 columns per block, from
// the wrapper's plan (ops/rnnt_loss_kernel.py beta_plan).
extern "C" int edd_lattice_beta_grad(const void* blank, const void* label,
                                     const void* alpha, const void* logz,
                                     const void* xlen, const void* ylen,
                                     void* gb, void* gl, int B, int T,
                                     int U1, int warps, int items,
                                     void* stream) {
  if (warps < 1 || warps > kMaxWarps || 32 * warps * items < U1)
    return (int)cudaErrorInvalidValue;
  const float* bl = static_cast<const float*>(blank);
  const float* la = static_cast<const float*>(label);
  const float* al = static_cast<const float*>(alpha);
  const float* lz = static_cast<const float*>(logz);
  const int* xl = static_cast<const int*>(xlen);
  const int* yl = static_cast<const int*>(ylen);
  float* g1 = static_cast<float*>(gb);
  float* g2 = static_cast<float*>(gl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B), block(32 * warps);
  switch (items) {
    case 1:
      lattice_beta_grad_kernel<1><<<grid, block, 0, s>>>(
          bl, la, al, lz, xl, yl, g1, g2, T, U1);
      break;
    case 2:
      lattice_beta_grad_kernel<2><<<grid, block, 0, s>>>(
          bl, la, al, lz, xl, yl, g1, g2, T, U1);
      break;
    case 4:
      lattice_beta_grad_kernel<4><<<grid, block, 0, s>>>(
          bl, la, al, lz, xl, yl, g1, g2, T, U1);
      break;
    case 8:
      lattice_beta_grad_kernel<8><<<grid, block, 0, s>>>(
          bl, la, al, lz, xl, yl, g1, g2, T, U1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
