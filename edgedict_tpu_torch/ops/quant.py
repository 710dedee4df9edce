"""Int8 weight-only serving of the encoder (counterpart of
edgedict_tpu/ops/quant.py): K11 (int8-weight matrix product,
csrc/quant_matmul.cu), K12 (int8 LSTM recurrence, csrc/lstm_fwd.cu) and K13
(int8 GRU recurrence, csrc/gru_fwd.cu).

Symmetric per-output-channel int8 weights: scale = absmax / 127 (1 for an
all-zero channel), q = round(w / scale) in [-127, 127], from the fp32
weights, once, at decoder construction (`quantize_encoder`).  Weight-only:
activations stay in the serving dtype (fp32 or bf16), there is no
calibration.  Only the encoder is quantized; the prediction net and the
joint stay fp32, so the greedy token loop keeps its fp32 arithmetic.  The
quantized encoder drops its float W_ih, W_hh and projection weight: it
holds a quarter of the fp32 encoder's weight bytes.

Numerics, as the TPU kernels define them:
  * K11 (x_proj of every layer and the final projection): products of x
    and q in fp32, the fp32 scale applied to the ACCUMULATOR, then the fp32
    bias, then the cast to x's dtype;
  * K12 / K13 (the recurrences): W_hh dequantized as q * scale in fp32 and
    ROUNDED TO THE COMPUTE DTYPE, then multiplied by h cast to that dtype
    with fp32 accumulation (not scale-after-accumulate: in bf16 the two
    differ).
Each kernel has its plain PyTorch version here; CPU tensors run it, CUDA
tensors launch the kernel.  The weights keep torch's (out, in) layout: one
row, and one scale, per output channel (the JAX package stores the
transpose).  Inference only.  The TPU kernels' padding (int8 sublane rows,
batch rows to 8), their shape gates and the route to XLA above 4096 rows
have no counterpart: the CUDA kernels take any shape.
"""

import torch
import torch.nn as nn

from edgedict_tpu_torch import _build
from edgedict_tpu_torch.ops.gru_kernel import (
    check_gru_args, gru_recurrence_plain)
from edgedict_tpu_torch.ops.rnn_kernel import lstm_recurrence_plain

FLOATS = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# quantization (once per decoder construction)
# ---------------------------------------------------------------------------

def quantize_int8(w):
    """w (N, K) float, one row per output channel → (q (N, K) int8, scale
    (N,) fp32): scale = absmax / 127 per row (1 for an all-zero row), q =
    round(w / scale), half to even, clipped to [-127, 127]."""
    w = w.detach().float()
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q, scale, dtype):
    """q * scale in fp32, rounded to `dtype` (the TPU recurrences' W_hh)."""
    return (q.float() * scale[:, None]).to(dtype)


class QuantRNN(nn.Module):
    """One int8 encoder layer (LSTM or GRU): w_ih_q (nH, in) / w_ih_scale
    (nH,), w_hh_q (nH, H) / w_hh_scale (nH,), float b_ih, b_hh.  `layer(0)`
    gives the params dict ops/rnn.py routes to the quantized layers."""

    def __init__(self, rnn):
        super().__init__()
        for name, key in (('w_ih', 'weight_ih_l0'), ('w_hh', 'weight_hh_l0')):
            q, s = quantize_int8(getattr(rnn, key))
            self.register_buffer(name + '_q', q)
            self.register_buffer(name + '_scale', s)
        self.register_buffer('b_ih', rnn.bias_ih_l0.detach().clone())
        self.register_buffer('b_hh', rnn.bias_hh_l0.detach().clone())

    def layer(self, k):
        assert k == 0
        return {'w_ih_q': self.w_ih_q, 'w_ih_scale': self.w_ih_scale,
                'w_hh_q': self.w_hh_q, 'w_hh_scale': self.w_hh_scale,
                'b_ih': self.b_ih, 'b_hh': self.b_hh}


class QuantLinear(nn.Module):
    """An int8 Linear: w_q (N, K), scale (N,), float bias (N,)."""

    def __init__(self, linear):
        super().__init__()
        q, s = quantize_int8(linear.weight)
        self.register_buffer('w_q', q)
        self.register_buffer('scale', s)
        self.register_buffer('bias', linear.bias.detach().clone())


class _Stack(nn.Module):
    def __init__(self, lstms, projs):
        super().__init__()
        self.lstms = lstms
        self.projs = projs


class QuantEncoder(nn.Module):
    """The int8 encoder: the attribute tree of models/transducer.py's
    Encoder (norm, lstm.lstms[i], lstm.projs[i], proj), so encoder_apply
    runs it unchanged."""

    def __init__(self, encoder):
        super().__init__()
        self.norm = encoder.norm
        self.lstm = _Stack(nn.ModuleList(QuantRNN(r)
                                         for r in encoder.lstm.lstms),
                           encoder.lstm.projs)
        self.proj = QuantLinear(encoder.proj)


def quantize_encoder(encoder):
    """models/transducer.py Encoder (fp32) → QuantEncoder: W_ih, W_hh and
    the projection weight become int8 + fp32 scales, biases and
    LayerNorms pass through (quant.py:quantize_encoder of the JAX
    package, without its int8 sublane row padding)."""
    return QuantEncoder(encoder).requires_grad_(False)


def cast_passthrough(qenc, dtype):
    """Cast the quantized encoder's float pass-through tensors (biases,
    LayerNorms) to `dtype` in place, leaving the int8 weights and the fp32
    scales as they are: the quantized values do not depend on the serving
    dtype.  → qenc."""
    for module in qenc.modules():
        for name, p in module.named_parameters(recurse=False):
            p.data = p.data.to(dtype)
        for name, b in list(module.named_buffers(recurse=False)):
            if b.is_floating_point() and not name.endswith('scale'):
                setattr(module, name, b.to(dtype))
    return qenc


def module_bytes(module):
    """Bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size() for t in
               list(module.parameters()) + list(module.buffers()))


# ---------------------------------------------------------------------------
# K11 — int8-weight matrix product
# ---------------------------------------------------------------------------

def quant_matmul_plain(x2d, wq, scale, bias):
    """x2d (R, K) fp32/bf16, wq (N, K) int8, scale (N,) and bias (N,) fp32
    → (R, N) in x2d's dtype: (x q^T in fp32) * scale + bias, then cast."""
    y = x2d.float() @ wq.float().t()
    return (y * scale + bias).to(x2d.dtype)


GEMV_MAX_ROWS = 32     # up to this many rows: the matrix-vector kernel
TILE_ROWS = 64         # output rows per block of the tiled kernels
TILE_COLS = 128        # output channels per block of the tiled kernels


def quant_plan(rows, k, n):
    """K11's launch shape for x (rows, k) . q (n, k)^T → True for the
    tiled kernels (TILE_ROWS x TILE_COLS outputs a block, rows > 32), False
    for the matrix-vector kernel, in either dtype.  ValueError for an empty
    or negative shape."""
    if rows < 1 or k < 1 or n < 1:
        raise ValueError(f'quant_matmul: no plan for R={rows} K={k} N={n}')
    return rows > GEMV_MAX_ROWS


def _quant_matmul_kernel(x2d, wq, scale, bias):
    _build.require_cuda(x2d, 'x', FLOATS)
    _build.require_cuda(wq, 'w_q', (torch.int8,))
    _build.require_cuda(scale, 'scale', (torch.float32,))
    _build.require_cuda(bias, 'bias', (torch.float32,))
    r, k = x2d.shape
    n = wq.shape[0]
    if wq.shape != (n, k) or scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f'quant_matmul: shapes x {tuple(x2d.shape)} w_q '
                         f'{tuple(wq.shape)} scale {tuple(scale.shape)} bias '
                         f'{tuple(bias.shape)}')
    out = torch.empty((r, n), dtype=x2d.dtype, device=x2d.device)
    if r == 0:
        return out
    bf16 = x2d.dtype == torch.bfloat16
    tiled = quant_plan(r, k, n)
    p = _build.ptr
    _build.check(_build.library().edd_quant_matmul(
        p(x2d), p(wq), p(scale), p(bias), p(out), r, k, n, int(bf16),
        int(tiled), _build.stream_ptr(x2d.device)), 'quant_matmul')
    quant_matmul.launches += 1
    quant_matmul.tile_launches += tiled
    return out


def quant_matmul(x2d, wq, scale, bias):
    """See quant_matmul_plain; CUDA tensors launch csrc/quant_matmul.cu
    (K11).  `launches` counts every launch, `tile_launches` those of the
    tiled kernels (rows > 32)."""
    if x2d.device.type == 'cpu':
        return quant_matmul_plain(x2d, wq, scale, bias)
    return _quant_matmul_kernel(x2d, wq, scale, bias)


quant_matmul.launches = 0
quant_matmul.tile_launches = 0


def quant_linear(proj, x):
    """The int8 counterpart of ops/layers.py:linear on a QuantLinear: x
    (..., K) → (..., N) in x's dtype."""
    lead = x.shape[:-1]
    y = quant_matmul(x.reshape(-1, x.shape[-1]).contiguous(), proj.w_q,
                     proj.scale, proj.bias.float().contiguous())
    return y.reshape(*lead, y.shape[-1])


# ---------------------------------------------------------------------------
# K12 — int8 LSTM recurrence
# ---------------------------------------------------------------------------

def lstm_recurrence_q_plain(x_proj, w_q, w_scale, h0, c0):
    """x_proj (T, B, 4H) fp32/bf16 incl. bias, w_q (4H, H) int8, w_scale
    (4H,) fp32, h0/c0 (B, H) fp32 → (ys, cs, hT) as
    ops/rnn_kernel.py:lstm_recurrence_plain with W_hh dequantized to
    x_proj's dtype."""
    return lstm_recurrence_plain(x_proj, dequantize(w_q, w_scale,
                                                    x_proj.dtype), h0, c0)


def _lstm_fwd_q_kernel(x_proj, w_q, w_scale, h0, c0):
    _build.require_cuda(x_proj, 'x_proj', FLOATS)
    _build.require_cuda(w_q, 'w_q', (torch.int8,))
    _build.require_cuda(w_scale, 'w_scale', (torch.float32,))
    _build.require_cuda(h0, 'h0', (torch.float32,))
    _build.require_cuda(c0, 'c0', (torch.float32,))
    t, b, h4 = x_proj.shape
    hid = h4 // 4
    if t < 1 or b < 1 or h4 != 4 * hid or w_q.shape != (h4, hid) \
            or w_scale.shape != (h4,) or h0.shape != (b, hid) \
            or c0.shape != (b, hid):
        raise ValueError('lstm_recurrence_q: shapes x_proj '
                         f'{tuple(x_proj.shape)} w_q {tuple(w_q.shape)} '
                         f'w_scale {tuple(w_scale.shape)} h0 '
                         f'{tuple(h0.shape)} c0 {tuple(c0.shape)}')
    dev = x_proj.device
    ys = torch.empty((t, b, hid), dtype=x_proj.dtype, device=dev)
    cs = torch.empty((t, b, hid), dtype=torch.float32, device=dev)
    hbuf = torch.empty((2, b, hid), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.check(_build.library().edd_lstm_fwd_q(
        p(x_proj), p(w_q), p(w_scale), p(h0), p(c0), p(ys), p(cs), p(hbuf),
        t, b, hid, int(x_proj.dtype == torch.bfloat16),
        _build.stream_ptr(dev)), 'lstm_fwd_q')
    lstm_recurrence_q.launches += 1
    return ys, cs, hbuf[(t - 1) % 2]


def lstm_recurrence_q(x_proj, w_q, w_scale, h0, c0):
    """See lstm_recurrence_q_plain; CUDA tensors launch csrc/lstm_fwd.cu's
    int8 entry (K12)."""
    if x_proj.device.type == 'cpu':
        return lstm_recurrence_q_plain(x_proj, w_q, w_scale, h0, c0)
    return _lstm_fwd_q_kernel(x_proj, w_q, w_scale, h0, c0)


lstm_recurrence_q.launches = 0


# ---------------------------------------------------------------------------
# K13 — int8 GRU recurrence
# ---------------------------------------------------------------------------

def gru_recurrence_q_plain(x_proj, w_q, w_scale, b_hh, h0):
    """x_proj (T, B, 3H) incl. b_ih, w_q (3H, H) int8, w_scale (3H,) fp32,
    b_hh (3H,) fp32, h0 (B, H) fp32 → ys (T, B, H), as
    ops/gru_kernel.py:gru_recurrence_plain with W_hh dequantized to
    x_proj's dtype."""
    return gru_recurrence_plain(x_proj, dequantize(w_q, w_scale,
                                                   x_proj.dtype), b_hh, h0)


def _gru_fwd_q_kernel(x_proj, w_q, w_scale, b_hh, h0):
    t, b, hid = check_gru_args(x_proj, w_q, b_hh, h0, (torch.int8,))
    _build.require_cuda(w_scale, 'w_scale', (torch.float32,))
    if w_scale.shape != (3 * hid,):
        raise ValueError(f'gru_recurrence_q: w_scale {tuple(w_scale.shape)}')
    dev = x_proj.device
    ys = torch.empty((t, b, hid), dtype=x_proj.dtype, device=dev)
    hbuf = torch.empty((2, b, hid), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.check(_build.library().edd_gru_fwd_q(
        p(x_proj), p(w_q), p(w_scale), p(b_hh), p(h0), p(ys), p(hbuf), t, b,
        hid, int(x_proj.dtype == torch.bfloat16), _build.stream_ptr(dev)),
        'gru_fwd_q')
    gru_recurrence_q.launches += 1
    return ys


def gru_recurrence_q(x_proj, w_q, w_scale, b_hh, h0):
    """See gru_recurrence_q_plain; CUDA tensors launch csrc/gru_fwd.cu's
    int8 entry (K13)."""
    if x_proj.device.type == 'cpu':
        return gru_recurrence_q_plain(x_proj, w_q, w_scale, b_hh, h0)
    return _gru_fwd_q_kernel(x_proj, w_q, w_scale, b_hh, h0)


gru_recurrence_q.launches = 0


# ---------------------------------------------------------------------------
# quantized layers (ops/rnn.py routes here on int8 params)
# ---------------------------------------------------------------------------

def _x_proj(params, xs, bias):
    t, b, n_in = xs.shape
    x_proj = quant_matmul(xs.reshape(t * b, n_in).contiguous(),
                          params['w_ih_q'], params['w_ih_scale'],
                          bias.float().contiguous())
    return x_proj.reshape(t, b, -1)


def lstm_layer_tm_q(params, xs, state):
    """int8 time-major LSTM layer: xs (T, B, in) → (ys (T, B, H), (hT,
    cT)).  x_proj by K11 with bias b_ih + b_hh (summed in their dtype),
    the recurrence by K12; hT is ys[-1] (quant.py:lstm_layer_tm_q)."""
    h0, c0 = state
    x_proj = _x_proj(params, xs, params['b_ih'] + params['b_hh'])
    ys, cs, _ = lstm_recurrence_q(x_proj, params['w_hh_q'],
                                  params['w_hh_scale'],
                                  h0.float().contiguous(),
                                  c0.float().contiguous())
    return ys, (ys[-1].to(h0.dtype), cs[-1].to(c0.dtype))


def gru_layer_tm_q(params, xs, state):
    """int8 time-major GRU layer: xs (T, B, in) → (ys (T, B, H), hT).
    x_proj by K11 with bias b_ih, the recurrence by K13 with b_hh inside
    the reset gate (quant.py:gru_layer_tm_q)."""
    x_proj = _x_proj(params, xs, params['b_ih'])
    ys = gru_recurrence_q(x_proj, params['w_hh_q'], params['w_hh_scale'],
                          params['b_hh'].float().contiguous(),
                          state.float().contiguous())
    return ys, ys[-1].to(state.dtype)
