"""LSTM and GRU layers (counterpart of edgedict_tpu/ops/rnn.py).

Layer params are dicts of tensors with the JAX package's names and torch's
layouts: {'w_ih' (nH, in), 'w_hh' (nH, H), 'b_ih' (nH), 'b_hh' (nH)}, with
n = 4 and gate order i,f,g,o for the LSTM, n = 3 and torch's r,z,n for the
GRU.  The input projection for the whole sequence is one matmul (as
rnn_pallas.py computes it outside its kernels); only the h W_hh^T
recurrence runs step by step, in ops/rnn_kernel.py (LSTM: K1, backward
K4) and ops/gru_kernel.py (GRU: K5, backward K6), plain loops on the CPU.
State is fp32.

Params holding int8 leaves ('w_hh_q', built by
stream.prepare_inference_params(quantize='int8')) route to the quantized
layers of ops/quant.py, as the JAX layers do (rnn.py:227).
"""

import torch

from edgedict_tpu_torch.ops import quant
from edgedict_tpu_torch.ops.gru_kernel import gru_recurrence
from edgedict_tpu_torch.ops.layers import dropout as dropout_fn
from edgedict_tpu_torch.ops.layers import linear
from edgedict_tpu_torch.ops.rnn_kernel import lstm_recurrence


def _cell_init(n_gates, input_size, hidden_size, generator):
    """PyTorch-style init U(-1/sqrt(H), 1/sqrt(H)) for all four tensors, on
    the CPU."""
    k = 1.0 / hidden_size ** 0.5

    def u(*shape):
        return torch.empty(*shape).uniform_(-k, k, generator=generator)

    rows = n_gates * hidden_size
    return {'w_ih': u(rows, input_size), 'w_hh': u(rows, hidden_size),
            'b_ih': u(rows), 'b_hh': u(rows)}


def lstm_init(input_size, hidden_size, generator):
    return _cell_init(4, input_size, hidden_size, generator)


def gru_init(input_size, hidden_size, generator):
    return _cell_init(3, input_size, hidden_size, generator)


def lstm_layer_tm(params, xs, state):
    """Time-major single-layer LSTM: xs (T, B, in) → (ys (T, B, H), (h, c)).

    The bias is (b_ih + b_hh) summed in the param dtype, then applied with
    the fp32-accumulated projection (rnn.py:245); x_proj is stored in xs's
    dtype and W_hh is used in xs's dtype (bf16 serving halves both), the
    recurrence itself accumulating in fp32."""
    if 'w_hh_q' in params:
        return quant.lstm_layer_tm_q(params, xs, state)
    h0, c0 = state
    dtype = xs.dtype
    bias = params['b_ih'] + params['b_hh']
    x_proj = linear(xs, params['w_ih'], bias.float()).contiguous()
    ys, cs, h = lstm_recurrence(x_proj, params['w_hh'].to(dtype).contiguous(),
                                h0.float().contiguous(),
                                c0.float().contiguous())
    return ys, (h.to(h0.dtype), cs[-1].to(c0.dtype))


def lstm_layer(params, xs, state):
    """Batch-major single-layer LSTM: xs (B, T, in) → (ys (B, T, H),
    (h, c))."""
    ys, st = lstm_layer_tm(params, xs.transpose(0, 1), state)
    return ys.transpose(0, 1), st


def stacked_lstm(layers, xs, state, dropout=0.0, generator=None):
    """Multi-layer LSTM (torch nn.LSTM(num_layers=L) equivalent), batch-
    major.  state: (h, c) each (L, B, H).  Inverted dropout between layers
    (not after the last), drawn from `generator`, when dropout > 0 and a
    generator is given (rnn.py:336-350)."""
    hs, cs = state
    new_h, new_c = [], []
    for i, layer in enumerate(layers):
        xs, (h, c) = lstm_layer(layer, xs, (hs[i], cs[i]))
        new_h.append(h)
        new_c.append(c)
        if dropout > 0 and generator is not None and i < len(layers) - 1:
            xs = dropout_fn(xs, dropout, False, generator)
    return xs, (torch.stack(new_h), torch.stack(new_c))


def lstm_zero_state(num_layers, batch, hidden, device):
    shape = (num_layers, batch, hidden)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))


def gru_layer_tm(params, xs, state):
    """Time-major single-layer GRU: xs (T, B, in) → (ys (T, B, H), hT).

    x_proj = x W_ih^T + b_ih with fp32 accumulation, stored in xs's dtype
    (rnn_pallas.py:gru_layer_tm); b_hh joins the recurrent product inside
    the reset gate, in fp32; hT is ys[-1] (its own output of the
    recurrence, whose cotangent joins the backward at t = T-1)."""
    if 'w_hh_q' in params:
        return quant.gru_layer_tm_q(params, xs, state)
    dtype = xs.dtype
    x_proj = linear(xs, params['w_ih'], params['b_ih'].float()).contiguous()
    ys, h = gru_recurrence(x_proj, params['w_hh'].to(dtype).contiguous(),
                           params['b_hh'].float().contiguous(),
                           state.float().contiguous())
    return ys, h.to(state.dtype)


def gru_zero_state(num_layers, batch, hidden, device):
    return torch.zeros((num_layers, batch, hidden), device=device)
