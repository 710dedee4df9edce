"""LSTM layers (counterpart of edgedict_tpu/ops/rnn.py, LSTM part).

Layer params are dicts of tensors with the JAX package's names and torch's
layouts: {'w_ih' (4H, in), 'w_hh' (4H, H), 'b_ih' (4H), 'b_hh' (4H)}, gate
order i,f,g,o.  The input projection x W_ih^T + (b_ih + b_hh) for the whole
sequence is one matmul (as rnn_pallas.py:_lstm_xproj computes it outside
its kernel); only the h W_hh^T recurrence runs step by step, in
ops/rnn_kernel.py (plain loop on CPU, K1 on CUDA).  State is fp32.

The GRU encoder option is not ported yet (models/transducer.py refuses it).
"""

import torch

from edgedict_tpu_torch.ops.layers import dropout as dropout_fn
from edgedict_tpu_torch.ops.layers import linear
from edgedict_tpu_torch.ops.rnn_kernel import lstm_recurrence


def lstm_init(input_size, hidden_size, generator):
    """PyTorch-style init U(-1/sqrt(H), 1/sqrt(H)) for all four tensors, on
    the CPU."""
    k = 1.0 / hidden_size ** 0.5

    def u(*shape):
        return torch.empty(*shape).uniform_(-k, k, generator=generator)

    return {'w_ih': u(4 * hidden_size, input_size),
            'w_hh': u(4 * hidden_size, hidden_size),
            'b_ih': u(4 * hidden_size),
            'b_hh': u(4 * hidden_size)}


def lstm_layer_tm(params, xs, state):
    """Time-major single-layer LSTM: xs (T, B, in) → (ys (T, B, H), (h, c)).

    The bias is (b_ih + b_hh) summed in the param dtype, then applied with
    the fp32-accumulated projection (rnn.py:245); x_proj is stored in xs's
    dtype and W_hh is used in xs's dtype (bf16 serving halves both), the
    recurrence itself accumulating in fp32."""
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
