"""RNN-Transducer model core (counterpart of
edgedict_tpu/models/transducer.py): Encoder, Decoder (prediction net) and
Joint as nn.Modules, plus the state-carrying functions that run them.

The module tree has the reference checkpoint's state_dict key layout
(reference rnnt/models.py:32-179, read by
edgedict_tpu/compat/torch_import.py:52-103), so a reference `.pt` loads
with `load_state_dict`:

  encoder.norm.{weight,bias}
  encoder.lstm.lstms.{i}.{weight_ih_l0,weight_hh_l0,bias_ih_l0,bias_hh_l0}
  encoder.lstm.projs.{i}.0.{weight,bias}          (LayerNorm)
  encoder.proj.{weight,bias}
  decoder.embed.weight
  decoder.lstm.{weight_ih_l{k},weight_hh_l{k},bias_ih_l{k},bias_hh_l{k}}
  decoder.proj.{weight,bias}
  joint.joint.0.{weight,bias}    ((J, E + D): sliced into w_enc / w_dec)
  joint.joint.2.{weight,bias}

The modules only hold parameters; the math is in the plain functions
below (encoder_apply, decoder_apply, joint_apply, ...), which take the
module and carry RNN state explicitly, as the JAX functions do.  Only the
LSTM encoder is ported (`module_type='GRU'` raises).
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from edgedict_tpu.tokenizer import BOS, NUL, PAD
from edgedict_tpu_torch.ops import rnn as rnn_ops
from edgedict_tpu_torch.ops.layers import (
    embedding, layer_norm, linear, linear_init)


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    vocab_size: int
    vocab_embed_size: int = 16
    input_size: int = 240
    enc_hidden_size: int = 600
    enc_layers: int = 4
    enc_proj_size: int = 600
    dec_hidden_size: int = 150
    dec_layers: int = 2
    dec_proj_size: int = 150
    joint_size: int = 512
    enc_time_reductions: Tuple[int, ...] = (1,)
    reduction_factor: int = 2
    blank: int = NUL
    module_type: str = 'LSTM'   # only 'LSTM' is ported

    @property
    def time_scale(self):
        return self.reduction_factor ** len(self.enc_time_reductions)


# ---------------------------------------------------------------------------
# parameter holders (reference key layout)
# ---------------------------------------------------------------------------

def _p(t):
    return nn.Parameter(t)


class LayerNorm(nn.Module):
    def __init__(self, size):
        super().__init__()
        self.weight = _p(torch.ones(size))
        self.bias = _p(torch.zeros(size))


class Linear(nn.Module):
    def __init__(self, in_size, out_size, generator):
        super().__init__()
        w, b = linear_init(in_size, out_size, generator)
        self.weight = _p(w)
        self.bias = _p(b)


class LSTM(nn.Module):
    """Parameters of a torch nn.LSTM (weight_ih_l{k}, ...); `layer(k)`
    gives the ops/rnn.py params dict of layer k."""

    def __init__(self, input_size, hidden_size, num_layers, generator):
        super().__init__()
        self.num_layers = num_layers
        for k in range(num_layers):
            p = rnn_ops.lstm_init(input_size if k == 0 else hidden_size,
                                  hidden_size, generator)
            setattr(self, f'weight_ih_l{k}', _p(p['w_ih']))
            setattr(self, f'weight_hh_l{k}', _p(p['w_hh']))
            setattr(self, f'bias_ih_l{k}', _p(p['b_ih']))
            setattr(self, f'bias_hh_l{k}', _p(p['b_hh']))

    def layer(self, k):
        return {'w_ih': getattr(self, f'weight_ih_l{k}'),
                'w_hh': getattr(self, f'weight_hh_l{k}'),
                'b_ih': getattr(self, f'bias_ih_l{k}'),
                'b_hh': getattr(self, f'bias_hh_l{k}')}

    def layers(self):
        return [self.layer(k) for k in range(self.num_layers)]


class Embedding(nn.Module):
    """N(0, 1) init with the PAD row zeroed (torch nn.Embedding default);
    `embedding` keeps reading the PAD row as zero whatever is stored."""

    def __init__(self, vocab_size, embed_size, generator):
        super().__init__()
        table = torch.randn(vocab_size, embed_size, generator=generator)
        table[PAD] = 0.0
        self.weight = _p(table)


class ResLayerNormLSTM(nn.Module):
    def __init__(self, cfg: 'TransducerConfig', generator):
        super().__init__()
        self.lstms = nn.ModuleList()
        self.projs = nn.ModuleList()
        in_size = cfg.input_size
        for _ in range(cfg.enc_layers):
            self.lstms.append(LSTM(in_size, cfg.enc_hidden_size, 1,
                                   generator))
            self.projs.append(nn.Sequential(LayerNorm(cfg.enc_hidden_size)))
            in_size = cfg.enc_hidden_size


class Encoder(nn.Module):
    def __init__(self, cfg: 'TransducerConfig', generator):
        super().__init__()
        self.norm = LayerNorm(cfg.input_size)
        self.lstm = ResLayerNormLSTM(cfg, generator)
        self.proj = Linear(cfg.enc_hidden_size, cfg.enc_proj_size, generator)


class Decoder(nn.Module):
    def __init__(self, cfg: 'TransducerConfig', generator):
        super().__init__()
        self.embed = Embedding(cfg.vocab_size, cfg.vocab_embed_size,
                               generator)
        self.lstm = LSTM(cfg.vocab_embed_size, cfg.dec_hidden_size,
                         cfg.dec_layers, generator)
        self.proj = Linear(cfg.dec_hidden_size, cfg.dec_proj_size, generator)


class Joint(nn.Module):
    """Linear(E + D, J) → Tanh → Linear(J, V), kept as the reference's
    single first weight; `w_enc` / `w_dec` are column views of it (the
    algebraic split of models/transducer.py's joint)."""

    def __init__(self, cfg: 'TransducerConfig', generator):
        super().__init__()
        self.enc_size = cfg.enc_proj_size
        self.joint = nn.Sequential(
            Linear(cfg.enc_proj_size + cfg.dec_proj_size, cfg.joint_size,
                   generator),
            nn.Tanh(),
            Linear(cfg.joint_size, cfg.vocab_size, generator))

    @property
    def w_enc(self):
        return self.joint[0].weight[:, :self.enc_size]

    @property
    def w_dec(self):
        return self.joint[0].weight[:, self.enc_size:]

    @property
    def b(self):
        return self.joint[0].bias

    @property
    def out(self):
        return self.joint[2]


class Transducer(nn.Module):
    """E/D/J parameter tree with seeded random init (torch.Generator on
    the CPU, then moved to `device`, so every device gets the same
    weights for one seed)."""

    def __init__(self, cfg: TransducerConfig, device, seed=0):
        super().__init__()
        if cfg.module_type != 'LSTM':
            raise NotImplementedError(
                f'module_type={cfg.module_type!r} is not yet ported '
                '(only the LSTM encoder)')
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.encoder = Encoder(cfg, g)
        self.decoder = Decoder(cfg, g)
        self.joint = Joint(cfg, g)
        self.to(device)


# ---------------------------------------------------------------------------
# time reduction
# ---------------------------------------------------------------------------

def time_reduction(xs, factor):
    """Mean-pool the time axis of (B, T, H) by `factor`, zero-padding T to
    divisible (reference rnnt/models.py:16-29)."""
    b, t, h = xs.shape
    pad = (-t) % factor
    if pad:
        xs = torch.cat([xs, xs.new_zeros(b, pad, h)], dim=1)
    return xs.reshape(b, -1, factor, h).mean(dim=2)


def time_reduction_tm(xs, factor):
    """time_reduction for time-major (T, B, H) activations."""
    t, b, h = xs.shape
    pad = (-t) % factor
    if pad:
        xs = torch.cat([xs, xs.new_zeros(pad, b, h)], dim=0)
    return xs.reshape(-1, factor, b, h).mean(dim=1)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encoder_zero_state(cfg: TransducerConfig, batch, device):
    return rnn_ops.lstm_zero_state(cfg.enc_layers, batch,
                                   cfg.enc_hidden_size, device)


def encoder_apply(encoder: Encoder, cfg: TransducerConfig, xs, state=None):
    """xs (B, T, input_size) → (ys (B, T // time_scale, enc_proj_size),
    new state ((L, B, H), (L, B, H))).  state None means zeros.  Runs
    time-major inside, like the JAX encoder."""
    if state is None:
        state = encoder_zero_state(cfg, xs.shape[0], xs.device)
    hs, cs = state
    xs = xs.transpose(0, 1)
    xs = layer_norm(xs, encoder.norm.weight, encoder.norm.bias)
    new_h, new_c = [], []
    for i, (lstm, proj) in enumerate(zip(encoder.lstm.lstms,
                                         encoder.lstm.projs)):
        ys, (h, c) = rnn_ops.lstm_layer_tm(lstm.layer(0), xs, (hs[i], cs[i]))
        new_h.append(h)
        new_c.append(c)
        # residual add from layer 2 on (reference rnnt/models.py:66-69)
        xs = xs + ys if i != 0 else ys
        xs = layer_norm(xs, proj[0].weight, proj[0].bias)
        if i in cfg.enc_time_reductions:
            xs = time_reduction_tm(xs, cfg.reduction_factor)
    xs = linear(xs, encoder.proj.weight, encoder.proj.bias)
    return xs.transpose(0, 1), (torch.stack(new_h), torch.stack(new_c))


# ---------------------------------------------------------------------------
# decoder (prediction network)
# ---------------------------------------------------------------------------

def decoder_zero_state(cfg: TransducerConfig, batch, device):
    return rnn_ops.lstm_zero_state(cfg.dec_layers, batch,
                                   cfg.dec_hidden_size, device)


def decoder_apply(decoder: Decoder, cfg: TransducerConfig, ys, state=None):
    """ys (B, U) int token ids → ((B, U(+1), dec_proj_size), state).  With
    state None a BOS is prepended and the state starts at zero (reference
    rnnt/models.py:150-152); with a state this is a streaming step."""
    if state is None:
        bos = torch.full((ys.shape[0], 1), BOS, dtype=ys.dtype,
                         device=ys.device)
        ys = torch.cat([bos, ys], dim=1)
        state = decoder_zero_state(cfg, ys.shape[0], ys.device)
    emb = embedding(decoder.embed.weight, ys.long(), padding_idx=PAD)
    out, state = rnn_ops.stacked_lstm(decoder.lstm.layers(), emb, state)
    return linear(out, decoder.proj.weight, decoder.proj.bias), state


# ---------------------------------------------------------------------------
# joint network
# ---------------------------------------------------------------------------

def joint_project(joint: Joint, h_enc, h_dec):
    """(f, g): f = h_enc W_e^T, g = h_dec W_d^T + b, each (..., J) in
    h_enc's dtype (fp32 accumulation, bias added in fp32)."""
    dtype = h_enc.dtype
    f = torch.matmul(h_enc, joint.w_enc.to(dtype).t())
    g = torch.matmul(h_dec.to(dtype), joint.w_dec.to(dtype).t()).float() \
        + joint.b.float()
    return f, g.to(dtype)


def joint_apply(joint: Joint, h_enc, h_dec):
    """(B,T,E)/(B,U,D) → (B,T,U,V) lattice; matching lower-rank inputs →
    pointwise joint (reference Joint.forward, rnnt/models.py:169-179)."""
    f, g = joint_project(joint, h_enc, h_dec)
    if h_enc.dim() == 3 and h_dec.dim() == 3:
        h = f[:, :, None, :] + g[:, None, :, :]
    else:
        h = f + g
    return linear(torch.tanh(h), joint.out.weight, joint.out.bias)


# ---------------------------------------------------------------------------
# full transducer
# ---------------------------------------------------------------------------

def scale_length(cfg: TransducerConfig, xlen, t_in, t_out):
    """Frame lengths after in-encoder time reduction (reference
    Transducer.scale_length, rnnt/models.py:223-226)."""
    scale = torch.ceil(torch.tensor(float(t_in)) / t_out)
    return torch.ceil(xlen.float() / scale.to(xlen.device)).to(torch.int32)


def transducer_logits(model: Transducer, cfg: TransducerConfig, xs, ys):
    """Full-lattice logits (B, T', U+1, V) (reference forward with
    output_loss=False)."""
    h_enc, _ = encoder_apply(model.encoder, cfg, xs)
    h_dec, _ = decoder_apply(model.decoder, cfg, ys)
    return joint_apply(model.joint, h_enc, h_dec)
