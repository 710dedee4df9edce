"""CTC encoder model (counterpart of edgedict_tpu/models/ctc.py; reference
CTCEncoder, rnnt/models.py:272-310): the transducer's Encoder → Linear →
log-softmax, trained with the CTC loss, greedy decode with consecutive
dedup and blank removal on the host.

The module tree is the JAX params tree: `encoder.*` (the reference key
layout of models/transducer.py) and `tovocab.{weight, bias}`.  The encoder
runs K1 (forward) and K4 (backward) on CUDA, as the transducer's does.

The JAX loss is optax.ctc_loss with pad masks.  `ctc_loss` computes it with
F.ctc_loss for every utterance whose labels fit in its frames (the same
value: optax's log-epsilon paths weigh exp(-1e5) = 0 in fp32), and with
`ctc_loss_plain`, a port of optax's forward recursion, for the rest: where
the labels need more frames than there are (the label count plus the
adjacent repeats), F.ctc_loss gives inf and optax a finite loss through its
log-epsilon transitions, which `ctc_loss_plain` reproduces, gradient
included.
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.models.decoding import ctc_greedy_decode_postprocess
from edgedict_tpu_torch.ops.layers import linear
from edgedict_tpu_torch.tokenizer import NUL

OPTAX_LOG_EPSILON = -1e5       # optax.ctc_loss's default log(+0)


@dataclasses.dataclass(frozen=True)
class CTCConfig:
    vocab_size: int
    input_size: int
    enc_hidden_size: int = 600
    enc_layers: int = 4
    enc_dropout: float = 0.0
    enc_proj_size: int = 600
    blank: int = NUL
    module_type: str = 'LSTM'

    @property
    def encoder_cfg(self):
        return T.TransducerConfig(
            vocab_size=self.vocab_size, input_size=self.input_size,
            enc_hidden_size=self.enc_hidden_size,
            enc_layers=self.enc_layers, enc_dropout=self.enc_dropout,
            enc_proj_size=self.enc_proj_size,
            enc_time_reductions=(1,), module_type=self.module_type)


class CTCModel(nn.Module):
    """Encoder + `tovocab` Linear(enc_proj_size, vocab_size), seeded
    init on the CPU (torch.Generator), then moved to `device`."""

    def __init__(self, cfg: CTCConfig, device, seed=0):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.encoder = T.Encoder(cfg.encoder_cfg, g)
        self.tovocab = T.Linear(cfg.enc_proj_size, cfg.vocab_size, g)
        self.to(device)


def ctc_apply(model: CTCModel, xs, deterministic=True, generator=None):
    """(B, T, F) → fp32 log-probs (B, T', V), T' = ceil(T / 2) (the
    encoder's time reduction after layer 1)."""
    cfg = model.cfg
    h, _ = T.encoder_apply(model.encoder, cfg.encoder_cfg, xs,
                           deterministic=deterministic, generator=generator)
    logits = linear(h, model.tovocab.weight, model.tovocab.bias)
    return torch.log_softmax(logits.float(), dim=-1)


def _logaddexp_tail(phi, added):
    """phi[:, 1:] ⊕ added in log space, phi[:, 0] kept (optax's
    update_phi_score)."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], 1)


def ctc_loss_plain(logp, xlen, labels, ylen, blank=0):
    """Per-utterance CTC loss (B,) by optax.ctc_loss's forward recursion,
    step for step: blank states phi (B, N+1) and label states emit (B, N)
    in log space, log(0) as the finite OPTAX_LOG_EPSILON, frames t >= xlen
    frozen; differentiable by autograd.  logp (B, T, V) is log-softmaxed
    again, as optax treats its input as logits; the recursion runs in fp32
    (fp64 for fp64 input)."""
    b, t_len, _ = logp.shape
    n = labels.shape[1]
    dtype = torch.promote_types(logp.dtype, torch.float32)
    dev = logp.device
    lp = torch.log_softmax(logp.to(dtype), dim=-1)
    labels = labels.long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dtype), (0, 1))
    lp_phi = lp[:, :, blank].t()[:, :, None]                   # (T, B, 1)
    lp_emit = torch.gather(lp, 2, labels[:, None, :].expand(b, t_len, n))
    lp_emit = lp_emit.transpose(0, 1)                          # (T, B, N)
    pad = (torch.arange(t_len, device=dev)[:, None]
           >= xlen.to(dev).long()[None, :]).to(dtype)[:, :, None]
    phi = torch.full((b, n + 1), OPTAX_LOG_EPSILON, dtype=dtype, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), OPTAX_LOG_EPSILON, dtype=dtype, device=dev)
    for t in range(t_len):
        # emit → phi epsilon transition, except into a repeated label
        prev_phi = _logaddexp_tail(phi, emit + OPTAX_LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[t],
                                    emit + lp_emit[t])
        next_phi = _logaddexp_tail(
            prev_phi + lp_phi[t],
            emit + lp_phi[t] + OPTAX_LOG_EPSILON * (1.0 - repeat))
        p = pad[t]
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * phi + (1.0 - p) * next_phi
    last = _logaddexp_tail(phi, emit)
    return -last.gather(1, ylen.to(dev).long()[:, None])[:, 0]


def ctc_frames_needed(labels, ylen):
    """(B,) the fewest frames that can emit each label sequence: its
    length plus one blank between each pair of equal adjacent labels."""
    u = torch.arange(labels.shape[1] - 1, device=labels.device)
    rep = (labels[:, 1:] == labels[:, :-1]) & (u[None] < ylen[:, None] - 1)
    return ylen + rep.sum(1)


def ctc_losses(logp, xlen, labels, ylen, blank=0):
    """Per-utterance CTC loss (B,) with optax.ctc_loss's values: F.ctc_loss
    (reduction='none') where the labels fit in xlen frames, ctc_loss_plain
    on the utterances where they do not (F.ctc_loss's inf and its gradient
    zeroed there by zero_infinity)."""
    xlen, ylen = xlen.long(), ylen.long()
    losses = F.ctc_loss(logp.transpose(0, 1), labels.long(), xlen, ylen,
                        blank=blank, reduction='none', zero_infinity=True)
    short = ctc_frames_needed(labels, ylen) > xlen
    if bool(short.any()):
        idx = short.nonzero()[:, 0]
        plain = ctc_loss_plain(logp[idx], xlen[idx], labels[idx], ylen[idx],
                               blank)
        losses = losses.index_put((idx,), plain)
    return losses


def ctc_loss(model: CTCModel, xs, ys, xlen, ylen, deterministic=True,
             generator=None):
    """Mean CTC loss (ctc.py:56-68): log-probs, frame lengths rescaled by
    the encoder's time reduction, per-utterance losses, their mean."""
    cfg = model.cfg
    logp = ctc_apply(model, xs, deterministic, generator)
    xlen_s = T.scale_length(cfg.encoder_cfg, xlen, xs.shape[1],
                            logp.shape[1])
    return ctc_losses(logp, xlen_s, ys, ylen, cfg.blank).mean()


def ctc_greedy_decode(model: CTCModel, xs, xlen):
    """Greedy decode (ctc.py:71-80): per frame the first maximal token and
    its log-prob, then the host collapse → (list of 1-D int arrays,
    neg_logp (B,))."""
    cfg = model.cfg
    logp = ctc_apply(model, xs)
    xlen_s = T.scale_length(cfg.encoder_cfg, xlen, xs.shape[1],
                            logp.shape[1])
    best_lp, y_seq = logp.max(dim=-1)
    return ctc_greedy_decode_postprocess(y_seq, best_lp, xlen_s,
                                         blank=cfg.blank)
