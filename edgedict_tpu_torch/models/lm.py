"""RNN language model for shallow fusion (counterpart of
edgedict_tpu/models/lm.py; the reference LMModel, models.py:224-261).

Embedding → multi-layer LSTM → Linear → log-softmax, with optional weight
tying (the embedding table doubles as the output weight, plus its own
bias `out_b`).  The LSTM runs through ops/rnn.py:stacked_lstm, so on a
CUDA tensor each layer is one K1 launch forward (K4 backward).  The same
state-carrying signature as the prediction net: the beam search threads
the LM state per hypothesis.

State dict keys:

  embed.weight                                   (V, E)
  lstm.{weight_ih_l{k},weight_hh_l{k},bias_ih_l{k},bias_hh_l{k}}
  out.{weight,bias}     (untied)   or   out_b    (tied, (V,))
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from edgedict_tpu_torch.models.transducer import LSTM, Linear
from edgedict_tpu_torch.ops import rnn as rnn_ops
from edgedict_tpu_torch.ops.layers import embedding, linear


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int
    embed_size: int = 256
    hidden_size: int = 512
    num_layers: int = 2
    dropout: float = 0.0          # the checkpoint's field; no dropout runs
    tie_weights: bool = False


class Table(nn.Module):
    """An N(0, 1) embedding table (lm_init's embedding_init without a
    padding row)."""

    def __init__(self, vocab_size, embed_size, generator):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(vocab_size, embed_size, generator=generator))


class LMModel(nn.Module):
    """The LM's parameters, seeded on the CPU (torch.Generator) and then
    moved to `device`, so every device gets the same weights."""

    def __init__(self, cfg: LMConfig, device, seed=0):
        super().__init__()
        if cfg.tie_weights and cfg.embed_size != cfg.hidden_size:
            raise ValueError('tie_weights needs embed_size == hidden_size '
                             '(models.py:239)')
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.embed = Table(cfg.vocab_size, cfg.embed_size, g)
        self.lstm = LSTM(cfg.embed_size, cfg.hidden_size, cfg.num_layers, g)
        if cfg.tie_weights:
            self.out_b = nn.Parameter(torch.zeros(cfg.vocab_size))
        else:
            self.out = Linear(cfg.hidden_size, cfg.vocab_size, g)
        self.to(device)


def lm_zero_state(cfg: LMConfig, batch, device):
    return rnn_ops.lstm_zero_state(cfg.num_layers, batch, cfg.hidden_size,
                                   device)


def lm_apply(model: LMModel, cfg: LMConfig, ys, state=None):
    """ys (B, U) int ids → (fp32 log-probs (B, U, V), new state (h, c) each
    (L, B, H)).  state None means zeros."""
    if state is None:
        state = lm_zero_state(cfg, ys.shape[0], ys.device)
    emb = embedding(model.embed.weight, ys.long())
    out, state = rnn_ops.stacked_lstm(model.lstm.layers(), emb, state)
    if cfg.tie_weights:
        # the table in out's dtype, products accumulated in fp32
        table = model.embed.weight.to(out.dtype)
        logits = out.float() @ table.float().t() + model.out_b.float()
    else:
        logits = linear(out, model.out.weight, model.out.bias)
    return F.log_softmax(logits.float(), dim=-1), state


def lm_loss(model: LMModel, cfg: LMConfig, ys, ylen):
    """Next-token NLL over ys (B, U): predicts ys[:, 1:] from ys[:, :-1] at
    positions < ylen - 1, id 0 ignored (the reference's
    NLLLoss(ignore_index=0))."""
    logp, _ = lm_apply(model, cfg, ys[:, :-1])
    targets = ys[:, 1:].long()
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    pos = torch.arange(targets.shape[1], device=ys.device)[None, :]
    valid = (pos < (ylen - 1)[:, None]) & (targets != 0)
    total = torch.where(valid, nll, 0.0).sum()
    return total / valid.sum().clamp(min=1)


def load_lm_checkpoint(path, device='cpu'):
    """An LM checkpoint → (LMModel on `device`, LMConfig): the port's
    cli.train_lm payload (checkpoint.py, extra['lm_cfg']) or the JAX
    package's flax-msgpack lm.ckpt (its params through
    compat.lm_state_dict_from_jax_params, lm_cfg from its JSON extra;
    edgedict_tpu/models/lm.py:85-100)."""
    from edgedict_tpu_torch.checkpoint import load_checkpoint
    from edgedict_tpu_torch.jax_checkpoint import (
        is_jax_checkpoint, load_jax_checkpoint)
    if is_jax_checkpoint(path):
        from edgedict_tpu_torch.compat import lm_state_dict_from_jax_params
        payload = load_jax_checkpoint(path)
        sd = lm_state_dict_from_jax_params(payload['model'])
    else:
        payload = load_checkpoint(path)
        sd = payload['model']
    cfg = LMConfig(**payload['extra']['lm_cfg'])
    model = LMModel(cfg, device='cpu')
    model.load_state_dict(sd)
    return model.to(device), cfg
