"""Legacy v1 model family (counterpart of edgedict_tpu/models/legacy.py;
reference models.py and recurrent.py at its top level).

* fast_tanh(x) = x / (1 + |x|), the v1 joint nonlinearity.
* Normalization: `batch_norm` over the feature axis of (B, T, F) (eval:
  running stats; train: batch stats, the updated running stats returned,
  not stored, as the JAX function returns them), `instance_norm`.
* Encoders: ResidualRNN (input LayerNorm → LSTM_0 → [LSTM_i + LayerNorm,
  residual when the widths match] × (L-1) → optional Linear head, an
  optional ×2 time reduction before one layer, state carry) and
  ResidualProj (blocks [Linear →] LSTM → Linear → fast_tanh, residual in
  the ff width).
* RNNModel: BatchNorm → multi-layer LSTM → Linear head, decoded by CTC
  prefix beam search on the host (numpy, as in the JAX package).
* LegacyTransducer: ResidualRNN encoder with its H → H head, embedding
  with the BOS row read as zero, plain LSTM prediction net, joint
  fc2(fast_tanh(fc1(cat(f, g)))) with fc1 applied as its two column blocks
  (f and g are never concatenated), the RNN-T loss through
  ops/rnnt_loss.py's lattice core and a frame-synchronous greedy decode.
* MFCC_: dB-scaled mel power → DCT-II, optional sliding-window CMVN
  (numpy).  The STFT is the plain one (ops/features_kernel.py
  stft_power), as the JAX legacy_mfcc calls the plain STFT and not the
  fused mel-power kernel.

Every LSTM runs through ops/rnn.py: K1 forward and K4 backward on CUDA.
The lattice runs K9 / K10 on CUDA.  Module trees mirror the JAX params
trees, with torch leaf names (compat.legacy_state_dict_from_jax_params).

The v1 token ids (<blank>=0, <bos>=1, <unk>=2, characters from 4) are
tokenizer.LegacyCharTokenizer's; size a legacy vocabulary with its
legacy_vocab_size() (73), since '9' encodes to id 72.
"""

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from edgedict_tpu_torch import features as F
# time_reduction: the v1 TimeReduction (reference recurrent.py:25-39) is
# the transducer's, the same math
from edgedict_tpu_torch.models.transducer import (  # noqa: F401
    LSTM, LayerNorm, Linear, time_reduction, time_reduction_tm)
from edgedict_tpu_torch.ops import rnn as rnn_ops
from edgedict_tpu_torch.ops.features_kernel import stft_power
from edgedict_tpu_torch.ops.layers import embedding, layer_norm, linear

BLANK = 0
BOS = 1   # v1 scheme: <bos>=1 doubles as the padding index


def fast_tanh(x):
    """x / (1 + |x|) (reference models.py:10)."""
    return x / (1.0 + x.abs())


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """nn.BatchNorm1d's parameters and running stats: weight (gamma), bias
    (beta), buffers running_mean, running_var."""

    def __init__(self, num_features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))


def batch_norm(norm: BatchNorm, x, train=False, momentum=0.1, eps=1e-5):
    """Feature-axis batch norm on (B, T, F) in fp32 → (y in x's dtype,
    (running_mean, running_var)).  Eval normalizes with the running stats
    and returns them as they are; train normalizes with the batch's
    (population variance) and returns the running stats updated with the
    unbiased variance, leaving `norm` untouched (the caller stores them)."""
    x32 = x.float()
    if train:
        mean = x32.mean(dim=(0, 1))
        var = x32.var(dim=(0, 1), unbiased=False)
        n = x.shape[0] * x.shape[1]
        unbiased = var * n / max(n - 1, 1)
        stats = ((1 - momentum) * norm.running_mean + momentum * mean,
                 (1 - momentum) * norm.running_var + momentum * unbiased)
    else:
        mean, var = norm.running_mean, norm.running_var
        stats = (mean, var)
    y = (x32 - mean) * torch.rsqrt(var + eps) * norm.weight + norm.bias
    return y.to(x.dtype), stats


def instance_norm(x, eps=1e-5):
    """Per-sample, per-feature normalization over time on (B, T, F), no
    affine parameters (reference NormalizationLayer, recurrent.py:282-290)."""
    x32 = x.float()
    mean = x32.mean(dim=1, keepdim=True)
    var = x32.var(dim=1, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# residual recurrent encoders (reference recurrent.py)
# ---------------------------------------------------------------------------

class ResidualRNN(nn.Module):
    """ResidualRNNModel (reference recurrent.py:138-169): `ln_in`,
    `layers.{i}` (one-layer LSTMs), `lns.{i}` (after layers 1 ..), and with
    out_size a Linear `head`."""

    def __init__(self, input_size, hidden_size, num_layers, generator,
                 out_size=None):
        super().__init__()
        self.ln_in = LayerNorm(input_size)
        self.layers = nn.ModuleList(
            LSTM(input_size if i == 0 else hidden_size, hidden_size, 1,
                 generator) for i in range(num_layers))
        self.lns = nn.ModuleList(LayerNorm(hidden_size)
                                 for _ in range(num_layers - 1))
        self.head = (Linear(hidden_size, out_size, generator)
                     if out_size is not None else None)


def _zero_lstm_state(batch, hidden, device):
    z = torch.zeros((batch, hidden), device=device)
    return z, z


def residual_rnn_apply(model: ResidualRNN, xs, state=None,
                       reduce_before_layer=None):
    """(B, T, in) → (ys (B, T', H or out_size), new state: a list of (h, c)
    per layer).  reduce_before_layer=k mean-pools time ×2 before layer k
    and restarts the state of layers k .. at zero (the time base
    changes).  Runs time-major inside."""
    num_layers = len(model.layers)
    hidden = model.layers[0].weight_hh_l0.shape[1]
    if state is None:
        state = [_zero_lstm_state(xs.shape[0], hidden, xs.device)
                 for _ in range(num_layers)]
    xs = layer_norm(xs.transpose(0, 1), model.ln_in.weight, model.ln_in.bias)
    new_state = []
    for i, lstm in enumerate(model.layers):
        if reduce_before_layer is not None and i == reduce_before_layer:
            xs = time_reduction_tm(xs, 2)
            state = state[:i] + [
                (torch.zeros_like(h), torch.zeros_like(c))
                for h, c in state[i:]]
        ys, st = rnn_ops.lstm_layer_tm(lstm.layer(0), xs, state[i])
        new_state.append(st)
        if i > 0:
            ys = layer_norm(ys, model.lns[i - 1].weight,
                            model.lns[i - 1].bias)
        # residual whenever the widths match (reference recurrent.py:267)
        xs = ys + xs if xs.shape[-1] == ys.shape[-1] else ys
    if model.head is not None:
        xs = linear(xs, model.head.weight, model.head.bias)
    return xs.transpose(0, 1), new_state


class ProjBlock(nn.Module):
    def __init__(self, in_size, hidden_size, ff_dim, generator, proj_in):
        super().__init__()
        self.proj_in = (Linear(ff_dim, hidden_size, generator) if proj_in
                        else None)
        self.rnn = LSTM(in_size, hidden_size, 1, generator)
        self.proj_out = Linear(hidden_size, ff_dim, generator)


class ResidualProj(nn.Module):
    """ResidualProjModel (reference recurrent.py:184-224): `blocks.{i}` of
    [proj_in: Linear(ff → H), from block 1] → rnn: LSTM(H) → proj_out:
    Linear(H → ff) → fast_tanh, residual adds in the ff width; ff_dim
    defaults to hidden_size // 2."""

    def __init__(self, input_size, hidden_size, num_layers, generator,
                 ff_dim=None):
        super().__init__()
        ff_dim = hidden_size // 2 if ff_dim is None else ff_dim
        self.blocks = nn.ModuleList(
            ProjBlock(input_size if i == 0 else hidden_size, hidden_size,
                      ff_dim, generator, proj_in=i > 0)
            for i in range(num_layers))


def residual_proj_apply(model: ResidualProj, xs, state=None):
    """(B, T, in) → (ys (B, T, ff_dim), new state: a list of (h, c))."""
    if state is None:
        state = [_zero_lstm_state(xs.shape[0],
                                  blk.rnn.weight_hh_l0.shape[1], xs.device)
                 for blk in model.blocks]
    xs = xs.transpose(0, 1)
    new_state = []
    for i, blk in enumerate(model.blocks):
        h = (linear(xs, blk.proj_in.weight, blk.proj_in.bias)
             if blk.proj_in is not None else xs)
        h, st = rnn_ops.lstm_layer_tm(blk.rnn.layer(0), h, state[i])
        new_state.append(st)
        h = fast_tanh(linear(h, blk.proj_out.weight, blk.proj_out.bias))
        xs = h + xs if xs.shape[-1] == h.shape[-1] else h
    return xs.transpose(0, 1), new_state


# ---------------------------------------------------------------------------
# RNNModel — CTC-style LSTM tagger (reference models.py:13-44)
# ---------------------------------------------------------------------------

class RNNModel(nn.Module):
    """`norm` (BatchNorm over the input features), `lstm` (num_layers),
    `head` Linear(hidden, vocab); seeded init on the CPU."""

    def __init__(self, input_size, vocab_size, hidden_size, num_layers,
                 device, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.norm = BatchNorm(input_size)
        self.lstm = LSTM(input_size, hidden_size, num_layers, g)
        self.head = Linear(hidden_size, vocab_size, g)
        self.to(device)


def rnn_model_apply(model: RNNModel, xs, state=None, train=False):
    """(B, T, F) → (logits (B, T, V), state ((L, B, H), (L, B, H))).  The
    batch norm runs with its running stats unless train; train's updated
    stats are dropped, as rnn_model_apply drops them in the JAX package."""
    if state is None:
        state = rnn_ops.lstm_zero_state(model.lstm.num_layers, xs.shape[0],
                                        model.lstm.weight_hh_l0.shape[1],
                                        xs.device)
    xs, _ = batch_norm(model.norm, xs, train=train)
    ys, state = rnn_ops.stacked_lstm(model.lstm.layers(), xs, state)
    return linear(ys, model.head.weight, model.head.bias), state


def ctc_prefix_beam_search(logp, beam_width, blank=BLANK):
    """CTC prefix beam search over (T, V) log-probs → (best labels,
    -logp), in float64 on the host (a copy of the JAX package's; the
    reference's RNNModel.beam_search called an undefined `ctc_beam`)."""
    if torch.is_tensor(logp):
        logp = logp.detach().cpu().numpy()
    logp = np.asarray(logp, np.float64)
    t_len, vocab = logp.shape
    neg = -np.inf
    # prefix → (logp ending in blank, logp ending in non-blank)
    beams = {(): (0.0, neg)}
    for t in range(t_len):
        new = {}
        for prefix, (p_b, p_nb) in beams.items():
            p_tot = np.logaddexp(p_b, p_nb)
            # extend with blank: prefix unchanged
            nb_b, nb_nb = new.get(prefix, (neg, neg))
            new[prefix] = (np.logaddexp(nb_b, p_tot + logp[t, blank]), nb_nb)
            for v in range(vocab):
                if v == blank:
                    continue
                ext = prefix + (v,)
                e_b, e_nb = new.get(ext, (neg, neg))
                if prefix and prefix[-1] == v:
                    # a repeated char needs a blank in between to extend
                    new[ext] = (e_b, np.logaddexp(e_nb, p_b + logp[t, v]))
                    # staying on the same char merges into this prefix
                    s_b, s_nb = new.get(prefix, (neg, neg))
                    new[prefix] = (s_b, np.logaddexp(s_nb,
                                                     p_nb + logp[t, v]))
                else:
                    new[ext] = (e_b, np.logaddexp(e_nb, p_tot + logp[t, v]))
        beams = dict(sorted(
            new.items(), key=lambda kv: -np.logaddexp(*kv[1]))[:beam_width])
    best, (p_b, p_nb) = max(beams.items(),
                            key=lambda kv: np.logaddexp(*kv[1]))
    return list(best), -float(np.logaddexp(p_b, p_nb))


# ---------------------------------------------------------------------------
# legacy Transducer (reference models.py:46-117)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LegacyTransducerConfig:
    input_size: int
    vocab_size: int
    vocab_embed_size: int
    hidden_size: int
    num_layers: int
    pred_hidden_size: int = -1     # -1 → hidden_size (reference :53-54)
    pred_num_layers: int = 1
    blank: int = BLANK

    @property
    def pred_hidden(self):
        return (self.hidden_size if self.pred_hidden_size == -1
                else self.pred_hidden_size)


class LegacyTransducer(nn.Module):
    """`encoder` ResidualRNN with its hidden → hidden head (the reference
    creates the head when vocab == hidden, models.py:56), `embed.weight`
    N(0, 1) with the BOS row zeroed, `decoder` LSTM(pred_num_layers),
    `fc1` Linear(H + P, H), `fc2` Linear(H, V); seeded init on the CPU."""

    def __init__(self, cfg: LegacyTransducerConfig, device, seed=0):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.encoder = ResidualRNN(cfg.input_size, cfg.hidden_size,
                                   cfg.num_layers, g,
                                   out_size=cfg.hidden_size)
        table = torch.randn(cfg.vocab_size, cfg.vocab_embed_size,
                            generator=g)
        table[BOS] = 0.0
        self.embed = nn.Module()
        self.embed.weight = nn.Parameter(table)
        self.decoder = LSTM(cfg.vocab_embed_size, cfg.pred_hidden,
                            cfg.pred_num_layers, g)
        self.fc1 = Linear(cfg.hidden_size + cfg.pred_hidden, cfg.hidden_size,
                          g)
        self.fc2 = Linear(cfg.hidden_size, cfg.vocab_size, g)
        self.to(device)


def legacy_joint(model: LegacyTransducer, f, g):
    """fc2(fast_tanh(fc1(cat(f, g)))) as fc1's two column blocks: h = f
    W1[:, :H]^T + g W1[:, H:]^T + b1 with fp32 accumulation, so f
    (..., T, 1, H) and g (..., 1, U, P) broadcast into the (..., T, U, H)
    hidden without a concatenated input; the hidden is fp32, fc2 runs in
    f's dtype."""
    w = model.fc1.weight
    hid = f.shape[-1]
    h_f = torch.matmul(f, w[:, :hid].to(f.dtype).t()).float()
    h_g = torch.matmul(g, w[:, hid:].to(g.dtype).t()).float()
    h = fast_tanh(h_f + h_g + model.fc1.bias.float())
    return linear(h.to(f.dtype), model.fc2.weight, model.fc2.bias)


def _decoder_states(model: LegacyTransducer, ys):
    """BOS-prepended prediction-net outputs (B, U+1, P)."""
    cfg = model.cfg
    bos = torch.full((ys.shape[0], 1), BOS, dtype=torch.long,
                     device=ys.device)
    emb = embedding(model.embed.weight, torch.cat([bos, ys.long()], 1),
                    padding_idx=BOS)
    state = rnn_ops.lstm_zero_state(cfg.pred_num_layers, ys.shape[0],
                                    cfg.pred_hidden, ys.device)
    ymat, _ = rnn_ops.stacked_lstm(model.decoder.layers(), emb, state)
    return ymat


def legacy_transducer_logits(model: LegacyTransducer, xs, ys):
    """(B, T, U+1, V) joint logits (reference forward, models.py:73-86)."""
    h_enc, _ = residual_rnn_apply(model.encoder, xs)
    ymat = _decoder_states(model, ys)
    return legacy_joint(model, h_enc[:, :, None, :], ymat[:, None, :, :])


def legacy_transducer_loss(model: LegacyTransducer, xs, ys, xlen, ylen):
    """Mean RNN-T loss of the log-softmaxed logits through ops/rnnt_loss.py
    rnnt_loss (its lattice core: K9 / K10 on CUDA)."""
    from edgedict_tpu_torch.ops.rnnt_loss import rnnt_loss
    logits = legacy_transducer_logits(model, xs, ys)
    return rnnt_loss(torch.log_softmax(logits.float(), dim=-1), ys, xlen,
                     ylen, blank=model.cfg.blank).mean()


def legacy_greedy_decode(model: LegacyTransducer, xs, xlen):
    """Batched frame-synchronous greedy decode (reference models.py:88-117):
    a loop over the encoder's frames, at most one label a frame; a row's
    prediction-net output and state advance only where it emitted (the
    JAX scan's where-gate).  The prediction net runs T=1 a frame (K1 on
    CUDA).  xlen is unused, as in the JAX function: every frame is
    decoded.  → (y_seq (B, T) int32 with blanks, neg_logp (B,))."""
    cfg = model.cfg
    h_enc, _ = residual_rnn_apply(model.encoder, xs)
    b = h_enc.shape[0]
    layers = model.decoder.layers()
    bos = torch.full((b, 1), BOS, dtype=torch.long, device=xs.device)
    state = rnn_ops.lstm_zero_state(cfg.pred_num_layers, b, cfg.pred_hidden,
                                    xs.device)
    h_pre, state = rnn_ops.stacked_lstm(
        layers, embedding(model.embed.weight, bos, padding_idx=BOS), state)
    h_pre = h_pre[:, 0]
    preds, probs = [], []
    for t in range(h_enc.shape[1]):
        logs = torch.log_softmax(
            legacy_joint(model, h_enc[:, t], h_pre).float(), dim=-1)
        prob, pred = logs.max(dim=-1)
        emb = embedding(model.embed.weight, pred[:, None], padding_idx=BOS)
        h_new, st_new = rnn_ops.stacked_lstm(layers, emb, state)
        adv = pred != cfg.blank
        h_pre = torch.where(adv[:, None], h_new[:, 0], h_pre)
        state = tuple(torch.where(adv[None, :, None], n, o)
                      for n, o in zip(st_new, state))
        preds.append(pred)
        probs.append(prob)
    y_seq = torch.stack(preds, 1).to(torch.int32)
    return y_seq, -torch.stack(probs, 1).sum(1)


# ---------------------------------------------------------------------------
# MFCC_ featurizer (reference recurrent.py:42-135)
# ---------------------------------------------------------------------------

def amplitude_to_db(spec, top_db=80.0, amin=1e-10):
    """Power → dB floored at top_db below the clip's maximum (torchaudio
    amplitude_to_DB as the reference MFCC_ uses it)."""
    db = 10.0 * torch.log10(torch.clamp(spec, min=amin))
    return torch.maximum(db, db.max() - top_db)


def cmvn_sliding(feat, win_size=201, variance=False):
    """Sliding-window cepstral mean (± variance) normalization over time on
    (T, F), speechpy `cmvnw` semantics: each frame normalized by the stats
    of a centred, edge-clamped window, by cumulative sums in float64 (a
    copy of the JAX package's numpy function) → float32 numpy."""
    feat = np.asarray(feat, np.float64)
    half = win_size // 2
    pad = np.pad(feat, ((half, half), (0, 0)), mode='edge')
    csum = np.cumsum(np.vstack([np.zeros((1, feat.shape[1])), pad]), axis=0)
    mean = (csum[win_size:] - csum[:-win_size]) / win_size
    out = feat - mean
    if variance:
        csq = np.cumsum(
            np.vstack([np.zeros((1, feat.shape[1])), pad ** 2]), axis=0)
        ex2 = (csq[win_size:] - csq[:-win_size]) / win_size
        std = np.sqrt(np.maximum(ex2 - mean ** 2, 0.0)) + 1e-10
        out = out / std
    return out.astype(np.float32)


def legacy_mfcc(audio, sample_rate=16000, n_mfcc=40, n_fft=400,
                hop_length=200, n_mels=128, log_mels=False, normalize=False):
    """MFCC_: mel power spectrogram (HTK mels, no norm) → log or dB →
    DCT-II (ortho) → optional CMVN (host, numpy).  audio: one utterance,
    a (L,) tensor → (T, n_mfcc) fp32 on the tensor's device."""
    audio = audio.float()
    dev = audio.device
    window = torch.as_tensor(F.hann_window(n_fft, periodic=True), device=dev)
    spec = stft_power(audio[None], window, n_fft, hop_length)[0]
    mel_fb = torch.as_tensor(F.mel_filters(sample_rate, n_fft, n_mels,
                                           htk=True, norm=None), device=dev)
    mel = spec @ mel_fb.t()
    mel = torch.log(mel + 1e-6) if log_mels else amplitude_to_db(mel)
    out = mel @ torch.as_tensor(F.dct_matrix(n_mfcc, n_mels), device=dev)
    if normalize:
        out = torch.as_tensor(cmvn_sliding(out.cpu().numpy(), win_size=201),
                              device=dev)
    return out
