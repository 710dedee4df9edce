"""wav2vec 2.0 self-supervised pretraining (counterpart of
edgedict_tpu/models/wav2vec.py).

  * The FrontEnd causal-conv feature extractor (wav2vec.py:161-226): each
    conv pads k-1 on both sides and trims k-1 from the end of its output;
    blocks >= 1 apply exact-erf GELU, then GroupNorm(1), then the conv; a
    final LayerNorm.  The convs are F.conv1d (the JAX package computes
    them with lax.conv, outside any Pallas kernel).
  * The fairseq-style conv extractor (:235-271), Gumbel VQ (:279-354) and
    k-means VQ (:358-419).
  * The Wav2Vec model (:427-525) as an nn.Module whose encoder is
    models/transducer.py's Encoder, so its keys splice 1:1 into the
    fine-tune Transducer; `wav2vec_forward` (:586-710) and the InfoNCE /
    BCE `contrastive_loss` (:713-761).

Span masks are planned on the host by `compute_mask_indices`, a numpy copy
of the JAX package's (same RandomState, same index arrays).  Every random
draw of the forward (Gumbel noise of each quantizer, negative and codebook
indices) enters as a tensor: `make_draws` makes them from an explicit
torch.Generator on the main path, and the parity tests pass JAX's own
draws instead.  Encoder dropout draws from the generator (ops/layers.py).
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.ops.layers import group_norm, layer_norm, linear


# ---------------------------------------------------------------------------
# host-side span mask planning (numpy)
# ---------------------------------------------------------------------------

def compute_mask_indices(shape, padding_mask, mask_prob, mask_length,
                         mask_type='static', mask_other=0.0, min_masks=0,
                         no_overlap=False, min_space=0, rng=None):
    """Sample span masks → bool (B, T), a copy of the JAX package's
    (wav2vec.py:46-144), itself fairseq's `compute_mask_indices` (MIT
    license, facebookresearch/fairseq fairseq/data/data_utils.py), kept
    structurally identical so that one seeded RandomState gives the same
    masks in both packages: expected `mask_prob * T / mask_length` spans a
    row, span lengths static/uniform/normal/poisson, counts equalized
    across rows by random subsampling."""
    rng = rng or np.random
    bsz, all_sz = shape
    mask = np.full((bsz, all_sz), False)

    all_num_mask = int(mask_prob * all_sz / float(mask_length)
                       + rng.random())
    all_num_mask = max(min_masks, all_num_mask)

    mask_idcs = []
    for i in range(bsz):
        if padding_mask is not None:
            sz = all_sz - int(padding_mask[i].sum())
            num_mask = int(mask_prob * sz / float(mask_length)
                           + rng.random())
            num_mask = max(min_masks, num_mask)
        else:
            sz = all_sz
            num_mask = all_num_mask

        if mask_type == 'static':
            lengths = np.full(num_mask, mask_length)
        elif mask_type == 'uniform':
            lengths = rng.randint(mask_other, mask_length * 2 + 1,
                                  size=num_mask)
        elif mask_type == 'normal':
            lengths = rng.normal(mask_length, mask_other, size=num_mask)
            lengths = np.maximum(1, np.round(lengths)).astype(int)
        elif mask_type == 'poisson':
            lengths = rng.poisson(mask_length, size=num_mask)
            lengths = np.round(lengths).astype(int)
        else:
            raise ValueError(f'unknown mask selection {mask_type}')

        if sum(lengths) == 0:
            lengths[0] = min(mask_length, sz - 1)

        if no_overlap:
            mask_idc = []

            def arrange(s, e, length, keep_length):
                span_start = rng.randint(s, e - length)
                mask_idc.extend(span_start + j for j in range(length))
                new_parts = []
                if span_start - s - min_space >= keep_length:
                    new_parts.append((s, span_start - min_space + 1))
                if e - span_start - length - min_space > keep_length:
                    new_parts.append((span_start + length + min_space, e))
                return new_parts

            parts = [(0, sz)]
            min_length = min(lengths)
            for length in sorted(lengths, reverse=True):
                lens = np.fromiter(
                    (e - s if e - s >= length + min_space else 0
                     for s, e in parts), np.int_)
                l_sum = np.sum(lens)
                if l_sum == 0:
                    break
                probs = lens / l_sum
                c = rng.choice(len(parts), p=probs)
                s, e = parts.pop(c)
                parts.extend(arrange(s, e, length, min_length))
            mask_idc = np.asarray(mask_idc)
        else:
            min_len = min(lengths)
            if sz - min_len <= num_mask:
                min_len = sz - num_mask - 1
            mask_idc = rng.choice(sz - min_len, num_mask, replace=False)
            mask_idc = np.asarray([
                mask_idc[j] + offset
                for j in range(len(mask_idc))
                for offset in range(lengths[j])])
        mask_idcs.append(np.unique(mask_idc[mask_idc < sz]))

    min_len = min(len(m) for m in mask_idcs)
    for i, mask_idc in enumerate(mask_idcs):
        if len(mask_idc) > min_len:
            mask_idc = rng.choice(mask_idc, min_len, replace=False)
        mask[i, mask_idc] = True
    return mask


def mask_to_dense_indices(mask):
    """bool (B, T) with equal per-row counts → int32 (B, M) positions."""
    counts = mask.sum(axis=1)
    m = int(counts.min()) if len(counts) else 0
    idx = np.zeros((mask.shape[0], m), np.int32)
    for i in range(mask.shape[0]):
        idx[i] = np.flatnonzero(mask[i])[:m]
    return idx


# ---------------------------------------------------------------------------
# parameter holders
# ---------------------------------------------------------------------------

def _kaiming_conv(out_ch, in_ch, k, generator):
    return torch.randn(out_ch, in_ch, k, generator=generator) \
        * math.sqrt(2.0 / (in_ch * k))


class ConvLayer(nn.Module):
    """One conv: `weight` (C_out, C_in, k), `bias` (C_out) or None, and a
    norm's `gn` / `ln` {weight, bias} of `norm_size` channels, or None."""

    def __init__(self, in_ch, out_ch, k, bias, generator, norm=None,
                 norm_size=None):
        super().__init__()
        self.weight = nn.Parameter(_kaiming_conv(out_ch, in_ch, k, generator))
        if bias:
            bound = 1.0 / math.sqrt(in_ch * k)
            self.bias = nn.Parameter(torch.empty(out_ch).uniform_(
                -bound, bound, generator=generator))
        else:
            self.register_parameter('bias', None)
        self.gn = T.LayerNorm(norm_size) if norm == 'gn' else None
        self.ln = T.LayerNorm(norm_size) if norm == 'ln' else None


# (kernel, stride, channels) of each conv (wav2vec.py:161)
DEFAULT_FRONTEND = ((10, 5, 16), (8, 4, 32), (4, 2, 128), (4, 2, 128),
                    (4, 2, 128))


class FrontEnd(nn.Module):
    """frontend.layers.{i}.{weight, bias}, layers.{i >= 1}.gn.{weight,
    bias} (GroupNorm(1) over the block's input channels), ln.{weight,
    bias}."""

    def __init__(self, spec=DEFAULT_FRONTEND, bias=True, generator=None):
        super().__init__()
        self.spec = tuple(tuple(s) for s in spec)
        layers, in_ch = [], 1
        for i, (k, _, c) in enumerate(self.spec):
            layers.append(ConvLayer(in_ch, c, k, bias, generator,
                                    norm='gn' if i > 0 else None,
                                    norm_size=in_ch))
            in_ch = c
        self.layers = nn.ModuleList(layers)
        self.ln = T.LayerNorm(self.spec[-1][2])


def _conv1d(x, layer, stride, pad):
    """x (B, C_in, T) → (B, C_out, T') fp32, symmetric padding `pad`."""
    return F.conv1d(x, layer.weight.float(), None if layer.bias is None
                    else layer.bias.float(), stride=stride, padding=pad)


def frontend_apply(frontend: FrontEnd, xs, spec=None):
    """Raw waveform (B, L) → features (B, T, C_last) in fp32
    (wav2vec.py:200-216)."""
    spec = spec or frontend.spec
    x = xs.float()[:, None, :]
    for i, ((k, s, _), layer) in enumerate(zip(spec, frontend.layers)):
        pad = k - 1
        if i > 0:
            x = F.gelu(x)                            # exact erf
            x = group_norm(x, layer.gn.weight, layer.gn.bias, 1)
        x = _conv1d(x, layer, s, pad)[:, :, :-pad]
    return layer_norm(x.transpose(1, 2), frontend.ln.weight, frontend.ln.bias)


def frontend_output_length(spec, n_samples):
    """Output frames for n_samples of input (pad both sides, trim the
    end)."""
    t = n_samples
    for (k, s, _) in spec:
        pad = k - 1
        t = (t + 2 * pad - k) // s + 1 - pad
    return t


class ConvFeatureExtractor(nn.Module):
    """The fairseq-style extractor (wav2vec.py:235-271; defined in the
    reference but unused by its trainers): conv_layers [(dim, kernel,
    stride), ...]; mode 'default' a GroupNorm(dim, dim) after the first
    conv, 'layer_norm' a LayerNorm after every conv."""

    def __init__(self, conv_layers, mode='default', bias=False,
                 generator=None):
        super().__init__()
        if mode not in ('default', 'layer_norm'):
            raise ValueError(f'unknown mode {mode!r}')
        self.conv_layers = tuple(tuple(c) for c in conv_layers)
        self.mode = mode
        layers, in_ch = [], 1
        for i, (dim, k, _) in enumerate(self.conv_layers):
            norm = 'ln' if mode == 'layer_norm' else (
                'gn' if i == 0 else None)
            layers.append(ConvLayer(in_ch, dim, k, bias, generator,
                                    norm=norm, norm_size=dim))
            in_ch = dim
        self.layers = nn.ModuleList(layers)


def conv_feature_extractor_apply(extractor: ConvFeatureExtractor, xs):
    """(B, L) waveform → (B, T, C): unpadded convs, each then its norm
    (fp32 GroupNorm with one group a channel, or a LayerNorm over
    channels) and exact GELU."""
    x = xs.float()[:, None, :]
    for (dim, _, s), layer in zip(extractor.conv_layers, extractor.layers):
        x = _conv1d(x, layer, s, 0)
        if layer.gn is not None:
            x = group_norm(x, layer.gn.weight, layer.gn.bias, dim)
        if layer.ln is not None:
            x = layer_norm(x.transpose(1, 2), layer.ln.weight,
                           layer.ln.bias).transpose(1, 2)
        x = F.gelu(x)
    return x.transpose(1, 2)


# ---------------------------------------------------------------------------
# vector quantizers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GumbelVQConfig:
    dim: int
    num_vars: int = 320
    groups: int = 2
    vq_dim: int = 256
    temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995)
    combine_groups: bool = False


class GumbelVQ(nn.Module):
    """vars (1, G·V, vq_dim / G) ~ U(0, 1) (G = 1 with combine_groups) and
    weight_proj Linear(dim, G·V)."""

    def __init__(self, cfg: GumbelVQConfig, generator):
        super().__init__()
        n_groups = 1 if cfg.combine_groups else cfg.groups
        self.vars = nn.Parameter(torch.rand(
            1, n_groups * cfg.num_vars, cfg.vq_dim // cfg.groups,
            generator=generator))
        self.weight_proj = T.Linear(cfg.dim, cfg.groups * cfg.num_vars,
                                    generator)


def gumbel_vq_temp(cfg: GumbelVQConfig, num_updates):
    start, end, decay = cfg.temp
    return max(start * decay ** num_updates, end)


def _perplexity(probs):
    """sum over groups of exp(entropy) of (G, V) probabilities."""
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-7), -1)).sum()


def gumbel_vq_apply(vq: GumbelVQ, cfg: GumbelVQConfig, x, temp,
                    uniform=None, training=True, produce_targets=False):
    """x (B, T, dim) → dict(x (B, T, vq_dim), code_perplexity,
    prob_perplexity, num_vars, temp, targets?).  In training with
    `uniform` (B·T·G, V) draws in [0, 1): Gumbel-softmax at `temp` with a
    straight-through hard pick, y_soft + (y_hard − y_soft).detach(); else
    the hard argmax (wav2vec.py:306-354)."""
    b, t, _ = x.shape
    v = cfg.num_vars
    logits = linear(x, vq.weight_proj.weight, vq.weight_proj.bias)
    logits = logits.reshape(b * t * cfg.groups, v)

    hard_idx = torch.argmax(logits, -1)
    hard = F.one_hot(hard_idx, v).to(logits.dtype)
    code_ppl = _perplexity(hard.reshape(b * t, cfg.groups, v).mean(0))
    soft = torch.softmax(logits.reshape(b * t, cfg.groups, v).float(), -1)
    prob_ppl = _perplexity(soft.mean(0))

    if training and uniform is not None:
        g = -torch.log(-torch.log(uniform + 1e-10) + 1e-10)
        y_soft = torch.softmax((logits + g) / temp, -1)
        y_hard = F.one_hot(torch.argmax(y_soft, -1), v).to(y_soft.dtype)
        sel = y_soft + (y_hard - y_soft).detach()
    else:
        sel = hard

    codebook = vq.vars
    if cfg.combine_groups:
        codebook = codebook.repeat(1, cfg.groups, 1)
    sel = sel.reshape(b * t, cfg.groups * v)[..., None]
    quantized = (sel * codebook).reshape(b * t, cfg.groups, v, -1).sum(-2)
    out = {'x': quantized.reshape(b, t, -1), 'num_vars': v * cfg.groups,
           'code_perplexity': code_ppl, 'prob_perplexity': prob_ppl,
           'temp': temp}
    if produce_targets:
        out['targets'] = hard_idx.reshape(b, t, cfg.groups)
    return out


def gumbel_vq_sample_codebook(vq: GumbelVQ, cfg: GumbelVQConfig, idx, b, n):
    """`n` full codewords (all groups concatenated) for each of `b`
    targets from idx (b·n, G) ints in [0, V) (wav2vec.py:573-583) →
    (b, n, vq_dim)."""
    codebook = vq.vars[0]                              # (G·V, var_dim)
    if cfg.combine_groups:
        codebook = codebook.repeat(cfg.groups, 1)
    idx = idx.long() + torch.arange(cfg.groups, device=idx.device)[None] \
        * cfg.num_vars
    z = codebook[idx.reshape(-1)].reshape(b * n, cfg.groups, -1)
    return z.reshape(b, n, -1)


@dataclasses.dataclass(frozen=True)
class KmeansVQConfig:
    dim: int
    num_vars: int = 320
    groups: int = 2
    vq_dim: int = 256
    gamma: float = 0.25     # commitment weight


class KmeansVQ(nn.Module):
    """embedding (V, G, vq_dim / G), proj (G, dim / G, vq_dim / G) (a
    grouped 1x1 conv) and gn {weight, bias} (vq_dim)."""

    def __init__(self, cfg: KmeansVQConfig, generator):
        super().__init__()
        var_dim = cfg.vq_dim // cfg.groups
        self.embedding = nn.Parameter(torch.randn(
            cfg.num_vars, cfg.groups, var_dim, generator=generator)
            / math.sqrt(var_dim))
        self.proj = nn.Parameter(torch.randn(
            cfg.groups, cfg.dim // cfg.groups, var_dim, generator=generator)
            * math.sqrt(2.0 / cfg.dim))
        self.gn = T.LayerNorm(cfg.vq_dim)


def kmeans_vq_apply(vq: KmeansVQ, cfg: KmeansVQConfig, x,
                    produce_targets=False):
    """Straight-through k-means VQ (wav2vec.py:380-419): grouped
    projection + fp32 GroupNorm → nearest codeword per group, forward zq
    with the gradient to ze; kmeans_loss = latent MSE + gamma · commitment
    MSE."""
    b, t, _ = x.shape
    var_dim = cfg.vq_dim // cfg.groups
    xg = x.reshape(b, t, cfg.groups, cfg.dim // cfg.groups)
    ze = torch.einsum('btgd,gdv->btgv', xg.float(), vq.proj.float())
    zf = ze.reshape(b, t, cfg.vq_dim).transpose(1, 2)
    zf = group_norm(zf, vq.gn.weight, vq.gn.bias, cfg.groups)
    ze = zf.transpose(1, 2).reshape(b, t, cfg.groups, var_dim)

    emb = vq.embedding.transpose(0, 1)                 # (G, V, var_dim)
    d = torch.sum((ze[:, :, :, None, :] - emb[None, None]) ** 2, -1)
    idx = torch.argmin(d, -1)                          # (B, T, G)
    zq = emb[torch.arange(cfg.groups, device=x.device)[None, None], idx]

    out_q = ze + (zq - ze).detach()
    latent_loss = torch.mean((ze.detach() - zq) ** 2)
    commit_loss = torch.mean((ze - zq.detach()) ** 2)
    hard = F.one_hot(idx.reshape(-1, cfg.groups), cfg.num_vars).float()
    out = {'x': out_q.reshape(b, t, cfg.vq_dim),
           'kmeans_loss': latent_loss + cfg.gamma * commit_loss,
           'code_perplexity': _perplexity(hard.mean(0)),
           'num_vars': cfg.num_vars * cfg.groups}
    if produce_targets:
        out['targets'] = idx
    return out


# ---------------------------------------------------------------------------
# Wav2Vec model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Wav2VecConfig:
    frontend_params: Tuple = DEFAULT_FRONTEND
    front_bias: bool = False
    input_size: int = 768
    enc_hidden_size: int = 768
    enc_layers: int = 7
    enc_dropout: float = 0.1
    enc_proj_size: int = 512
    module_type: str = 'LSTM'
    mask_prob: float = 0.15
    mask_length: int = 10
    mask_selection: str = 'static'
    num_negatives: int = 100
    final_dim: int = 0
    latent_groups: int = 2
    latent_vars: int = 320
    latent_temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995)
    logit_temp: float = 0.1
    quantize_targets: bool = True
    # the reference's optional branches (rnnt/wav2vec.py:115-145, 332-358)
    quantize_input: bool = False
    same_quantizer: bool = False          # input VQ shares the target VQ
    negatives_from_everywhere: bool = False
    cross_sample_negatives: int = 0
    codebook_negatives: int = 0

    @property
    def embed(self):
        return self.frontend_params[-1][2]

    @property
    def final_dim_(self):
        return self.final_dim if self.final_dim > 0 else self.input_size

    @property
    def encoder_cfg(self):
        return T.TransducerConfig(
            vocab_size=1, input_size=self.input_size,
            enc_hidden_size=self.enc_hidden_size,
            enc_layers=self.enc_layers, enc_dropout=self.enc_dropout,
            enc_proj_size=self.enc_proj_size,
            enc_time_reductions=(),      # no time reduction in pretraining
            module_type=self.module_type)

    @property
    def gumbel_cfg(self):
        return GumbelVQConfig(
            dim=self.embed, num_vars=self.latent_vars,
            groups=self.latent_groups, vq_dim=self.final_dim_,
            temp=self.latent_temp)

    @property
    def input_vq_cfg(self):
        """Input-VQ geometry: dim = frontend embed, vq_dim = the encoder's
        input width (wav2vec.py:481-488)."""
        return GumbelVQConfig(
            dim=self.embed, num_vars=self.latent_vars,
            groups=self.latent_groups, vq_dim=self.input_size,
            temp=self.latent_temp)


class Wav2Vec(nn.Module):
    """The pretraining model's parameters (wav2vec.py:491-525), seeded
    from a CPU torch.Generator and moved to `device`: frontend, encoder
    (models/transducer.py's Encoder), mask_emb ~ U(0, 1), final_proj, and
    as the config asks post_extract_proj (embed != input_size without
    input VQ), quantizer + project_q (final_dim → final_dim) or project_q
    alone (embed → final_dim), input_quantizer and project_inp."""

    def __init__(self, cfg: Wav2VecConfig, device, seed=0):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.frontend = FrontEnd(cfg.frontend_params, cfg.front_bias, g)
        self.encoder = T.Encoder(cfg.encoder_cfg, g)
        self.mask_emb = nn.Parameter(torch.rand(cfg.input_size, generator=g))
        self.final_proj = T.Linear(cfg.enc_proj_size, cfg.final_dim_, g)
        self.post_extract_proj = T.Linear(cfg.embed, cfg.input_size, g) \
            if cfg.embed != cfg.input_size and not cfg.quantize_input \
            else None
        self.quantizer = GumbelVQ(cfg.gumbel_cfg, g) \
            if cfg.quantize_targets else None
        self.project_q = T.Linear(
            cfg.final_dim_ if cfg.quantize_targets else cfg.embed,
            cfg.final_dim_, g)
        self.input_quantizer = self.project_inp = None
        if cfg.quantize_input:
            if cfg.same_quantizer and cfg.quantize_targets:
                self.project_inp = T.Linear(cfg.final_dim_, cfg.input_size, g)
            else:
                self.input_quantizer = GumbelVQ(cfg.input_vq_cfg, g)
                self.project_inp = T.Linear(cfg.input_vq_cfg.vq_dim,
                                            cfg.input_size, g)
        self.to(device)


def _lin(layer, x):
    return linear(x, layer.weight, layer.bias)


def draw_spec(cfg: Wav2VecConfig, b, t, m, training=True):
    """{name: (shape, high)} of the random draws `wav2vec_forward` takes
    for B = b utterances of t frames and m masked steps: uniform [0, 1)
    Gumbel noise (high None) for each quantizer that runs in training,
    and integer indices in [0, high) for the negatives and the codebook,
    before the skip-self shift (wav2vec.py:555-564, 580)."""
    g, v = cfg.latent_groups, cfg.latent_vars
    spec = {}
    if training and cfg.quantize_input:
        spec['gumbel_input'] = ((b * t * g, v), None)
    if training and cfg.quantize_targets:
        spec['gumbel'] = ((b * m * g, v), None)
        if cfg.negatives_from_everywhere:
            spec['gumbel_everywhere'] = ((b * t * g, v), None)
    tsz = t if cfg.negatives_from_everywhere else m
    if cfg.num_negatives > 0:
        spec['neg_within'] = ((b, cfg.num_negatives * m), max(tsz - 1, 1))
    if cfg.cross_sample_negatives > 0:
        spec['neg_cross'] = ((b, cfg.cross_sample_negatives * m),
                             max(b * tsz - 1, 1))
    if cfg.quantize_targets and cfg.codebook_negatives > 0:
        spec['codebook'] = ((b * m * cfg.codebook_negatives, g), v)
    return spec


def make_draws(cfg: Wav2VecConfig, b, t, m, generator, device,
               training=True):
    """The forward's draws (draw_spec) from `generator`, on `device`."""
    out = {}
    for name, (shape, high) in draw_spec(cfg, b, t, m, training).items():
        out[name] = torch.rand(shape, generator=generator, device=device) \
            if high is None else torch.randint(0, high, shape,
                                               generator=generator,
                                               device=device)
    return out


def sample_negatives(y, num, n_negatives, cross_sample_negatives=0,
                     within=None, cross=None):
    """Negatives for each of the `num` target steps (wav2vec.py:538-570):
    `within` (B, n_negatives·num) draws in [0, Tsz − 1) index the row's
    own Tsz candidates, `cross` (B, cross·num) draws in [0, B·Tsz − 1) the
    whole flattened pool, each shifted past its own step.  y: (B, Tsz, F)
    candidates.  → (n_negatives + cross, B, num, F), from the
    concatenated index block reshaped as the reference does."""
    b, tsz, fsz = y.shape
    if n_negatives == 0 and cross_sample_negatives == 0:
        return y.new_zeros((0, b, num, fsz))
    parts = []
    for draws, n, row_local in ((within, n_negatives, True),
                                (cross, cross_sample_negatives, False)):
        if n > 0:
            tszs = torch.arange(num, device=y.device).repeat_interleave(n)
            idx = draws.long()
            idx = torch.where(idx >= tszs[None], idx + 1, idx)
            if row_local:
                idx = idx + torch.arange(b, device=y.device)[:, None] * tsz
            parts.append(idx)
    neg_idxs = torch.cat(parts, 1)
    negs = y.reshape(b * tsz, fsz)[neg_idxs.reshape(-1)]
    n_total = n_negatives + cross_sample_negatives
    return negs.reshape(b, num, n_total, fsz).permute(2, 0, 1, 3)


def _gather_steps(x, idx):
    """x (B, T, F), idx (B, M) → (B, M, F)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1,
                                                           x.shape[-1]))


def wav2vec_forward(model: Wav2Vec, cfg: Wav2VecConfig, source, mask_idx,
                    temp=0.5, draws=None, generator=None, training=True):
    """Pretraining forward (wav2vec.py:586-710).

    source (B, L) raw waveform; mask_idx (B, M) masked frames (equal count
    a row); temp the Gumbel temperature; draws: the random draws
    (draw_spec), made from `generator` when None (which also drives
    encoder dropout in training).  → dict with 'logits' (1+N, B, M),
    'features_pen', and 'prob_perplexity', 'code_perplexity', 'num_vars',
    'temp' (and 'targets' out of training) where a quantizer ran."""
    features = frontend_apply(model.frontend, source, cfg.frontend_params)
    out = {'features_pen': features.float().pow(2).mean()}
    unmasked = features
    if model.post_extract_proj is not None:
        features = _lin(model.post_extract_proj, features)
    b, t, _ = features.shape
    m = mask_idx.shape[1]
    if draws is None:
        draws = make_draws(cfg, b, t, m, generator, source.device, training)

    if cfg.quantize_input:
        # the ENCODER INPUT quantized over the full sequence; the targets
        # keep the unmasked frontend output
        vq, vq_cfg = (model.input_quantizer, cfg.input_vq_cfg) \
            if model.input_quantizer is not None \
            else (model.quantizer, cfg.gumbel_cfg)
        q_in = gumbel_vq_apply(vq, vq_cfg, features, temp,
                               draws.get('gumbel_input'), training)
        features = _lin(model.project_inp, q_in['x'])
        out.update(input_prob_perplexity=q_in['prob_perplexity'],
                   input_code_perplexity=q_in['code_perplexity'])
        if not cfg.quantize_targets:
            out.update(prob_perplexity=q_in['prob_perplexity'],
                       code_perplexity=q_in['code_perplexity'],
                       num_vars=q_in['num_vars'], temp=temp)

    # the learned mask embedding at the masked frames
    is_masked = features.new_zeros((b, t)).scatter(
        1, mask_idx.long(), 1.0)[..., None]
    x = features * (1 - is_masked) + is_masked * model.mask_emb
    h, _ = T.encoder_apply(model.encoder, cfg.encoder_cfg, x,
                           deterministic=not training, generator=generator)

    y_feats = _gather_steps(unmasked, mask_idx)           # (B, M, embed)
    negs_kw = dict(within=draws.get('neg_within'),
                   cross=draws.get('neg_cross'))
    n_neg, n_cross = cfg.num_negatives, cfg.cross_sample_negatives
    if cfg.quantize_targets:
        q = gumbel_vq_apply(model.quantizer, cfg.gumbel_cfg, y_feats, temp,
                            draws.get('gumbel'), training,
                            produce_targets=not training)
        y = _lin(model.project_q, q['x'])
        out.update(prob_perplexity=q['prob_perplexity'],
                   code_perplexity=q['code_perplexity'],
                   num_vars=q['num_vars'], temp=temp)
        if 'targets' in q:
            out['targets'] = q['targets']
        if cfg.negatives_from_everywhere:
            # candidates: the QUANTIZED full unmasked sequence, projected
            # after sampling
            cands = gumbel_vq_apply(model.quantizer, cfg.gumbel_cfg,
                                    unmasked, temp,
                                    draws.get('gumbel_everywhere'),
                                    training)['x']
            negs = _lin(model.project_q, sample_negatives(
                cands, m, n_neg, n_cross, **negs_kw))
        else:
            negs = sample_negatives(y, m, n_neg, n_cross, **negs_kw)
        if cfg.codebook_negatives > 0:
            k = cfg.codebook_negatives
            cb = gumbel_vq_sample_codebook(model.quantizer, cfg.gumbel_cfg,
                                           draws['codebook'], b * m, k)
            cb = cb.reshape(b, m, k, -1).permute(2, 0, 1, 3)
            negs = torch.cat([negs, _lin(model.project_q, cb)], 0)
    else:
        y = _lin(model.project_q, y_feats)
        if cfg.negatives_from_everywhere:
            negs = _lin(model.project_q, sample_negatives(
                unmasked, m, n_neg, n_cross, **negs_kw))
        else:
            negs = sample_negatives(y, m, n_neg, n_cross, **negs_kw)

    x_m = _lin(model.final_proj, _gather_steps(h, mask_idx))   # (B, M, F)

    # cosine similarity over [positive; negatives] / temperature
    targets = torch.cat([y[None], negs], 0)                # (1+N, B, M, F)
    x32, t32 = x_m.float(), targets.float()
    cos = torch.sum(x32[None] * t32, -1) / (
        torch.linalg.norm(x32, dim=-1)[None]
        * torch.linalg.norm(t32, dim=-1) + 1e-8)
    logits = cos / cfg.logit_temp
    neg_is_pos = torch.isclose(y[None], negs).all(-1)      # (N, B, M)
    out['logits'] = torch.cat(
        [logits[:1], logits[1:].masked_fill(neg_is_pos, float('-inf'))], 0)
    return out


def contrastive_loss(result, prob_ppl_weight=0.1, features_pen_weight=10.0,
                     infonce=True):
    """InfoNCE cross-entropy over axis 0 (class 0 = the positive), or with
    infonce=False elementwise BCE-with-logits (target 1 on row 0, −inf
    logits contribute 0), plus the weighted prob-perplexity and feature
    penalties (wav2vec.py:713-761).  `correct` counts a step only where the
    positive alone holds the max.  → (loss, metrics)."""
    logits = result['logits']
    _, b, m = logits.shape
    x = logits.float()
    if infonce:
        loss = -torch.log_softmax(x, 0)[0].sum() / (b * m)
    else:
        neg = F.softplus(x[1:]).masked_fill(torch.isneginf(x[1:]), 0.0)
        loss = (F.softplus(-x[0]).sum() + neg.sum()) / (b * m)

    metrics = {'contrastive_loss': loss}
    extra = 0.0
    if 'prob_perplexity' in result:
        n = result['num_vars']
        extra = extra + prob_ppl_weight * (n - result['prob_perplexity']) / n
        metrics['prob_perplexity'] = result['prob_perplexity']
        metrics['code_perplexity'] = result['code_perplexity']
    extra = extra + features_pen_weight * result['features_pen']
    metrics['features_pen'] = result['features_pen']

    pred = torch.argmax(logits, 0)
    maxes = torch.amax(logits, 0)
    metrics['correct'] = torch.sum((pred == 0)
                                   & ((logits == maxes[None]).sum(0) == 1))
    metrics['count'] = b * m
    total = loss + extra
    metrics['loss'] = total
    return total, metrics


class RawTransducer(T.Transducer):
    """The raw-waveform fine-tune model: the Transducer (encoder without
    time reduction, input = the FrontEnd's last channels) and a trainable
    FrontEnd with conv biases, `frontend.*` (raw_trainer.py:60-64)."""

    def __init__(self, cfg: T.TransducerConfig, device, seed=0,
                 spec=DEFAULT_FRONTEND):
        super().__init__(cfg, device='cpu', seed=seed)
        self.frontend = FrontEnd(spec, bias=True,
                                 generator=torch.Generator().manual_seed(
                                     seed + 1))
        self.to(device)
