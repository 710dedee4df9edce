"""Raw-waveform fine-tune trainer (counterpart of
edgedict_tpu/raw_trainer.py).

The Trainer with a trainable causal-conv FrontEnd in place of the feature
pipeline: the encoder's input is the FrontEnd's last channel count and it
has no time reduction (raw_trainer.py:54-57); frame lengths come from the
conv stride ratio, xlen = min(ceil(alen / (L / T)), T) (:71-82); the loss
casts the FrontEnd's fp32 output to the compute dtype (:84-88); eval is
greedy only (:96-100).  --tp_size cuts the joint's vocabulary over the
grid as the Trainer does; --pp_size > 1 is refused as in the JAX package
(:43-47).  `load_pretrained` splices the FrontEnd and encoder
of a pretraining checkpoint (cli/pretrain_wav2vec.py's pretrained.ckpt,
the port's or the JAX package's) into the model key by key and
re-initialises the optimizer state (:102-138).
"""

import dataclasses

import torch

from edgedict_tpu_torch import parallel
from edgedict_tpu_torch.checkpoint import load_checkpoint
from edgedict_tpu_torch.compat import wav2vec_state_dict_from_jax_params
from edgedict_tpu_torch.config import transducer_config_from_flags
from edgedict_tpu_torch.features import pcm_to_float
from edgedict_tpu_torch.jax_checkpoint import (
    is_jax_checkpoint, load_jax_checkpoint)
from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.models import wav2vec as W
from edgedict_tpu_torch.train import (
    TrainState, make_eval_step, make_train_step)
from edgedict_tpu_torch.trainer import Trainer

SPLICED = ('frontend', 'encoder')


def frame_lengths(alen, n_samples, n_frames):
    """(B,) audio lengths of a batch padded to n_samples → (B,) int32
    valid frames of its n_frames FrontEnd frames, from the conv stride
    ratio: min(ceil(alen / (n_samples / n_frames)), n_frames)."""
    xlen = torch.ceil(alen.float() / (n_samples / n_frames)).to(torch.int32)
    return torch.clamp(xlen, max=n_frames)


def raw_features(model, spec, audio, alen):
    """(B, L) int16 or float audio → (FrontEnd features (B, T, C) fp32,
    xlen (B,) int32 from the conv stride ratio)."""
    xs = W.frontend_apply(model.frontend, pcm_to_float(audio), spec)
    return xs, frame_lengths(alen, audio.shape[1], xs.shape[1])


def _layer_count(keys, prefix):
    """Layers of a spliced module: the distinct indices after `prefix`."""
    return len({k[len(prefix):].split('.', 1)[0] for k in keys
                if k.startswith(prefix)})


def splice_state_dict(dst, src, prefixes=SPLICED):
    """Per key, the reference's state-dict update (cli/train.py:42-49):
    every key of `dst` under a prefix that `src` also holds is copied from
    `src`, its shape checked; keys only the fine-tune has keep `dst`'s
    value.  The layer counts of the FrontEnd and the encoder must agree.
    → (new state dict, the copied keys)."""
    for layers in ('frontend.layers.', 'encoder.lstm.lstms.'):
        n_dst, n_src = _layer_count(dst, layers), _layer_count(src, layers)
        if n_dst != n_src:
            raise ValueError(f'{layers}: {n_dst} layers vs {n_src} in the '
                             'pretrained checkpoint — pretrain and fine-tune '
                             'encoder flags must match')
    out, copied = dict(dst), []
    for k, v in dst.items():
        if k.split('.', 1)[0] in prefixes and k in src:
            if tuple(src[k].shape) != tuple(v.shape):
                raise ValueError(f'{k}: {tuple(v.shape)} vs '
                                 f'{tuple(src[k].shape)} — pretrain and '
                                 'fine-tune encoder flags must match')
            out[k] = src[k].to(v.dtype)
            copied.append(k)
    return out, copied


class RawTrainer(Trainer):
    FRONTEND_SPEC = W.DEFAULT_FRONTEND

    def _build_model_and_steps(self):
        flags = self.flags
        if self.layout.pp > 1:
            raise NotImplementedError(
                'pipeline parallelism (--pp_size) is wired for the '
                'feature-based trainer only; the raw-waveform FrontEnd '
                'path trains with dp/tp')
        spec = self.FRONTEND_SPEC
        self.feature_cfg = None
        self.pipeline = None
        base = transducer_config_from_flags(
            flags, self.tokenizer.vocab_size, spec[-1][2])
        self.cfg = cfg = dataclasses.replace(base, enc_time_reductions=())
        self.optimizer = T.build_optimizer(
            cfg, flags.optim, gradclip=flags.gradclip,
            shards=parallel.vocab_shards(cfg, self.layout))
        model = parallel.place_model(
            W.RawTransducer(cfg, self.device, seed=0, spec=spec), self.layout)
        self.state = TrainState(
            model, self.optimizer.init(dict(model.named_parameters())))
        compute_dtype = torch.bfloat16 if flags.bf16 else torch.float32

        def feature_fn(model, batch):
            return raw_features(model, spec, batch['audio'], batch['alen'])

        def loss_fn(model, micro, generator, aux):
            xs, xlen = feature_fn(model, micro)
            return T.transducer_loss(model, cfg, xs.to(compute_dtype),
                                     micro['ys'], xlen, micro['ylen'],
                                     deterministic=False,
                                     generator=generator)

        self.feature_fn = feature_fn
        self.train_step = make_train_step(cfg, self.optimizer,
                                          bf16=flags.bf16, loss_fn=loss_fn)
        self.eval_step = make_eval_step(cfg, feature_fn=feature_fn)
        # the raw path evaluates greedy only (--eval_beam_width is a
        # feature-trainer extra)
        self.beam_eval_step = None

    def load_pretrained(self, path):
        """Splice the FrontEnd and encoder of a pretraining checkpoint into
        the model (splice_state_dict) and re-initialise the optimizer
        state.  A JAX pretrained.ckpt is read through
        wav2vec_state_dict_from_jax_params.  → the copied keys."""
        if is_jax_checkpoint(path):
            src = wav2vec_state_dict_from_jax_params(
                load_jax_checkpoint(path)['model'])
        else:
            src = load_checkpoint(path)['model']
        model = self.state.model
        sd, copied = splice_state_dict(model.state_dict(), src)
        model.load_state_dict(sd)
        self.state = TrainState(
            model, self.optimizer.init(dict(model.named_parameters())),
            self.state.step)
        return copied
