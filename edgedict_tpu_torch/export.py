"""Ahead-of-time export of the encoder / predictor / joint triplet
(counterpart of edgedict_tpu/export.py) with torch.export.

Each component is traced at the pinned streaming shapes (the reference's
export_openvino.sh static-shape table, as the JAX package pins them) from
a frozen prepare_inference_params copy of the model, and saved as
`{encoder,decoder,joint}.pt2` (torch.export.save) beside a `meta.json`.
The recurrences and the int8 products are the registered ops
`edgedict::lstm_fwd`, `edgedict::quant_matmul` and `edgedict::lstm_fwd_q`
(ops/rnn_kernel.py, ops/quant.py), so each is one node of the graph, and
the reloaded graph launches the same kernels as the live model (K1, K11,
K12 on CUDA; their plain versions on the CPU).  Loading an artifact needs
this package importable, for that op registry; the JAX package's
artifacts need only JAX.

Graph constants (the weights) are traced on one device: an artifact runs
only on the device it was exported for (meta.json's 'device').

Numerical parity of each reloaded artifact against the live model is
asserted at export time with the reference's tolerances (rtol 1e-3,
atol 1e-5; reference cli/export_onnx.py:63-68) on seeded inputs.

`ExportedStreamDecoder` has the JAX package's exported decoder's protocol
(decode(frame) / reset() / reset_profile() / elapsed): the featurizer runs
live (K2), the per-frame greedy loop calls the joint and predictor graphs
from the host.
"""

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.nn as nn

from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.ops import quant  # noqa: F401  (registers the ops)
from edgedict_tpu_torch.stream import (
    prepare_inference_params, resolve_device, stream_chunk_geometry)
from edgedict_tpu_torch.tokenizer import BOS, UNK

PARITY_RTOL = 1e-3
PARITY_ATOL = 1e-5
COMPONENTS = ('encoder', 'decoder', 'joint')


class _Encoder(nn.Module):
    def __init__(self, encoder, cfg):
        super().__init__()
        self.encoder, self.cfg = encoder, cfg

    def forward(self, xs, h, c):
        ys, (h2, c2) = T.encoder_apply(self.encoder, self.cfg, xs, (h, c))
        return ys, h2, c2


class _Decoder(nn.Module):
    def __init__(self, decoder, cfg):
        super().__init__()
        self.decoder, self.cfg = decoder, cfg

    def forward(self, token, h, c):
        ys, (h2, c2) = T.decoder_apply(self.decoder, self.cfg, token, (h, c))
        return ys, h2, c2


class _Joint(nn.Module):
    def __init__(self, joint):
        super().__init__()
        self.joint = joint

    def forward(self, f, g):
        return T.joint_apply(self.joint, f, g)


def export_transducer(model, cfg: T.TransducerConfig, out_dir, batch_size=1,
                      step_frames=2, check_parity=True, quantize=None,
                      device='cuda'):
    """Export encoder / decoder / joint of `model` (a Transducer) at pinned
    shapes → out_dir (export.py:40-117 of the JAX package): the encoder
    takes `step_frames` stacked feature frames with explicit (h, c) state,
    the decoder one int32 token with state, the joint one (enc, dec)
    feature pair, each in fp32 at batch `batch_size`, traced on `device`.

    quantize='int8' quantizes the encoder before tracing
    (ops/quant.py:quantize_encoder through prepare_inference_params), so
    the artifact holds int8 weights and fp32 scales and its graph runs K11
    and K12; parity is then asserted against the live int8 model.  The
    export is LSTM-only (its state I/O is (h, c)): a GRU encoder raises
    ValueError.  → out_dir."""
    if cfg.module_type != 'LSTM':
        raise ValueError(f'export is LSTM-only (encoder state (h, c)); got '
                         f'enc_type {cfg.module_type!r}')
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    prepared = prepare_inference_params(model, None, quantize, device=device)
    b = batch_size

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    specs = {
        'encoder': (_Encoder(prepared.encoder, cfg), (
            zeros(b, step_frames, cfg.input_size),
            zeros(cfg.enc_layers, b, cfg.enc_hidden_size),
            zeros(cfg.enc_layers, b, cfg.enc_hidden_size))),
        'decoder': (_Decoder(prepared.decoder, cfg), (
            zeros(b, 1, dtype=torch.int32),
            zeros(cfg.dec_layers, b, cfg.dec_hidden_size),
            zeros(cfg.dec_layers, b, cfg.dec_hidden_size))),
        'joint': (_Joint(prepared.joint), (
            zeros(b, cfg.enc_proj_size), zeros(b, cfg.dec_proj_size)))}
    with torch.no_grad():
        for name, (fn, args) in specs.items():
            path = os.path.join(out_dir, f'{name}.pt2')
            torch.export.save(torch.export.export(fn, args), path)
            if check_parity:
                _check_parity(fn, args, path, cfg.vocab_size)

    meta = {'batch_size': b, 'step_frames': step_frames,
            'quantize': quantize, 'device': device.type,
            'config': {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in dataclasses.asdict(cfg).items()}}
    with open(os.path.join(out_dir, 'meta.json'), 'w') as f:
        json.dump(meta, f, indent=2)
    return out_dir


def _check_parity(fn, args, path, vocab_size):
    """The reloaded artifact against the live module on seeded inputs
    (normal floats, int32 tokens in [4, vocab)), at PARITY_RTOL /
    PARITY_ATOL."""
    rng = np.random.RandomState(0)
    live = tuple(
        torch.as_tensor(rng.randint(4, vocab_size, a.shape), dtype=a.dtype)
        if a.dtype == torch.int32 else
        torch.as_tensor(rng.randn(*a.shape), dtype=a.dtype)
        for a in args)
    live = tuple(a.to(args[0].device) for a in live)
    want = fn(*live)
    got = torch.export.load(path).module()(*live)
    for w, g in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (want, got))):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL)


def build_exported_decoder(flags, export_dir=None):
    """ExportedStreamDecoder from parsed flags (the tokenizer, features and
    --device; artifacts in --export_dir or <logdir_root>/<name>/export),
    with the chunk geometry attached (win_size / hop_size) — shared by
    cli.demo, cli.youtube_live --wav and cli.wav_inference
    (export.py:120-138 of the JAX package)."""
    from edgedict_tpu_torch.config import feature_config_from_flags
    from edgedict_tpu_torch.features import FeaturePipeline
    from edgedict_tpu_torch.trainer import build_tokenizer

    device = resolve_device(flags.device)
    feature_cfg = feature_config_from_flags(flags, pad_to_divisible=False)
    export_dir = export_dir or getattr(flags, 'export_dir', None) or \
        os.path.join(flags.logdir_root, flags.name, 'export')
    decoder = ExportedStreamDecoder(
        export_dir, FeaturePipeline(feature_cfg, device),
        build_tokenizer(flags), device=device)
    decoder.win_size, decoder.hop_size = stream_chunk_geometry(
        flags.win_length, flags.hop_length, flags.downsample,
        decoder.meta['step_frames'])
    return decoder


class ExportedStreamDecoder:
    """Streaming greedy decoder over the saved artifacts (the
    OpenVINOStreamDecoder role, reference rnnt/stream.py:123-223; the JAX
    package's export.py:141-210): decode(frame) returns the newly decoded
    text, one token at most per encoder frame, <unk> masked and the
    argmax taken again.  `device` must be the artifact's own (ValueError
    otherwise); `feature_pipeline` featurizes on it.  Per-chunk wall times
    (ending in the last logits fetch) go to `elapsed`."""

    def __init__(self, artifact_dir, feature_pipeline, tokenizer, *,
                 device='cuda', blank=0):
        with open(os.path.join(artifact_dir, 'meta.json')) as f:
            self.meta = json.load(f)
        self.device = resolve_device(device)
        if self.meta['device'] != self.device.type:
            raise ValueError(f'{artifact_dir} was exported for '
                             f"{self.meta['device']!r}; it does not run on "
                             f'{self.device.type!r}')
        cfg = self.meta['config']
        self.enc_shape = (cfg['enc_layers'], self.meta['batch_size'],
                          cfg['enc_hidden_size'])
        self.dec_shape = (cfg['dec_layers'], self.meta['batch_size'],
                          cfg['dec_hidden_size'])
        self.blank = blank
        self.tokenizer = tokenizer
        self.pipeline = feature_pipeline
        self.encoder, self.decoder, self.joint = (
            torch.export.load(os.path.join(artifact_dir, f'{name}.pt2'))
            .module() for name in COMPONENTS)
        self.reset_profile()
        self.reset()

    def reset_profile(self):
        """Per-chunk wall times (reference rnnt/stream.py:16-26), read by
        cli.wav_inference."""
        self.elapsed = []

    @torch.no_grad()
    def reset(self):
        """Zero encoder state; the predictor primed with BOS."""
        self.enc_h = torch.zeros(self.enc_shape, device=self.device)
        self.enc_c = torch.zeros_like(self.enc_h)
        bos = torch.full((self.meta['batch_size'], 1), BOS,
                         dtype=torch.int32, device=self.device)
        zeros = torch.zeros(self.dec_shape, device=self.device)
        self.dec_x, self.dec_h, self.dec_c = self.decoder(bos, zeros, zeros)

    @torch.no_grad()
    def decode(self, frame) -> str:
        """frame: (win_size,) samples → newly decoded text."""
        start = time.perf_counter()
        audio = torch.as_tensor(np.asarray(frame, np.float32)[None]).to(
            self.device)
        xs, _ = self.pipeline(audio, torch.full(
            (1,), audio.shape[1], dtype=torch.int32, device=self.device))
        enc_xs, self.enc_h, self.enc_c = self.encoder(
            xs.float(), self.enc_h, self.enc_c)
        out = []
        for k in range(enc_xs.shape[1]):
            logits = self.joint(enc_xs[:, k], self.dec_x[:, 0])[0] \
                .cpu().numpy()
            pred = int(logits.argmax())
            if pred == UNK:
                logits[pred] = -np.inf
                pred = int(logits.argmax())
            if pred != self.blank:
                token = torch.full((1, 1), pred, dtype=torch.int32,
                                   device=self.device)
                self.dec_x, self.dec_h, self.dec_c = self.decoder(
                    token, self.dec_h, self.dec_c)
                if pred > UNK:
                    out.append(self.tokenizer.id_to_token(pred)
                               .replace('</w>', ' '))
        self.elapsed.append(time.perf_counter() - start)
        return ''.join(out)
