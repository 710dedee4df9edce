"""Streaming decode runtime (counterpart of edgedict_tpu/stream.py): greedy
and beam search, one stream or N in server mode.

A greedy decoder carries the encoder state (LSTM (h, c), or GRU h),
prediction-net (h, c) and the last prediction-net output across fixed-size
audio chunks; each chunk is featurized (K2), run through one encoder step
(per layer K1 for the LSTM, K5 for the GRU) and every
resulting encoder frame emits at most one token through the fused frame
loop (K3): argmax of the joint, `<unk>` re-argmaxed, the prediction net
advanced only on non-blank (reference rnnt/stream.py:28-120).  A beam
decoder carries the fixed-shape beam of models/beam_search.py instead and
returns the current best full hypothesis per chunk; its frames run the
prediction net (and the LM of shallow fusion) through K1 at B·W rows.

Chunk geometry (reference youtube_live.py:26-30):
  win_size = win_length + hop_length * (downsample * step_n_frame - 1)
  hop_size = hop_length * downsample * step_n_frame
with the features computed per chunk with pad_to_divisible=False.

Every decoder takes an explicit `device`; 'cuda' without a card raises.
`quantize='int8'` serves an int8 weight-only encoder (ops/quant.py: K11
for the input projections and the final projection, K12 / K13 for the LSTM
/ GRU recurrences).

The multi-stream decoders take `devices=` instead (the JAX package's
`mesh=` over a 'dp' axis, stream.py:241, :462, :605 there): a replica on
each device holds its own prepared copy of the model (K3 decode cache and
int8 weights included) and a contiguous slice of the streams' states; a
round launches every replica's chunk step, each under its device, before
it waits on any token fetch, and returns the streams in order.  `mesh=`
itself, and any multi-device argument of the single-stream decoders,
raises.
"""

import copy
import time
from typing import NamedTuple

import numpy as np
import torch

from edgedict_tpu_torch._build import on_device
from edgedict_tpu_torch.features import FeatureConfig, FeaturePipeline
from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.ops import quant
from edgedict_tpu_torch.ops.decode_kernel import (
    build_decode_cache, greedy_frame_loop)
from edgedict_tpu_torch.tokenizer import UNK


class StreamState(NamedTuple):
    enc_state: object        # encoder: LSTM ((L, B, H), (L, B, H)),
                             # GRU (L, B, H)
    dec_state: tuple         # prediction net ((L, B, H), (L, B, H))
    h_dec: torch.Tensor      # last prediction-net output (B, dec_proj)


def resolve_device(device):
    """torch.device(device), refusing 'cuda' when no card is visible."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           'torch.cuda.is_available() is False')
    return device


def stream_chunk_geometry(win_length, hop_length, downsample, step_n_frame):
    """(win_size, hop_size) in samples (reference youtube_live.py:26-30)."""
    win_size = win_length + hop_length * (downsample * step_n_frame - 1)
    hop_size = hop_length * downsample * step_n_frame
    return win_size, hop_size


def _not_ported(mesh):
    if mesh is not None:
        raise NotImplementedError('mesh= is the JAX package\'s: a multi-'
                                  'stream decoder takes devices=[...]; a '
                                  'single stream runs on one device')


def replica_devices(device, devices, n_streams):
    """The devices a multi-stream decoder spreads its streams over:
    `devices` (n_streams a multiple of their count, as the JAX decoders
    assert of the mesh), else [device]."""
    if devices is None:
        if device is None:
            raise ValueError('pass device= or devices=')
        return [resolve_device(device)]
    devices = [resolve_device(d) for d in devices]
    if not devices or n_streams % len(devices):
        raise ValueError(f'{n_streams} streams do not split evenly over '
                         f'{len(devices)} devices')
    return devices


@torch.no_grad()
def make_stream_state(model, cfg: T.TransducerConfig, batch, device):
    """Zero encoder state; prediction net primed with BOS (reference
    rnnt/stream.py:78-91).  batch > 1 = independent parallel streams."""
    enc_state = T.encoder_zero_state(cfg, batch, device)
    empty = torch.zeros((batch, 0), dtype=torch.long, device=device)
    h_dec, dec_state = T.decoder_apply(model.decoder, cfg, empty)
    return StreamState(enc_state=enc_state, dec_state=dec_state,
                       h_dec=h_dec[:, 0].contiguous())


@torch.no_grad()
def prepare_inference_params(model, dtype=None, quantize=None, device=None):
    """A frozen copy of `model` on `device` for serving.

    Serving precision policy (stream.py:71-139 of the JAX package): with a
    reduced `dtype` (bf16) ONLY the encoder is cast; the prediction net and
    the joint stay fp32, so the whole frame-synchronous token loop runs in
    fp32 and token decisions do not sit on bf16 rounding boundaries.  The
    copy carries `decode_cache`, the K3 weight layout, built once.

    quantize='int8' replaces the encoder by its int8 weight-only version
    (ops/quant.py:quantize_encoder), quantized from the PRE-CAST fp32
    weights so that the int8 values and the fp32 scales do not depend on
    the serving dtype; only the pass-through tensors (biases, LayerNorms)
    then follow `dtype` (stream.py:99-131).  Another mode raises
    ValueError."""
    if quantize not in (None, 'int8'):
        raise ValueError(f"unknown quantize mode {quantize!r}; expected "
                         "'int8'")
    prepared = copy.deepcopy(model).requires_grad_(False)
    if quantize is not None:
        prepared.encoder = quant.quantize_encoder(prepared.encoder)
    if device is not None:
        prepared.to(device)
    if dtype is not None:
        if quantize is not None:
            quant.cast_passthrough(prepared.encoder, dtype)
        else:
            prepared.encoder.to(dtype)
    prepared.decode_cache = build_decode_cache(prepared)
    return prepared


def make_chunk_step(model, cfg: T.TransducerConfig,
                    pipeline: FeaturePipeline, unk_id=None,
                    compute_dtype=None):
    """Per-chunk decode step: fn(state, audio (B, chunk)) → (tokens
    (n_frames, B) int32 with NUL on silent frames, new_state).  `model`
    comes from prepare_inference_params.  fn.frame_loop(state, enc_xs) is
    the greedy loop alone."""
    blank = int(cfg.blank)
    unk = None if unk_id is None else int(unk_id)

    def frame_loop(state, enc_xs):
        # the token loop runs at the joint's fp32 (bf16 frames upcast)
        enc_xs = enc_xs.float()
        f = torch.matmul(enc_xs, model.joint.w_enc.t())  # all frames at once
        hs, cs = state.dec_state
        tokens, _, h_dec, hs, cs = greedy_frame_loop(
            model.decode_cache, f.transpose(0, 1).contiguous(), state.h_dec,
            hs, cs, blank, unk)
        return tokens, h_dec, (hs, cs)

    def encode(state, xs):
        if compute_dtype is not None:
            xs = xs.to(compute_dtype)
        enc_xs, enc_state = T.encoder_apply(model.encoder, cfg, xs,
                                            state.enc_state)
        tokens, h_dec, dec_state = frame_loop(state, enc_xs)
        return tokens, StreamState(enc_state=enc_state, dec_state=dec_state,
                                   h_dec=h_dec)

    @torch.no_grad()
    def chunk_step(state, audio):
        lens = torch.full((audio.shape[0],), audio.shape[1],
                          dtype=torch.int32, device=audio.device)
        xs, _ = pipeline(audio, lens)
        return encode(state, xs)

    chunk_step.frame_loop = frame_loop
    chunk_step.encode = encode
    return chunk_step


def make_chunk_group_step(chunk_step, pipeline: FeaturePipeline):
    """Multi-chunk step, LAYER-MAJOR: the n chunks are featurized as one
    batch, their frames concatenated along time, and the encoder runs once
    over them with the carried state — the same math as n sequential
    chunk steps (TimeReduction boundaries align because each chunk gives
    the same even number of frames), reading each layer's weights once
    per block instead of once per chunk.  fn(state, chunks (n, chunk)) →
    (tokens (n, f, 1), new_state)."""

    @torch.no_grad()
    def group_step(state, chunks):
        n = chunks.shape[0]
        lens = torch.full((n,), chunks.shape[1], dtype=torch.int32,
                          device=chunks.device)
        xs, _ = pipeline(chunks, lens)                 # (n, f, feat)
        tokens, new_state = chunk_step.encode(
            state, xs.reshape(1, n * xs.shape[1], -1))
        return tokens.reshape(n, -1, 1), new_state

    return group_step


def _audio_tensor(frames, device):
    """numpy PCM → device tensor: int16 stays int16 (the pipeline scales
    it on the device, halving the host→device bytes), anything else is
    sent as float32."""
    frames = np.asarray(frames)
    if frames.dtype != np.int16:
        frames = frames.astype(np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(frames)).to(device)


def _fetch_start(tokens):
    """Begin the device→host copy of `tokens` without waiting for it."""
    if tokens.device.type != 'cuda':
        return tokens, None
    host = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
    host.copy_(tokens, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _fetch_done(pending):
    host, event = pending
    if event is not None:
        event.synchronize()
    return host.numpy()


def _chunks(audio, win, hop):
    n = max((len(audio) - win) // hop + 1, 0)
    if not n:
        return np.zeros((0, win), np.float32)
    return np.stack([audio[i * hop:i * hop + win] for i in range(n)])


class _GreedyReplica:
    """One device's share of a MultiStreamDecoder: the prepared model, the
    feature pipeline, the chunk step and the states of `n` streams."""

    def __init__(self, model, cfg, feature_cfg, tokenizer, n, device,
                 step_n_frame, compute_dtype, quantize):
        self.device = device
        with on_device(device):
            self.model = prepare_inference_params(model, compute_dtype,
                                                  quantize, device=device)
            self.pipeline = FeaturePipeline(feature_cfg, device)
            self.chunk_step = make_chunk_step(
                self.model, cfg, self.pipeline,
                unk_id=getattr(tokenizer, 'unk_id', None),
                compute_dtype=compute_dtype)
            self.fresh = make_stream_state(self.model, cfg, n, device)
        self.state = self.fresh

    def launch(self, frames):
        """Run the chunk step on these streams' frames and start the token
        fetch; → the pending fetch."""
        with on_device(self.device):
            tokens, self.state = self.chunk_step(
                self.state, _audio_tensor(frames, self.device))
            return _fetch_start(tokens)


class MultiStreamDecoder:
    """Server mode: N independent streams decoded in one chunk step per
    round — the batch axis carries the streams; with `devices=` the
    streams are split over one replica a device (module docstring)."""

    def __init__(self, model, cfg, feature_cfg: FeatureConfig, tokenizer,
                 n_streams, *, device=None, devices=None, step_n_frame=2,
                 compute_dtype=None, quantize=None, mesh=None):
        assert not feature_cfg.pad_to_divisible
        _not_ported(mesh)
        devices = replica_devices(device, devices, n_streams)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.n = n_streams
        self.per_replica = n_streams // len(devices)
        self.replicas = [_GreedyReplica(model, cfg, feature_cfg, tokenizer,
                                        self.per_replica, dev, step_n_frame,
                                        compute_dtype, quantize)
                         for dev in devices]
        # the first replica's (the only one without devices=)
        first = self.replicas[0]
        self.device, self.model, self._fresh = (first.device, first.model,
                                                first.fresh)
        self.win_size, self.hop_size = stream_chunk_geometry(
            feature_cfg.win_length, feature_cfg.hop_length,
            feature_cfg.downsample, step_n_frame)
        self.elapsed = []
        self.reset()

    @property
    def state(self):
        """The first replica's stream states."""
        return self.replicas[0].state

    def reset(self):
        for r in self.replicas:
            r.state = r.fresh
        self._pending = None                 # decode_pipelined lag buffer

    def reset_stream(self, i):
        """Reset one stream's state, leaving the others untouched."""
        r = self.replicas[i // self.per_replica]
        i %= self.per_replica

        def blend(new, old, axis):
            out = old.clone()
            out.select(axis, i).copy_(new.select(axis, i))
            return out

        fresh, st = r.fresh, r.state
        if isinstance(st.enc_state, torch.Tensor):        # GRU (L, B, H)
            enc_state = blend(fresh.enc_state, st.enc_state, 1)
        else:                                             # LSTM (h, c)
            enc_state = tuple(blend(n, o, 1) for n, o in
                              zip(fresh.enc_state, st.enc_state))
        r.state = StreamState(
            enc_state=enc_state,
            dec_state=tuple(blend(n, o, 1) for n, o in
                            zip(fresh.dec_state, st.dec_state)),
            h_dec=blend(fresh.h_dec, st.h_dec, 0))

    def _launch(self, frames):
        """Every replica's chunk step on its slice of the streams, all
        launched before any fetch is waited on → the pending fetches."""
        frames = np.asarray(frames)
        k = self.per_replica
        return [r.launch(frames[j * k:(j + 1) * k])
                for j, r in enumerate(self.replicas)]

    @staticmethod
    def _tokens(pending):
        """(n_frames, N) tokens of the fetches, streams in order."""
        return np.concatenate([_fetch_done(p) for p in pending], axis=1)

    def decode(self, frames):
        """frames (n_streams, win_size), float or int16 PCM → list of the
        newly decoded text per stream."""
        start = time.perf_counter()
        tokens = self._tokens(self._launch(frames))
        self.elapsed.append(time.perf_counter() - start)
        return self._render(tokens)

    def _render(self, tokens):
        """(n_frames, N) int tokens → text per stream, touching only the
        emitting positions."""
        out = [''] * self.n
        flat = tokens.reshape(tokens.shape[0], self.n)
        frames_idx, stream_idx = np.nonzero(flat > UNK)
        for s in np.unique(stream_idx):
            rows = frames_idx[stream_idx == s]
            out[int(s)] = detokenize(self.tokenizer, flat[rows, s])
        return out

    def decode_pipelined(self, frames):
        """Lag-1 round: dispatch THIS round, then fetch the PREVIOUS round's
        tokens, so the host's fetch overlaps the device's work on the new
        round.  Returns None on the first call; flush() gives the last
        round's text at end of stream."""
        prev, self._pending = self._pending, self._launch(frames)
        if prev is None:
            return None
        return self._render(self._tokens(prev))

    def flush(self):
        """Drain the pipelined decoder: text of the last dispatched round."""
        prev, self._pending = self._pending, None
        return self._render(self._tokens(prev)) if prev is not None else None


def detokenize(tokenizer, tokens):
    """Token ids → text, NUL/PAD/BOS/UNK left out."""
    return ''.join(tokenizer.id_to_token(int(t)).replace('</w>', ' ')
                   for t in tokens if t > UNK)


class StreamingDecoder:
    """Single-stream decoder (the reference PytorchStreamDecoder).

    decode(frame) consumes one chunk (win_size samples) and returns the
    newly decoded text; per-chunk wall times (ending in the token fetch,
    so device work included) go to `elapsed`, and the per-frame tokens
    (blanks included) of every call since the last decode_wav go to
    `emitted`."""

    def __init__(self, model, cfg, feature_cfg: FeatureConfig, tokenizer, *,
                 device, step_n_frame=2, reset_step=None, block_chunks=1,
                 compute_dtype=None, quantize=None, mesh=None):
        assert not feature_cfg.pad_to_divisible, \
            'streaming uses pad_to_divisible=False (rnnt/stream.py:38-44)'
        _not_ported(mesh)
        self.device = resolve_device(device)
        self.model = prepare_inference_params(model, compute_dtype, quantize,
                                              device=self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.pipeline = FeaturePipeline(feature_cfg, self.device)
        self.win_size, self.hop_size = stream_chunk_geometry(
            feature_cfg.win_length, feature_cfg.hop_length,
            feature_cfg.downsample, step_n_frame)
        self.chunk_step = make_chunk_step(
            self.model, cfg, self.pipeline,
            unk_id=getattr(tokenizer, 'unk_id', None),
            compute_dtype=compute_dtype)
        self.block_chunks = max(1, block_chunks)
        self.group_step = (make_chunk_group_step(self.chunk_step,
                                                 self.pipeline)
                           if self.block_chunks > 1 else None)
        self.reset_step = reset_step
        self.compute_dtype = compute_dtype
        self._fresh = make_stream_state(self.model, cfg, 1, self.device)
        self.emitted = []
        self.reset_profile()
        self.reset()

    def reset(self):
        self.state = self._fresh
        self._steps = 0

    def reset_profile(self):
        self.elapsed = []

    def _detok(self, tokens):
        return detokenize(self.tokenizer, tokens)

    def _after(self, n_chunks):
        self._steps += n_chunks
        if self.reset_step and self._steps >= self.reset_step:
            self.reset()

    def decode(self, frame) -> str:
        """frame: (win_size,) samples → newly decoded text."""
        start = time.perf_counter()
        audio = _audio_tensor(np.asarray(frame, np.float32)[None, :],
                              self.device)
        tokens, self.state = self.chunk_step(self.state, audio)
        tokens = tokens.cpu().numpy()[:, 0]
        self.elapsed.append(time.perf_counter() - start)
        self.emitted.append(tokens)
        self._after(1)
        return self._detok(tokens)

    def decode_block(self, chunks) -> str:
        """`block_chunks` consecutive chunks (block_chunks, win_size) in one
        group step; same text as that many decode() calls."""
        assert self.group_step is not None
        if self.reset_step and self._steps + len(chunks) > self.reset_step:
            # the periodic reset lands inside this block: per-chunk decode
            # so it fires at exactly the chunk decode() would reset at
            return ''.join(self.decode(c) for c in chunks)
        start = time.perf_counter()
        tokens, self.state = self.group_step(
            self.state, _audio_tensor(np.asarray(chunks, np.float32),
                                      self.device))
        tokens = tokens.cpu().numpy().reshape(-1)
        self.elapsed.append(time.perf_counter() - start)
        self.emitted.append(tokens)
        self._after(len(chunks))
        return self._detok(tokens)

    def decode_wav(self, audio) -> str:
        """Offline chunked decode of a whole waveform (reference
        stream.py:106-117): block-grouped while whole blocks remain, then
        chunk by chunk."""
        self.reset()
        self.emitted = []
        chunks = _chunks(audio, self.win_size, self.hop_size)
        n = len(chunks)
        text = []
        i = 0
        if self.group_step is not None:
            while i + self.block_chunks <= n:
                text.append(self.decode_block(
                    chunks[i:i + self.block_chunks]))
                i += self.block_chunks
        for j in range(i, n):
            text.append(self.decode(chunks[j]))
        return ''.join(text)

    @torch.no_grad()
    def profile_components(self, audio, max_chunks=50):
        """Per-stage wall ms (stream.py:803-855 of the JAX package; the
        reference README latency table): the featurizer, the encoder, the
        joint and the prediction net run as SEPARATE calls over the first
        `max_chunks` chunks of `audio`, each ended by a synchronise on
        CUDA, greedy without <unk> masking → {'featurize', 'encoder',
        'joint', 'decoder'}: the mean ms of each, its first two samples
        (warm-up) left out where it has more.  The decode path runs all
        four in one chunk step; this mode exists to compare with the
        reference."""
        cfg, model, dev = self.cfg, self.model, self.device

        def synced(fn, key):
            t0 = time.perf_counter()
            out = fn()
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            times[key].append(time.perf_counter() - t0)
            return out

        times = {'featurize': [], 'encoder': [], 'joint': [], 'decoder': []}
        enc_state, dec_state, h_dec = make_stream_state(model, cfg, 1, dev)
        for chunk in _chunks(audio, self.win_size,
                             self.hop_size)[:max_chunks]:
            x = _audio_tensor(chunk[None], dev)
            lens = torch.full((1,), x.shape[1], dtype=torch.int32,
                              device=dev)
            xs = synced(lambda: self.pipeline(x, lens)[0], 'featurize')
            if self.compute_dtype is not None:
                xs = xs.to(self.compute_dtype)
            enc_xs, enc_state = synced(lambda: T.encoder_apply(
                model.encoder, cfg, xs, enc_state), 'encoder')
            for k in range(enc_xs.shape[1]):
                pred = synced(lambda: int(T.joint_apply(
                    model.joint, enc_xs[:, k].float(), h_dec)[0].argmax()),
                    'joint')
                if pred != cfg.blank:
                    token = torch.full((1, 1), pred, dtype=torch.long,
                                       device=dev)
                    h_new, dec_state = synced(lambda: T.decoder_apply(
                        model.decoder, cfg, token, dec_state), 'decoder')
                    h_dec = h_new[:, 0]
        return {k: float(np.mean(v[2:] if len(v) > 2 else v)) * 1e3
                if v else 0.0 for k, v in times.items()}

    def decode_wav_pipelined(self, audio) -> str:
        """decode_wav over whole blocks with a lag-1 token fetch: block i's
        tokens come back while block i+1 runs.  A trailing partial block is
        dropped, as in the JAX decoder; under a reset_step policy this
        delegates to decode_wav (which honours the resets)."""
        assert self.group_step is not None
        if self.reset_step:
            return self.decode_wav(audio)
        self.reset()
        chunks = _chunks(audio, self.win_size, self.hop_size)
        n = len(chunks) - len(chunks) % self.block_chunks
        pending, done = None, []
        start = time.perf_counter()
        for i in range(0, n, self.block_chunks):
            tokens, self.state = self.group_step(
                self.state, _audio_tensor(
                    np.asarray(chunks[i:i + self.block_chunks], np.float32),
                    self.device))
            prev, pending = pending, _fetch_start(tokens)
            if prev is not None:
                done.append(_fetch_done(prev))
        if pending is not None:
            done.append(_fetch_done(pending))
        self.elapsed.append(time.perf_counter() - start)
        return ''.join(self._detok(t.reshape(-1)) for t in done)


# ---------------------------------------------------------------------------
# beam search (models/beam_search.py), single stream and server mode
# ---------------------------------------------------------------------------

@torch.no_grad()
def prepare_lm(lm, dtype=None, device=None):
    """(LMModel, LMConfig, weight) → the same triple with a frozen copy of
    the LM on `device`, every floating weight in `dtype` when one is given
    (prepare_inference_params(lm[0], compute_dtype) of the JAX package);
    None stays None."""
    if lm is None:
        return None
    model, cfg, weight = lm
    prepared = copy.deepcopy(model).requires_grad_(False)
    prepared.to(device=device, dtype=dtype)
    return prepared, cfg, float(weight)


class _BeamRuntime:
    """What both beam decoders share: the prepared model and LM, the
    feature pipeline, the beam machinery for `batch` streams and the chunk
    step.  run_frames(enc_state, beam, xs) runs the encoder over xs
    (B, T, feat) with the carried state (K1 per layer, or K11 + K12 /
    K5 / K13), then every encoder frame through the beam; it returns
    (enc_state, beam, best tokens (B, U_cap), n_tok (B,), logp (B,))."""

    def __init__(self, model, cfg, feature_cfg, batch, device, step_n_frame,
                 beam_width, max_sym_per_frame, max_tokens, lm,
                 merge_prefixes, compute_dtype, quantize):
        from edgedict_tpu_torch.models.beam_search import make_beam_machinery
        assert not feature_cfg.pad_to_divisible
        self.device = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.win_size, self.hop_size = stream_chunk_geometry(
            feature_cfg.win_length, feature_cfg.hop_length,
            feature_cfg.downsample, step_n_frame)
        with on_device(self.device):
            self.model = prepare_inference_params(
                model, compute_dtype, quantize, device=self.device)
            self.lm = prepare_lm(lm, compute_dtype, self.device)
            self.pipeline = FeaturePipeline(feature_cfg, self.device)
            self.init_beam, self.frame_step = make_beam_machinery(
                self.model, cfg, batch, beam_width=beam_width,
                max_sym_per_frame=max_sym_per_frame, max_tokens=max_tokens,
                lm=self.lm, merge_prefixes=merge_prefixes,
                device=self.device)
            self.fresh_enc = T.encoder_zero_state(cfg, batch, self.device)

    @torch.no_grad()
    def run_frames(self, enc_state, beam, xs):
        from edgedict_tpu_torch.models.beam_search import best_hypothesis
        if self.compute_dtype is not None:
            xs = xs.to(self.compute_dtype)
        enc_xs, enc_state = T.encoder_apply(self.model.encoder, self.cfg, xs,
                                            enc_state)
        for t in range(enc_xs.shape[1]):
            beam = self.frame_step(beam, enc_xs[:, t])
        return (enc_state, beam) + best_hypothesis(beam)

    @torch.no_grad()
    def chunk_step(self, enc_state, beam, audio):
        """audio (B, chunk) → run_frames over its features."""
        lens = torch.full((audio.shape[0],), audio.shape[1],
                          dtype=torch.int32, device=audio.device)
        xs, _ = self.pipeline(audio, lens)
        return self.run_frames(enc_state, beam, xs)

    @torch.no_grad()
    def group_step(self, enc_state, beam, chunks):
        """Layer-major block, as the greedy group step: the n chunks
        featurized as one batch, their frames concatenated along time,
        the encoder once over them, then the beam over every frame."""
        n = chunks.shape[0]
        lens = torch.full((n,), chunks.shape[1], dtype=torch.int32,
                          device=chunks.device)
        xs, _ = self.pipeline(chunks, lens)
        return self.run_frames(enc_state, beam,
                               xs.reshape(1, n * xs.shape[1], -1))


class StreamingBeamDecoder:
    """Online beam search: the fixed-shape beam is carried across chunks
    beside the encoder state.  decode(chunk) returns the CURRENT best full
    hypothesis (beam search may revise earlier output, unlike greedy);
    per-call wall times (ending in the hypothesis fetch) go to `elapsed`.
    lm: optional (LMModel, LMConfig, weight) for shallow fusion; its
    weights follow `compute_dtype`, the prediction net and joint stay
    fp32, `logp` is fp32."""

    def __init__(self, model, cfg, feature_cfg: FeatureConfig, tokenizer, *,
                 device, step_n_frame=2, beam_width=4, max_sym_per_frame=3,
                 max_tokens=200, lm=None, merge_prefixes=True,
                 block_chunks=1, compute_dtype=None, quantize=None,
                 mesh=None):
        _not_ported(mesh)
        self.rt = _BeamRuntime(model, cfg, feature_cfg, 1, device,
                               step_n_frame, beam_width, max_sym_per_frame,
                               max_tokens, lm, merge_prefixes, compute_dtype,
                               quantize)
        self.device = self.rt.device
        self.model = self.rt.model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.win_size, self.hop_size = self.rt.win_size, self.rt.hop_size
        self.block_chunks = max(1, block_chunks)
        self.elapsed = []
        self.reset()

    def reset(self):
        """Fresh encoder state and the initial beam (no launch)."""
        self.enc_state = self.rt.fresh_enc
        self.beam = self.rt.init_beam()

    def _finish(self, out, start):
        self.enc_state, self.beam, toks, n_tok, _ = out
        text = detokenize(self.tokenizer,
                          toks[0].cpu().numpy()[:int(n_tok[0])])
        self.elapsed.append(time.perf_counter() - start)
        return text

    def decode(self, frame) -> str:
        """frame: (win_size,) samples → the current best full hypothesis."""
        start = time.perf_counter()
        audio = _audio_tensor(np.asarray(frame, np.float32)[None, :],
                              self.device)
        return self._finish(self.rt.chunk_step(self.enc_state, self.beam,
                                               audio), start)

    def decode_block(self, chunks) -> str:
        """`block_chunks` consecutive chunks in one layer-major group step
        (the same math as that many decode() calls)."""
        start = time.perf_counter()
        audio = _audio_tensor(np.asarray(chunks, np.float32), self.device)
        return self._finish(self.rt.group_step(self.enc_state, self.beam,
                                               audio), start)

    def decode_wav(self, audio) -> str:
        """Offline one-shot decode: every chunk, block-grouped while whole
        blocks remain when block_chunks > 1; → the final best
        hypothesis."""
        self.reset()
        chunks = _chunks(audio, self.win_size, self.hop_size)
        n = len(chunks)
        text = ''
        i = 0
        if self.block_chunks > 1:
            while i + self.block_chunks <= n:
                text = self.decode_block(chunks[i:i + self.block_chunks])
                i += self.block_chunks
        for j in range(i, n):
            text = self.decode(chunks[j])
        return text


class MultiStreamBeamDecoder:
    """Server-mode beam search: N independent streams, each with its own
    beam, advanced in one chunk step per round (the batch axis carries the
    streams, as in MultiStreamDecoder; with `devices=` one _BeamRuntime a
    device holds a contiguous slice of them).  decode(frames) returns the
    current best hypothesis text per stream; the server sends it as '='
    replace messages (serving.StreamServer(full_hypothesis=True))."""

    def __init__(self, model, cfg, feature_cfg: FeatureConfig, tokenizer,
                 n_streams, *, device=None, devices=None, step_n_frame=2,
                 beam_width=4, max_sym_per_frame=3, max_tokens=200, lm=None,
                 merge_prefixes=True, compute_dtype=None, quantize=None,
                 mesh=None):
        _not_ported(mesh)
        devices = replica_devices(device, devices, n_streams)
        self.per_replica = n_streams // len(devices)
        self.rts = [_BeamRuntime(model, cfg, feature_cfg, self.per_replica,
                                 dev, step_n_frame, beam_width,
                                 max_sym_per_frame, max_tokens, lm,
                                 merge_prefixes, compute_dtype, quantize)
                    for dev in devices]
        # the first replica's (the only one without devices=)
        self.rt = self.rts[0]
        self.device = self.rt.device
        self.model = self.rt.model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.n = n_streams
        self.win_size, self.hop_size = self.rt.win_size, self.rt.hop_size
        self.elapsed = []
        self.reset()

    @property
    def enc_state(self):
        """The first replica's encoder state."""
        return self.enc_states[0]

    @property
    def beam(self):
        """The first replica's beam."""
        return self.beams[0]

    def reset(self):
        self.enc_states = [rt.fresh_enc for rt in self.rts]
        self.beams = [rt.init_beam() for rt in self.rts]

    def reset_stream(self, i):
        """Reset stream i's encoder state and beam, leaving the others."""
        k, i = divmod(i, self.per_replica)
        rt = self.rts[k]

        def blend(axis):
            def f(new, old):
                out = old.clone()
                out.select(axis, i).copy_(new.select(axis, i))
                return out
            return f

        fresh_enc, enc = rt.fresh_enc, self.enc_states[k]
        if isinstance(fresh_enc, torch.Tensor):            # GRU (L, B, H)
            self.enc_states[k] = blend(1)(fresh_enc, enc)
        else:                                              # LSTM (h, c)
            self.enc_states[k] = tuple(map(blend(1), fresh_enc, enc))
        # the batch axis is 1 for the (L, B, W, H) network states, 0 for
        # everything else
        fresh, b = rt.init_beam(), self.beams[k]
        self.beams[k] = b._replace(
            tokens=blend(0)(fresh.tokens, b.tokens),
            n_tok=blend(0)(fresh.n_tok, b.n_tok),
            logp=blend(0)(fresh.logp, b.logp),
            dec_out=blend(0)(fresh.dec_out, b.dec_out),
            dec_state=tuple(map(blend(1), fresh.dec_state, b.dec_state)),
            lm_state=(tuple(map(blend(1), fresh.lm_state, b.lm_state))
                      if b.lm_state is not None else None),
            lm_next=(blend(0)(fresh.lm_next, b.lm_next)
                     if b.lm_next is not None else None))

    def decode(self, frames):
        """frames (n_streams, win_size), float or int16 PCM (int16 is
        scaled on the device) → the current best text per stream.  Every
        replica's step is launched before any fetch is waited on."""
        start = time.perf_counter()
        frames = np.asarray(frames)
        k, pending = self.per_replica, []
        for j, rt in enumerate(self.rts):
            with on_device(rt.device):
                self.enc_states[j], self.beams[j], toks, n_tok, _ = \
                    rt.chunk_step(self.enc_states[j], self.beams[j],
                                  _audio_tensor(frames[j * k:(j + 1) * k],
                                                rt.device))
                pending.append((_fetch_start(toks), _fetch_start(n_tok)))
        toks = np.concatenate([_fetch_done(p) for p, _ in pending])
        n_tok = np.concatenate([_fetch_done(p) for _, p in pending])
        self.elapsed.append(time.perf_counter() - start)
        return [detokenize(self.tokenizer, toks[s][:int(n_tok[s])])
                for s in range(self.n)]
