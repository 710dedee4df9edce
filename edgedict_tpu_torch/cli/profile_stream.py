"""Where a streaming chunk's time goes, for each encoder dtype (fp32, bf16).

  python -m edgedict_tpu_torch.cli.profile_stream \
      --flagfile flagfiles/E6D2.txt [--seconds 8] [--device cuda|cpu] \
      [--quantize int8] [--enc_type GRU] [--streams N]

--quantize int8 profiles the int8 weight-only encoder, --enc_type GRU the
GRU encoder (the flags of cli/stream.py).

Seeded random weights (seed 0), seeded synthetic audio and a stand-in
tokenizer over `--bpe_size` ids.  For B=1 StreamingDecoder.decode_wav it
prints one JSON line per dtype with
  wall_ms_per_chunk       unprofiled mean of the decoder's per-chunk clock;
  device_ms_per_chunk     torch.profiler: summed device time of every kernel
                          and copy, divided by the chunks;
  device_busy_share       that device time over the profiled run's wall time
                          (one stream, so device events do not overlap);
  kernel_device_ms_per_chunk   the same, per hand-written kernel of the
                          variant's path (K2, K3 and the encoder's: K1;
                          K11 + K12 int8; K5 GRU; K11 + K13 int8 GRU);
  stage_ms                featurize / encoder / frame loop, each closed by a
                          device synchronise (the chunk step run piecewise);
  block_ms                per layer-major block of --block_chunks chunks.
With --streams N (N > 1) it profiles the server's round instead:
MultiStreamDecoder at N streams, one seeded utterance of --seconds a
stream, and prints per dtype wall_ms_per_round (unprofiled mean of the
decoder's round clock), device_ms_per_round, device_busy_share and
kernel_device_ms_per_round as above.
On the CPU the device fields are null: the profiler sees no device there.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from edgedict_tpu_torch.cli.stream import set_numerics
from edgedict_tpu_torch.config import (
    add_model_flags, feature_config_from_flags, parse_flags,
    transducer_config_from_flags)
from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.stream import (
    MultiStreamDecoder, StreamingDecoder, StreamState, _audio_tensor, _chunks,
    resolve_device)

# the hand-written kernels in the profiler's trace: every substring of a
# value is in the kernel's name (K1/K5: the persistent recurrence, K12 / K13:
# its int8 LSTM / GRU entries under names of their own, K3: its one
# cooperative launch)
KERNELS = {'lstm_fwd': ('recur_fwd_kernel', 'LstmStep'),
           'lstm_fwd_q': ('recur_fwd_q_kernel',),
           'gru_fwd': ('recur_fwd_kernel', 'GruStep'),
           'gru_fwd_q': ('recur_fwd_gru_q_kernel',),
           'quant_matmul': ('qmm_',),
           'mel_power': ('mel_power_kernel',),
           'greedy_decode': ('greedy_frame_kernel',)}


# the encoder's kernels per (enc_type, quantize); K2 and K3 run in every
# variant
ENCODER_KERNELS = {('LSTM', None): ('lstm_fwd',),
                   ('LSTM', 'int8'): ('quant_matmul', 'lstm_fwd_q'),
                   ('GRU', None): ('gru_fwd',),
                   ('GRU', 'int8'): ('quant_matmul', 'gru_fwd_q')}


def kernel_of(key, kernel):
    """True if the profiler key `key` names `kernel` of KERNELS."""
    return all(sub in key for sub in KERNELS[kernel])


class StandInTokenizer:
    """Stand-in for a trained tokenizer: one distinct character per id, so
    equal text means equal non-special tokens."""
    unk_id = 3

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def id_to_token(self, i):
        return chr(0x4E00 + int(i))


def synthetic_audio(seed, seconds=4.0, sr=16000):
    """Seeded tones plus noise, with near-silent stretches."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = np.zeros_like(t)
    for _ in range(4):
        x += rng.uniform(0.05, 0.3) * np.sin(
            2 * np.pi * rng.uniform(120, 3500) * t + rng.uniform(0, 6.28))
    x += 0.02 * rng.randn(len(t))
    env = np.ones_like(t)
    for _ in range(3):
        s = rng.randint(0, len(t) - sr // 3)
        env[s:s + sr // 3] = 1e-3
    return (x * env).astype(np.float32)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def device_times_us(prof):
    """{kernel or copy name: device µs} over the profiled run."""
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + e.device_time_total
    return out


@torch.no_grad()
def stage_ms(dec, chunks, dtype):
    """Mean ms per chunk of featurize / encoder / frame loop, each ended by
    a device synchronise (the frame loop by its token fetch)."""
    dev, state = dec.device, dec._fresh
    times = []
    for chunk in chunks:
        audio = _audio_tensor(chunk[None], dev)
        lens = torch.full((1,), audio.shape[1], dtype=torch.int32,
                          device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        xs, _ = dec.pipeline(audio, lens)
        _sync(dev)
        t1 = time.perf_counter()
        if dtype is not None:
            xs = xs.to(dtype)
        enc, enc_state = T.encoder_apply(dec.model.encoder, dec.cfg, xs,
                                         state.enc_state)
        _sync(dev)
        t2 = time.perf_counter()
        tokens, h_dec, dec_state = dec.chunk_step.frame_loop(state, enc)
        tokens.cpu()
        t3 = time.perf_counter()
        state = StreamState(enc_state, dec_state, h_dec)
        times.append((t1 - t0, t2 - t1, t3 - t2))
    mean = 1e3 * np.mean(times, axis=0)
    return dict(zip(('featurize', 'encoder', 'frame_loop'),
                    map(float, mean)))


def profile_run(run, device):
    """(wall s, {kernel or copy name: device µs}) of one call of `run`
    under torch.profiler, ended by a device synchronise."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        _sync(device)
        wall = time.perf_counter() - t0
    return wall, device_times_us(prof) if device.type == 'cuda' else {}


def device_fields(wall, dev_us, n, unit, variant):
    """The profiled run's fields per `unit` (chunk or round) of n."""
    total_us = sum(dev_us.values())
    return {
        f'profiled_wall_ms_per_{unit}': 1e3 * wall / n,
        f'device_ms_per_{unit}': total_us / 1e3 / n if total_us else None,
        'device_busy_share': total_us / 1e6 / wall if total_us else None,
        f'kernel_device_ms_per_{unit}': {
            name: sum(us for key, us in dev_us.items()
                      if kernel_of(key, name)) / 1e3 / n
            if total_us else None
            for name in ENCODER_KERNELS[variant]
            + ('mel_power', 'greedy_decode')}}


def profile_dtype(model, cfg, feat, tok, audio, device, dtype, block_chunks,
                  quantize=None):
    dec = StreamingDecoder(model, cfg, feat, tok, device=device,
                           compute_dtype=dtype, quantize=quantize)
    dec.decode_wav(audio)                               # warm-up
    dec.reset_profile()
    dec.decode_wav(audio)
    n = len(dec.elapsed)
    res = {'dtype': 'bf16' if dtype is not None else 'fp32',
           'quantize': quantize, 'enc_type': cfg.module_type, 'chunks': n,
           'wall_ms_per_chunk': 1e3 * float(np.mean(dec.elapsed))}
    wall, dev_us = profile_run(lambda: dec.decode_wav(audio), device)
    res.update(device_fields(wall, dev_us, n, 'chunk',
                             (cfg.module_type, quantize)))
    res['stage_ms'] = stage_ms(
        dec, _chunks(audio, dec.win_size, dec.hop_size), dtype)

    block = StreamingDecoder(model, cfg, feat, tok, device=device,
                             block_chunks=block_chunks, compute_dtype=dtype,
                             quantize=quantize)
    block.decode_wav(audio)                             # warm-up
    block.reset_profile()
    block.decode_wav(audio)
    n_blocks = n // block_chunks
    res['block_chunks'] = block_chunks
    res['block_ms'] = (1e3 * float(np.mean(block.elapsed[:n_blocks]))
                       if n_blocks else None)
    return res


def profile_rounds(model, cfg, feat, tok, seconds, device, dtype, n_streams,
                   quantize=None):
    """The server's round: MultiStreamDecoder at n_streams (as
    cli/serve.py builds it), one seeded utterance a stream, one chunk of
    every stream a round."""
    dec = MultiStreamDecoder(model, cfg, feat, tok, n_streams=n_streams,
                             device=device, compute_dtype=dtype,
                             quantize=quantize)
    rounds = np.stack([_chunks(synthetic_audio(i, seconds), dec.win_size,
                               dec.hop_size) for i in range(n_streams)], 1)

    def run():
        dec.reset()
        for frames in rounds:
            dec.decode(frames)

    run()                                               # warm-up
    dec.elapsed = []
    run()
    res = {'dtype': 'bf16' if dtype is not None else 'fp32',
           'quantize': quantize, 'enc_type': cfg.module_type,
           'streams': n_streams, 'rounds': len(rounds),
           'wall_ms_per_round': 1e3 * float(np.mean(dec.elapsed))}
    wall, dev_us = profile_run(run, device)
    res.update(device_fields(wall, dev_us, len(rounds), 'round',
                             (cfg.module_type, quantize)))
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    add_model_flags(parser)
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default) or 'cpu'")
    parser.add_argument('--seconds', type=float, default=8.0,
                        help='length of the synthetic utterance')
    parser.add_argument('--block_chunks', type=int, default=8,
                        help='chunks per layer-major block for block_ms')
    parser.add_argument('--quantize', default=None, choices=('int8',),
                        help="'int8' = weight-only int8 encoder")
    parser.add_argument('--streams', type=int, default=1,
                        help='above 1: the server round of that many '
                        'streams instead of the B=1 chunk')
    flags = parse_flags(parser, sys.argv[1:] if argv is None else argv)
    set_numerics()
    device = resolve_device(flags.device)
    feat = feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = transducer_config_from_flags(flags, flags.bpe_size,
                                       feat.input_size)
    tok = StandInTokenizer(flags.bpe_size)
    model = T.Transducer(cfg, device='cpu', seed=0)
    head = {'device': str(device), 'enc_type': cfg.module_type,
            'quantize': flags.quantize,
            'params': sum(p.numel() for p in model.parameters()),
            'audio_s': flags.seconds}
    if device.type == 'cuda':
        head['name'] = torch.cuda.get_device_name(device)
        head['nvidia_smi'] = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps(head), flush=True)
    audio = synthetic_audio(0, flags.seconds)
    for dtype in (None, torch.bfloat16):
        if flags.streams > 1:
            res = profile_rounds(model, cfg, feat, tok, flags.seconds,
                                 device, dtype, flags.streams,
                                 flags.quantize)
        else:
            res = profile_dtype(model, cfg, feat, tok, audio, device, dtype,
                                flags.block_chunks, flags.quantize)
        print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
