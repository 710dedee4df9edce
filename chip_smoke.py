#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (edgedict_tpu_torch) on one GPU.

  python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing JSON or text lines:
  1 device   card name, nvidia-smi name + power limit
  2 build    nvcc build of csrc/*.cu (seconds, ptxas register/spill lines)
  3 kernels  K1 (LSTM forward), K2 (mel power), K3 (greedy frame loop),
             each against its plain PyTorch version on the card at the main
             path's shapes, with stated tolerances (tokens exact), and both
             timed with CUDA events (median of 20 after warm-up, in turns
             plain, kernel, kernel, plain)
  4 slice    E6D2 from flagfiles/E6D2.txt with seeded random weights:
             StreamingDecoder.decode_wav of 4 s of seeded synthetic audio
             on cuda fp32 == the CPU run (plain versions), token for token;
             cuda bf16 encoder diff and token agreement; per-chunk ms
  5 server   StreamServer over MultiStreamDecoder(n_streams=8, cuda), as
             edgedict_tpu_torch/cli/serve.py builds it; 4 concurrent
             clients, each transcript == decode_wav of its audio
  6 launches every kernel launched by the main path itself: the counts are
             zeroed just before the measured cuda fp32 decode_wav and just
             before the clients connect, and read just after each, so no
             warm-up, reference or comparison call is counted
Then the kernels JSON line, the nvidia-smi line and, only when every phase
passed, {"ok": true, "device": {...}} as the last line.  Any failure exits
non-zero; without a CUDA card nothing runs.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
STATE = {}     # results shared between phases


class SmokeFailure(Exception):
    pass


def emit(obj):
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
    require(r.returncode == 0, f'nvidia-smi failed: {r.stderr.strip()}')
    return r.stdout.strip().splitlines()[0]


def set_numerics(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _median_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_pair(torch, plain, kernel):
    """(kernel ms, plain ms), each the mean of two medians taken in the
    order plain, kernel, kernel, plain."""
    p1 = _median_ms(torch, plain)
    k1 = _median_ms(torch, kernel)
    k2 = _median_ms(torch, kernel)
    p2 = _median_ms(torch, plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    STATE['kind'] = name
    STATE['smi'] = nvidia_smi_line()
    emit({'phase': 'device', 'name': name,
          'count': torch.cuda.device_count(), 'nvidia_smi': STATE['smi'],
          'torch': torch.__version__, 'cuda': torch.version.cuda})


def phase_build(torch):
    from edgedict_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    ptxas = [ln.strip() for ln in info['log'].splitlines()
             if 'registers' in ln or 'spill' in ln or 'Compiling entry' in ln]
    emit({'phase': 'build', 'seconds': round(time.perf_counter() - t0, 3),
          'nvcc_seconds': round(info['seconds'], 3),
          'cached': info['cached'], 'library': os.path.relpath(
              info['path'], REPO)})
    for ln in ptxas:
        emit(f'ptxas: {ln}')


def _close(a, b, atol, rtol):
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    ok = bool((diff <= atol + rtol * b.abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def lstm_steps_plain(torch, K1, xp, w, h0, c0, ys, cs):
    """Each step of the plain recurrence, started from the state the
    kernel itself carried into it: (h, c) = (h0, c0) at t=0, else
    (ys[t-1], cs[t-1]).  ys[t-1] is h rounded to x_proj's dtype, which is
    what the kernel feeds the recurrent dot."""
    t, b, h4 = xp.shape
    h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b, -1)
    c_prev = torch.cat([c0[None], cs[:-1]]).reshape(t * b, -1)
    y1, c1, _ = K1.lstm_recurrence_plain(xp.reshape(1, t * b, h4), w,
                                         h_prev, c_prev)
    return y1.reshape(ys.shape), c1.reshape(cs.shape)


def phase_kernels(torch):
    from edgedict_tpu_torch import features as F
    from edgedict_tpu_torch.ops import decode_kernel as K3
    from edgedict_tpu_torch.ops import features_kernel as K2
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    from edgedict_tpu_torch.models import transducer as T
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    summary = {}

    def record(name, err, ms=None, plain_ms=None):
        s = summary.setdefault(name, {'max_abs_err': 0.0})
        s['max_abs_err'] = max(s['max_abs_err'], err)
        if ms is not None and 'ms' not in s:
            s['ms'], s['plain_ms'] = ms, plain_ms

    # K2 — mel power, E6D2 featurizer (n_fft 512, win 320, hop 200, 80 mels)
    cfg = F.FeatureConfig(feature_type='logfbank', feature_size=80,
                          n_fft=512, win_length=320, hop_length=200,
                          downsample=3, pad_to_divisible=False)
    pipe = F.FeaturePipeline(cfg, dev)
    for b, length in ((1, 1320), (8, 1320), (1, 64000), (8, 64000)):
        audio = torch.as_tensor(
            (rng.randn(b, length) * 0.1).astype(np.float32), device=dev)
        audio[:, : length // 4] *= 1e-4           # near-silent stretch
        audio = F.preemphasis(audio)
        ker = K2.mel_power(audio, pipe.tables)
        ref = K2.mel_power_plain(audio, pipe.tables)
        torch.cuda.synchronize()
        ok, err = _close(torch.log(ker + F.LOG_GUARD),
                         torch.log(ref + F.LOG_GUARD), 5e-3, 1e-3)
        _, perr = _close(ker, ref, 0.0, 0.0)
        case = {'kernel': 'K2 mel_power', 'B': b, 'samples': length,
                'frames': ker.shape[1], 'logmel_max_abs': err,
                'power_max_abs': perr, 'tol': 'log-mel atol 5e-3 rtol 1e-3'}
        if length == 1320 or b == 1:
            ms, pms = time_pair(torch,
                                lambda: K2.mel_power_plain(audio, pipe.tables),
                                lambda: K2.mel_power(audio, pipe.tables))
            case.update(ms=ms, plain_ms=pms)
        emit(case)
        require(ok, f'K2 disagrees: {case}')
        record('mel_power', err, case.get('ms') if (b, length) == (1, 1320)
               else None, case.get('plain_ms'))

    # K1 — LSTM recurrence, encoder (H=1024) and prediction net (H=256)
    cases = [(1024, b, t, dt) for dt in (torch.float32, torch.bfloat16)
             for b in (1, 8) for t in (1, 2, 16)]
    cases += [(256, b, t, torch.float32) for b in (1, 8) for t in (1, 2)]
    for hid, b, t, dt in cases:
        k = 1.0 / hid ** 0.5
        xp = torch.as_tensor(rng.randn(t, b, 4 * hid).astype(np.float32),
                             device=dev).to(dt)
        w = torch.as_tensor(rng.uniform(-k, k, (4 * hid, hid))
                            .astype(np.float32), device=dev).to(dt)
        h0 = torch.as_tensor(rng.randn(b, hid).astype(np.float32) * 0.5,
                             device=dev)
        c0 = torch.as_tensor(rng.randn(b, hid).astype(np.float32) * 0.5,
                             device=dev)
        ys, cs, hT = K1.lstm_recurrence(xp, w, h0, c0)
        rys, rcs, rhT = K1.lstm_recurrence_plain(xp, w, h0, c0)
        step_ys, step_cs = lstm_steps_plain(torch, K1, xp, w, h0, c0, ys, cs)
        torch.cuda.synchronize()
        # free-running, bf16 drifts: a one-ulp flip of h's bf16 rounding
        # feeds every later step.  Step by step from the kernel's own state,
        # cs is held to the fp32 bound, so a kernel that fed fp32 h to the
        # dot (no bf16 cast) fails; bf16 ys may still differ by one ulp
        run_tol = (1e-4, 1e-4) if dt == torch.float32 else (2e-2, 2e-2)
        ys_tol = (1e-4, 1e-4) if dt == torch.float32 else (1e-2, 0.0)
        oks, errs = zip(*[_close(a, r, *tol) for a, r, tol in
                          ((ys, rys, run_tol), (cs, rcs, run_tol),
                           (hT, rhT, run_tol), (ys, step_ys, ys_tol),
                           (cs, step_cs, (1e-4, 1e-4)))])
        case = {'kernel': 'K1 lstm_fwd', 'H': hid, 'B': b, 'T': t,
                'dtype': str(dt).split('.')[-1], 'ys_max_abs': errs[0],
                'cs_max_abs': errs[1], 'hT_max_abs': errs[2],
                'step_ys_max_abs': errs[3], 'step_cs_max_abs': errs[4],
                'tol': f'run atol {run_tol[0]} rtol {run_tol[1]}; per step '
                       f'ys atol {ys_tol[0]} rtol {ys_tol[1]}, cs atol 1e-4 '
                       'rtol 1e-4'}
        main = (hid, b, t, dt) == (1024, 1, 2, torch.float32)
        if t != 16 or b == 1:
            ms, pms = time_pair(
                torch, lambda: K1.lstm_recurrence_plain(xp, w, h0, c0),
                lambda: K1.lstm_recurrence(xp, w, h0, c0))
            case.update(ms=ms, plain_ms=pms)
        emit(case)
        require(all(oks), f'K1 disagrees: {case}')
        record('lstm_fwd', max(errs), case.get('ms') if main else None,
               case.get('plain_ms'))

    # K3 — greedy frame loop at E6D2's joint / prediction-net widths
    dcfg = T.TransducerConfig(vocab_size=2048, vocab_embed_size=64,
                              enc_hidden_size=8, enc_layers=1,
                              enc_proj_size=640, dec_hidden_size=256,
                              dec_layers=2, dec_proj_size=256,
                              joint_size=640)
    # blank bias 0: every frame emits; 1.8: about half blank; 6: all blank
    for blank_bias in (0.0, 1.8, 6.0):
        model = T.Transducer(dcfg, device=dev, seed=1)
        with torch.no_grad():
            model.joint.out.bias[dcfg.blank] += blank_bias
            model.joint.out.bias[3] += 0.0 if blank_bias else 4.0  # <unk>
        cache = K3.build_decode_cache(model)
        for b in (1, 8):
            with torch.no_grad():
                h_dec0, (hs, cs) = T.decoder_apply(
                    model.decoder, dcfg,
                    torch.zeros((b, 0), dtype=torch.long, device=dev))
            h_dec0 = h_dec0[:, 0].contiguous()
            for t in (1, 16):
                f = torch.as_tensor(rng.randn(t, b, 640).astype(np.float32),
                                    device=dev)
                for emit_logp in (False, True):
                    args = (cache, f, h_dec0, hs, cs, 0, 3, emit_logp)
                    out = K3.greedy_frame_loop(*args)
                    ref = K3.greedy_frame_loop_plain(*args)
                    torch.cuda.synchronize()
                    tok_eq = bool(torch.equal(out[0], ref[0]))
                    errs = [_close(a, r, 1e-4, 1e-4) for a, r in
                            zip(out[1:], ref[1:]) if a is not None]
                    err = max(e for _, e in errs)
                    case = {'kernel': 'K3 greedy_decode', 'B': b, 'T': t,
                            'emit_logp': emit_logp, 'unk': 3,
                            'blank_bias': blank_bias, 'tokens_equal': tok_eq,
                            'blank_share': float((ref[0] == 0).float()
                                                 .mean()),
                            'state_max_abs': err,
                            'tol': 'tokens exact, atol 1e-4 rtol 1e-4'}
                    main = (b, t, emit_logp, blank_bias) == (1, 1, False, 0.0)
                    if not emit_logp and (t == 1 or b == 1):
                        ms, pms = time_pair(
                            torch, lambda: K3.greedy_frame_loop_plain(*args),
                            lambda: K3.greedy_frame_loop(*args))
                        case.update(ms=ms, plain_ms=pms)
                    emit(case)
                    require(tok_eq and all(ok for ok, _ in errs),
                            f'K3 disagrees: {case}')
                    record('greedy_decode', err,
                           case.get('ms') if main else None,
                           case.get('plain_ms'))
    STATE['kernels'] = summary


def _e6d2():
    from edgedict_tpu_torch import config as C
    flags = C.parse_flags(C.add_model_flags(argparse.ArgumentParser()),
                          [f'--flagfile={REPO}/flagfiles/E6D2.txt'])
    feat = C.feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = C.transducer_config_from_flags(flags, 2048, feat.input_size)
    return cfg, feat


def _reset_launches():
    from edgedict_tpu_torch.ops import decode_kernel, features_kernel, \
        rnn_kernel
    rnn_kernel.lstm_recurrence.launches = 0
    features_kernel.mel_power.launches = 0
    decode_kernel.greedy_frame_loop.launches = 0


def _launches():
    from edgedict_tpu_torch.ops import decode_kernel, features_kernel, \
        rnn_kernel
    return {'lstm_fwd': rnn_kernel.lstm_recurrence.launches,
            'mel_power': features_kernel.mel_power.launches,
            'greedy_decode': decode_kernel.greedy_frame_loop.launches}


def _first_divergence(torch, model, cfg, feat, tok, audio, a, b):
    """Replay the CPU plain decode up to the first frame where the token
    sequences a and b differ; return (frame, top-2 logit gap there)."""
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.models import transducer as T
    from edgedict_tpu_torch.ops.decode_kernel import greedy_frame_loop_plain
    k = int(np.argmax(a[:len(b)] != b[:len(a)]))
    dec = S.StreamingDecoder(model, cfg, feat, tok, device='cpu')
    state, frame = dec._fresh, 0
    cache = dec.model.decode_cache
    for chunk in S._chunks(audio, dec.win_size, dec.hop_size):
        with torch.no_grad():
            x = torch.as_tensor(chunk[None].astype(np.float32))
            xs, _ = dec.pipeline(x, torch.tensor([len(chunk)]))
            enc, enc_state = T.encoder_apply(dec.model.encoder, cfg, xs,
                                             state.enc_state)
            for i in range(enc.shape[1]):
                fr = enc[:, i] @ dec.model.joint.w_enc.t()
                g = state.h_dec @ cache['w_dec_t'] + cache['b_joint']
                logits = torch.tanh(fr + g) @ cache['w_out_t'] \
                    + cache['b_out']
                if frame == k:
                    top = torch.topk(logits[0], 2).values
                    return k, float(top[0] - top[1])
                _, _, h_dec, hs, cs = greedy_frame_loop_plain(
                    cache, fr[None], state.h_dec, *state.dec_state,
                    int(cfg.blank), 3)
                state = S.StreamState(state.enc_state, (hs, cs), h_dec)
                frame += 1
            state = S.StreamState(enc_state, state.dec_state, state.h_dec)
    return k, float('nan')


def phase_slice(torch):
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model = T.Transducer(cfg, device='cpu', seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    audio = synthetic_audio(0)
    emit({'phase': 'slice', 'config': 'flagfiles/E6D2.txt', 'params':
          n_params, 'input_size': cfg.input_size, 'audio_s': len(audio) /
          16000, 'weights': 'random, seed 0'})

    def run(device, dtype, count=False):
        dec = S.StreamingDecoder(model, cfg, feat, tok, device=device,
                                 compute_dtype=dtype)
        dec.decode_wav(audio)                    # warm-up
        dec.reset_profile()
        if count:
            _reset_launches()
        text = dec.decode_wav(audio)
        if count:
            STATE['launches_decode_wav'] = _launches()
        return dec, text, np.concatenate(dec.emitted)

    cuda32, text32, tok32 = run('cuda', None, count=True)
    cpu32, text_cpu, tok_cpu = run('cpu', None)
    cuda16, text16, tok16 = run('cuda', torch.bfloat16)
    equal = tok32.shape == tok_cpu.shape and bool((tok32 == tok_cpu).all())
    res = {'phase': 'slice', 'frames': int(tok32.size),
           'nonblank_frames': int((tok32 != 0).sum()),
           'chunks': len(cuda32.elapsed),
           'cuda_fp32_equals_cpu': equal,
           'chunk_ms_cuda_fp32': 1e3 * float(np.mean(cuda32.elapsed)),
           'chunk_ms_cuda_bf16': 1e3 * float(np.mean(cuda16.elapsed)),
           'chunk_ms_cpu_fp32': 1e3 * float(np.mean(cpu32.elapsed)),
           'bf16_token_agreement': float((tok16 == tok32).mean())
           if tok16.shape == tok32.shape else 0.0}
    # encoder output, bf16 encoder vs fp32, over the whole utterance as
    # one layer-major block
    with torch.no_grad():
        chunks = torch.as_tensor(S._chunks(audio, cuda32.win_size,
                                           cuda32.hop_size), device='cuda')
        lens = torch.full((len(chunks),), chunks.shape[1], device='cuda')
        xs, _ = cuda32.pipeline(chunks, lens)
        xs = xs.reshape(1, -1, xs.shape[-1])
        e32, _ = T.encoder_apply(cuda32.model.encoder, cfg, xs)
        e16, _ = T.encoder_apply(cuda16.model.encoder, cfg,
                                 xs.to(torch.bfloat16))
        res['bf16_encoder_max_abs'] = float((e16.float() - e32).abs().max())
        res['encoder_out_max_abs'] = float(e32.abs().max())
    if not equal:
        k, gap = _first_divergence(torch, model, cfg, feat, tok, audio,
                                   tok_cpu, tok32)
        res.update(first_diverging_frame=k, top2_gap=gap)
    emit(res)
    require(equal, 'cuda fp32 tokens differ from the CPU run')
    require(res['nonblank_frames'] > 0, 'no token emitted')
    STATE['model'] = model
    STATE['chunk_ms'] = res['chunk_ms_cuda_fp32']


def phase_server(torch):
    import asyncio

    from edgedict_tpu.serving import stream_client
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.cli.serve import build_server
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model = STATE.get('model') or T.Transducer(cfg, device='cpu', seed=0)
    audios = [synthetic_audio(10 + i, seconds=3.0) for i in range(4)]
    single = S.StreamingDecoder(model, cfg, feat, tok, device='cuda')
    expected = [single.decode_wav(a) for a in audios]
    dec = S.MultiStreamDecoder(model, cfg, feat, tok, n_streams=8,
                               device='cuda')
    server = build_server(dec, port=0, round_timeout_ms=0)   # lockstep
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        started.set()
        loop.run_forever()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    require(started.wait(120), 'server did not start')
    results = [None] * len(audios)

    def client(i):
        results[i] = stream_client('127.0.0.1', server.port, audios[i])

    try:
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(audios))]
        _reset_launches()
        for c in clients:
            c.start()
        for c in clients:
            c.join(600)
        STATE['launches_server'] = _launches()
        require(not any(c.is_alive() for c in clients), 'client timed out')
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(60)
    match = [r == e for r, e in zip(results, expected)]
    res = {'phase': 'server', 'n_streams': dec.n, 'clients': len(audios),
           'rounds': server.rounds,
           'round_ms_mean': 1e3 * float(np.mean(dec.elapsed)),
           'transcripts_match': match,
           'transcript_chars': [len(r or '') for r in results]}
    emit(res)
    require(all(match), 'a server transcript differs from decode_wav')
    STATE['round_ms'] = res['round_ms_mean']


SOURCES = {
    'lstm_fwd': ('edgedict_tpu_torch/csrc/lstm_fwd.cu',
                 'edgedict_tpu/ops/rnn_pallas.py:116'),
    'mel_power': ('edgedict_tpu_torch/csrc/mel_power.cu',
                  'edgedict_tpu/ops/features_pallas.py:57'),
    'greedy_decode': ('edgedict_tpu_torch/csrc/greedy_decode.cu',
                      'edgedict_tpu/ops/decode_pallas.py:131'),
}


def main():
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 2
    try:
        import edgedict_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port is not importable: {e}',
              file=sys.stderr)
        return 2
    set_numerics(torch)
    phases = (('device', phase_device), ('build', phase_build),
              ('kernels', phase_kernels), ('slice', phase_slice),
              ('server', phase_server))
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            fn(torch)
            emit(f'phase {name} passed in {time.perf_counter() - t0:.1f} s')
        runs = {'decode_wav': STATE['launches_decode_wav'],
                'server': STATE['launches_server']}
        emit({'phase': 'launches', **runs})
        for run, counts in runs.items():
            require(all(n > 0 for n in counts.values()),
                    f'a kernel was not launched by {run}: {counts}')
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr, flush=True)
        return 1
    launches = {k: sum(c[k] for c in runs.values()) for k in SOURCES}
    kernels = STATE['kernels']
    emit({'kernels': [
        {'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
         'replaces': SOURCES[name][1], 'launches': launches[name],
         'max_abs_err': kernels[name]['max_abs_err'],
         'ms': kernels[name]['ms'], 'plain_ms': kernels[name]['plain_ms']}
        for name in SOURCES]})
    emit(nvidia_smi_line())
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': STATE['kind'],
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
