#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (edgedict_tpu_torch) on one GPU.

  python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing JSON or text lines:
  1 device   card name, nvidia-smi name + power limit
  2 build    nvcc build of csrc/*.cu (seconds, ptxas register/spill lines)
  3 kernels  K1 (LSTM forward), K2 (mel power), K3 (greedy frame loop),
             K4 (LSTM backward), K5 (GRU forward), K6 (GRU backward), K7/K8
             (fused joint forward / backward), K9/K10 (lattice alpha /
             beta+grad), K11 (int8-weight matmul), K12/K13 (int8 LSTM / GRU
             recurrences), each against its plain PyTorch version on the
             card at the main paths' shapes, with stated tolerances (tokens
             exact), and both timed with CUDA events (median of 20 after
             warm-up, in turns plain, kernel, kernel, plain); K11 also
             beside a dequantize-then-F.linear yardstick (its tiled
             kernels, R > 32, as the quant_matmul_tile entry with every R=512
             case), the recurrences
             K1/K4/K5/K6 beside one cuDNN nn.LSTM / nn.GRU layer (forward,
             or forward+backward) and the port's own layer timed the same
             way (library_ms, layer_ms); K4/K6 also split into their two
             launches, the gate remat and the dh chain (torch.profiler
             device ms), and K8 into its tensor-core launches (h, dlogits,
             dh, dW, the partials' reduction) with its launch plan; K1 and
             K5 (one persistent launch per call) with their launch plan
             (grid, shared memory, blocks per SM), also at the training
             shape (H=1024 B=32 T=427 bf16, held step by step from the
             kernel's own state) beside cuDNN's layer forward and the port's
             own layer; K12/K13 beside dequantize + one cuDNN layer
             forward and the port's own int8 layer; K7 (bf16: two lattice
             tiles a block, h resident in shared memory, plan
             ops/joint_lse_plan.py fwd_plan) at the E6D2 step also with h
             staged through the slab scratch (both timed, the same bits),
             at ragged B=33, U+1 = 1, 300, 1100, J/V padded (600, 2000), a
             wide J=768 and fp32, each bit-stable across two calls; K3 (one
             cooperative launch over the card, plan ops/decode_plan.py) at
             B=1/8 T=1/16, the int8 server's B=64 and the eval decode's B=4
             T=214, bit-stable, with its device time by torch.profiler;
             each kernel's bound
             (bytes once over 3.35 TB/s, or operations over the peak of
             their type, whichever is larger) from the timed inputs
  4 slice    E6D2 from flagfiles/E6D2.txt with seeded random weights:
             StreamingDecoder.decode_wav of 4 s of seeded synthetic audio
             on cuda fp32 == the CPU run (plain versions), token for token;
             cuda bf16 encoder diff and token agreement; per-chunk ms
  5 slice_int8  the same decode with quantize='int8' (fp32): cuda == the
             CPU int8 run token for token, int8-vs-fp32 token agreement,
             per-chunk ms, encoder bytes int8 against fp32
  6 slice_gru  E6D2 widths with enc_type GRU (seeded random weights): cuda
             fp32 == CPU, cuda int8 == CPU int8, bf16 encoder diff and
             token agreement, per-chunk ms
  7 server   StreamServer over MultiStreamDecoder(n_streams=8, cuda), as
             edgedict_tpu_torch/cli/serve.py builds it; 4 concurrent
             clients, each transcript == decode_wav of its audio
  8 server_int8  the same with quantize='int8' (cli/serve.py --quantize
             int8) at n_streams=64, where every K11 call runs its tiled
             kernel (R = 128 and 64 rows)
  9 train_parity  one fp32 E6D2 train step (full width and depth, B=4,
             ~2 s) on cuda against the CPU plain path from the same weights
             and batch: loss, grad_norm, grads and params after the Adam step
 10 train_parity_gru  the same with --enc_type GRU (K5/K6 on cuda)
 11 train_run  the port's Trainer (as cli/baseline.py builds it) from
             flagfiles/E6D2.txt (batch 32, bf16, BPE 2048) on a seeded
             synthetic corpus of 8-16 s utterances: 2 warm-up and 5 measured
             steps (median step ms, audio s/s, peak memory), loss falling on
             a repeated small batch, one --mode eval pass (val_loss, WER)
 12 train_run_gru  the same with --enc_type GRU on the same corpus and
             BPE model, plus one step of a Trainer with --time_warp_w 80
             --optim novograd (finite loss)
 13 launches every kernel launched by the main paths themselves: the counts
             are zeroed just before each measured cuda decode_wav (LSTM
             fp32 / int8, GRU fp32 / int8), just before the clients of each
             server connect and just before the measured train steps, and
             read just after each, so no warm-up, reference or comparison
             call is counted; the decodes' counts must equal what their
             encoder calls imply (per call: int8 LSTM K11 7, K12 6, K1 0;
             GRU K5 6; int8 GRU K11 7, K13 6, K5 0), the train counts what
             the steps imply (per micro-step: LSTM 8 K1 and 8 K4, GRU 6 K5,
             6 K6, 2 K1 and 2 K4; one of K2 and K7-K10 each); every K11
             launch of the int8 server is a tiled one
Then the kernels JSON line, the nvidia-smi line and, only when every phase
passed, {"ok": true, "device": {...}} as the last line.  Any failure exits
non-zero; without a CUDA card nothing runs.
"""

import argparse
import json
import os
import shutil
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


# the H100 SXM's published peaks (NVIDIA's data sheet; dense): device memory
# rate and the operation rate of each input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'fp32': 67e12, 'bf16': 989e12}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, n_ops, kind):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of the bytes moved (each input read once, each output
    written once) over the memory rate and the operations over the peak of
    their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def kind_of(torch, t):
    return 'bf16' if t.dtype == torch.bfloat16 else 'fp32'


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


def fwd_plan(x_proj, gates):
    """K1/K5's launch plan for x_proj (ops/rnn_fwd.py, from the card)."""
    import dataclasses

    from edgedict_tpu_torch.ops import rnn_fwd
    return dataclasses.asdict(rnn_fwd.card_plan(x_proj, gates))


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
    import dataclasses

    from edgedict_tpu_torch import features as F
    from edgedict_tpu_torch.ops import decode_kernel as K3
    from edgedict_tpu_torch.ops import features_kernel as K2
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    from edgedict_tpu_torch.models import transducer as T
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    summary = {}

    def record(name, err, ms=None, plain_ms=None, bounds=None,
               library_ms=None):
        """Keep the largest error, and the times and bound of the first
        timed main-path case."""
        s = summary.setdefault(name, {'max_abs_err': 0.0})
        s['max_abs_err'] = max(s['max_abs_err'], err)
        if ms is not None and 'ms' not in s:
            s['ms'], s['plain_ms'], s['library_ms'] = ms, plain_ms, library_ms
            s['bound_ms'], s['bound_by'] = bounds

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
        n_freq, n_mels = pipe.tables.mel_t.shape
        frames = b * ker.shape[1]
        bounds = bound(nbytes(audio, pipe.tables.wcos, pipe.tables.wsin,
                              pipe.tables.mel_t, ker),
                       frames * (4 * cfg.n_fft * n_freq + 3 * n_freq
                                 + 2 * n_freq * n_mels), 'fp32')
        case.update(bound_ms=bounds[0], bound_by=bounds[1])
        emit(case)
        require(ok, f'K2 disagrees: {case}')
        record('mel_power', err, case.get('ms') if (b, length) == (1, 1320)
               else None, case.get('plain_ms'), bounds)

    # K1 — LSTM recurrence, encoder (H=1024) and prediction net (H=256, and
    # E6D2_LARGE_Batch's 512); the persistent kernel's 32-row slabs at the
    # ragged B=33 and the server's 256
    cases = [(1024, b, t, dt) for dt in (torch.float32, torch.bfloat16)
             for b in (1, 8) for t in (1, 2, 16)]
    cases += [(256, b, t, torch.float32) for b in (1, 8) for t in (1, 2)]
    cases += [(1024, 33, 3, torch.bfloat16), (1024, 256, 2, torch.float32),
              (512, 32, 2, torch.bfloat16)]
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
                       'rtol 1e-4', 'plan': fwd_plan(xp, 4)}
        main = (hid, b, t, dt) == (1024, 1, 2, torch.float32)
        if t != 16 or b == 1:
            ms, pms = time_pair(
                torch, lambda: K1.lstm_recurrence_plain(xp, w, h0, c0),
                lambda: K1.lstm_recurrence(xp, w, h0, c0))
            case.update(ms=ms, plain_ms=pms)
        if main:
            case.update(layer_times(torch, 'LSTM', hid, b, t, dt, False))
        bounds = bound(nbytes(xp, w, h0, c0, ys, cs, hT),
                       2 * t * b * 4 * hid * hid, kind_of(torch, xp))
        case.update(bound_ms=bounds[0], bound_by=bounds[1])
        emit(case)
        require(all(oks), f'K1 disagrees: {case}')
        record('lstm_fwd', max(errs), case.get('ms') if main else None,
               case.get('plain_ms'), bounds, case.get('library_ms'))

    # K3 — greedy frame loop at E6D2's joint / prediction-net widths: one
    # stream (T=1: a streaming chunk), the fp32 server's 8 and the int8
    # server's 64 streams, and the trainer's eval decode (B=4 over a whole
    # utterance, T=214)
    dcfg = T.TransducerConfig(vocab_size=2048, vocab_embed_size=64,
                              enc_hidden_size=8, enc_layers=1,
                              enc_proj_size=640, dec_hidden_size=256,
                              dec_layers=2, dec_proj_size=256,
                              joint_size=640)
    # blank bias 0: every frame emits; 1.8: about half blank; 6: all blank
    k3_timed = []      # (case, args): device time by the profiler, last
    for blank_bias in (0.0, 1.8, 6.0):
        model = T.Transducer(dcfg, device=dev, seed=1)
        with torch.no_grad():
            model.joint.out.bias[dcfg.blank] += blank_bias
            model.joint.out.bias[3] += 0.0 if blank_bias else 4.0  # <unk>
        cache = K3.build_decode_cache(model)
        for b, t in ((1, 1), (1, 16), (8, 1), (8, 16), (64, 1), (4, 214)):
            with torch.no_grad():
                h_dec0, (hs, cs) = T.decoder_apply(
                    model.decoder, dcfg,
                    torch.zeros((b, 0), dtype=torch.long, device=dev))
            h_dec0 = h_dec0[:, 0].contiguous()
            f = torch.as_tensor(rng.randn(t, b, 640).astype(np.float32),
                                device=dev)
            for emit_logp in (False, True):
                args = (cache, f, h_dec0, hs, cs, 0, 3, emit_logp)
                out = K3.greedy_frame_loop(*args)
                again = K3.greedy_frame_loop(*args)
                ref = K3.greedy_frame_loop_plain(*args)
                torch.cuda.synchronize()
                tok_eq = bool(torch.equal(out[0], ref[0]))
                errs = [_close(a, r, 1e-4, 1e-4) for a, r in
                        zip(out[1:], ref[1:]) if a is not None]
                err = max(e for _, e in errs)
                stable = all(torch.equal(a, c) for a, c in zip(out, again)
                             if a is not None)
                case = {'kernel': 'K3 greedy_decode', 'B': b, 'T': t,
                        'emit_logp': emit_logp, 'unk': 3,
                        'blank_bias': blank_bias, 'tokens_equal': tok_eq,
                        'blank_share': float((ref[0] == 0).float().mean()),
                        'state_max_abs': err, 'bit_stable': stable,
                        'tol': 'tokens exact, atol 1e-4 rtol 1e-4',
                        'plan': dataclasses.asdict(K3.card_plan(cache, f,
                                                                hs))}
                main = (b, t, emit_logp, blank_bias) == (1, 1, False, 0.0)
                if not emit_logp and (t == 1 or b == 1 or (
                        t == 214 and blank_bias == 1.8)):
                    ms, pms = time_pair(
                        torch, lambda: K3.greedy_frame_loop_plain(*args),
                        lambda: K3.greedy_frame_loop(*args))
                    case.update(ms=ms, plain_ms=pms)
                    if t == 1 or t == 214:
                        k3_timed.append(({key: case[key] for key in (
                            'B', 'T', 'blank_bias')}, args))
                bounds = k3_bound(torch, dcfg, cache, args, out)
                case.update(bound_ms=bounds[0], bound_by=bounds[1])
                emit(case)
                require(tok_eq and all(ok for ok, _ in errs) and stable,
                        f'K3 disagrees: {case}')
                record('greedy_decode', err,
                       case.get('ms') if main else None,
                       case.get('plain_ms'), bounds)
    train_kernels(torch, rng, dev, record)
    train_shape_forward(torch, rng, dev)
    summary['quant_matmul_tile']['cases'] = serving_kernels_q(torch, rng, dev,
                                                              record)
    # K3's device time by torch.profiler (None where no profiled run
    # recorded a launch)
    for key, args in k3_timed:
        ms, n = device_ms_per_launch(
            torch, lambda: K3.greedy_frame_loop(*args), 'greedy_frame_kernel')
        emit({'kernel': 'K3 greedy_decode', **key, 'device_ms': ms,
              'profiled_launches': n})
        if key == {'B': 1, 'T': 1, 'blank_bias': 0.0}:
            summary['greedy_decode']['device_ms'] = ms
    STATE['kernels'] = summary


def k3_bound(torch, cfg, cache, args, out):
    """K3's bound from this call's data: every frame's joint and logits,
    and the prediction net, its joint projection and an embedding row for
    each non-blank frame; the weights read once."""
    f, h_dec, hs, cs, blank = args[1], args[2], args[3], args[4], args[5]
    tokens = out[0]
    frames = tokens.numel()
    emitted = int((tokens != blank).sum())
    j, v = cache['w_out_t'].shape
    d = cache['w_dec_t'].shape[0]
    pred = sum(2 * (lay['w_ih_t'].numel() + lay['w_hh_t'].numel())
               for lay in cache['layers']) + 2 * cache['w_proj_t'].numel()
    weights = [t for k, t in cache.items() if k not in ('layers', 'table')]
    weights += [t for lay in cache['layers'] for t in lay.values()]
    n_bytes = (nbytes(f, h_dec, hs, cs, *weights, *out[:1], *out[2:])
               + emitted * cache['table'].shape[1] * 4)
    n_ops = frames * (2 * j * v + 2 * j) + emitted * (pred + 2 * d * j)
    return bound(n_bytes, n_ops, 'fp32')


def _rel(torch, a, b):
    """max |a - b| / max(1, max |b|), in fp32."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


ENC_IN = 240      # E6D2 encoder layer 0's input: 80 mels stacked 3 times


def layer_times(torch, cell, hid, b, t, dt, backward, n_in=ENC_IN):
    """The library yardstick of a recurrence kernel: one cuDNN nn.LSTM /
    nn.GRU layer (num_layers=1, input (T, B, n_in), weights in the same
    dtype), forward alone or forward+backward, beside the port's own layer
    (ops/rnn.py: the cuBLAS input projection and the kernels, fp32 master
    weights as in training) timed the same way.  cuDNN computes the same
    layer function (b_hh inside the GRU's reset gate included); it is a
    layer time, the kernel's ms is the recurrence alone.  Where cuDNN
    refuses the dtype, that is recorded and fp32 is timed.
    → {'library_ms', 'library_dtype', 'layer_ms', 'cudnn'}."""
    from edgedict_tpu_torch.ops import rnn as R
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(hid + b + t)
    xs = torch.randn(t, b, n_in, generator=gen).to(dev, dt)
    dy = torch.randn(t, b, hid, generator=gen).to(dev, dt)
    mod = getattr(torch.nn, cell)(n_in, hid).to(dev)
    params = {k: getattr(mod, f'{name}_l0').detach().clone().requires_grad_()
              for k, name in (('w_ih', 'weight_ih'), ('w_hh', 'weight_hh'),
                              ('b_ih', 'bias_ih'), ('b_hh', 'bias_hh'))}
    h0 = torch.zeros(b, hid, device=dev)
    state = h0 if cell == 'GRU' else (h0, h0)
    layer = R.gru_layer_tm if cell == 'GRU' else R.lstm_layer_tm

    def run(fn, x):
        if not backward:
            with torch.no_grad():
                fn(x)
            return
        x = x.detach().requires_grad_()
        fn(x)[0].backward(dy.to(x.dtype))

    out = {'cudnn': torch.backends.cudnn.version(), 'library_dtype':
           str(dt).split('.')[-1]}
    try:
        lib_mod = mod.to(dt)
        run(lib_mod, xs)
        lib_x = xs
    except RuntimeError as e:         # cuDNN refuses the dtype: say so
        out.update(cudnn_refused=f'{out["library_dtype"]}: {e}'[:200],
                   library_dtype='float32')
        lib_mod, lib_x = mod.float(), xs.float()
    out['library_ms'] = _median_ms(torch, lambda: run(lib_mod, lib_x),
                                   iters=10, warmup=2)
    out['layer_ms'] = _median_ms(torch, lambda: run(
        lambda x: layer(params, x, state), xs), iters=10, warmup=2)
    return out


def _profiled_us(torch, fn, n):
    """{kernel name: (device µs, launches)} of one run of torch.profiler
    over n calls of fn."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, count = out.get(e.key, (0.0, 0))
            out[e.key] = (us + e.device_time_total, count + e.count)
    return out


# the profiler on the card machine has lost kernel records of a profiled
# run (parent and change alike, PERF.md §7): a lost record only lowers a
# total, so parts are read as the largest of PROFILE_RUNS profiled runs
PROFILE_RUNS = 3


def kernel_split_ms(torch, fn, parts, n=5):
    """Device ms per call of fn for each part of `parts` ({name: substrings
    all in the kernel's name}), from torch.profiler over n calls: the
    largest of PROFILE_RUNS profiled runs' totals."""
    fn()
    torch.cuda.synchronize()
    best = {name: 0.0 for name in parts}
    for _ in range(PROFILE_RUNS):
        dev = _profiled_us(torch, fn, n)
        for name, subs in parts.items():
            total = sum(us for key, (us, _) in dev.items()
                        if all(sub in key for sub in subs)) / 1e3 / n
            best[name] = max(best[name], total)
    return best


def device_ms_per_launch(torch, fn, name, n=5):
    """(device ms of one launch of the kernel whose name holds `name`, the
    launches torch.profiler recorded) over n calls of fn: the mean over the
    recorded launches of the first of PROFILE_RUNS profiled runs that
    recorded one; (None, 0) when none did."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_RUNS):
        dev = _profiled_us(torch, fn, n)
        us = sum(u for key, (u, _) in dev.items() if name in key)
        count = sum(c for key, (_, c) in dev.items() if name in key)
        if count:
            return us / 1e3 / count, count
    return None, 0


# K4/K6's two launches: the gate remat over all steps and the dh chain
BWD_PARTS = {'remat_ms': ('remat_',), 'chain_ms': ('chain_kernel',)}
# K7's launches: the resident kernel (one), or the staged h and product
K7_PARTS = {'h_ms': ('joint_lse_fwd_h_',), 'mma_ms': ('joint_lse_fwd_mma',)}
# K8's tensor-core launches, summed over the slabs (ops/joint_lse_plan.py)
K8_PARTS = {'h_ms': ('joint_lse_bwd_h_',),
            'dlogits_ms': ('joint_lse_bwd_dl_',),
            'dh_ms': ('joint_lse_bwd_dh_mma',),
            'dw_ms': ('joint_lse_bwd_dw_mma',),
            'reduce_ms': ('joint_lse_bwd_reduce',)}


def train_shape_forward(torch, rng, dev):
    """K1 and K5 at the training step's encoder shape (H=1024 B=32 T=427
    bf16) beside one cuDNN layer's forward (the next redesign's yardstick).
    Free-running bf16 drifts over 427 steps (a one-ulp flip of h feeds every
    later step), so each step is held from the kernel's own carried state:
    ys to one bf16 ulp, the LSTM's cs to 1e-4; the free-running error is
    reported."""
    from edgedict_tpu_torch.ops import gru_kernel as K5
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    hid, b, t, dt = 1024, 32, 427, torch.bfloat16
    k = 1.0 / hid ** 0.5
    for cell, gates in (('LSTM', 4), ('GRU', 3)):
        xp = torch.as_tensor(rng.randn(t, b, gates * hid).astype(np.float32),
                             device=dev).to(dt)
        w = torch.as_tensor(rng.uniform(-k, k, (gates * hid, hid))
                            .astype(np.float32), device=dev).to(dt)
        h0 = torch.as_tensor(rng.randn(b, hid).astype(np.float32) * 0.5,
                             device=dev)
        if cell == 'LSTM':
            c0 = torch.as_tensor(rng.randn(b, hid).astype(np.float32) * 0.5,
                                 device=dev)
            inputs = (xp, w, h0, c0)
            kernel = lambda: K1.lstm_recurrence(*inputs)  # noqa: E731
            plain = lambda: K1.lstm_recurrence_plain(*inputs)  # noqa: E731
            ys, cs, hT = kernel()
            outs = (ys, cs, hT)
            step_ys, step_cs = lstm_steps_plain(torch, K1, xp, w, h0, c0, ys,
                                                cs)
            steps = [_close(ys, step_ys, 1e-2, 2.0 ** -7),
                     _close(cs, step_cs, 1e-4, 1e-4)]
            run_err = _close(ys, plain()[0], 0.0, 0.0)[1]
        else:
            b_hh = torch.as_tensor(rng.randn(gates * hid).astype(np.float32)
                                   * 0.1, device=dev)
            inputs = (xp, w, b_hh, h0)
            kernel = lambda: K5.gru_recurrence(*inputs)[0]  # noqa: E731
            plain = lambda: K5.gru_recurrence_plain(*inputs)  # noqa: E731
            ys = kernel()
            outs = (ys,)
            h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b,
                                                                    hid)
            step_ys = K5.gru_recurrence_plain(
                xp.reshape(1, t * b, gates * hid), w, b_hh,
                h_prev).reshape(ys.shape)
            steps = [_close(ys, step_ys, 1e-2, 2.0 ** -7)]
            run_err = _close(ys, plain(), 0.0, 0.0)[1]
        torch.cuda.synchronize()
        ms, pms = time_pair(torch, plain, kernel)
        b_ms, b_by = bound(nbytes(*inputs, *outs),
                           2 * t * b * gates * hid * hid, 'bf16')
        label = 'K1 lstm_fwd' if cell == 'LSTM' else 'K5 gru_fwd'
        case = {'kernel': label, 'H': hid, 'B': b, 'T': t, 'dtype': 'bfloat16',
                'shape': 'training', 'plan': fwd_plan(xp, gates),
                'step_max_abs': [e for _, e in steps],
                'run_max_abs': run_err, 'ms': ms, 'plain_ms': pms,
                'bound_ms': b_ms, 'bound_by': b_by,
                'tol': 'per step ys atol 1e-2 rtol 2^-7'
                       + (', cs 1e-4' if cell == 'LSTM' else '')}
        case.update(layer_times(torch, cell, hid, b, t, dt, False))
        emit(case)
        require(all(ok for ok, _ in steps), f'{label} disagrees: {case}')


def train_kernels(torch, rng, dev, record):
    """K4, K7/K8 and K9/K10 against their plain versions at the E6D2
    training step's shapes (B=32, 16 s: encoder T=427/214, prediction net
    T=U+1=65, joint J=640, V=2048)."""
    import dataclasses

    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.ops import joint_lse_plan as JP
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    from edgedict_tpu_torch.ops import rnnt_loss as PL
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
    bf16, fp32 = torch.bfloat16, torch.float32

    def t_(*shape, scale=1.0, dtype=fp32):
        return torch.as_tensor((rng.randn(*shape) * scale).astype(np.float32),
                               device=dev).to(dtype)

    # K4 — LSTM backward: encoder layer 0 in bf16 (the training dtype), a
    # shorter encoder layer in fp32, the prediction net in bf16
    for hid, b, t, dt in ((1024, 32, 427, bf16), (1024, 32, 64, fp32),
                          (256, 32, 65, bf16)):
        k = 1.0 / hid ** 0.5
        xp = t_(t, b, 4 * hid, dtype=dt)
        w = torch.as_tensor(rng.uniform(-k, k, (4 * hid, hid))
                            .astype(np.float32), device=dev).to(dt)
        h0, c0 = t_(b, hid, scale=0.5), t_(b, hid, scale=0.5)
        ys, cs, _ = K1.lstm_recurrence(xp, w, h0, c0)
        dys = t_(t, b, hid, dtype=dt)
        args = (xp, w, h0, c0, ys, cs, dys, None, None)
        out = K1.lstm_recurrence_bwd(*args)
        ref = K1.lstm_recurrence_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = [_rel(torch, a, r) for a, r in zip(out, ref)]
        tol = 1e-4 if dt == fp32 else 2e-2
        case = {'kernel': 'K4 lstm_bwd', 'H': hid, 'B': b, 'T': t,
                'dtype': str(dt).split('.')[-1], 'dgates_rel': errs[0],
                'dh0_rel': errs[1], 'dc0_rel': errs[2],
                'tol': f'max|d| / max(1, max|ref|) <= {tol}'}
        ms, pms = time_pair(torch, lambda: K1.lstm_recurrence_bwd_plain(*args),
                            lambda: K1.lstm_recurrence_bwd(*args))
        bounds = bound(nbytes(xp, w, h0, c0, ys, cs, dys, *out),
                       4 * t * b * 4 * hid * hid, kind_of(torch, xp))
        case.update(ms=ms, plain_ms=pms, bound_ms=bounds[0],
                    bound_by=bounds[1])
        main = (hid, t) == (1024, 427)
        case.update(kernel_split_ms(
            torch, lambda: K1.lstm_recurrence_bwd(*args), BWD_PARTS))
        if main:
            case.update(layer_times(torch, 'LSTM', hid, b, t, dt, True))
        emit(case)
        require(max(errs) <= tol, f'K4 disagrees: {case}')
        record('lstm_bwd', max(errs), ms if main else None, pms, bounds,
               case.get('library_ms'))

    # K6 — GRU backward: encoder layer 0 in bf16 (the training dtype), a
    # shorter encoder layer in fp32, and odd small shapes
    from edgedict_tpu_torch.ops import gru_kernel as K5
    for hid, b, t, dt in ((1024, 32, 427, bf16), (1024, 32, 64, fp32),
                          (1030, 11, 3, fp32), (40, 5, 7, bf16)):
        k = 1.0 / hid ** 0.5
        xp = t_(t, b, 3 * hid, dtype=dt)
        w = torch.as_tensor(rng.uniform(-k, k, (3 * hid, hid))
                            .astype(np.float32), device=dev).to(dt)
        b_hh = t_(3 * hid, scale=0.1)
        h0 = t_(b, hid, scale=0.5)
        ys, _ = K5.gru_recurrence(xp, w, b_hh, h0)
        dys = t_(t, b, hid, dtype=dt)
        dhT = t_(b, hid)
        args = (xp, w, b_hh, h0, ys, dys, dhT)
        out = K5.gru_recurrence_bwd(*args)
        ref = K5.gru_recurrence_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = [_rel(torch, a, r) for a, r in zip(out, ref)]
        tol = 1e-4 if dt == fp32 else 2e-2
        case = {'kernel': 'K6 gru_bwd', 'H': hid, 'B': b, 'T': t,
                'dtype': str(dt).split('.')[-1], 'dgx_rel': errs[0],
                'dgh_rel': errs[1], 'dh0_rel': errs[2],
                'tol': f'max|d| / max(1, max|ref|) <= {tol}'}
        main = (hid, t) == (1024, 427)
        ms, pms = time_pair(torch, lambda: K5.gru_recurrence_bwd_plain(*args),
                            lambda: K5.gru_recurrence_bwd(*args))
        case.update(ms=ms, plain_ms=pms)
        # the gate remat and the dh product: 2 x 2·T·B·3H·H
        bounds = bound(nbytes(xp, w, b_hh, h0, ys, dys, dhT, *out),
                       12 * t * b * hid * hid, kind_of(torch, xp))
        case.update(bound_ms=bounds[0], bound_by=bounds[1])
        case.update(kernel_split_ms(
            torch, lambda: K5.gru_recurrence_bwd(*args), BWD_PARTS))
        if main:
            case.update(layer_times(torch, 'GRU', hid, b, t, dt, True))
        emit(case)
        require(max(errs) <= tol, f'K6 disagrees: {case}')
        record('gru_bwd', max(errs), ms if main else None, pms, bounds,
               case.get('library_ms'))

    # K7 / K8 — fused joint: the E6D2 step in bf16, and U+1 = 300 (past the
    # TPU kernel's U envelope)
    for b, t, u1, dt in ((32, 214, 65, bf16), (2, 50, 300, bf16)):
        j, v = 640, 2048
        f, g = t_(b, t, j, dtype=dt), t_(b, u1, j, dtype=dt)
        w_t = t_(j, v, scale=j ** -0.5)
        bias = t_(v, scale=0.1)
        labels = torch.as_tensor(rng.randint(4, v, (b, u1 - 1))
                                 .astype(np.int32), device=dev)
        d_b, d_l = t_(b, t, u1, scale=0.1), t_(b, t, u1 - 1, scale=0.1)
        wt_e = w_t.to(dt).contiguous()
        blank_lp, label_lp, lse = KJ.joint_lse_fwd(f, g, wt_e, bias, labels,
                                                   0)
        grads = KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse, d_b, d_l)
        leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
        ref = KJ.fused_joint_lse_plain(*leaves, labels, 0)
        ref_g = torch.autograd.grad(ref, leaves, (d_b, d_l),
                                    retain_graph=True)
        torch.cuda.synchronize()
        fwd_err = max(_rel(torch, blank_lp, ref[0]),
                      _rel(torch, label_lp, ref[1]))
        bwd_errs = [_rel(torch, a, r) for a, r in zip(grads, ref_g)]
        case = {'kernel': 'K7/K8 joint_lse', 'B': b, 'T': t, 'U1': u1,
                'J': j, 'V': v, 'dtype': str(dt).split('.')[-1],
                'fwd_rel': fwd_err, 'df_rel': bwd_errs[0],
                'dg_rel': bwd_errs[1], 'dw_rel': bwd_errs[2],
                'dbias_rel': bwd_errs[3],
                'tol': 'lp 1e-4, grads 2e-2 (bf16 dlogits), of max(1, max|ref|)'}
        main = u1 == 65
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        case['plan'] = dataclasses.asdict(JP.bwd_plan(b, t, u1, j, v, sms))
        case['fwd_plan'] = dataclasses.asdict(JP.fwd_plan(b, t, u1, j, v,
                                                          sms))
        case['bwd_parts_ms'] = kernel_split_ms(
            torch, lambda: KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse,
                                            d_b, d_l), K8_PARTS)
        case['fwd_parts_ms'] = kernel_split_ms(
            torch, lambda: KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0),
            K7_PARTS)
        if main:
            ms, pms = time_pair(
                torch, lambda: KJ.fused_joint_lse_plain(f, g, w_t, bias,
                                                        labels, 0),
                lambda: KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0))
            bms, bpms = time_pair(
                torch, lambda: torch.autograd.grad(ref, leaves, (d_b, d_l),
                                                   retain_graph=True),
                lambda: KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse,
                                         d_b, d_l))
            # the same forward with h staged through the slab scratch
            staged = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0, True)
            st_ms, _ = time_pair(
                torch, lambda: KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0),
                lambda: KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0, True))
            case.update(fwd_ms=ms, fwd_plain_ms=pms, bwd_ms=bms,
                        bwd_plain_ms=bpms, fwd_staged_ms=st_ms,
                        fwd_staged_parts_ms=kernel_split_ms(
                            torch, lambda: KJ.joint_lse_fwd(
                                f, g, wt_e, bias, labels, 0, True),
                            K7_PARTS),
                        fwd_staged_equal=all(torch.equal(a, c) for a, c in
                                             zip(staged, (blank_lp,
                                                          label_lp, lse))))
            require(case['fwd_staged_equal'],
                    'K7 staged through the scratch differs from resident')
        lattice_ops = 2 * b * t * u1 * j * v
        fwd_bound = bound(nbytes(f, g, wt_e, bias, labels, blank_lp,
                                 label_lp, lse), lattice_ops,
                          kind_of(torch, f))
        bwd_bound = bound(nbytes(f, g, wt_e, bias, labels, lse, d_b, d_l,
                                 *grads), 3 * lattice_ops, kind_of(torch, f))
        case.update(fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                    bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])
        emit(case)
        require(fwd_err <= 1e-4 and max(bwd_errs) <= 2e-2,
                f'K7/K8 disagree: {case}')
        record('joint_lse_fwd', fwd_err, case.get('fwd_ms'),
               case.get('fwd_plain_ms'), fwd_bound)
        record('joint_lse_bwd', max(bwd_errs), case.get('bwd_ms'),
               case.get('bwd_plain_ms'), bwd_bound)
        del ref, ref_g, leaves

    k7_cases(torch, rng, dev, record)

    # K9 / K10 — the lattice of the E6D2 step
    b, t, u1 = 32, 214, 65
    logits = torch.as_tensor(rng.randn(b, t, u1, 2).astype(np.float32),
                             device=dev)
    lp = logits - torch.logsumexp(logits, -1, keepdim=True)
    blank, label = lp[..., 0].contiguous(), lp[:, :, :-1, 1].contiguous()
    xlen = torch.as_tensor(rng.randint(200, t + 1, b).astype(np.int32),
                           device=dev)
    ylen = torch.as_tensor(rng.randint(40, u1, b).astype(np.int32),
                           device=dev)
    alpha, logz = KL.lattice_alpha(blank, label, xlen, ylen)
    gb, gl = KL.lattice_beta_grad(blank, label, alpha, logz, xlen, ylen)
    r_alpha, r_logz = PL.lattice_alpha_plain(blank, label, xlen, ylen)
    r_gb, r_gl = PL.lattice_beta_grad_plain(blank, label, r_alpha, r_logz,
                                            xlen, ylen)
    torch.cuda.synchronize()
    logz_err = _rel(torch, logz, r_logz)
    occ_err = max(float((gb - r_gb).abs().max()),
                  float((gl - r_gl).abs().max()))
    occ_tol = max(1e-5, 1e-6 * float(r_logz.abs().max()))
    ams, apms = time_pair(
        torch, lambda: PL.lattice_alpha_plain(blank, label, xlen, ylen),
        lambda: KL.lattice_alpha(blank, label, xlen, ylen))
    bms, bpms = time_pair(
        torch, lambda: PL.lattice_beta_grad_plain(blank, label, alpha, logz,
                                                  xlen, ylen),
        lambda: KL.lattice_beta_grad(blank, label, alpha, logz, xlen, ylen))
    case = {'kernel': 'K9/K10 lattice', 'B': b, 'T': t, 'U1': u1,
            'logz_rel': logz_err, 'occupancy_max_abs': occ_err,
            'tol': f'logz 1e-5 of max(1, |logz|); occupancy {occ_tol:.2e} '
                   '(1e-6 |logZ|)', 'alpha_ms': ams, 'alpha_plain_ms': apms,
            'beta_grad_ms': bms, 'beta_grad_plain_ms': bpms}
    # the cells this data needs: t < xlen, u <= ylen (fp32 in and out)
    cells = int((xlen.long() * (ylen.long() + 1)).sum())
    alpha_bound = bound(cells * 4 * 3 + nbytes(xlen, ylen, logz), cells * 10,
                        'fp32')
    beta_bound = bound(cells * 4 * 5 + nbytes(xlen, ylen, logz), cells * 20,
                       'fp32')
    case.update(alpha_bound_ms=alpha_bound[0],
                beta_grad_bound_ms=beta_bound[0])
    emit(case)
    require(logz_err <= 1e-5 and occ_err <= occ_tol,
            f'K9/K10 disagree: {case}')
    record('lattice_alpha', logz_err, ams, apms, alpha_bound)
    record('lattice_beta_grad', occ_err, bms, bpms, beta_bound)


def k7_cases(torch, rng, dev, record):
    """K7 against its plain version at the shapes beside the E6D2 step:
    ragged B=33, U+1 = 1, 300 and 1100, J and V padded to multiples of 16
    (600, 2000), a J too wide for h to stay resident (768), and fp32 on CUDA
    cores; labels equal to blank included, and the same bits on a second
    call.  The blank / label log-probs and the logsumexp to 1e-4 of
    max(1, |ref|)."""
    import dataclasses

    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.ops import joint_lse_plan as JP
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, t, u1, j, v, dt in ((33, 214, 65, 640, 2048, torch.bfloat16),
                               (4, 50, 1, 640, 2048, torch.bfloat16),
                               (2, 50, 300, 640, 2048, torch.bfloat16),
                               (2, 6, 1100, 640, 2048, torch.bfloat16),
                               (2, 9, 33, 600, 2000, torch.bfloat16),
                               (2, 6, 33, 768, 400, torch.bfloat16),
                               (2, 20, 65, 640, 2048, torch.float32)):
        def t_(*shape, scale=1.0):
            return torch.as_tensor((rng.randn(*shape) * scale)
                                   .astype(np.float32), device=dev)
        f, g = t_(b, t, j).to(dt), t_(b, u1, j).to(dt)
        w_t, bias = t_(j, v, scale=j ** -0.5), t_(v, scale=0.1)
        labels = torch.as_tensor(rng.randint(0, v, (b, u1 - 1))
                                 .astype(np.int32), device=dev)
        labels[:, ::3] = 0
        wt_e = w_t.to(dt)
        out = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0)
        again = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0)
        ref = KJ.fused_joint_lse_plain(f, g, w_t, bias, labels, 0)
        h = torch.tanh(f.float()[:, :, None] + g.float()[:, None])
        lse = torch.logsumexp(h.to(dt).float() @ wt_e.float() + bias, -1)
        del h
        torch.cuda.synchronize()
        errs = [_rel(torch, a, r) if a.numel() else 0.0
                for a, r in zip(out, (*ref, lse))]
        stable = all(torch.equal(a, c) for a, c in zip(out, again))
        case = {'kernel': 'K7 joint_lse_fwd', 'B': b, 'T': t, 'U1': u1,
                'J': j, 'V': v, 'dtype': str(dt).split('.')[-1],
                'blank_rel': errs[0], 'label_rel': errs[1],
                'lse_rel': errs[2],
                'bit_stable': stable,
                'tol': 'lp and lse 1e-4 of max(1, max|ref|)'}
        if dt == torch.bfloat16:
            jp, vp = -(-j // 16) * 16, -(-v // 16) * 16
            case['plan'] = dataclasses.asdict(JP.fwd_plan(b, t, u1, jp, vp,
                                                          sms))
        emit(case)
        require(max(errs) <= 1e-4 and stable, f'K7 disagrees: {case}')
        record('joint_lse_fwd', max(errs))
        del out, again, ref, lse


def quant_layer_times(torch, cell, hid, b, t, n_in=ENC_IN):
    """K12 / K13's library yardstick: dequantize W_ih and W_hh (int8 →
    fp32) and one cuDNN nn.LSTM / nn.GRU layer forward with them (input
    (T, B, n_in), fp32), beside the port's own int8 layer (ops/quant.py:
    K11's x_proj, then K12 / K13) from the same int8 weights, both timed
    as layer_times times K1/K5's (median of 10).
    → {'library_ms', 'layer_ms', 'cudnn'}."""
    from torch.func import functional_call

    from edgedict_tpu_torch.ops import quant as Q
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(hid + b + t)
    xs = torch.randn(t, b, n_in, generator=gen).to(dev)
    mod = getattr(torch.nn, cell)(n_in, hid).to(dev)
    qrnn = Q.QuantRNN(mod).to(dev)
    params = qrnn.layer(0)
    h0 = torch.zeros(b, hid, device=dev)
    layer = Q.gru_layer_tm_q if cell == 'GRU' else Q.lstm_layer_tm_q
    state = h0 if cell == 'GRU' else (h0, h0)

    def library():
        with torch.no_grad():
            functional_call(mod, {
                'weight_ih_l0': Q.dequantize(qrnn.w_ih_q, qrnn.w_ih_scale,
                                             torch.float32),
                'weight_hh_l0': Q.dequantize(qrnn.w_hh_q, qrnn.w_hh_scale,
                                             torch.float32),
                'bias_ih_l0': qrnn.b_ih, 'bias_hh_l0': qrnn.b_hh}, (xs,))

    def port():
        with torch.no_grad():
            layer(params, xs, state)
    return {'cudnn': torch.backends.cudnn.version(),
            'library_ms': _median_ms(torch, library, iters=10, warmup=2),
            'layer_ms': _median_ms(torch, port, iters=10, warmup=2)}


def serving_kernels_q(torch, rng, dev, record):
    """K5 (GRU forward), K11 (int8-weight matmul), K12 / K13 (int8 LSTM /
    GRU recurrences) against their plain versions at E6D2's serving shapes
    (H=1024, B 1 and 64, T=2; K11 for every layer's x_proj and the final
    projection at R = T*B rows 2, 64, 128 and 512: one stream, the int8
    server's 64 streams after and before the time reduction, 256 streams),
    fp32 and bf16.  → K11's R=512 cases (its tiled kernels)."""
    from edgedict_tpu_torch.ops import gru_kernel as K5
    from edgedict_tpu_torch.ops import quant as Q
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    fp32, bf16 = torch.float32, torch.bfloat16

    def t_(*shape, scale=1.0, dtype=fp32):
        return torch.as_tensor((rng.randn(*shape) * scale).astype(np.float32),
                               device=dev).to(dtype)

    # K11: fp32 to 1e-5 of max(1, |out|) (fp32 sums in another order); bf16
    # to 1e-2 (both round the same fp32 value to bf16: one ulp apart at most).
    # R=2 runs the matrix-vector kernel, R=64, 128 and 512 the tiled kernels
    # (each R=512 case is kept in the kernels line's quant_matmul_tile entry)
    tile_cases = []
    for (k, n), r, dt in [(kn, r, dt) for kn in ((240, 4096), (1024, 4096),
                                                 (1024, 640), (240, 3072),
                                                 (1024, 3072))
                          for r in (2, 64, 128, 512)
                          for dt in (fp32, bf16)]:
        x = t_(r, k, dtype=dt)
        q, sc = Q.quantize_int8(t_(n, k, scale=k ** -0.5))
        bias = t_(n, scale=0.1)
        out = Q.quant_matmul(x, q, sc, bias)
        ref = Q.quant_matmul_plain(x, q, sc, bias)
        torch.cuda.synchronize()
        rel = _rel(torch, out, ref)
        tol = 1e-5 if dt == fp32 else 1e-2
        ms, pms = time_pair(torch, lambda: Q.quant_matmul_plain(x, q, sc,
                                                                bias),
                            lambda: Q.quant_matmul(x, q, sc, bias))
        lib = _median_ms(torch, lambda: torch.nn.functional.linear(
            x, Q.dequantize(q, sc, dt), bias.to(dt)))
        case = {'kernel': 'K11 quant_matmul', 'R': r, 'K': k, 'N': n,
                'dtype': str(dt).split('.')[-1], 'rel_err': rel,
                'tol': f'max|d| / max(1, max|ref|) <= {tol}', 'ms': ms,
                'plain_ms': pms, 'library_ms': lib}
        b_ms, b_by = bound(nbytes(x, q, sc, bias, out), 2 * r * k * n,
                           kind_of(torch, x))
        case.update(bound_ms=b_ms, bound_by=b_by)
        emit(case)
        require(rel <= tol, f'K11 disagrees: {case}')
        if r <= 32:
            main = (r, k, n, dt) == (2, 1024, 4096, fp32)
            record('quant_matmul', rel, ms if main else None, pms,
                   (b_ms, b_by), lib)
        else:
            main = (r, k, n, dt) == (512, 1024, 4096, bf16)
            record('quant_matmul_tile', rel, ms if main else None, pms,
                   (b_ms, b_by), lib)
            if r == 512:
                tile_cases.append({key: case[key] for key in (
                    'R', 'K', 'N', 'dtype', 'ms', 'plain_ms', 'library_ms',
                    'bound_ms', 'bound_by', 'rel_err')})

    # K5 / K12 / K13: free-running to 1e-4 in fp32 and 2e-2 in bf16, where
    # one rounding flip of h feeds every later step; so bf16 is also held
    # step by step from the kernel's own carried state: ys to one bf16 ulp
    # (2^-7 of |ys|, or 1e-2), the LSTM's cs to 1e-4
    hid, t = 1024, 2
    kw = 1.0 / hid ** 0.5
    for name, b, dt in [(nm, b, dt) for nm in ('gru_fwd', 'lstm_fwd_q',
                                                'gru_fwd_q')
                        for b in (1, 64) for dt in (fp32, bf16)] + [
                            ('gru_fwd', 33, bf16), ('gru_fwd', 256, fp32)]:
        gates = 4 if name == 'lstm_fwd_q' else 3
        xp = t_(t, b, gates * hid, dtype=dt)
        w = torch.as_tensor(rng.uniform(-kw, kw, (gates * hid, hid))
                            .astype(np.float32), device=dev)
        b_hh = t_(gates * hid, scale=0.1)
        h0 = t_(b, hid, scale=0.5)
        c0 = t_(b, hid, scale=0.5)
        if name == 'gru_fwd':
            w = w.to(dt)
            kernel = lambda: K5.gru_recurrence(  # noqa: E731
                xp, w, b_hh, h0)[0]
            plain = lambda: K5.gru_recurrence_plain(  # noqa: E731
                xp, w, b_hh, h0)
            w_eff, inputs = w, (xp, w, b_hh, h0)
        else:
            q, sc = Q.quantize_int8(w)
            w_eff = Q.dequantize(q, sc, dt)
            if name == 'gru_fwd_q':
                kernel = lambda: Q.gru_recurrence_q(  # noqa: E731
                    xp, q, sc, b_hh, h0)
                plain = lambda: Q.gru_recurrence_q_plain(  # noqa: E731
                    xp, q, sc, b_hh, h0)
                inputs = (xp, q, sc, b_hh, h0)
            else:
                kernel = lambda: Q.lstm_recurrence_q(  # noqa: E731
                    xp, q, sc, h0, c0)
                plain = lambda: Q.lstm_recurrence_q_plain(  # noqa: E731
                    xp, q, sc, h0, c0)
                inputs = (xp, q, sc, h0, c0)
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        run_tol = 1e-4 if dt == fp32 else 2e-2
        step_tol = (1e-4, 1e-4) if dt == fp32 else (1e-2, 2.0 ** -7)
        if name == 'lstm_fwd_q':
            ys, cs, _ = out
            step_ys, step_cs = lstm_steps_plain(torch, K1, xp, w_eff, h0, c0,
                                                ys, cs)
            runs = [_close(a, r_, run_tol, run_tol)
                    for a, r_ in zip(out, ref)]
            steps = [_close(ys, step_ys, *step_tol),
                     _close(cs, step_cs, 1e-4, 1e-4)]
        else:
            ys = out
            h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b,
                                                                    hid)
            step_ys = K5.gru_recurrence_plain(
                xp.reshape(1, t * b, gates * hid), w_eff, b_hh,
                h_prev).reshape(ys.shape)
            runs = [_close(ys, ref, run_tol, run_tol)]
            steps = [_close(ys, step_ys, *step_tol)]
        ok = all(c for c, _ in runs + steps)
        errs = [e for _, e in runs]
        steps = [e for _, e in steps]
        ms, pms = time_pair(torch, plain, kernel)
        b_ms, b_by = bound(nbytes(*inputs, *((out,) if name != 'lstm_fwd_q'
                                             else out)),
                           2 * t * b * gates * hid * hid, kind_of(torch, xp))
        label = {'gru_fwd': 'K5 gru_fwd', 'lstm_fwd_q': 'K12 lstm_fwd_q',
                 'gru_fwd_q': 'K13 gru_fwd_q'}[name]
        case = {'kernel': label, 'H': hid, 'B': b, 'T': t,
                'dtype': str(dt).split('.')[-1], 'run_max_abs': max(errs),
                'step_max_abs': steps, 'ms': ms, 'plain_ms': pms,
                'bound_ms': b_ms, 'bound_by': b_by,
                'tol': f'run atol/rtol {run_tol}; per step ys atol '
                       f'{step_tol[0]} rtol {step_tol[1]:.3g}'
                       + (', cs 1e-4' if name == 'lstm_fwd_q' else '')}
        main = (b, dt) == (1, fp32)
        if name == 'gru_fwd':
            case['plan'] = fwd_plan(xp, 3)
        if main and name == 'gru_fwd':
            case.update(layer_times(torch, 'GRU', hid, b, t, dt, False))
        if main and name in ('lstm_fwd_q', 'gru_fwd_q'):
            case.update(quant_layer_times(
                torch, 'GRU' if name == 'gru_fwd_q' else 'LSTM', hid, b, t))
        emit(case)
        require(ok, f'{label} disagrees: {case}')
        record(name, max(errs + steps), ms if main else None, pms,
               (b_ms, b_by), case.get('library_ms'))
    return tile_cases


def _e6d2():
    from edgedict_tpu_torch import config as C
    flags = C.parse_flags(C.add_model_flags(argparse.ArgumentParser()),
                          [f'--flagfile={REPO}/flagfiles/E6D2.txt'])
    feat = C.feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = C.transducer_config_from_flags(flags, 2048, feat.input_size)
    return cfg, feat


def _counters():
    """{kernel name: the wrapper that counts its launches}."""
    from edgedict_tpu_torch.ops import (
        decode_kernel, features_kernel, gru_kernel, joint_lse_kernel, quant,
        rnn_kernel, rnnt_loss_kernel)
    return {'lstm_fwd': rnn_kernel.lstm_recurrence,
            'gru_fwd': gru_kernel.gru_recurrence,
            'quant_matmul': quant.quant_matmul,
            'lstm_fwd_q': quant.lstm_recurrence_q,
            'gru_fwd_q': quant.gru_recurrence_q,
            'mel_power': features_kernel.mel_power,
            'greedy_decode': decode_kernel.greedy_frame_loop,
            'lstm_bwd': rnn_kernel.lstm_recurrence_bwd,
            'gru_bwd': gru_kernel.gru_recurrence_bwd,
            'joint_lse_fwd': joint_lse_kernel.joint_lse_fwd,
            'joint_lse_bwd': joint_lse_kernel.joint_lse_bwd,
            'lattice_alpha': rnnt_loss_kernel.lattice_alpha,
            'lattice_beta_grad': rnnt_loss_kernel.lattice_beta_grad}


def _reset_launches():
    for fn in _counters().values():
        fn.launches = 0
    _counters()['quant_matmul'].tile_launches = 0


def _launches():
    """{kernel name: launches}; quant_matmul_tile counts K11's tiled
    launches (R > 32), which quant_matmul also counts."""
    counts = {name: fn.launches for name, fn in _counters().items()}
    counts['quant_matmul_tile'] = _counters()['quant_matmul'].tile_launches
    return counts


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


def _decode(model, cfg, feat, tok, audio, device, dtype=None, quantize=None,
            count=None):
    """A warm-up decode_wav, then the measured one → (decoder, tokens);
    with `count`, the launch counts of the measured decode alone go to
    STATE['launches_' + count]."""
    from edgedict_tpu_torch import stream as S
    dec = S.StreamingDecoder(model, cfg, feat, tok, device=device,
                             compute_dtype=dtype, quantize=quantize)
    dec.decode_wav(audio)                    # warm-up
    dec.reset_profile()
    if count:
        _reset_launches()
    dec.decode_wav(audio)
    if count:
        STATE['launches_' + count] = _launches()
        STATE['chunks_' + count] = len(dec.elapsed)
    return dec, np.concatenate(dec.emitted)


def _agreement(a, b):
    return float((a == b).mean()) if a.shape == b.shape else 0.0


def _bf16_encoder_diff(torch, cfg, dec32, dec16, audio):
    """Encoder output, bf16 encoder against fp32, over the whole
    utterance as one layer-major block → (max |diff|, max |fp32 out|)."""
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.models import transducer as T
    with torch.no_grad():
        chunks = torch.as_tensor(S._chunks(audio, dec32.win_size,
                                           dec32.hop_size), device='cuda')
        lens = torch.full((len(chunks),), chunks.shape[1], device='cuda')
        xs, _ = dec32.pipeline(chunks, lens)
        xs = xs.reshape(1, -1, xs.shape[-1])
        e32, _ = T.encoder_apply(dec32.model.encoder, cfg, xs)
        e16, _ = T.encoder_apply(dec16.model.encoder, cfg,
                                 xs.to(torch.bfloat16))
    return float((e16.float() - e32).abs().max()), float(e32.abs().max())


def phase_slice(torch):
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

    cuda32, tok32 = _decode(model, cfg, feat, tok, audio, 'cuda',
                            count='decode_wav')
    cpu32, tok_cpu = _decode(model, cfg, feat, tok, audio, 'cpu')
    cuda16, tok16 = _decode(model, cfg, feat, tok, audio, 'cuda',
                            torch.bfloat16)
    equal = tok32.shape == tok_cpu.shape and bool((tok32 == tok_cpu).all())
    res = {'phase': 'slice', 'frames': int(tok32.size),
           'nonblank_frames': int((tok32 != 0).sum()),
           'chunks': len(cuda32.elapsed),
           'cuda_fp32_equals_cpu': equal,
           'chunk_ms_cuda_fp32': 1e3 * float(np.mean(cuda32.elapsed)),
           'chunk_ms_cuda_bf16': 1e3 * float(np.mean(cuda16.elapsed)),
           'chunk_ms_cpu_fp32': 1e3 * float(np.mean(cpu32.elapsed)),
           'bf16_token_agreement': _agreement(tok16, tok32)}
    res['bf16_encoder_max_abs'], res['encoder_out_max_abs'] = \
        _bf16_encoder_diff(torch, cfg, cuda32, cuda16, audio)
    if not equal:
        k, gap = _first_divergence(torch, model, cfg, feat, tok, audio,
                                   tok_cpu, tok32)
        res.update(first_diverging_frame=k, top2_gap=gap)
    emit(res)
    require(equal, 'cuda fp32 tokens differ from the CPU run')
    require(res['nonblank_frames'] > 0, 'no token emitted')
    STATE['model'] = model
    STATE['tokens_fp32'] = tok32
    STATE['chunk_ms'] = res['chunk_ms_cuda_fp32']


def phase_slice_int8(torch):
    """E6D2 StreamingDecoder(quantize='int8'), fp32, on the slice's model
    and audio: cuda tokens == the CPU plain int8 run's; int8-vs-fp32 token
    agreement; per-chunk ms; the encoder's bytes int8 against fp32."""
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.ops.quant import module_bytes
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model = STATE['model']
    audio = synthetic_audio(0)
    cuda8, tok8 = _decode(model, cfg, feat, tok, audio, 'cuda',
                          quantize='int8', count='decode_wav_int8')
    cpu8, tok_cpu = _decode(model, cfg, feat, tok, audio, 'cpu',
                            quantize='int8')
    equal = tok8.shape == tok_cpu.shape and bool((tok8 == tok_cpu).all())
    res = {'phase': 'slice_int8', 'quantize': 'int8', 'dtype': 'fp32',
           'frames': int(tok8.size), 'nonblank_frames': int((tok8 != 0).sum()),
           'chunks': len(cuda8.elapsed), 'cuda_int8_equals_cpu_int8': equal,
           'int8_vs_fp32_token_agreement': _agreement(tok8,
                                                      STATE['tokens_fp32']),
           'chunk_ms_cuda_int8': 1e3 * float(np.mean(cuda8.elapsed)),
           'chunk_ms_cpu_int8': 1e3 * float(np.mean(cpu8.elapsed)),
           'encoder_bytes_int8': module_bytes(cuda8.model.encoder),
           'encoder_bytes_fp32': module_bytes(model.encoder)}
    emit(res)
    require(equal, 'cuda int8 tokens differ from the CPU int8 run')
    require(res['nonblank_frames'] > 0, 'no token emitted')
    require(res['encoder_bytes_int8'] < 0.3 * res['encoder_bytes_fp32'],
            'the int8 encoder is not a quarter of the fp32 one')


def phase_slice_gru(torch):
    """E6D2 widths with enc_type GRU (seeded random weights): cuda fp32
    == CPU and cuda int8 == CPU int8, token for token; bf16 encoder diff and
    token agreement; per-chunk ms."""
    import dataclasses

    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2()
    cfg = dataclasses.replace(cfg, module_type='GRU')
    tok = StandInTokenizer(cfg.vocab_size)
    model = T.Transducer(cfg, device='cpu', seed=0)
    audio = synthetic_audio(0)
    emit({'phase': 'slice_gru', 'config': 'flagfiles/E6D2.txt --enc_type GRU',
          'params': sum(p.numel() for p in model.parameters()),
          'weights': 'random, seed 0'})
    cuda32, tok32 = _decode(model, cfg, feat, tok, audio, 'cuda',
                            count='decode_wav_gru')
    _, tok_cpu = _decode(model, cfg, feat, tok, audio, 'cpu')
    cuda8, tok8 = _decode(model, cfg, feat, tok, audio, 'cuda',
                          quantize='int8', count='decode_wav_gru_int8')
    _, tok8_cpu = _decode(model, cfg, feat, tok, audio, 'cpu',
                          quantize='int8')
    cuda16, tok16 = _decode(model, cfg, feat, tok, audio, 'cuda',
                            torch.bfloat16)
    eq32 = tok32.shape == tok_cpu.shape and bool((tok32 == tok_cpu).all())
    eq8 = tok8.shape == tok8_cpu.shape and bool((tok8 == tok8_cpu).all())
    res = {'phase': 'slice_gru', 'frames': int(tok32.size),
           'nonblank_frames': int((tok32 != 0).sum()),
           'chunks': len(cuda32.elapsed),
           'cuda_fp32_equals_cpu': eq32, 'cuda_int8_equals_cpu_int8': eq8,
           'chunk_ms_cuda_fp32': 1e3 * float(np.mean(cuda32.elapsed)),
           'chunk_ms_cuda_bf16': 1e3 * float(np.mean(cuda16.elapsed)),
           'chunk_ms_cuda_int8': 1e3 * float(np.mean(cuda8.elapsed)),
           'bf16_token_agreement': _agreement(tok16, tok32),
           'int8_vs_fp32_token_agreement': _agreement(tok8, tok32)}
    res['bf16_encoder_max_abs'], res['encoder_out_max_abs'] = \
        _bf16_encoder_diff(torch, cfg, cuda32, cuda16, audio)
    emit(res)
    require(eq32, 'GRU cuda fp32 tokens differ from the CPU run')
    require(eq8, 'GRU cuda int8 tokens differ from the CPU int8 run')
    require(res['nonblank_frames'] > 0, 'no token emitted')


def phase_server(torch, quantize=None, n_streams=8):
    """StreamServer over MultiStreamDecoder(n_streams, cuda, quantize) as
    cli/serve.py builds it; 4 concurrent clients, each transcript ==
    decode_wav of its audio."""
    import asyncio

    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.cli.serve import build_server
    from edgedict_tpu_torch.models import transducer as T
    from edgedict_tpu_torch.serving import stream_client
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model = STATE.get('model') or T.Transducer(cfg, device='cpu', seed=0)
    audios = [synthetic_audio(10 + i, seconds=3.0) for i in range(4)]
    single = S.StreamingDecoder(model, cfg, feat, tok, device='cuda',
                                quantize=quantize)
    expected = [single.decode_wav(a) for a in audios]
    dec = S.MultiStreamDecoder(model, cfg, feat, tok, n_streams=n_streams,
                               device='cuda', quantize=quantize)
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
        run = 'server' if quantize is None else f'server_{quantize}'
        STATE['launches_' + run] = _launches()
        require(not any(c.is_alive() for c in clients), 'client timed out')
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(60)
    match = [r == e for r, e in zip(results, expected)]
    res = {'phase': run, 'n_streams': dec.n, 'clients': len(audios),
           'rounds': server.rounds,
           'round_ms_mean': 1e3 * float(np.mean(dec.elapsed)),
           'transcripts_match': match,
           'transcript_chars': [len(r or '') for r in results]}
    emit(res)
    require(all(match), 'a server transcript differs from decode_wav')
    STATE['round_ms'] = res['round_ms_mean']


def phase_server_int8(torch):
    """The int8 server at 64 streams: x_proj's R = 2 x 64 rows (64 after
    the time reduction) put every K11 call on its tiled kernel."""
    phase_server(torch, quantize='int8', n_streams=64)


def _e6d2_train_cfg():
    """E6D2 TransducerConfig (V=2048) and the trainer's FeatureConfig from
    flagfiles/E6D2.txt, with dither and SpecAugment off."""
    import dataclasses

    from edgedict_tpu_torch import config as C
    parser = C.add_train_flags(C.add_model_flags(argparse.ArgumentParser()))
    flags = C.parse_flags(parser, [f'--flagfile={REPO}/flagfiles/E6D2.txt'])
    feat = dataclasses.replace(C.feature_config_from_flags(flags), dither=0.0,
                               T_num_mask=0, F_num_mask=0)
    return C.transducer_config_from_flags(flags, 2048, feat.input_size), feat


def phase_train_parity(torch, module_type='LSTM'):
    """One fp32 E6D2 train step (full width and depth, seeded init, B=4,
    ~2 s) on CUDA against the CPU plain path from the same weights and
    batch; dither and SpecAugment off so that both see the same features,
    lr 5e-4 (E6D2's, without warmup) so that the step moves the params.
    module_type='GRU': the same with the GRU encoder (K5/K6 on CUDA)."""
    import copy
    import dataclasses

    from edgedict_tpu_torch import optim
    from edgedict_tpu_torch import train as TR
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    from edgedict_tpu_torch.features import FeaturePipeline
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2_train_cfg()
    cfg = dataclasses.replace(cfg, module_type=module_type)
    lr = 5e-4
    rng = np.random.RandomState(7)
    secs = (2.0, 1.8, 1.6, 2.0)
    audio = np.zeros((4, 32000), np.float32)
    for i, sec in enumerate(secs):
        audio[i, :int(sec * 16000)] = synthetic_audio(20 + i, sec)
    host = {'audio': audio,
            'alen': np.array([int(x * 16000) for x in secs], np.int32),
            'ys': rng.randint(4, 2048, (4, 12)).astype(np.int32),
            'ylen': np.array([12, 10, 8, 11], np.int32)}
    model = T.Transducer(cfg, device='cpu', seed=0)
    opt = optim.build_optimizer('adam')
    res = {}
    for dev in ('cuda', 'cpu'):
        m = copy.deepcopy(model).to(dev)
        pipe = FeaturePipeline(feat, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        batch = TR.device_batch(host, 1, dev)
        micro = {k: v[0] for k, v in batch.items()}
        xs, xlen = pipe(micro['audio'], micro['alen'], train=True,
                        generator=gen)
        loss = T.transducer_loss(m, cfg, xs, micro['ys'], xlen,
                                 micro['ylen'], deterministic=False,
                                 generator=gen)
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
        for p in m.parameters():
            p.grad = None
        state = TR.TrainState(m, opt.init(dict(m.named_parameters())))
        step = TR.make_train_step(cfg, opt, bf16=False, feature_pipeline=pipe)
        t0 = time.perf_counter()
        state, met = step(state, batch, lr, gen)
        res[dev] = {'loss': float(met['loss']),
                    'grad_norm': float(met['grad_norm']),
                    'skipped': float(met['skipped']),
                    'step_s': time.perf_counter() - t0, 'grads': grads,
                    'params': {k: v.detach().cpu() for k, v in
                               state.model.state_dict().items()}}
    a, b = res['cuda'], res['cpu']
    grad_rel = max(float((a['grads'][k] - g).abs().max())
                   / max(1e-30, float(g.abs().max()))
                   for k, g in b['grads'].items())
    diffs = [(a['params'][k] - p).abs() for k, p in b['params'].items()]
    moved = max(float((b['params'][k] - model.state_dict()[k]).abs().max())
                for k in b['params'])
    n = sum(d.numel() for d in diffs)
    out = {'phase': 'train_parity' + ('_gru' if module_type == 'GRU'
                                       else ''),
           'config': 'flagfiles/E6D2.txt fp32' + (
               ' --enc_type GRU' if module_type == 'GRU' else ''),
           'params': sum(p.numel() for p in model.parameters()), 'B': 4, 'audio_s': list(secs), 'lr': lr,
           'loss_cuda': a['loss'], 'loss_cpu': b['loss'],
           'loss_rel': abs(a['loss'] - b['loss']) / abs(b['loss']),
           'grad_norm_rel': abs(a['grad_norm'] - b['grad_norm'])
           / b['grad_norm'],
           'grad_max_rel': grad_rel,
           'param_max_abs_diff': max(float(d.max()) for d in diffs),
           'param_share_diff_over_0.01lr':
               sum(int((d > 0.01 * lr).sum()) for d in diffs) / n,
           'param_max_update': moved,
           'step_s_cuda': a['step_s'], 'step_s_cpu': b['step_s'],
           'bounds': 'loss 1e-5 rel, grad_norm 1e-4 rel, each grad 1e-3 of '
                     'its max, params max 2 lr and > 0.01 lr on < 1e-3 of '
                     'them (Adam\'s first step is g/|g|: a grad at its '
                     'rounding level may flip sign)'}
    emit(out)
    require(a['skipped'] == b['skipped'] == 0.0, 'a parity step was skipped')
    require(out['loss_rel'] <= 1e-5 and out['grad_norm_rel'] <= 1e-4
            and grad_rel <= 1e-3, 'CUDA train step differs from the CPU')
    require(out['param_max_abs_diff'] <= 2 * lr + 1e-6
            and out['param_share_diff_over_0.01lr'] <= 1e-3,
            'params after the step differ between CUDA and the CPU')


def _synthetic_corpus(root, texts, seed, lo=8.0, hi=16.0):
    """LibriSpeech layout (<root>/<spk>/<chap>/*.trans.txt + wav) of one
    utterance of lo..hi seconds of synthetic audio per text."""
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    from edgedict_tpu_torch.data.audio_io import save_wav
    rng = np.random.RandomState(seed)
    d = os.path.join(root, '1', '1')
    os.makedirs(d, exist_ok=True)
    lines = []
    for i, text in enumerate(texts):
        name = f'1-1-{i:04d}'
        save_wav(os.path.join(d, name + '.wav'),
                 synthetic_audio(seed + i, rng.uniform(lo, hi)), 16000)
        lines.append(f'{name} {text.upper()}')
    with open(os.path.join(d, '1-1.trans.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')


def _corpus_texts(n_train, n_eval, seed=0):
    """Texts over a seeded lexicon of 800 made-up words, each used twice in
    the training texts, so that BPE training reaches 2048 ids."""
    rng = np.random.RandomState(seed)
    letters = np.array(list('abcdefghijklmnopqrstuvwxyz'))
    lex = []
    while len(lex) < 800:
        w = ''.join(rng.choice(letters, rng.randint(4, 10)))
        if w not in lex:
            lex.append(w)
    stream = list(rng.permutation(lex + lex))
    train = [' '.join(c) for c in np.array_split(stream, n_train)]
    evals = [' '.join(rng.choice(lex, 12)) for _ in range(n_eval)]
    return train, evals


def _train_corpus():
    """The synthetic corpus of the train_run phases, written once into a
    temp dir that main() removes: → (dir, trainer argv without --name)."""
    import tempfile
    if 'train_corpus' not in STATE:
        tmp = tempfile.mkdtemp(prefix='edd_smoke_')
        STATE['train_corpus'] = (tmp, None)
        train_texts, eval_texts = _corpus_texts(96, 8)
        _synthetic_corpus(os.path.join(tmp, 'train'), train_texts, 100)
        _synthetic_corpus(os.path.join(tmp, 'test'), eval_texts, 900)
        none = os.path.join(tmp, 'none')
        argv = [f'--flagfile={REPO}/flagfiles/E6D2.txt',
                '--LibriSpeech_train_100', os.path.join(tmp, 'train'),
                '--LibriSpeech_train_360', none,
                '--LibriSpeech_train_500', none,
                '--LibriSpeech_test', os.path.join(tmp, 'test'),
                '--TEDLIUM_train', none, '--CommonVoice', none,
                '--YT_bloomberg2', none, '--YT_life', none,
                '--logdir_root', os.path.join(tmp, 'logs'),
                '--device', 'cuda']
        STATE['train_corpus'] = (tmp, argv)
    return STATE['train_corpus']


def phase_train_run(torch, enc_type='LSTM'):
    """The port's Trainer, built as cli/baseline.py builds it, from
    flagfiles/E6D2.txt (batch 32, bf16, BPE 2048) with --enc_type on a
    synthetic corpus of 8-16 s utterances (shared by both encoders, the
    BPE model trained once): warm-up steps, then measured steps; loss
    falls on a repeated small batch; one --mode eval pass.  GRU: also one
    step with --time_warp_w 80 --optim novograd."""
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.train import device_batch, make_train_state
    from edgedict_tpu_torch.trainer import Trainer
    gru = enc_type == 'GRU'
    run = 'train_gru' if gru else 'train'
    cwd = os.getcwd()
    t0 = time.perf_counter()
    tmp, base = _train_corpus()
    os.chdir(tmp)                 # the BPE-2048/ cache lands in the cwd
    try:
        argv = base + ['--name', f'e6d2-{enc_type.lower()}', '--enc_type',
                       enc_type]
        flags = parse_flags(baseline.build_parser(), argv)
        trainer = Trainer(flags)
        setup_s = time.perf_counter() - t0
        vocab = trainer.tokenizer.vocab_size
        require(vocab == 2048 and trainer.cfg.vocab_size == 2048,
                f'vocab is {vocab}, not 2048')
        require(trainer.cfg.module_type == enc_type,
                f'the trainer built a {trainer.cfg.module_type} encoder')

        def batches():
            while True:
                yield from trainer.loader

        it = batches()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):                                  # warm-up
            float(trainer.run_step(next(it))['loss'])
        _reset_launches()
        times, audio_s, losses, shapes = [], [], [], []
        n_measured = 5
        for _ in range(n_measured):
            batch = next(it)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(trainer.run_step(batch)['loss']))
            times.append(time.perf_counter() - t1)
            audio_s.append(float(batch['alen'].sum()) / 16000.0)
            shapes.append([int(x) for x in batch['audio'].shape[1:]]
                          + [int(batch['ys'].shape[1]) + 1])
        STATE['launches_' + run] = _launches()
        it.close()
        med = statistics.median(times)
        n = trainer.accum_steps * n_measured        # micro-steps measured
        enc, dec = trainer.cfg.enc_layers, trainer.cfg.dec_layers
        STATE.setdefault('train_expect', {})[run] = {
            'lstm_fwd': (dec if gru else enc + dec) * n,
            'lstm_bwd': (dec if gru else enc + dec) * n,
            'gru_fwd': enc * n if gru else 0,
            'gru_bwd': enc * n if gru else 0,
            'mel_power': n, 'joint_lse_fwd': n, 'joint_lse_bwd': n,
            'lattice_alpha': n, 'lattice_beta_grad': n}
        res = {'phase': 'train_run' + ('_gru' if gru else ''),
               'config': 'flagfiles/E6D2.txt' + (' --enc_type GRU' if gru
                                                 else ''),
               'params': sum(p.numel() for p in
                             trainer.state.model.parameters()),
               'vocab': vocab, 'batch_size': flags.batch_size,
               'accum': trainer.accum_steps, 'bf16': flags.bf16,
               'utterances': len(trainer.train_dataset),
               'setup_s': setup_s,
               'batch_samples_U1': shapes,
               'step_ms': [1e3 * x for x in times],
               'step_ms_median': 1e3 * med,
               'audio_s_per_s': [a / x for a, x in zip(audio_s, times)],
               'audio_s_per_s_median': statistics.median(
                   a / x for a, x in zip(audio_s, times)),
               'losses': losses,
               'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}

        # loss falls on a repeated small batch (fresh weights, lr 1e-3)
        small = {k: v[:4] for k, v in next(iter(trainer.loader)).items()}
        dev_small = device_batch(small, 1, trainer.device)
        state = make_train_state(trainer.cfg, trainer.optimizer,
                                 trainer.device, seed=1)
        fall = []
        for _ in range(10):
            state, m = trainer.train_step(state, dev_small, 1e-3,
                                          trainer.generator)
            fall.append(float(m['loss']))
        res['repeated_batch_losses'] = fall
        del state

        trainer.save()
        lines = []
        baseline.main(argv + ['--mode', 'eval'], log_fn=lines.append)
        val = [ln for ln in lines if ln.startswith('val_loss')]
        res['eval'] = val[0] if val else None
        if gru:
            res['warp_novograd'] = _warp_novograd_step(torch, argv, batch)
        del trainer
        emit(res)
        require(all(np.isfinite(losses)), 'a train loss is not finite')
        require(fall[-1] < fall[0], f'loss did not fall: {fall}')
        require(bool(val) and np.isfinite(float(val[0].split()[1])),
                f'eval printed no finite val_loss: {lines}')
        if gru:
            w = res['warp_novograd']
            require(np.isfinite(w['loss']) and w['skipped'] == 0.0,
                    f'the time-warp + novograd step failed: {w}')
    finally:
        os.chdir(cwd)


def _warp_novograd_step(torch, argv, batch):
    """One measured step of a Trainer built with --time_warp_w 80 --optim
    novograd (the two training flags the slice added), on `batch`."""
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.trainer import Trainer
    flags = parse_flags(baseline.build_parser(), argv + [
        '--name', 'e6d2-gru-warp', '--time_warp_w', '80', '--optim',
        'novograd'])
    trainer = Trainer(flags)
    require(trainer.feature_cfg.W_warp == 80
            and trainer.optimizer.name == 'novograd',
            'the time-warp / novograd flags did not reach the trainer')
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m = trainer.run_step(batch)
    loss = float(m['loss'])
    return {'flags': '--time_warp_w 80 --optim novograd', 'loss': loss,
            'skipped': float(m['skipped']),
            'step_ms': 1e3 * (time.perf_counter() - t1)}


SOURCES = {
    'lstm_fwd': ('edgedict_tpu_torch/csrc/rnn_fwd.cu',
                 'edgedict_tpu/ops/rnn_pallas.py:116'),
    'mel_power': ('edgedict_tpu_torch/csrc/mel_power.cu',
                  'edgedict_tpu/ops/features_pallas.py:57'),
    'greedy_decode': ('edgedict_tpu_torch/csrc/greedy_decode.cu',
                      'edgedict_tpu/ops/decode_pallas.py:131'),
    'lstm_bwd': ('edgedict_tpu_torch/csrc/rnn_bwd.cu',
                 'edgedict_tpu/ops/rnn_pallas.py:205'),
    'gru_fwd': ('edgedict_tpu_torch/csrc/rnn_fwd.cu',
                'edgedict_tpu/ops/rnn_pallas.py:462'),
    'gru_bwd': ('edgedict_tpu_torch/csrc/rnn_bwd.cu',
                'edgedict_tpu/ops/rnn_pallas.py:512'),
    'joint_lse_fwd': ('edgedict_tpu_torch/csrc/joint_lse.cu',
                      'edgedict_tpu/ops/joint_lse_pallas.py:156'),
    'joint_lse_bwd': ('edgedict_tpu_torch/csrc/joint_lse.cu',
                      'edgedict_tpu/ops/joint_lse_pallas.py:277'),
    'lattice_alpha': ('edgedict_tpu_torch/csrc/rnnt_loss.cu',
                      'edgedict_tpu/ops/rnnt_loss_pallas.py:78'),
    'lattice_beta_grad': ('edgedict_tpu_torch/csrc/rnnt_loss.cu',
                          'edgedict_tpu/ops/rnnt_loss_pallas.py:116'),
    'quant_matmul': ('edgedict_tpu_torch/csrc/quant_matmul.cu',
                     'edgedict_tpu/ops/quant.py:162'),
    'quant_matmul_tile': ('edgedict_tpu_torch/csrc/quant_matmul.cu',
                          'edgedict_tpu/ops/quant.py:162'),
    'lstm_fwd_q': ('edgedict_tpu_torch/csrc/lstm_fwd.cu',
                   'edgedict_tpu/ops/quant.py:287'),
    'gru_fwd_q': ('edgedict_tpu_torch/csrc/gru_fwd.cu',
                  'edgedict_tpu/ops/quant.py:361'),
}
SERVING = ('mel_power', 'greedy_decode')
# per encoder call of each measured decode: the encoder kernels it must
# launch (E6D2: 6 layers; K11 for each layer's x_proj and the projection)
DECODE_RUNS = {
    'decode_wav': {'lstm_fwd': 6, 'gru_fwd': 0, 'quant_matmul': 0,
                   'lstm_fwd_q': 0, 'gru_fwd_q': 0},
    'decode_wav_int8': {'lstm_fwd': 0, 'gru_fwd': 0, 'quant_matmul': 7,
                        'quant_matmul_tile': 0, 'lstm_fwd_q': 6,
                        'gru_fwd_q': 0},
    'decode_wav_gru': {'lstm_fwd': 0, 'gru_fwd': 6, 'quant_matmul': 0,
                       'lstm_fwd_q': 0, 'gru_fwd_q': 0},
    'decode_wav_gru_int8': {'lstm_fwd': 0, 'gru_fwd': 0, 'quant_matmul': 7,
                            'quant_matmul_tile': 0, 'lstm_fwd_q': 0,
                            'gru_fwd_q': 6},
}


def check_launches():
    """The launch counts of every main-path run against what it implies."""
    runs = {run: STATE['launches_' + run] for run in
            (*DECODE_RUNS, 'server', 'server_int8', 'train', 'train_gru')}
    expect = {}
    for run, per_call in DECODE_RUNS.items():
        n = STATE['chunks_' + run]      # one encoder call per chunk
        expect[run] = {k: c * n for k, c in per_call.items()}
        expect[run].update(mel_power=n, greedy_decode=n)
    emit({'phase': 'launches', **runs, 'decode_expected': expect,
          'train_expected': STATE['train_expect']})
    for run, want in expect.items():
        require(all(runs[run][k] == c for k, c in want.items()),
                f'{run} launches {runs[run]} != {want}')
    for run, kernels in (('server', ('lstm_fwd',)),
                         ('server_int8', ('quant_matmul', 'lstm_fwd_q'))):
        require(all(runs[run][k] > 0 for k in SERVING + kernels),
                f'a kernel was not launched by {run}: {runs[run]}')
    require(runs['server_int8']['lstm_fwd'] == 0,
            f'the int8 server launched K1: {runs["server_int8"]}')
    q = runs['server_int8']
    require(q['quant_matmul_tile'] == q['quant_matmul'] > 0,
            f'the 64-stream int8 server ran K11 off its tiled kernel: {q}')
    for run, want in STATE['train_expect'].items():
        require(all(runs[run][k] == n for k, n in want.items()),
                f'{run} launches {runs[run]} != {want}')
    return runs


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
              ('slice_int8', phase_slice_int8),
              ('slice_gru', phase_slice_gru), ('server', phase_server),
              ('server_int8', phase_server_int8),
              ('train_parity', phase_train_parity),
              ('train_parity_gru',
               lambda torch: phase_train_parity(torch, 'GRU')),
              ('train_run', phase_train_run),
              ('train_run_gru', lambda torch: phase_train_run(torch, 'GRU')))
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            fn(torch)
            emit(f'phase {name} passed in {time.perf_counter() - t0:.1f} s')
        runs = check_launches()
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr, flush=True)
        return 1
    finally:
        if 'train_corpus' in STATE:
            shutil.rmtree(STATE['train_corpus'][0], ignore_errors=True)
    launches = {k: sum(c[k] for c in runs.values()) for k in SOURCES}
    kernels = STATE['kernels']
    emit({'kernels': [
        {'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
         'replaces': SOURCES[name][1], 'launches': launches[name],
         **{key: kernels[name][key] for key in (
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
             'library_ms', 'device_ms', 'cases') if key in kernels[name]}}
        for name in SOURCES]})
    emit(nvidia_smi_line())
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': STATE['kind'],
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
