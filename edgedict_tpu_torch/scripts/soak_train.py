"""Training soak of the port (counterpart of scripts/soak_train.py): many
full-width E6D2 steps through the real trainer (cli.baseline in a child
process: loader, decoded-PCM cache, background checkpoints, evaluation)
with a mid-run SIGKILL, a double resume held bit for bit, and a resume to
the end.

  python -m edgedict_tpu_torch.scripts.soak_train [--steps 5000] \
      [--batch 64] [--utts 512] [--utt_seconds 14] [--device_corpus] \
      [--device cuda|cpu] [--tiny] [--work DIR] [--out PATH]

Phases:
  1. synthesize a WAV corpus (LibriSpeech layout, char transcripts), the
     JAX script's bit for bit;
  2. train from scratch; SIGKILL the child once its log shows step
     `--steps * --kill_frac` (the soak fails unless the kill hit a live
     process);
  3. resume from the newest surviving checkpoint twice, for
     `--resume_probe_steps` steps each, and require the two legs' final
     checkpoint files to be byte-identical (on a mismatch, every tensor
     that differs is reported with its largest absolute difference);
  4. resume again to `--steps`;
  4b. `--mode device_rate` of the same configuration (one real batch
      re-fed): the denominator of `loader_efficiency`;
  5. report, with the JAX report's keys: loss trajectory (first / mid /
     final window means), sustained step ms and audio-s/s from the final
     leg's step lines, NaN-skipped loss lines, the kill and resume steps,
     the checkpoints, loader efficiency against the device rate.  Written
     to --out (default: soak_report.json in the work directory).

The children run on the card (--device cuda, the default) unless --tiny
(a tiny model: the orchestration itself) or --device cpu asks for the
CPU; without a card the soak refuses before any work.  The exit code is 0
when every check held.
"""

import argparse
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

# the repository root: the children import the port from here
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class SoakError(RuntimeError):
    """A check of the soak failed."""


def require(cond, msg):
    if not cond:
        raise SoakError(msg)


def make_corpus(root, n, seconds, sr=16000, seed=0):
    """n tone-word utterances of `seconds` each (synth_hard at 20 or 10
    dB, ~2.5 words a second, zero-padded to length) under
    root/1/1/1-1-<i>.wav, their word transcripts in 1-1.trans.txt."""
    from edgedict_tpu_torch.data.audio_io import save_wav
    from edgedict_tpu_torch.scripts.synthetic_convergence import (
        WORDS, synth_hard)
    rng = np.random.RandomState(seed)
    names = list(WORDS)
    d = os.path.join(root, '1', '1')
    os.makedirs(d, exist_ok=True)
    lines = []
    target = int(sr * seconds)
    for i in range(n):
        name = f'1-1-{i:04d}'
        # word groups until the next one would pass `seconds`; the gaps
        # keep a 14 s transcript near 110 characters
        words, audio = [], np.zeros(0, np.float32)
        while True:
            w = [names[rng.randint(len(names))]
                 for _ in range(rng.randint(6, 12))]
            seg = synth_hard(w, rng, snr_db=[20.0, 10.0][rng.randint(2)],
                             gap=(0.12, 0.25))
            if len(audio) + len(seg) > target:
                break
            words.extend(w)
            audio = np.concatenate([audio, seg])
        audio = np.concatenate(
            [audio, np.zeros(target - len(audio), np.float32)])
        save_wav(os.path.join(d, name + '.wav'), audio, sr)
        lines.append(f'{name} ' + ' '.join(words).upper())
    with open(os.path.join(d, '1-1.trans.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')


def device_of(args):
    return 'cpu' if args.tiny else args.device


def flags_for(args, corpus, logs, epochs, mode='train', extra=()):
    """cli.baseline's flags of a leg: the JAX script's, then --device."""
    return [
        '--mode', mode,
        '--cache_audio=%s' % ('false' if args.no_cache_audio else 'true'),
        '--device_corpus=%s' % ('true' if args.device_corpus else 'false'),
        '--LibriSpeech_train_100', corpus,
        '--LibriSpeech_train_360', '/nonexistent',
        '--LibriSpeech_train_500', '/nonexistent',
        '--LibriSpeech_test', corpus,
        '--TEDLIUM_train', '/nonexistent', '--CommonVoice', '/nonexistent',
        '--YT_bloomberg2', '/nonexistent', '--YT_life', '/nonexistent',
        '--logdir_root', logs, '--name', 'soak',
        '--tokenizer', 'char',
    ] + ([
        # --tiny: the orchestration itself, on the CPU
        '--enc_hidden_size', '16', '--enc_layers', '2',
        '--enc_proj_size', '16', '--dec_hidden_size', '16',
        '--dec_layers', '1', '--dec_proj_size', '16',
        '--joint_size', '16', '--vocab_embed_size', '8',
        '--feature', 'logfbank', '--feature_size', '8',
        '--n_fft', '256', '--win_length', '256', '--hop_length', '128',
        '--downsample', '3',
    ] if args.tiny else [
        # E6D2 (flagfiles/E6D2.txt model shapes)
        '--enc_hidden_size', '1024', '--enc_layers', '6',
        '--enc_proj_size', '640', '--dec_hidden_size', '256',
        '--dec_layers', '2', '--dec_proj_size', '256',
        '--joint_size', '640', '--vocab_embed_size', '64',
        '--feature', 'logfbank', '--feature_size', '80',
        '--n_fft', '400', '--win_length', '400', '--hop_length', '200',
        '--downsample', '3',
    ]) + [
        '--batch_size', str(args.batch), '--sub_batch_size',
        str(args.batch), '--eval_batch_size', '16',
        '--audio_max_length', str(args.utt_seconds),
        '--lr', '4e-4', '--warmup_step', '200', '--gradclip', '10',
        '--loss_step', '10',
        '--save_step', str(args.save_step),
        '--eval_step', str(args.eval_step),
        '--epochs', str(epochs),
    ] + list(extra) + ['--device', device_of(args)]


STEP_RE = re.compile(
    r'step (\d+)/\d+ loss ([-\d.naif]+) lr \S+ \((\d+\.\d+)s\)')


def parse_log(path, offset=0):
    """[(step, loss, seconds since the child's start)] of the step lines
    in path from byte `offset` on."""
    steps = []
    with open(path, errors='ignore') as f:
        f.seek(offset)
        for line in f:
            m = STEP_RE.search(line)
            if m:
                steps.append((int(m.group(1)), float(m.group(2)),
                              float(m.group(3))))
    return steps


def child_command():
    """The trainer of every leg: cli.baseline, unbuffered, as its step
    lines are print()s that wait_for_step reads while it runs."""
    return [sys.executable, '-u', '-m', 'edgedict_tpu_torch.cli.baseline']


def launch(flags, log_path, env):
    """→ (the child, its log file), stdout and stderr appended to
    log_path."""
    log = open(log_path, 'a')
    return subprocess.Popen(
        child_command() + flags, cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT), log


def wait_for_step(log_path, target, proc, timeout, poll=5.0):
    """The last step the log shows once it is >= target, or once the
    child has exited (-1: no step line)."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        exited = proc.poll() is not None
        steps = parse_log(log_path)
        if exited or (steps and steps[-1][0] >= target):
            return steps[-1][0] if steps else -1
        time.sleep(poll)
    raise TimeoutError(f'no step >= {target} within {timeout}s')


def checkpoint_steps(logdir):
    models = os.path.join(logdir, 'models')
    return sorted(int(f.split('.')[0]) for f in os.listdir(models)
                  if f.split('.')[0].isdigit() and f.endswith('.ckpt'))


def sha256(path):
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def checkpoint_diff(path_a, path_b):
    """Every entry in which two checkpoint files differ → [(key path,
    largest absolute difference, or a note for a non-tensor or a shape /
    dtype mismatch)]."""
    import torch

    from edgedict_tpu_torch.checkpoint import load_checkpoint
    out = []

    def walk(a, b, key):
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b), key=str):
                if k not in a or k not in b:
                    out.append((f'{key}/{k}', 'only in leg '
                                + ('A' if k in a else 'B')))
                else:
                    walk(a[k], b[k], f'{key}/{k}')
        elif isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            if a.shape != b.shape or a.dtype != b.dtype:
                out.append((key, f'{tuple(a.shape)} {a.dtype} against '
                                 f'{tuple(b.shape)} {b.dtype}'))
            elif not torch.equal(a, b):
                out.append((key, float((a.double() - b.double())
                                       .abs().max())))
        elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) \
                and len(a) == len(b):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f'{key}/{i}')
        elif a != b:
            out.append((key, f'{a!r} against {b!r}'))

    walk(load_checkpoint(path_a), load_checkpoint(path_b), '')
    return out


def _kill_mid_run(args, corpus, logs, log_path, env, total_epochs, kill_at,
                  log_fn):
    """Phases 1+2: a fresh run, SIGKILLed once its log reaches kill_at;
    → the last step its log showed."""
    proc, log = launch(flags_for(args, corpus, logs, total_epochs),
                       log_path, env)
    try:
        reached = wait_for_step(log_path, kill_at, proc, timeout=7200,
                                poll=args.poll)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)      # a real unclean death
        proc.wait()
        log.close()
    require(proc.returncode == -signal.SIGKILL,
            f'the kill did not hit a live trainer: it exited by itself '
            f'(rc {proc.returncode}) at step {reached}, see {log_path}')
    require(reached >= kill_at,
            f'died before the kill point (step {reached} < {kill_at})')
    log_fn(f'[soak] killed at step >= {reached}')
    return reached


def _double_resume(args, corpus, logs, logdir, work, env, ckpt,
                   steps_per_epoch, log_fn):
    """Phase 3: two resumes from ckpt to the same step; → (their final
    step, sha256).  Fails with checkpoint_diff's list on a mismatch."""
    probe_target = ckpt + args.resume_probe_steps
    probe_epochs = -(-probe_target // steps_per_epoch)
    models = os.path.join(logdir, 'models')
    legs = []
    for leg in ('A', 'B'):
        # checkpoints after ckpt go, so both legs resume from it
        for s in checkpoint_steps(logdir):
            if s > ckpt:
                os.remove(os.path.join(models, f'{s}.ckpt'))
        plog = os.path.join(work, f'probe_{leg}.log')
        proc, log = launch(
            flags_for(args, corpus, logs, probe_epochs, mode='resume'),
            plog, env)
        rc = proc.wait(timeout=7200)
        log.close()
        require(rc == 0, f'probe {leg} rc={rc}: see {plog}')
        final = checkpoint_steps(logdir)[-1]
        kept = os.path.join(work, f'probe_{leg}.ckpt')
        shutil.copyfile(os.path.join(models, f'{final}.ckpt'), kept)
        legs.append((final, sha256(kept), kept))
        log_fn(f'[soak] resume leg {leg}: step {final} '
               f'sha256 {legs[-1][1][:16]}')
    (step_a, hash_a, path_a), (step_b, hash_b, path_b) = legs
    if (step_a, hash_a) != (step_b, hash_b):
        diff = checkpoint_diff(path_a, path_b)
        raise SoakError(
            f'resume is NOT bit-deterministic: leg A step {step_a} '
            f'{hash_a}, leg B step {step_b} {hash_b}; entries that differ '
            f'(key, largest |A - B|): {diff}')
    log_fn('[soak] double-resume checkpoints BYTE-IDENTICAL')
    return step_a, hash_a


def _device_rate(args, corpus, logs, work, env, total_epochs, log_fn):
    """Phase 4b: --mode device_rate of the same flags; → (step ms,
    audio-s/s), or (None, None) when the probe failed."""
    drate_log = os.path.join(work, 'device_rate.log')
    proc, log = launch(
        flags_for(args, corpus, logs, total_epochs, mode='device_rate'),
        drate_log, env)
    try:
        rc = proc.wait(timeout=3600)
    except subprocess.TimeoutExpired:
        # optional evidence: a hang must not discard the finished soak
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        rc = -1
    log.close()
    if rc == 0:
        with open(drate_log, errors='ignore') as f:
            m = re.search(r'device_rate: step_ms ([\d.]+) .*'
                          r'audio_s_per_s ([\d.]+)', f.read())
        if m:
            return float(m.group(1)), float(m.group(2))
    log_fn(f'[soak] device_rate probe failed rc={rc} (see {drate_log})')
    return None, None


def report(args, log_path, final_offset, reached, ckpt, ckpts,
           device_step_ms, device_rate):
    """The JAX script's report from the logs (its keys, its windows)."""
    steps = parse_log(log_path)
    losses = np.array([(s, l) for s, l, _ in steps if np.isfinite(l)])
    require(len(losses), f'no finite loss line in {log_path}')
    n = len(losses)
    window = max(n // 10, 1)
    first = float(losses[:window, 1].mean())
    mid = float(losses[n // 2:n // 2 + window, 1].mean())
    last = float(losses[-window:, 1].mean())
    # sustained throughput from the final leg's step lines only (elapsed
    # restarts per process; its first tenth skipped for start-up)
    leg = parse_log(log_path, offset=final_offset)
    leg = [(s, t) for s, _, t in leg[max(len(leg) // 10, 1):]]
    if len(leg) >= 2:
        ds = leg[-1][0] - leg[0][0]
        dt = leg[-1][1] - leg[0][1]
        step_ms = dt / max(ds, 1) * 1e3
        # median per-line step time: robust to the pauses the mean absorbs
        # (evaluation, checkpoint snapshots)
        deltas = [(t2 - t1) / max(s2 - s1, 1) * 1e3
                  for (s1, t1), (s2, t2) in zip(leg, leg[1:]) if s2 > s1]
        step_ms_median = float(np.median(deltas)) if deltas else step_ms
    else:
        step_ms = step_ms_median = float('nan')
    audio_rate = args.batch * args.utt_seconds / (step_ms_median / 1e3)
    nan_skips = sum(1 for _, l, _ in steps if not np.isfinite(l))
    return {
        'steps': int(losses[-1, 0]), 'batch': args.batch,
        'loss_first': round(first, 3), 'loss_mid': round(mid, 3),
        'loss_final': round(last, 3),
        'monotone_improving': bool(first > mid > last),
        'sustained_step_ms': round(step_ms_median, 2),
        'sustained_step_ms_mean': round(step_ms, 2),  # incl. eval/ckpt
        'sustained_audio_s_per_s': round(audio_rate, 1),
        'nan_skipped_loss_lines': nan_skips,
        'killed_at_step': int(reached), 'resumed_from': int(ckpt),
        'double_resume_bit_identical': True,
        'checkpoints': ckpts,
        'cache_audio': not args.no_cache_audio,
        'device_corpus': bool(args.device_corpus),
        'device_step_ms': device_step_ms,
        'device_audio_s_per_s': device_rate,
        # the loop's own rate bounds the device step from above, so a
        # probe slower than the loop reads as efficiency 1.0
        'loader_efficiency': (
            round(min(device_step_ms, step_ms_median) / step_ms_median, 3)
            if device_step_ms else None),
    }


def run(args, log_fn=print):
    """Every phase; → the report (also written to args.out, default
    <work>/soak_report.json).  SoakError when a check fails."""
    from edgedict_tpu_torch.stream import resolve_device
    resolve_device(device_of(args))        # no card: fail before any work
    work = args.work
    corpus = os.path.join(work, 'libri')
    logs = os.path.join(work, 'logs')
    logdir = os.path.join(logs, 'soak')
    log_path = os.path.join(work, 'train.log')
    out = args.out or os.path.join(work, 'soak_report.json')
    if os.path.exists(work):
        shutil.rmtree(work)
    os.makedirs(work)
    log_fn(f'[soak] corpus: {args.utts} x {args.utt_seconds}s WAV')
    make_corpus(corpus, args.utts, args.utt_seconds)

    steps_per_epoch = args.utts // args.batch
    require(steps_per_epoch > 0, f'--utts {args.utts} < --batch '
            f'{args.batch}: no step')
    total_epochs = -(-args.steps // steps_per_epoch)
    kill_at = int(args.steps * args.kill_frac)
    # PYTHONPATH appended to, not replaced: the ambient value may carry
    # the interpreter's own site set-up
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')

    log_fn(f'[soak] training to {args.steps} steps ({steps_per_epoch}/'
           f'epoch) on {device_of(args)}, SIGKILL at ~{kill_at}')
    reached = _kill_mid_run(args, corpus, logs, log_path, env, total_epochs,
                            kill_at, log_fn)
    ckpts = checkpoint_steps(logdir)
    require(ckpts, 'no checkpoint survived the kill')
    ckpt = ckpts[-1]
    log_fn(f'[soak] surviving checkpoints: {ckpts} -> resume from {ckpt}')

    _double_resume(args, corpus, logs, logdir, work, env, ckpt,
                   steps_per_epoch, log_fn)

    # phase 4: resume to the end
    final_offset = os.path.getsize(log_path)
    proc, log = launch(
        flags_for(args, corpus, logs, total_epochs, mode='resume'),
        log_path, env)
    rc = proc.wait(timeout=14400)
    log.close()
    require(rc == 0, f'final leg rc={rc}: see {log_path}')

    device_step_ms, device_rate = _device_rate(
        args, corpus, logs, work, env, total_epochs, log_fn)
    result = report(args, log_path, final_offset, reached, ckpt, ckpts,
                    device_step_ms, device_rate)
    with open(out, 'w') as f:
        json.dump(result, f, indent=2)
    log_fn('[soak] ' + json.dumps(result))
    log_fn(f'[soak] wrote {out}')
    return result


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--steps', type=int, default=5000)
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--utts', type=int, default=512)
    ap.add_argument('--utt_seconds', type=float, default=14.0)
    ap.add_argument('--save_step', type=int, default=250)
    ap.add_argument('--eval_step', type=int, default=1000)
    ap.add_argument('--kill_frac', type=float, default=0.45)
    ap.add_argument('--resume_probe_steps', type=int, default=100,
                    help='steps per double-resume determinism leg')
    ap.add_argument('--work', default=os.path.join(tempfile.gettempdir(),
                                                   'edgedict_torch_soak'),
                    help='working directory (emptied first)')
    ap.add_argument('--tiny', action='store_true',
                    help='tiny model on the CPU: the orchestration itself')
    ap.add_argument('--device', default='cuda',
                    help="the children's torch device: 'cuda' (default) "
                         "or 'cpu'")
    ap.add_argument('--device_corpus', action='store_true',
                    help='the corpus on the device: the step loop gathers '
                         'its batches there by index')
    ap.add_argument('--no_cache_audio', action='store_true',
                    help='decode the WAVs per item instead of from the '
                         'decoded-PCM cache')
    ap.add_argument('--poll', type=float, default=5.0,
                    help='seconds between reads of the killed leg\'s log')
    ap.add_argument('--out', default=None,
                    help='report path (default: <work>/soak_report.json)')
    return ap


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    try:
        run(args)
    except SoakError as e:
        print(f'[soak] FAILED: {e}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
