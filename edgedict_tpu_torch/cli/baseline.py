"""Trainer CLI of the port (counterpart of cli/baseline.py).

  python -m edgedict_tpu_torch.cli.baseline --flagfile flagfiles/E6D2.txt \
      [--mode train|resume|eval|device_rate] [--device cuda|cpu] ...

Modes:
  train        fresh run; snapshots flags to logs/<name>/flagfile.txt
  resume       reload logs/<name>/models/<resume_step or latest>.ckpt, go on
  eval         one evaluation pass (val_loss + greedy WER) and exit
  device_rate  the device step rate of this config: one real batch from the
               loader, re-fed for 100 steps after one warm-up step

--device defaults to cuda and fails without a card; the CPU runs only when
asked with --device cpu.
"""

import argparse
import sys
import time

import torch

from edgedict_tpu_torch.config import (
    add_model_flags, add_train_flags, parse_flags)


def set_numerics():
    """True fp32 matmuls, fp32 reductions in bf16 matmuls (as cli/stream)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def build_parser():
    parser = argparse.ArgumentParser(description='RNN-T trainer')
    add_model_flags(parser)
    add_train_flags(parser)
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default) or 'cpu'")
    return parser


def device_rate(trainer, steps=100, log_fn=print):
    """Mean step ms over `steps` re-fed steps of one batch,
    synchronised at both ends; → (step_ms, audio_s_per_s)."""
    from edgedict_tpu_torch.train import device_batch
    batch = next(iter(trainer.loader))
    dev = device_batch(batch, trainer.accum_steps, trainer.device)
    audio_s = float(batch['alen'].sum()) / 16000.0
    lr = trainer._lr(0)
    state = trainer.state
    state, m = trainer.train_step(state, dev, lr, trainer.generator)
    float(m['loss'])                                   # warm-up, synced
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = trainer.train_step(state, dev, lr, trainer.generator)
    float(m['loss'])
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    log_fn(f'device_rate: step_ms {step_ms:.2f} batch_audio_s {audio_s:.1f} '
           f'audio_s_per_s {audio_s / (step_ms / 1e3):.1f}')
    return step_ms, audio_s / (step_ms / 1e3)


def main(argv=None, log_fn=print):
    from edgedict_tpu_torch.trainer import Trainer
    flags = parse_flags(build_parser(),
                        sys.argv[1:] if argv is None else argv)
    set_numerics()
    trainer = Trainer(flags)
    log_fn(f'device: {trainer.device}')
    if flags.mode == 'resume':
        log_fn(f'resumed from step {trainer.load(flags.resume_step)}')
    if flags.mode == 'eval':
        trainer.load(flags.resume_step)
        loss, wer = trainer.evaluate()
        log_fn(f'val_loss {loss:.4f} WER {wer:.4f}')
        return trainer
    if flags.mode == 'device_rate':
        device_rate(trainer, log_fn=log_fn)
        return trainer
    trainer.train(log_fn=log_fn)
    return trainer


if __name__ == '__main__':
    main()
