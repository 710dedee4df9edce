"""Raw-waveform RNN-T trainer CLI of the port (counterpart of cli/train.py):
a trainable conv FrontEnd in place of spectral features, optionally
initialised from a wav2vec pretraining run.

  python -m edgedict_tpu_torch.cli.train --flagfile flagfiles/E6D2.txt \
      --LibriSpeech_train_100 <dir> --name <run> [--use_pretrained] \
      [--mode train|resume|eval] [--device cuda|cpu]

--use_pretrained splices the FrontEnd and encoder of
logs/<name>/pretrained.ckpt (cli.pretrain_wav2vec) into the model before
anything else; --mode resume then reloads logs/<name>/models/<resume_step
or latest>.ckpt and goes on, --mode eval reloads it and prints one
evaluation (val_loss and greedy WER).  --device defaults to cuda and
fails without a card.
"""

import argparse
import os
import sys

from edgedict_tpu_torch.config import (
    add_model_flags, add_pretrain_flags, add_train_flags, parse_flags)


def build_parser():
    parser = argparse.ArgumentParser(description='raw-waveform RNN-T '
                                                 'trainer')
    add_model_flags(parser)
    add_train_flags(parser)
    add_pretrain_flags(parser)
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default) or 'cpu'")
    return parser


def main(argv=None, log_fn=print):
    from edgedict_tpu_torch.cli.baseline import set_numerics
    from edgedict_tpu_torch.raw_trainer import RawTrainer
    flags = parse_flags(build_parser(),
                        sys.argv[1:] if argv is None else argv)
    set_numerics()
    trainer = RawTrainer(flags)
    log_fn(f'device: {trainer.device}')
    if flags.use_pretrained:
        path = os.path.join(flags.logdir_root, flags.name, 'pretrained.ckpt')
        trainer.load_pretrained(path)
        log_fn(f'initialized frontend+encoder from {path}')
    if flags.mode == 'resume':
        log_fn(f'resumed from step '
               f'{trainer.load(flags.resume_step, log_fn=log_fn)}')
    if flags.mode == 'eval':
        trainer.load(flags.resume_step, log_fn=log_fn)
        loss, wer = trainer.evaluate()
        log_fn(f'val_loss {loss:.4f} WER {wer:.4f}')
        return trainer
    trainer.train(log_fn=log_fn)
    return trainer


if __name__ == '__main__':
    main()
