"""wav2vec 2.0 pretraining CLI of the port (counterpart of
cli/pretrain_wav2vec.py).

  python -m edgedict_tpu_torch.cli.pretrain_wav2vec --flagfile \
      flagfiles/E6D2.txt --LibriSpeech_train_100 <dir> --name <run> \
      [--device cuda|cpu] [--mask_prob 0.15 --num_negatives 100 ...]

Trains the contrastive model on raw audio crops of --pretrain_audio_samples
(the encoder at the preset's widths, input 128: the FrontEnd's embed),
logging loss / accuracy / perplexity every --loss_step steps; every
--eval_iteration steps the held-out accuracy (else the train accuracy)
may make a new best checkpoint, copied to logs/<name>/pretrained.ckpt for
cli.train --use_pretrained; the last step always leaves one.  On CUDA each
encoder layer's forward is one K1 launch and its backward one K4 launch
(fp32: the loss takes no bf16 cast).  --device defaults to cuda and fails
without a card.
"""

import argparse
import sys

from edgedict_tpu_torch.config import (
    add_model_flags, add_pretrain_flags, add_train_flags, parse_flags)


def build_parser():
    parser = argparse.ArgumentParser(description='wav2vec 2.0 pretraining')
    add_model_flags(parser)
    add_train_flags(parser)
    add_pretrain_flags(parser)
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default) or 'cpu'")
    return parser


class NullTokenizer:
    """Pretraining reads audio only: every text encodes to no ids."""
    vocab_size = 0

    def encode(self, text, max_length=None):
        return []


def accuracy(metrics):
    return float(metrics.get('correct', 0)) / max(
        float(metrics.get('count', 1)), 1)


def main(argv=None, log_fn=print):
    from edgedict_tpu_torch.cli.baseline import set_numerics
    from edgedict_tpu_torch.data import DataLoader, MergedDataset
    from edgedict_tpu_torch.pretrainer import Wav2VecPretrainer
    from edgedict_tpu_torch.trainer import build_datasets

    flags = parse_flags(build_parser(),
                        sys.argv[1:] if argv is None else argv)
    set_numerics()
    train_sets, eval_set = build_datasets(flags, NullTokenizer())
    if not train_sets:
        raise SystemExit('no training corpora found at the flag paths')
    train = MergedDataset(train_sets)
    pretrainer = Wav2VecPretrainer(flags, train, eval_set)
    # no prefetch: the crops and masks draw from the pretrainer's
    # RandomState in batch order, evaluate() too
    loader = DataLoader(train, flags.batch_size, shuffle=True, prefetch=0,
                        collate_fn=pretrainer.make_batch,
                        workers=max(1, flags.num_workers))
    for epoch in range(flags.epochs):
        for batch in loader:
            metrics = pretrainer.run_step(batch)
            step = pretrainer.host_step
            if step % flags.loss_step == 0:
                log_fn(f'epoch {epoch} step {step} '
                       f'loss {float(metrics["loss"]):.4f} '
                       f'acc {accuracy(metrics):.4f} ppl '
                       f'{float(metrics.get("prob_perplexity", 0)):.1f}')
            if step % flags.eval_iteration == 0:
                ev = pretrainer.evaluate()
                if ev is not None:
                    log_fn(f'eval @ {step}: acc {ev["accuracy"]:.4f} '
                           f'loss {ev["loss"]:.4f}')
                    pretrainer.save_best(ev['accuracy'])
                else:      # no eval corpus: the train accuracy
                    pretrainer.save_best(accuracy(metrics))
    pretrainer.save_best(-0.5)      # always leave a final checkpoint
    return pretrainer


if __name__ == '__main__':
    main()
