"""WER-parity runbook of the port (counterpart of cli/wer_parity.py):
reference .pt + LibriSpeech test-clean → WER, on the card.

  python -m edgedict_tpu_torch.cli.wer_parity \
      --flagfile flagfiles/E6D2.txt --pt_path <released .pt> \
      --LibriSpeech_test <LibriSpeech>/test-clean \
      [--bpe_cache_dir <the checkpoint's BPE-2048 cache>] [--max_batches N] \
      [--eval_batch_size 4] [--device cuda|cpu]

The tokenizer from the flags (or the checkpoint's own BPE cache,
--bpe_cache_dir), the weights of the .pt through
compat.load_reference_checkpoint (a reference .pt, plain or lightning; a
port or JAX .ckpt too), then every test-clean utterance (or the first
--max_batches batches) through the trainer's eval step
(train.make_eval_step: features on K2, the encoder and prediction net on
K1, the loss on K7 and K9, the greedy decode on K3), its frames cut at
their lengths and blanks dropped (trainer.truncate_and_strip) → one JSON
line {"wer", "n_utts", "checkpoint"}.  Nothing is downloaded.
"""

import json
import sys

import numpy as np
import torch

from edgedict_tpu_torch.config import (
    TRAIN_FLAGS, add_model_flags, feature_config_from_flags, parse_flags,
    transducer_config_from_flags)

# the eval loader's flags, with the trainer's defaults
LOADER_FLAGS = ('LibriSpeech_test', 'eval_batch_size', 'audio_bucket_frames',
                'label_bucket')


def build_parser():
    import argparse
    parser = argparse.ArgumentParser(description='reference .pt → '
                                                 'test-clean WER')
    add_model_flags(parser)
    for name, typ, default in TRAIN_FLAGS:
        if name in LOADER_FLAGS:
            parser.add_argument(f'--{name}', type=typ, default=default)
    parser.add_argument('--pt_path', required=True,
                        help='reference .pt checkpoint')
    parser.add_argument('--bpe_cache_dir', default=None,
                        help="the checkpoint's own BPE cache (released "
                             'checkpoints ship their vocab / merges)')
    parser.add_argument('--max_batches', type=int, default=0,
                        help='0 = the whole eval set')
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default) or 'cpu'")
    return parser


@torch.no_grad()
def evaluate(flags):
    """→ ({'wer', 'n_utts', 'checkpoint'}, refs, hyps)."""
    from edgedict_tpu_torch.compat import load_reference_checkpoint
    from edgedict_tpu_torch.data import BucketSpec, DataLoader, Librispeech
    from edgedict_tpu_torch.features import FeaturePipeline
    from edgedict_tpu_torch.metrics import wer as wer_fn
    from edgedict_tpu_torch.stream import resolve_device
    from edgedict_tpu_torch.tokenizer import HuggingFaceTokenizer
    from edgedict_tpu_torch.train import make_eval_step
    from edgedict_tpu_torch.trainer import build_tokenizer, truncate_and_strip

    device = resolve_device(flags.device)
    if flags.bpe_cache_dir:
        tokenizer = HuggingFaceTokenizer(cache_dir=flags.bpe_cache_dir,
                                         vocab_size=flags.bpe_size)
    else:
        tokenizer = build_tokenizer(flags)
    feature_cfg = feature_config_from_flags(flags)
    cfg = transducer_config_from_flags(flags, tokenizer.vocab_size,
                                       feature_cfg.input_size)
    model = load_reference_checkpoint(flags.pt_path, cfg, device) \
        .requires_grad_(False)
    eval_step = make_eval_step(cfg, FeaturePipeline(feature_cfg, device))

    eval_ds = Librispeech(flags.LibriSpeech_test, tokenizer,
                          audio_max_length=999)
    hop = flags.hop_length * max(1, flags.downsample)
    bucket = BucketSpec(t_multiple=flags.audio_bucket_frames * hop,
                        u_multiple=flags.label_bucket,
                        t_max=int(999 * 16000))
    loader = DataLoader(eval_ds, flags.eval_batch_size, shuffle=False,
                        bucket=bucket, drop_last=False, prefetch=0)
    refs, hyps = [], []
    for i, batch in enumerate(loader):
        if flags.max_batches and i >= flags.max_batches:
            break
        dev = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        _, y_seq, out_len = eval_step(model, dev)
        hyps.extend(tokenizer.decode_plus(truncate_and_strip(
            y_seq.cpu(), out_len.cpu(), blank=cfg.blank)))
        refs.extend(tokenizer.decode_plus(
            [y[:n] for y, n in zip(np.asarray(batch['ys']),
                                   np.asarray(batch['ylen']))]))
    pairs = [(r, h) for r, h in zip(refs, hyps) if r.strip()]
    value = wer_fn([r for r, _ in pairs], [h for _, h in pairs]) \
        if pairs else 1.0
    return ({'wer': round(float(value), 4), 'n_utts': len(pairs),
             'checkpoint': flags.pt_path}, refs, hyps)


def main(argv=None):
    from edgedict_tpu_torch.cli.stream import set_numerics
    parser = build_parser()
    flags = parse_flags(parser, sys.argv[1:] if argv is None else argv)
    set_numerics()
    result, _, hyps = evaluate(flags)
    print(json.dumps(result), flush=True)
    return result, hyps


if __name__ == '__main__':
    main()
