"""Import a reference PyTorch checkpoint or a JAX package checkpoint into
the port's format (counterpart of cli/import_checkpoint.py).

  python -m edgedict_tpu_torch.cli.import_checkpoint --flagfile <flags> \
      --name <run> --pt_path <reference .pt | JAX .ckpt> [--out_step N]

Reads the weights (compat.load_model_state: a plain or lightning `.pt`,
or the JAX package's flax-msgpack `.ckpt` through
state_dict_from_jax_params), checks them against the model the flags and
the tokenizer describe (strict: a missing, unexpected or misshapen key
raises) and writes a model-only logs/<name>/models/<out_step>.ckpt, which
cli.stream, cli.serve and cli.baseline --mode eval / resume then read.
"""

import argparse
import os
import sys

from edgedict_tpu_torch.config import (
    TRAIN_FLAGS, add_model_flags, feature_config_from_flags, parse_flags,
    transducer_config_from_flags)


def build_parser():
    parser = argparse.ArgumentParser(description='import a checkpoint')
    add_model_flags(parser)
    run_name = next(d for n, _, d in TRAIN_FLAGS if n == 'name')
    parser.add_argument('--name', default=run_name,
                        help='the run to write logs/<name>/models/ of')
    parser.add_argument('--pt_path', required=True,
                        help="a reference .pt or the JAX package's .ckpt")
    parser.add_argument('--out_step', type=int, default=0,
                        help='step number of the written checkpoint')
    return parser


def main(argv=None, log_fn=print):
    from edgedict_tpu_torch.checkpoint import save_checkpoint
    from edgedict_tpu_torch.compat import load_reference_checkpoint
    from edgedict_tpu_torch.trainer import build_tokenizer
    flags = parse_flags(build_parser(),
                        sys.argv[1:] if argv is None else argv)
    tokenizer = build_tokenizer(flags)
    feature_cfg = feature_config_from_flags(flags)
    cfg = transducer_config_from_flags(flags, tokenizer.vocab_size,
                                       feature_cfg.input_size)
    model = load_reference_checkpoint(flags.pt_path, cfg, 'cpu')
    logdir = os.path.join(flags.logdir_root, flags.name)
    path = save_checkpoint(logdir, flags.out_step, model.state_dict())
    log_fn(f'imported {flags.pt_path} → {path}')
    log_fn('(vocab %d, enc %dx%d, dec %dx%d, joint %d)' % (
        cfg.vocab_size, cfg.enc_layers, cfg.enc_hidden_size,
        cfg.dec_layers, cfg.dec_hidden_size, cfg.joint_size))
    return path


if __name__ == '__main__':
    main()
