"""AOT export CLI of the port (counterpart of cli/export.py):

  python -m edgedict_tpu_torch.cli.export --flagfile logs/<name>/flagfile.txt \
      [--export_dir logs/<name>/export] [--export_step_n_frame 2] \
      [--quantize int8] [--pt_path ref.pt | --model_name <step>.ckpt] \
      [--device cuda|cpu]

Rebuilds the transducer from the flags and the run's checkpoint (as the
port's cli.stream loads it: --pt_path, else logs/<name>/models/
<--model_name, else the latest step>.ckpt, else random weights), exports
the encoder / decoder / joint as torch.export artifacts at the pinned
streaming shapes on --device (cuda by default; the artifacts run on that
device only) and asserts their parity with the live model (rtol 1e-3 /
atol 1e-5, reference cli/export_onnx.py:63-68).  --quantize int8 exports
the int8 weight-only encoder.
"""

import argparse
import os
import sys

from edgedict_tpu_torch.cli import stream
from edgedict_tpu_torch.config import (
    TRAIN_FLAGS, add_model_flags, parse_flags)


def build_parser(description):
    """Model flags, --device, --name and --export_dir: what
    export.build_exported_decoder reads."""
    parser = argparse.ArgumentParser(description=description)
    add_model_flags(parser)
    parser.add_argument('--device', default='cuda',
                        help="the artifacts' device: 'cuda' (default) or "
                             "'cpu'")
    run_name = next(d for n, _, d in TRAIN_FLAGS if n == 'name')
    parser.add_argument('--name', default=run_name,
                        help="the training run's name (the trainer's --name)")
    parser.add_argument('--export_dir', default=None,
                        help='the artifacts (default <logdir_root>/<name>/'
                             'export)')
    return parser


def main(argv=None):
    from edgedict_tpu_torch.export import export_transducer

    parser = build_parser('export encoder / decoder / joint')
    parser.add_argument('--export_step_n_frame', type=int, default=2,
                        help='encoder input frames per streaming chunk')
    parser.add_argument('--quantize', default=None, choices=('int8',),
                        help="'int8' = weight-only int8 encoder")
    parser.add_argument('--pt_path', default=None,
                        help='a reference .pt, a port .ckpt or a JAX .ckpt; '
                             "unset = the run's checkpoint")
    parser.add_argument('--model_name', default=None,
                        help='checkpoint file under <logdir_root>/<name>/'
                             'models; unset = the latest step')
    flags = parse_flags(parser, sys.argv[1:] if argv is None else argv)
    stream.set_numerics()
    model, cfg, _, _, device = stream.load_model(flags)
    out = flags.export_dir or os.path.join(flags.logdir_root, flags.name,
                                           'export')
    export_transducer(model, cfg, out, step_frames=flags.export_step_n_frame,
                      quantize=flags.quantize, device=device)
    enc_bytes = os.path.getsize(os.path.join(out, 'encoder.pt2'))
    tag = f', int8 encoder {enc_bytes / 1e6:.1f} MB' if flags.quantize \
        else ''
    print(f'exported encoder/decoder/joint → {out} (parity OK{tag})')
    return out


if __name__ == '__main__':
    main()
