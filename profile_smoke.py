"""Seconds of chip_smoke.py phases, this tree's against another tree's, in
turns in one process on the card.

  python3 profile_smoke.py --other DIR [--setup train_run lm_train ...] \
      --phases kernels slice_beam ... [--out FILE]

DIR holds another version of the repo (a `git archive` of the parent
commit); its chip_smoke.py is loaded beside this tree's, and both run on
this tree's package and share one STATE.  First `device`, `build` and the
--setup phases run once (this tree's: the prerequisites of the timed
phases), then each --phases phase in the order TURNS: the other tree's,
this tree's, this tree's, the other tree's.  Each line either module
prints goes to --out (default logs/profile_smoke.txt) with the seconds
since its phase began and since the line before.  Prints one line per
phase run, then one JSON line {phase: [[turn, seconds], ...]} and the
card's `nvidia-smi --query-gpu=name,power.limit` line.  A failed phase
prints its error and the turns go on.  Needs a CUDA card, as the smoke's
phases do.
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
# O: the other tree's phase, C: this tree's
TURNS = 'OCCO'


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--other', required=True,
                        help='a directory holding another chip_smoke.py')
    parser.add_argument('--setup', nargs='*', default=[],
                        help="phases run once first (this tree's), after "
                             'device and build')
    parser.add_argument('--phases', nargs='+', required=True,
                        help='the phases timed in turns')
    parser.add_argument('--out', default=os.path.join(
        REPO, 'logs', 'profile_smoke.txt'))
    return parser


def load_smokes(other):
    """(this tree's chip_smoke module, the other tree's), sharing one
    STATE."""
    import chip_smoke
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_other', os.path.join(other, 'chip_smoke.py'))
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    theirs.STATE = chip_smoke.STATE
    return chip_smoke, theirs


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('profile_smoke: no CUDA card')
    ours, theirs = load_smokes(args.other)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, 'a')
    clock = {}

    def emit(obj):
        now = time.perf_counter()
        line = obj if isinstance(obj, str) else json.dumps(obj)
        out.write(f'[{now - clock["phase"]:8.2f} +{now - clock["last"]:7.2f}]'
                  f' {line}\n')
        out.flush()
        clock['last'] = now

    ours.emit = theirs.emit = emit
    ours.set_numerics(torch)
    times = {}

    def run(module, turn, name):
        if name == 'slice_beam':      # each turn builds its own beam models
            ours.STATE.pop('beam_model', None)
            ours.STATE.pop('beam_lm', None)
        clock['phase'] = clock['last'] = time.perf_counter()
        emit(f'=== {turn} {name}')
        try:
            getattr(module, 'phase_' + name)(torch)
            seconds = round(time.perf_counter() - clock['phase'], 1)
        except Exception as e:  # noqa: BLE001 (the turns go on)
            out.write(traceback.format_exc())
            seconds = f'FAILED {e!r}'[:300]
        times.setdefault(name, []).append((turn, seconds))
        print(f'{turn} {name}: {seconds}', flush=True)

    try:
        for name in ['device', 'build'] + args.setup:
            run(ours, 'setup', name)
        for i, side in enumerate(TURNS):
            for name in args.phases:
                run(theirs if side == 'O' else ours, f'{side}{i + 1}', name)
        print(json.dumps(times), flush=True)
        print(ours.nvidia_smi_line(), flush=True)
    finally:
        out.close()
        if 'train_corpus' in ours.STATE:
            shutil.rmtree(ours.STATE['train_corpus'][0], ignore_errors=True)


if __name__ == '__main__':
    main()
