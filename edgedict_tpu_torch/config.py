"""Flagfile-driven configuration (counterpart of edgedict_tpu/config.py),
on argparse.

Reads the reference's flagfile presets (flagfiles/E6D2.txt, ...) in the
absl syntax they use: one flag per line, `--k=v`, `--flag`, `--noflag`,
nested `--flagfile=path`, blank lines and `#` / `//` comments.  The flags
each entry point reads are registered with the JAX package's defaults:
`add_model_flags` for the model, features and tokenizer (every CLI),
`add_train_flags` for the trainer (cli/baseline.py), `add_pretrain_flags`
for wav2vec pretraining (cli/pretrain_wav2vec.py, cli/train.py).  The
other keys of the JAX registry that a preset or a run snapshot carries
(`--apex`, `--opt_level`, the trainer's keys in a serving CLI, ...) are
accepted and ignored.  The JAX package's flags whose work the port does
not do yet (`REFUSED`, empty since every one is ported) parse at their
defaults, and any other value stops the parse with an error that names
the flag and the ROADMAP.md Queue 1 item that brings it: nothing is
dropped without a word.  Any other key is an error, as with absl.

--dp_size is data parallelism over processes (cli/distributed.py, one
process a GPU): -1 and the default process group's world size parse (1
without a group), anything else stops the parse naming the launcher or
the world size.  --serve_dp_size N (the stream / serve parser) asks for N
local devices; over --device cuda, N larger than the visible cards stops
the parse as the JAX server's assertion does (root cli/serve.py:58-67).
--tp_size / --pp_size split a trainer's model over a grid of devices
(parallel/); under --device cuda a trainer's parse stops when fewer than
tp_size × pp_size cards are visible, naming the count.  The serving CLIs
parse both and ignore them, as the JAX package's serving does.
"""

import argparse

from edgedict_tpu_torch.features import FeatureConfig
from edgedict_tpu_torch.models.transducer import TransducerConfig


def parse_bool(text):
    low = str(text).lower()
    if low in ('1', 'true', 't', 'yes', 'y'):
        return True
    if low in ('0', 'false', 'f', 'no', 'n'):
        return False
    raise argparse.ArgumentTypeError(f'not a boolean: {text!r}')


# (name, type, default) — defaults as in edgedict_tpu/config.py
MODEL_FLAGS = (
    ('logdir_root', str, 'logs'),
    ('enc_type', str, 'LSTM'),
    ('enc_hidden_size', int, 600),
    ('enc_layers', int, 4),
    ('enc_proj_size', int, 600),
    ('dec_hidden_size', int, 150),
    ('dec_layers', int, 2),
    ('dec_proj_size', int, 150),
    ('joint_size', int, 512),
    ('tokenizer', str, 'char'),
    ('bpe_size', int, 256),
    ('vocab_embed_size', int, 16),
    ('feature', str, 'mfcc'),
    ('feature_size', int, 80),
    ('n_fft', int, 400),
    ('win_length', int, 400),
    ('hop_length', int, 200),
    ('delta', parse_bool, False),
    ('cmvn', parse_bool, False),
    ('downsample', int, 3),
    # the trainers' (the raw-waveform fine-tune's splice, cli/train.py; the
    # device-resident corpus and the profiler trace, trainer.py); the JAX
    # registry defines them for every entry point
    ('use_pretrained', parse_bool, False),
    ('device_corpus', parse_bool, False),
    ('profile_dir', str, None),
)

def optional_float(text):
    return None if str(text).lower() in ('none', '') else float(text)


def optional_int(text):
    return None if str(text).lower() in ('none', '') else int(text)


_LIBRI = '../librispeech/LibriSpeech/'
_SPEECH = '../speech_data/'

# the trainer's flags (name, type, default) — defaults as in
# edgedict_tpu/config.py
TRAIN_FLAGS = (
    ('name', str, 'rnn-t-v5'),
    ('mode', str, 'train'),
    ('resume_step', optional_int, None),
    ('LibriSpeech_train_100', str, _LIBRI + 'train-clean-100'),
    ('LibriSpeech_train_360', str, _LIBRI + 'train-clean-360'),
    ('LibriSpeech_train_500', str, _LIBRI + 'train-other-500'),
    ('LibriSpeech_test', str, _LIBRI + 'test-clean'),
    ('TEDLIUM_train', str, _SPEECH + 'TEDLIUM/TEDLIUM_release1/train'),
    ('CommonVoice', str, _SPEECH + 'common_voice'),
    ('YT_bloomberg2', str, _SPEECH + 'common_voice'),
    ('YT_life', str, _SPEECH + 'common_voice'),
    ('num_workers', int, 4),
    ('cache_audio', parse_bool, False),
    ('optim', str, 'adam'),
    ('lr', float, 1e-4),
    ('sched', parse_bool, True),
    ('sched_patience', int, 1),
    ('sched_factor', float, 0.5),
    ('sched_min_lr', float, 1e-6),
    ('warmup_step', int, 10000),
    ('epochs', int, 30),
    ('batch_size', int, 8),
    ('sub_batch_size', int, 8),
    ('eval_batch_size', int, 4),
    ('gradclip', optional_float, None),
    ('enc_dropout', float, 0.0),
    ('dec_dropout', float, 0.0),
    ('audio_max_length', float, 14),
    ('T_mask', int, 50),
    ('T_num_mask', int, 2),
    ('F_mask', int, 5),
    ('F_num_mask', int, 1),
    ('time_warp_w', int, 0),
    ('loss_step', int, 5),
    ('save_step', int, 10000),
    ('keep_checkpoints', int, 0),
    ('eval_step', int, 10000),
    ('eval_beam_width', int, 0),
    ('sample_size', int, 20),
    ('bf16', parse_bool, True),
    ('audio_bucket_frames', int, 128),
    ('label_bucket', int, 16),
)
# wav2vec pretraining (edgedict_tpu/pretrain_config.py:15-36, the
# reference's names and defaults): cli/pretrain_wav2vec.py and cli/train.py
PRETRAIN_FLAGS = (
    ('prob_perplex', float, 0.1),
    ('code_perplex', float, 1.0),
    ('features_pen', float, 10.0),
    ('init_temp', float, 1.0),
    ('min_temp', float, 0.1),
    ('temp_decay', float, 0.999995),
    ('eval_iteration', int, 1000),
    ('beta1', float, 0.9),
    ('beta2', float, 0.998),
    ('weight_decay', float, 0.01),
    ('num_negatives', int, 100),
    ('mask_prob', float, 0.15),
    ('mask_length', int, 10),
    ('latent_vars', int, 320),
    ('latent_groups', int, 2),
    ('final_dim', int, 256),
    ('pretrain_audio_samples', int, 48000),
)
MODES = ('train', 'resume', 'eval', 'device_rate')
OPTIMIZERS = ('adam', 'adamw', 'sgd', 'sm3', 'novograd')

# flags of edgedict_tpu/config.py that the JAX package also accepts and
# ignores (or that only steer XLA): dropped
UNREAD = frozenset(('LibriSpeech_dev', 'TEDLIUM_test', 'apex', 'opt_level',
                    'multi_gpu', 'compilation_cache_dir'))
# absl's own flags and those of the libraries the JAX package imports
# (absl.app, absl.logging, absl.testing, chex): the JAX package's flag
# snapshot (FLAGS.append_flags_into_file) carries them, and they are ignored
ABSL_FLAGS = frozenset((
    'only_check_args', 'pdb', 'pdb_post_mortem', 'run_with_pdb',
    'run_with_profiling', 'profile_file', 'use_cprofile_for_profiling',
    'alsologtostderr', 'log_dir', 'logger_levels', 'logtostderr',
    'showprefixforinfo', 'stderrthreshold', 'verbosity', 'v',
    'test_random_seed', 'test_randomize_ordering_seed', 'test_srcdir',
    'test_tmpdir', 'xml_output_file', 'chex_assert_multiple_cpu_devices',
    'chex_n_cpu_devices', 'chex_skip_pmap_variant_if_single_device'))
# keys a flagfile may carry that a parser may leave unregistered
_IGNORABLE = UNREAD | ABSL_FLAGS | {
    name for name, _, _ in TRAIN_FLAGS + PRETRAIN_FLAGS}

# flags of edgedict_tpu/config.py whose work the port does not do yet:
# (name, type, the values that ask for nothing, ROADMAP.md Queue 1 item)
REFUSED = ()
LAUNCHER = 'python -m edgedict_tpu_torch.cli.distributed'


def add_refused_flags(parser, refused):
    """Register the flags of `refused` at their first allowed value
    (parse_flags checks them)."""
    for name, typ, allowed, item in refused:
        parser.add_argument(f'--{name}', type=typ, default=allowed[0],
                            help=f'not ported yet (ROADMAP.md Queue 1 item '
                                 f'{item}): only {allowed} are accepted')
    return parser


def add_model_flags(parser):
    """Register --flagfile, the model/feature/tokenizer flags, --dp_size,
    --tp_size, --pp_size and the refused ones (parse_flags checks
    those)."""
    parser.add_argument('--flagfile', action='append', default=[],
                        help='read flags from this file (absl syntax)')
    for name, typ, default in MODEL_FLAGS:
        parser.add_argument(f'--{name}', type=typ, default=default)
    parser.add_argument('--dp_size', type=int, default=-1,
                        help='data-parallel processes: -1 or the process '
                             f"group's world size (launch with {LAUNCHER})")
    parser.add_argument('--tp_size', type=int, default=1,
                        help='trainers: the joint\'s vocabulary in this many '
                             'slices, one a device of the process\'s grid '
                             '(edgedict_tpu_torch/parallel/); serving '
                             'ignores it')
    parser.add_argument('--pp_size', type=int, default=1,
                        help='the transducer trainer: the encoder in this '
                             'many pipeline stages, one a device of the '
                             'grid; serving ignores it')
    return add_refused_flags(parser, REFUSED)


def add_serve_flags(parser):
    """Register --serve_dp_size (root cli/serve.py:41) on the stream /
    serve parser."""
    parser.add_argument('--serve_dp_size', type=int, default=0,
                        help='>1: shard the server\'s streams over this many '
                             'local devices (cuda:0 ... cuda:N-1, or N CPU '
                             'replicas under --device cpu)')
    return parser


def _parallel_errors(flags):
    """The --dp_size, --tp_size / --pp_size and --serve_dp_size values this
    process cannot honour, as messages.  A trainer's parser (one with
    --mode) over --device cuda needs tp_size × pp_size visible cards from
    its first (parallel/__init__.py:grid_devices)."""
    from edgedict_tpu_torch import parallel, train
    errors = []
    world = train.world()[1]
    dp = getattr(flags, 'dp_size', -1)
    if dp not in (-1, world):
        errors.append(
            f'--dp_size={dp}: data parallelism runs one process a GPU; '
            f'launch {LAUNCHER} under torchrun (--nproc_per_node {dp}) or '
            'with --coordinator_address, --num_processes and --process_id'
            if world == 1 else
            f'--dp_size={dp} but the process group has world size {world}')
    tp, pp = getattr(flags, 'tp_size', 1), getattr(flags, 'pp_size', 1)
    if tp < 1 or pp < 1:
        errors.append(f'--tp_size={tp} --pp_size={pp}: each must be >= 1')
    elif tp * pp > 1 and hasattr(flags, 'mode'):
        try:
            parallel.grid_devices(getattr(flags, 'device', 'cuda'), tp * pp)
        except ValueError as e:
            errors.append(f'--tp_size={tp} --pp_size={pp}: {e}')
    n = getattr(flags, 'serve_dp_size', 0)
    if n > 1 and str(getattr(flags, 'device', 'cuda')).startswith('cuda'):
        import torch
        n_dev = torch.cuda.device_count()
        if n > n_dev:
            errors.append(
                f'--serve_dp_size {n} but only {n_dev} devices — a silently '
                'smaller mesh would miss real-time deadlines at the planned '
                'stream count')
    return errors


def add_train_flags(parser):
    """Register the trainer's flags (cli/baseline.py) next to the model
    flags."""
    for name, typ, default in TRAIN_FLAGS:
        kw = {}
        if name == 'mode':
            kw['choices'] = MODES
        elif name == 'optim':
            kw['choices'] = OPTIMIZERS
        parser.add_argument(f'--{name}', type=typ, default=default, **kw)
    return parser


def add_pretrain_flags(parser):
    """Register the wav2vec pretraining flags (PRETRAIN_FLAGS)."""
    for name, typ, default in PRETRAIN_FLAGS:
        parser.add_argument(f'--{name}', type=typ, default=default)
    return parser


def read_flagfile(path):
    """One flag per line; blank lines and #, // comments skipped."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    return [ln for ln in lines
            if ln and not ln.startswith('#') and not ln.startswith('//')]


def expand_argv(argv):
    """Inline every --flagfile (recursively), in place."""
    out = []
    it = iter(argv)
    for arg in it:
        if arg == '--flagfile':
            out += expand_argv(read_flagfile(next(it)))
        elif arg.startswith('--flagfile='):
            out += expand_argv(read_flagfile(arg.split('=', 1)[1]))
        else:
            out.append(arg)
    return out


def _bool_flags(parser):
    return {a.dest for a in parser._actions if a.type is parse_bool}


def normalize_argv(argv, parser):
    """absl spellings → argparse: `--flag` / `--noflag` of a bool flag
    become `--flag=true/false`; keys of the JAX registry this parser does
    not register are dropped, with their value where it is the next
    argument (`--name x`; no CLI of the port takes a positional)."""
    bools = _bool_flags(parser)
    ignore = _IGNORABLE - {a.dest for a in parser._actions}
    out = []
    args = iter(enumerate(argv))
    for i, arg in args:
        if arg.startswith('--'):
            key = arg[2:].split('=', 1)[0]
            if key in ignore or (key.startswith('no')
                                 and key[2:] in ignore):
                if '=' not in arg and i + 1 < len(argv) \
                        and not argv[i + 1].startswith('--'):
                    next(args)
                continue
            if '=' not in arg:
                if key in bools:
                    arg = f'--{key}=true'
                elif key.startswith('no') and key[2:] in bools:
                    arg = f'--{key[2:]}=false'
        out.append(arg)
    return out


def parse_flags(parser, argv):
    """argv (without the program name) → argparse Namespace.  A refused
    flag at a value that asks for work the port does not do, and a
    --dp_size, --tp_size / --pp_size or --serve_dp_size this process
    cannot honour, stop the parse (parser.error: SystemExit 2) naming the
    flag."""
    flags = parser.parse_args(normalize_argv(expand_argv(list(argv)), parser))
    refused = [f'--{name}={getattr(flags, name)} (ROADMAP.md Queue 1 item '
               f'{item})'
               for name, _, allowed, item in REFUSED
               if getattr(flags, name, allowed[0]) not in allowed]
    errors = _parallel_errors(flags)
    if refused:
        errors.insert(0, 'not ported yet, only the default is accepted: '
                      + '; '.join(refused))
    if errors:
        parser.error('; '.join(errors))
    return flags


def transducer_config_from_flags(flags, vocab_size, input_size):
    """TransducerConfig.from_flags of the JAX package."""
    return TransducerConfig(
        vocab_size=vocab_size,
        vocab_embed_size=flags.vocab_embed_size,
        input_size=input_size,
        enc_hidden_size=flags.enc_hidden_size,
        enc_layers=flags.enc_layers,
        enc_proj_size=flags.enc_proj_size,
        dec_hidden_size=flags.dec_hidden_size,
        dec_layers=flags.dec_layers,
        dec_proj_size=flags.dec_proj_size,
        joint_size=flags.joint_size,
        enc_dropout=getattr(flags, 'enc_dropout', 0.0),
        dec_dropout=getattr(flags, 'dec_dropout', 0.0),
        module_type=flags.enc_type)


def feature_config_from_flags(flags, pad_to_divisible=True):
    """FeatureConfig.from_flags of the JAX package; the SpecAugment fields
    come from the trainer's flags where the parser has them."""
    return FeatureConfig(
        feature_type=flags.feature,
        feature_size=flags.feature_size,
        n_fft=flags.n_fft,
        win_length=flags.win_length,
        hop_length=flags.hop_length,
        delta=flags.delta,
        normalize='per_feature' if flags.cmvn else 'none',
        downsample=flags.downsample,
        pad_to_divisible=pad_to_divisible,
        T_mask=getattr(flags, 'T_mask', 0),
        T_num_mask=getattr(flags, 'T_num_mask', 0),
        F_mask=getattr(flags, 'F_mask', 0),
        F_num_mask=getattr(flags, 'F_num_mask', 0),
        W_warp=getattr(flags, 'time_warp_w', 0))
