"""Flagfile-driven configuration (counterpart of edgedict_tpu/config.py),
on argparse.

Reads the reference's flagfile presets (flagfiles/E6D2.txt, ...) in the
absl syntax they use: one flag per line, `--k=v`, `--flag`, `--noflag`,
nested `--flagfile=path`, blank lines and `#` / `//` comments.  The flags
each entry point reads are registered with the JAX package's defaults:
`add_model_flags` for the model, features and tokenizer (every CLI),
`add_train_flags` for the trainer (cli/baseline.py).  The other keys of the
JAX registry that a preset or a run snapshot carries (`--apex`,
`--opt_level`, the trainer's keys in a serving CLI, ...) are accepted and
ignored.  Any other key is an error, as with absl.
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
    ('sample_size', int, 20),
    ('bf16', parse_bool, True),
    ('audio_bucket_frames', int, 128),
    ('label_bucket', int, 16),
)
MODES = ('train', 'resume', 'eval', 'device_rate')
OPTIMIZERS = ('adam', 'adamw', 'sgd', 'sm3', 'novograd')

# flags of edgedict_tpu/config.py that no entry point of the port reads
UNREAD = frozenset((
    'LibriSpeech_dev', 'TEDLIUM_test', 'device_corpus', 'use_pretrained',
    'apex', 'opt_level', 'multi_gpu', 'eval_beam_width', 'dp_size',
    'tp_size', 'pp_size', 'profile_dir', 'compilation_cache_dir'))
# keys a flagfile may carry that a parser may leave unregistered
_IGNORABLE = UNREAD | {name for name, _, _ in TRAIN_FLAGS}


def add_model_flags(parser):
    """Register --flagfile and the model/feature/tokenizer flags."""
    parser.add_argument('--flagfile', action='append', default=[],
                        help='read flags from this file (absl syntax)')
    for name, typ, default in MODEL_FLAGS:
        parser.add_argument(f'--{name}', type=typ, default=default)
    return parser


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
    not register are dropped."""
    bools = _bool_flags(parser)
    ignore = _IGNORABLE - {a.dest for a in parser._actions}
    out = []
    for arg in argv:
        if arg.startswith('--'):
            key = arg[2:].split('=', 1)[0]
            if key in ignore or (key.startswith('no')
                                 and key[2:] in ignore):
                continue
            if '=' not in arg:
                if key in bools:
                    arg = f'--{key}=true'
                elif key.startswith('no') and key[2:] in bools:
                    arg = f'--{key[2:]}=false'
        out.append(arg)
    return out


def parse_flags(parser, argv):
    """argv (without the program name) → argparse Namespace."""
    return parser.parse_args(normalize_argv(expand_argv(list(argv)), parser))


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
