"""Flagfile-driven configuration (counterpart of edgedict_tpu/config.py),
on argparse.

Reads the reference's flagfile presets (flagfiles/E6D2.txt, ...) in the
absl syntax they use: one flag per line, `--k=v`, `--flag`, `--noflag`,
nested `--flagfile=path`, blank lines and `#` / `//` comments.  The flags
the serving slice reads are registered with the JAX package's defaults;
the other keys of the JAX registry that a preset or a run snapshot
carries (`--lr`, `--apex`, `--opt_level`, `--name`, ...) are accepted and
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

# flags of edgedict_tpu/config.py the serving slice does not read
UNREAD = frozenset((
    'name', 'enc_dropout', 'dec_dropout', 'mode', 'resume_step',
    'LibriSpeech_train_100', 'LibriSpeech_train_360',
    'LibriSpeech_train_500', 'LibriSpeech_test', 'LibriSpeech_dev',
    'TEDLIUM_train', 'TEDLIUM_test', 'CommonVoice', 'YT_bloomberg2',
    'YT_life', 'num_workers', 'cache_audio', 'device_corpus',
    'use_pretrained', 'optim', 'lr', 'sched', 'sched_patience',
    'sched_factor', 'sched_min_lr', 'warmup_step', 'epochs', 'batch_size',
    'sub_batch_size', 'eval_batch_size', 'gradclip', 'audio_max_length',
    'T_mask', 'T_num_mask', 'F_mask', 'F_num_mask', 'apex', 'opt_level',
    'multi_gpu', 'loss_step', 'save_step', 'keep_checkpoints', 'eval_step',
    'sample_size', 'eval_beam_width', 'dp_size', 'tp_size', 'pp_size',
    'bf16', 'audio_bucket_frames', 'label_bucket', 'time_warp_w',
    'profile_dir', 'compilation_cache_dir'))


def add_model_flags(parser):
    """Register --flagfile and the model/feature/tokenizer flags."""
    parser.add_argument('--flagfile', action='append', default=[],
                        help='read flags from this file (absl syntax)')
    for name, typ, default in MODEL_FLAGS:
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
    become `--flag=true/false`; unread keys are dropped."""
    bools = _bool_flags(parser)
    out = []
    for arg in argv:
        if arg.startswith('--'):
            key = arg[2:].split('=', 1)[0]
            if key in UNREAD or (key.startswith('no')
                                 and key[2:] in UNREAD):
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
        module_type=flags.enc_type)


def feature_config_from_flags(flags, pad_to_divisible=True):
    """FeatureConfig.from_flags of the JAX package, inference fields."""
    return FeatureConfig(
        feature_type=flags.feature,
        feature_size=flags.feature_size,
        n_fft=flags.n_fft,
        win_length=flags.win_length,
        hop_length=flags.hop_length,
        delta=flags.delta,
        normalize='per_feature' if flags.cmvn else 'none',
        downsample=flags.downsample,
        pad_to_divisible=pad_to_divisible)
