"""The port's flag parsing: nothing is refused as not ported any more
(edgedict_tpu_torch/config.py REFUSED is empty).  --tp_size / --pp_size
stop a trainer's parse over --device cuda when fewer cards are visible
than the grid needs, naming the count, and the stream and serve parsers
take and ignore them.  --dp_size parses at -1 and the process group's
world size and otherwise names the launcher (cli.distributed) or the
world size;
--serve_dp_size N stops the parse when --device cuda has fewer than N
cards.  The defaults, the flags the JAX package itself ignores and
the three preset flagfiles still parse; --eval_beam_width,
--use_pretrained, --device_corpus and --profile_dir, ported, are
accepted, and the wav2vec pretraining flags parse with the JAX package's
defaults."""

import os

import pytest
import torch

from edgedict_tpu_torch import config as C
from edgedict_tpu_torch.cli import baseline, pretrain_wav2vec, stream
from edgedict_tpu_torch.cli import train as cli_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ['E6D2.txt', 'E4D1.txt', 'E6D2_LARGE_Batch.txt']


def _serve_parser():
    # cli/serve.py's parser: cli/stream.py's plus the server's own flags
    parser = stream.build_parser('serve')
    parser.add_argument('--n_streams', type=int, default=64)
    return parser


PARSERS = {'baseline': baseline.build_parser,
           'stream': lambda: stream.build_parser('stream'),
           'serve': _serve_parser}


@pytest.mark.parametrize('arg,name,item', [
    ('--dp_size=2', 'dp_size', 'python -m edgedict_tpu_torch.cli.'
                               'distributed under torchrun'),
    ('--tp_size=2', 'tp_size', '2 cards needed from cuda:0 (tp_size × '
                               'pp_size) but 1 visible'),
    ('--pp_size=4', 'pp_size', '4 cards needed from cuda:0 (tp_size × '
                               'pp_size) but 1 visible'),
])
@pytest.mark.parametrize('cli', sorted(PARSERS))
def test_refused_flag_stops_the_parse(capsys, monkeypatch, cli, arg, name,
                                      item):
    """Outside a process group --dp_size 2 names the launcher.  --tp_size
    and --pp_size split a trainer's model over a grid of cards: on a
    machine with one visible card the trainer's parse (--device cuda)
    stops, naming the count; the stream and serve parsers take both and
    ignore them, as the JAX package's serving does."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    argv = [f'--flagfile={REPO}/flagfiles/E6D2.txt', arg]
    if name != 'dp_size' and cli != 'baseline':
        flags = C.parse_flags(PARSERS[cli](), argv)
        assert getattr(flags, name) == int(arg.split('=')[1])
        return
    with pytest.raises(SystemExit) as exc:
        C.parse_flags(PARSERS[cli](), argv)
    assert exc.value.code == 2
    err = ' '.join(capsys.readouterr().err.split())
    assert f'--{name}=' in err and item in err


def test_every_refused_flag_is_named_at_once(capsys):
    """The command line ROADMAP.md's Queue 3 fault gave: it parsed and
    trained greedy-only on one device from a random init.  Now --dp_size
    names its launcher and the tp × pp grid its card count in one error;
    nothing is refused as not ported (REFUSED is empty)."""
    with pytest.raises(SystemExit):
        C.parse_flags(baseline.build_parser(), [
            '--flagfile', f'{REPO}/flagfiles/E6D2.txt',
            '--tp_size=2', '--profile_dir=traces', '--device_corpus',
            '--pp_size=2', '--dp_size=4'])
    err = capsys.readouterr().err
    for name in ('tp_size', 'pp_size', 'dp_size'):
        assert f'--{name}=' in err
    assert '4 cards needed' in err and 'not ported' not in err
    for name in ('profile_dir', 'device_corpus'):     # ported: not refused
        assert f'--{name}=' not in err
    assert C.REFUSED == ()


@pytest.mark.parametrize('arg,name,value', [
    ('--device_corpus', 'device_corpus', True),
    ('--device_corpus=true', 'device_corpus', True),
    ('--profile_dir=traces', 'profile_dir', 'traces'),
])
@pytest.mark.parametrize('cli', sorted(PARSERS))
def test_trainer_feature_flags_parse(cli, arg, name, value):
    """--device_corpus and --profile_dir are ported (trainer.py): every
    parser takes them, as the JAX registry defines them for every entry
    point, and only the trainers act on them."""
    flags = C.parse_flags(PARSERS[cli](), [
        f'--flagfile={REPO}/flagfiles/E6D2.txt', arg])
    assert getattr(flags, name) == value


def test_a_jax_flag_snapshot_parses():
    """The JAX package's logs/<name>/flagfile.txt (its FLAGS written whole,
    absl's own and chex's flags included) parses under the trainer's and
    the stream parsers."""
    snapshot = os.path.join(REPO, 'tests', 'data', 'jax_ckpt', 'run',
                            'flagfile.txt')
    for build in PARSERS.values():
        flags = C.parse_flags(build(), [f'--flagfile={snapshot}'])
        assert flags.enc_hidden_size == 16 and flags.device_corpus is False


@pytest.mark.parametrize('spelling', ['--use_pretrained=true',
                                      '--use_pretrained'])
@pytest.mark.parametrize('cli', sorted(PARSERS))
def test_use_pretrained_is_accepted(cli, spelling):
    """--use_pretrained is ported (cli/train.py splices the wav2vec
    FrontEnd and encoder): every parser takes it, as the JAX registry
    defines it for every entry point, and only cli.train acts on it."""
    flags = C.parse_flags(PARSERS[cli](), [
        f'--flagfile={REPO}/flagfiles/E6D2.txt', spelling])
    assert flags.use_pretrained is True


def test_pretrain_flags_parse_with_the_jax_defaults():
    """cli.pretrain_wav2vec and cli.train register the pretraining flags
    with the names and defaults of edgedict_tpu/pretrain_config.py; the
    other parsers ignore them in a flagfile (a run's snapshot)."""
    from edgedict_tpu.pretrain_config import FLAGS as JFLAGS
    want = {name: JFLAGS[name].default for name, _, _ in C.PRETRAIN_FLAGS}
    assert len(want) == 17
    for build in (pretrain_wav2vec.build_parser, cli_train.build_parser):
        flags = C.parse_flags(build(), [
            f'--flagfile={REPO}/flagfiles/E6D2.txt'])
        assert {k: getattr(flags, k) for k in want} == want
        flags = C.parse_flags(build(), ['--mask_prob=0.3', '--final_dim',
                                        '64', '--temp_decay=0.9'])
        assert (flags.mask_prob, flags.final_dim, flags.temp_decay) == \
            (0.3, 64, 0.9)
    flags = C.parse_flags(baseline.build_parser(), [
        f'--flagfile={REPO}/flagfiles/E6D2.txt', '--mask_prob=0.3'])
    assert not hasattr(flags, 'mask_prob')


@pytest.mark.parametrize('cli', sorted(PARSERS))
def test_eval_beam_width_is_accepted(tmp_path, cli):
    """--eval_beam_width is a trainer flag now (beam search is ported):
    the trainer's parser takes it, and a flagfile that carries it (a run's
    snapshot) still parses under the stream and serve parsers, which
    ignore it as they ignore the trainer's other flags."""
    flagfile = tmp_path / 'run.txt'
    flagfile.write_text(f'--flagfile={REPO}/flagfiles/E6D2.txt\n'
                        '--eval_beam_width=4\n')
    flags = C.parse_flags(PARSERS[cli](), [f'--flagfile={flagfile}'])
    if cli == 'baseline':
        assert flags.eval_beam_width == 4
    else:
        assert not hasattr(flags, 'eval_beam_width')
        assert flags.enc_layers == 6


@pytest.mark.parametrize('preset', PRESETS)
@pytest.mark.parametrize('cli', sorted(PARSERS))
def test_presets_defaults_and_ignored_flags_parse(cli, preset):
    flags = C.parse_flags(PARSERS[cli](), [
        f'--flagfile={REPO}/flagfiles/{preset}',
        # the refused flags at their defaults, in each spelling
        '--eval_beam_width=0', '--nodevice_corpus', '--use_pretrained=false',
        '--dp_size=-1', '--dp_size=1', '--tp_size=1', '--pp_size=1',
        '--profile_dir=',
        # accepted and ignored, as by the JAX package
        '--apex', '--noapex', '--opt_level=O2', '--multi_gpu',
        '--LibriSpeech_dev=dev', '--TEDLIUM_test=test',
        '--compilation_cache_dir=cache'])
    assert (flags.device_corpus, flags.use_pretrained, flags.dp_size,
            flags.tp_size, flags.pp_size) == (False, False, 1, 1, 1)
    # a trainer flag: only the trainer's parser keeps it
    assert getattr(flags, 'eval_beam_width', 0) == 0
    assert hasattr(flags, 'eval_beam_width') == (cli == 'baseline')
    assert flags.profile_dir == ''
    assert not hasattr(flags, 'apex') and not hasattr(flags, 'opt_level')
    assert flags.enc_layers in (4, 6) and flags.tokenizer == 'bpe'


def test_an_ignored_flag_takes_its_value_along():
    """A JAX registry key that a CLI does not register is dropped with its
    value, in either spelling (`--name x`, `--name=x`), bare bools too."""
    from edgedict_tpu_torch.cli import wer_parity
    for argv in (['--name', 'tiny', '--sched', '--lr', '3e-4'],
                 ['--name=tiny', '--nosched', '--lr=3e-4']):
        flags = C.parse_flags(wer_parity.build_parser(),
                              argv + ['--pt_path', 'x.pt', '--enc_layers',
                                      '3'])
        assert (flags.pt_path, flags.enc_layers) == ('x.pt', 3)
        assert not hasattr(flags, 'name') and not hasattr(flags, 'lr')


@pytest.mark.parametrize('value', ['0', '1'])
@pytest.mark.parametrize('cli', ['stream', 'serve'])
def test_serve_dp_size_asking_for_one_device_parses(cli, value):
    """--serve_dp_size (root cli/serve.py:41, default 0) is registered by
    the stream / serve parser: 0 and 1 ask for one device and parse."""
    for argv in ([f'--serve_dp_size={value}'], ['--serve_dp_size', value]):
        flags = C.parse_flags(PARSERS[cli](), [
            f'--flagfile={REPO}/flagfiles/E6D2.txt', *argv])
        assert flags.serve_dp_size == int(value)
    flags = C.parse_flags(PARSERS[cli](), [
        f'--flagfile={REPO}/flagfiles/E6D2.txt'])
    assert flags.serve_dp_size == 0


@pytest.mark.parametrize('value', ['2', '8'])
@pytest.mark.parametrize('cli', ['stream', 'serve'])
def test_serve_dp_size_over_one_is_refused(capsys, monkeypatch, cli, value):
    """--serve_dp_size N over --device cuda asks for N cards: with fewer
    visible the parse stops with the JAX server's reason (root
    cli/serve.py:58-67); with N CPU replicas, or N cards, it parses."""
    import torch
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(SystemExit) as exc:
        C.parse_flags(PARSERS[cli](), [
            f'--flagfile={REPO}/flagfiles/E6D2.txt', '--serve_dp_size',
            value])
    assert exc.value.code == 2
    err = ' '.join(capsys.readouterr().err.split())
    assert f'--serve_dp_size {value} but only 1 devices' in err
    assert 'real-time deadlines' in err
    flags = C.parse_flags(PARSERS[cli](), [
        f'--flagfile={REPO}/flagfiles/E6D2.txt', '--serve_dp_size', value,
        '--device', 'cpu'])
    assert flags.serve_dp_size == int(value)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 8)
    flags = C.parse_flags(PARSERS[cli](), [
        f'--flagfile={REPO}/flagfiles/E6D2.txt', '--serve_dp_size', value])
    assert flags.serve_dp_size == int(value)


@pytest.mark.parametrize('dp_size,ok', [(-1, True), (2, True), (1, False),
                                        (4, False)])
def test_dp_size_follows_the_process_group(capsys, monkeypatch, dp_size,
                                           ok):
    """Inside a process group of world size 2, --dp_size -1 and 2 parse;
    any other value names the world size."""
    from edgedict_tpu_torch import train
    monkeypatch.setattr(train, 'world', lambda: (0, 2))
    argv = [f'--flagfile={REPO}/flagfiles/E6D2.txt', f'--dp_size={dp_size}']
    for build in (baseline.build_parser, cli_train.build_parser,
                  pretrain_wav2vec.build_parser):
        if ok:
            assert C.parse_flags(build(), argv).dp_size == dp_size
            continue
        with pytest.raises(SystemExit) as exc:
            C.parse_flags(build(), argv)
        assert exc.value.code == 2
        err = ' '.join(capsys.readouterr().err.split())
        assert f'--dp_size={dp_size} but the process group has world ' \
            'size 2' in err
