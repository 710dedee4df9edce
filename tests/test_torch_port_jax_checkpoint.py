"""The port reads what the JAX package writes, on the CPU:

  * edgedict_tpu_torch/jax_checkpoint.py against flax.serialization.to_bytes,
    payload type by payload type (arrays of every dtype the package
    writes, bf16, 0-d arrays, numpy scalars, None, str, bool, int, float,
    complex, nested lists, empty dicts, a chunked array), bit for bit;
    garbage and truncated bytes raise;
  * a JAX lm.ckpt (cli/train_lm.py's writer) gives the same LM log-probs in
    the port; a JAX pretrained.ckpt splices into the RawTrainer bit-equal
    to wav2vec_state_dict_from_jax_params;
  * the committed run directory tests/data/jax_ckpt/ (written by the JAX
    package, tests/data/make_jax_ckpt_fixture.py): cli.stream on it and
    on its import by cli.import_checkpoint gives the JAX transcript;
    cli.baseline --mode resume takes step 3 from it; rerunning the script
    reproduces the committed decode;
  * E6D2's full-width params (~200 MB) read bit-equal in well under 10 s.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from edgedict_tpu_torch import jax_checkpoint as J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'data', 'jax_ckpt')


def _expected():
    with open(os.path.join(FIXTURE, 'expected.json')) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the msgpack reader against flax
# ---------------------------------------------------------------------------

def _rng():
    return np.random.RandomState(0)


PAYLOADS = {
    'float32': lambda: _rng().randn(3, 4).astype(np.float32),
    'float64': lambda: _rng().randn(5).astype(np.float64),
    'float16': lambda: _rng().randn(2, 3).astype(np.float16),
    'int32': lambda: _rng().randint(-9, 9, (2, 2, 3)).astype(np.int32),
    'uint32': lambda: np.array([0, 1, 2 ** 32 - 1], np.uint32),
    'int8': lambda: np.array([-128, 0, 127], np.int8),
    'uint64': lambda: np.array([2 ** 63 + 5], np.uint64),
    'bool_array': lambda: np.array([True, False, True]),
    'bfloat16': lambda: jnp.asarray(_rng().randn(4, 3), jnp.bfloat16),
    'jax_float32': lambda: jnp.arange(6.0).reshape(2, 3),
    'zero_d': lambda: np.array(2.5, np.float32),
    'empty_array': lambda: np.zeros((0, 3), np.float32),
    'np_scalar': lambda: np.int32(-7),
    'np_float_scalar': lambda: np.float64(1.25),
    'none': lambda: None,
    'str': lambda: 'héllo ' * 40,
    'bool': lambda: True,
    'small_int': lambda: -3,
    'int64': lambda: -(2 ** 40),
    'uint64_int': lambda: 2 ** 63 + 1,
    'float': lambda: 0.1,
    'inf': lambda: float('inf'),
    'complex': lambda: 1.5 - 2j,
    'nested_list': lambda: [1, [2.0, 'x'], [], {'a': np.ones(2, np.int16)}],
    'empty_dict': lambda: {},
    'long_map': lambda: {f'k{i}': i for i in range(40)},
}


def _same(got, want):
    """Bit equality of a read tree against the one flax restores."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, np.ndarray) and want.dtype.name == 'bfloat16':
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.uint16).numpy(),
                              want.view(np.uint16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert np.shape(got) == np.shape(want)
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize('kind', sorted(PAYLOADS))
def test_reader_matches_flax(kind):
    tree = {'x': PAYLOADS[kind](), 'y': {'z': PAYLOADS[kind]()}}
    data = serialization.to_bytes(tree)
    _same(J.msgpack_restore(data), serialization.msgpack_restore(data))
    _same(J.msgpack_restore(bytearray(data)),
          serialization.msgpack_restore(data))


def test_reader_joins_chunked_arrays(monkeypatch):
    """Arrays over flax's MAX_CHUNK_SIZE are written as
    __msgpack_chunked_array__ maps of flat chunks."""
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    big = _rng().randn(7, 9).astype(np.float32)        # 252 bytes: 4 chunks
    bf = jnp.asarray(_rng().randn(50), jnp.bfloat16)   # 100 bytes: 2 chunks
    data = serialization.to_bytes({'big': big, 'bf': bf, 'small': big[0]})
    raw = J._Reader(data).value()
    assert raw['big']['__msgpack_chunked_array__'] is True
    assert len(raw['big']['chunks']) == 4
    got = J.msgpack_restore(data)
    assert np.array_equal(got['big'], big) and got['big'].shape == (7, 9)
    assert np.array_equal(got['small'], big[0])
    assert np.array_equal(got['bf'].view(torch.uint16).numpy(),
                          np.asarray(bf).view(np.uint16))


def test_unstate_restores_lists():
    tree = {'layers': [{'w': np.ones(2)}, {'w': np.zeros(2)}], 'e': {}}
    raw = J.msgpack_restore(serialization.to_bytes(tree))
    assert set(raw['layers']) == {'0', '1'}
    back = J.unstate(raw)
    assert isinstance(back['layers'], list) and back['e'] == {}
    assert np.array_equal(back['layers'][1]['w'], np.zeros(2))


def _bad_dtype():
    inner = serialization.msgpack.packb(((2,), 'float128x', b'\0' * 32),
                                        use_bin_type=True)
    return b'\x81\xa1a\xc7' + bytes([len(inner)]) + b'\x01' + inner


BAD = {
    'garbage': lambda good: b'\xc1\x00\x01',
    'truncated_map': lambda good: good[:len(good) // 2],
    'truncated_header': lambda good: good[:1],
    'truncated_array_bytes': lambda good: good[:-3],
    'trailing_bytes': lambda good: good + b'\x00',
    'unknown_ext': lambda good: b'\x81\xa1a\xd4\x09\x00',
    'unknown_dtype': lambda good: _bad_dtype(),
    'short_buffer': lambda good: good.replace(b'float32', b'float64'),
    'empty': lambda good: b'',
}


@pytest.mark.parametrize('case', sorted(BAD))
def test_reader_rejects_bad_bytes(case):
    good = serialization.to_bytes({'a': np.arange(4, dtype=np.float32)})
    with pytest.raises(ValueError):
        J.msgpack_restore(BAD[case](good))


def test_is_jax_checkpoint_sniffs_the_format(tmp_path):
    flax_file = tmp_path / 'a.ckpt'
    flax_file.write_bytes(serialization.to_bytes(
        {'step': 1, 'model': {'w': np.ones(2)}}))
    zip_file = tmp_path / 'b.ckpt'
    torch.save({'step': 1}, zip_file)
    legacy = tmp_path / 'c.pt'
    torch.save({'step': 1}, legacy, _use_new_zipfile_serialization=False)
    assert J.is_jax_checkpoint(flax_file)
    assert not J.is_jax_checkpoint(zip_file)
    assert not J.is_jax_checkpoint(legacy)
    assert J.is_jax_checkpoint(os.path.join(FIXTURE, 'run', 'models',
                                            '2.ckpt'))


def test_fixture_checkpoint_payload():
    payload = J.load_jax_checkpoint(os.path.join(FIXTURE, 'run', 'models',
                                                 '2.ckpt'))
    assert payload['step'] == 2 and payload['extra']['best_wer'] == np.inf
    assert isinstance(payload['model']['encoder']['layers'], list)
    assert set(payload['optim']) >= {'count', 'hyperparams', 'inner_state'}
    assert payload['sched'] == {'best': np.inf, 'bad_evals': 0, 'scale': 1.0}


# ---------------------------------------------------------------------------
# lm.ckpt and pretrained.ckpt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('tie', [False, True])
def test_jax_lm_ckpt_gives_the_same_log_probs(tmp_path, tie):
    from edgedict_tpu.checkpoint import save_checkpoint
    from edgedict_tpu.models import lm as JL
    from edgedict_tpu_torch.models import lm as PL
    cfg = JL.LMConfig(vocab_size=13, embed_size=8, hidden_size=8,
                      num_layers=2, tie_weights=tie)
    params = JL.lm_init(jax.random.PRNGKey(1), cfg)
    logdir = str(tmp_path / 'lm')
    save_checkpoint(logdir, 5, params, extra={'lm_cfg': cfg.__dict__})
    shutil.copy(os.path.join(logdir, 'models', '5.ckpt'),
                os.path.join(logdir, 'lm.ckpt'))
    model, pcfg = PL.load_lm_checkpoint(os.path.join(logdir, 'lm.ckpt'))
    assert pcfg.__dict__ == cfg.__dict__
    ys = np.random.RandomState(2).randint(0, 13, (3, 7)).astype(np.int32)
    want, _ = JL.lm_apply(params, cfg, jnp.asarray(ys))
    with torch.no_grad():
        got, _ = PL.lm_apply(model, pcfg, torch.from_numpy(ys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_jax_pretrained_ckpt_splices_into_the_raw_trainer(tmp_path):
    from edgedict_tpu.checkpoint import save_checkpoint
    from edgedict_tpu.models import wav2vec as JW
    from edgedict_tpu_torch.cli import train as cli_train
    from edgedict_tpu_torch.compat import wav2vec_state_dict_from_jax_params
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.raw_trainer import RawTrainer

    from test_torch_port_train import _cli_args, _write_corpus
    corpus = _write_corpus(str(tmp_path / 'libri'), n=4)
    args = _cli_args(corpus, str(tmp_path / 'logs'), 'w2v')
    trainer = RawTrainer(parse_flags(cli_train.build_parser(), args))
    jcfg = JW.Wav2VecConfig(input_size=128, enc_hidden_size=16,
                            enc_layers=2, enc_proj_size=16, final_dim=8,
                            latent_vars=8)
    params = JW.wav2vec_init(jax.random.PRNGKey(4), jcfg)
    path = save_checkpoint(trainer.logdir, 7, params,
                           extra={'accuracy': 0.5})
    pretrained = os.path.join(trainer.logdir, 'pretrained.ckpt')
    shutil.copy(path, pretrained)
    before = trainer.state.model.state_dict()
    copied = trainer.load_pretrained(pretrained)
    want = wav2vec_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params))
    sd = trainer.state.model.state_dict()
    spliced = [k for k in want if k.split('.')[0] in ('frontend', 'encoder')
               and k in sd]
    assert sorted(copied) == sorted(spliced) and len(spliced) > 10
    for k, v in sd.items():
        assert torch.equal(v, want[k] if k in spliced else before[k]), k
    assert int(trainer.state.opt_state['count']) == 0


# ---------------------------------------------------------------------------
# the committed JAX run directory through the port's CLIs
# ---------------------------------------------------------------------------

def _stream(argv, capsys):
    from edgedict_tpu_torch.cli import stream
    capsys.readouterr()
    stream.main(argv)
    return capsys.readouterr().out.splitlines()


def test_cli_stream_reads_the_jax_run(capsys):
    want = _expected()
    out = _stream(['--flagfile', os.path.join(FIXTURE, 'run',
                                              'flagfile.txt'),
                   '--logdir_root', FIXTURE, '--name', 'run', '--path',
                   os.path.join(FIXTURE, 'utt.wav'), '--device', 'cpu',
                   '--infer_dtype', 'fp32'], capsys)
    assert out[0] == f'loaded {FIXTURE}/run/models/2.ckpt'
    assert out[1] == want['text'] and want['text']


def test_stream_decoder_frame_tokens_equal_jax(capsys):
    """The port's decoder built as cli.stream builds it emits the JAX
    package's token at every frame."""
    from edgedict_tpu_torch.cli import stream
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.data.audio_io import load_audio
    flags = parse_flags(stream.build_parser('s'), [
        '--flagfile', os.path.join(FIXTURE, 'run', 'flagfile.txt'),
        '--logdir_root', FIXTURE, '--device', 'cpu', '--infer_dtype',
        'fp32'])
    flags.block_chunks = 1                  # cli.stream main's own flag
    decoder = stream.build_stream_decoder(flags)
    audio, _ = load_audio(os.path.join(FIXTURE, 'utt.wav'))
    text = decoder.decode_wav(audio)
    frames = [int(t) for chunk in decoder.emitted for t in chunk]
    assert frames == _expected()['frame_tokens'] and text == \
        _expected()['text']


def test_import_checkpoint_then_stream_by_name(tmp_path, capsys):
    from edgedict_tpu_torch.checkpoint import load_checkpoint
    from edgedict_tpu_torch.cli import import_checkpoint
    logs = str(tmp_path / 'logs')
    shutil.copytree(os.path.join(FIXTURE, 'char'), os.path.join(logs, 'char'))
    flagfile = os.path.join(FIXTURE, 'run', 'flagfile.txt')
    path = import_checkpoint.main([
        '--flagfile', flagfile, '--logdir_root', logs, '--name', 'imported',
        '--pt_path', os.path.join(FIXTURE, 'run', 'models', '2.ckpt'),
        '--out_step', '5'], log_fn=lambda *_: 0)
    assert path == os.path.join(logs, 'imported', 'models', '5.ckpt')
    payload = load_checkpoint(path)
    assert payload['optim'] is None and payload['step'] == 5
    out = _stream(['--flagfile', flagfile, '--logdir_root', logs, '--name',
                   'imported', '--path', os.path.join(FIXTURE, 'utt.wav'),
                   '--device', 'cpu', '--infer_dtype', 'fp32'], capsys)
    assert out[0] == f'loaded {path}' and out[1] == _expected()['text']


def test_import_checkpoint_refuses_a_mismatched_model(tmp_path):
    from edgedict_tpu_torch.cli import import_checkpoint
    logs = str(tmp_path / 'logs')
    shutil.copytree(os.path.join(FIXTURE, 'char'), os.path.join(logs, 'char'))
    with pytest.raises(RuntimeError, match='size mismatch|Missing|Unexpected'):
        import_checkpoint.main([
            '--flagfile', os.path.join(FIXTURE, 'run', 'flagfile.txt'),
            '--logdir_root', logs, '--enc_hidden_size', '32',
            '--pt_path', os.path.join(FIXTURE, 'run', 'models', '2.ckpt')],
            log_fn=lambda *_: 0)


def _fixture_corpus(root):
    """12 seeded utterances of the fixture's texts: three batches of 4, so
    the run's one epoch ends at step 3."""
    from edgedict_tpu_torch.data.audio_io import save_wav
    texts = ['HELLO WORLD', 'THE CAT SAT', 'A B C D', 'SPEECH TEST']
    rng = np.random.RandomState(3)
    d = os.path.join(root, '1', '2')
    os.makedirs(d, exist_ok=True)
    lines = []
    for i in range(12):
        name = f'1-2-{i:04d}'
        save_wav(os.path.join(d, name + '.wav'),
                 0.3 * np.sin(np.arange(16000) * (0.05 + 0.01 * i))
                 + 0.05 * rng.randn(16000), 16000)
        lines.append(f'{name} {texts[i % len(texts)]}')
    with open(os.path.join(d, '1-2.trans.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return root


def test_cli_baseline_resumes_the_jax_run(tmp_path):
    """cli.baseline --mode resume on a copy of the JAX run: the port loads
    its params, Adam state, step and plateau state, takes step 3 with a
    finite loss and the optimizer count at 3, and writes 3.ckpt."""
    from edgedict_tpu_torch.checkpoint import load_checkpoint
    logs = str(tmp_path / 'logs')
    shutil.copytree(FIXTURE, logs, ignore=shutil.ignore_patterns('*.wav',
                                                                 '*.json'))
    corpus = _fixture_corpus(str(tmp_path / 'libri'))
    from edgedict_tpu_torch.cli import baseline
    lines = []
    trainer = baseline.main([
        '--flagfile', os.path.join(logs, 'run', 'flagfile.txt'),
        '--logdir_root', logs, '--LibriSpeech_train_100', corpus,
        '--mode', 'resume', '--loss_step', '1', '--device', 'cpu'],
        log_fn=lines.append)
    assert 'resumed from step 2' in lines
    assert any(ln.startswith('JAX checkpoint: its augmentation rng')
               for ln in lines)
    steps = [ln for ln in lines if ln.startswith('step ')]
    assert len(steps) == 1 and steps[0].startswith('step 3/3 loss ')
    assert np.isfinite(float(steps[0].split()[3]))
    assert trainer.state.step == 3
    assert int(trainer.state.opt_state['count']) == 3
    assert trainer.sched.state_dict() == {'best': float('inf'),
                                          'bad_evals': 0, 'scale': 1.0}
    payload = load_checkpoint(os.path.join(logs, 'run', 'models', '3.ckpt'))
    assert payload['step'] == 3 and int(payload['optim']['count']) == 3


# ---------------------------------------------------------------------------
# full width, and the fixture's own script
# ---------------------------------------------------------------------------

def test_e6d2_full_width_params_read_bit_equal_and_fast(tmp_path):
    from edgedict_tpu.checkpoint import save_checkpoint
    from edgedict_tpu.config import FLAGS as JFLAGS  # noqa: F401
    from edgedict_tpu.models import transducer as JT
    from edgedict_tpu_torch.compat import (
        load_model_state, state_dict_from_jax_params)
    cfg = JT.TransducerConfig(
        vocab_size=2048, vocab_embed_size=64, input_size=240,
        enc_hidden_size=1024, enc_layers=6, enc_proj_size=640,
        dec_hidden_size=256, dec_layers=2, dec_proj_size=256,
        joint_size=640)
    params = jax.tree.map(np.asarray,
                          JT.transducer_init(jax.random.PRNGKey(0), cfg))
    path = save_checkpoint(str(tmp_path), 1, params)
    assert os.path.getsize(path) > 190e6
    t0 = time.perf_counter()
    got = load_model_state(path)
    seconds = time.perf_counter() - t0
    want = state_dict_from_jax_params(params)
    del params
    assert set(got) == set(want) and len(want) == 55
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    assert seconds < 10.0, seconds


def test_fixture_script_reproduces_the_committed_decode(tmp_path):
    out = str(tmp_path / 'jax_ckpt')
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([sys.executable, os.path.join(
        REPO, 'tests', 'data', 'make_jax_ckpt_fixture.py'), '--out', out],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(out, 'expected.json')) as f:
        assert json.load(f) == _expected()
    for name in ('utt.wav', os.path.join('char', 'token2id.pkl')):
        with open(os.path.join(out, name), 'rb') as a, \
                open(os.path.join(FIXTURE, name), 'rb') as b:
            assert a.read() == b.read(), name
