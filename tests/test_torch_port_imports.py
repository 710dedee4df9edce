"""The port runs without JAX and without the JAX package: no JAX-family
and no edgedict_tpu import anywhere in edgedict_tpu_torch/ or
chip_smoke.py, and neither appears in sys.modules when the port is
imported, nor do the audio packages of the apps (sounddevice, PyAV,
yt-dlp), which only the modes that use them import.  The port's own copies of the JAX package's JAX-free modules
(tokenizer, serving) agree with them.  Without a card, every CUDA entry
point fails loudly."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {'jax', 'jaxlib', 'flax', 'optax', 'absl', 'msgpack'}
ALLOWED_REFERENCE = set()      # nothing of the JAX package
AUDIO_IO = {'sounddevice', 'av', 'yt_dlp', 'youtube_dl'}


def _port_files():
    out = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(os.path.join(REPO, 'edgedict_tpu_torch')):
        out += [os.path.join(root, f) for f in files if f.endswith('.py')]
    return out


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for a in node.names:
                yield f'{node.module}.{a.name}'


def test_no_jax_family_import_in_the_port():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            assert name.split('.')[0] not in BANNED, (path, name)
            if name.split('.')[0] == 'edgedict_tpu':
                assert any(name == m or name.startswith(m + '.')
                           for m in ALLOWED_REFERENCE), (path, name)


def test_importing_the_port_adds_no_jax_module():
    modules = ['edgedict_tpu_torch.' + m for m in (
        '_build', '_native', 'config', 'features', 'compat', 'stream',
        'tokenizer', 'serving', 'metrics', 'data', 'data.audio_io',
        'data.dataset', 'data.collate', 'text', 'data.segment',
        'data.perturb', 'data.manifest', 'data.nvidia_features', 'utils',
        'ops.layers', 'ops.rnn', 'ops.rnn_kernel', 'ops.gru_kernel',
        'ops.quant', 'ops.features_kernel',
        'ops.decode_kernel', 'ops.rnnt_loss', 'ops.rnnt_loss_kernel',
        'ops.joint_lse_kernel', 'ops.image_warp', 'models.transducer',
        'models.decoding', 'models.ctc', 'models.legacy',
        'models.lm', 'models.beam_search', 'cli.train_lm',
        'models.wav2vec', 'pretrainer', 'raw_trainer', 'cli.train',
        'cli.pretrain_wav2vec',
        'optim', 'train', 'checkpoint', 'jax_checkpoint', 'trainer',
        'cli.stream', 'cli.serve', 'cli.import_checkpoint',
        'cli.baseline', 'cli.profile_stream', 'cli.profile_train',
        'export', 'cli.export', 'cli.demo', 'cli.youtube_live',
        'cli.wav_inference', 'cli.wer_parity',
        'scripts.synthetic_convergence')]
    # the apps' audio packages are imported only in the modes that need
    # them (--mic, youtube_live --url)
    banned = sorted(BANNED | {'edgedict_tpu'} | AUDIO_IO)
    code = ('import importlib, sys\n'
            'fam = lambda: {m for m in sys.modules if m.split(".")[0] in '
            f'{banned!r}}}\n'
            'before = fam()\n'
            f'for m in {modules!r}: importlib.import_module(m)\n'
            'print(sorted(fam() - before))\n')
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == '[]'


def test_cuda_entry_points_fail_loudly_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    from edgedict_tpu_torch.features import FeatureConfig
    from edgedict_tpu_torch.models.transducer import (
        Transducer, TransducerConfig)
    from edgedict_tpu_torch.stream import StreamingDecoder
    cfg = TransducerConfig(vocab_size=8, input_size=6, enc_hidden_size=4,
                           enc_layers=1, enc_proj_size=4, dec_hidden_size=4,
                           dec_layers=1, dec_proj_size=4, joint_size=4)
    feat = FeatureConfig(feature_size=2, n_fft=32, win_length=20,
                         hop_length=10, downsample=3, pad_to_divisible=False)
    with pytest.raises(RuntimeError, match='is_available'):
        StreamingDecoder(Transducer(cfg, 'cpu'), cfg, feat, None,
                         device='cuda')
    # chip_smoke.py: non-zero exit and no verdict, in the repo and alone
    alone = tmp_path / 'alone'
    alone.mkdir()
    (alone / 'chip_smoke.py').write_bytes(
        open(os.path.join(REPO, 'chip_smoke.py'), 'rb').read())
    for cwd, script in ((REPO, 'chip_smoke.py'), (str(alone),
                                                  'chip_smoke.py')):
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


# ---------------------------------------------------------------------------
# the port's copies of the JAX package's JAX-free modules agree with them
# ---------------------------------------------------------------------------

_TEXTS = ['the quick brown fox jumps over the lazy dog',
          'a stream of speech becomes a stream of words',
          "it's punctuation, isn't it? yes: it is!",
          'quick quick brown brown fox fox words words stream']


@pytest.mark.parametrize('kind', ['bpe', 'char'])
def test_port_tokenizer_ids_equal_the_jax_package(tmp_path, kind):
    """A vocab built by the JAX package loads in the port with the same
    ids for encode, decode and id_to_token; a vocab the port builds from
    the same texts is the same vocab (for BPE: the CharBPE trainer, since
    the HF trainer, when installed, orders ties differently run to run)."""
    from edgedict_tpu import tokenizer as JTok
    from edgedict_tpu_torch import tokenizer as PTok
    if kind == 'bpe':
        mk = [lambda d, m=m: m.HuggingFaceTokenizer(cache_dir=str(d),
                                                    vocab_size=60)
              for m in (JTok, PTok)]
    else:
        mk = [lambda d, m=m: m.CharTokenizer(cache_dir=str(d))
              for m in (JTok, PTok)]
    jtok = mk[0](tmp_path / 'jax')
    jtok.build(_TEXTS)
    ptok = mk[1](tmp_path / 'jax')            # the JAX package's files
    if kind == 'char':
        ptok.load()
    pairs = [(jtok, ptok)]
    if kind == 'bpe':
        specials = [JTok.NUL_token, JTok.PAD_token, JTok.BOS_token,
                    JTok.UNK_token]
        j_bpe = JTok.CharBPE.train(_TEXTS, 60, specials)
        p_bpe = PTok.CharBPE.train(_TEXTS, 60, specials)
        assert p_bpe.merges == j_bpe.merges and p_bpe.vocab == j_bpe.vocab
        pairs.append((j_bpe, p_bpe))
    else:
        own = mk[1](tmp_path / 'port')
        own.build(_TEXTS)
        assert own.token2id == jtok.token2id
    assert (PTok.NUL, PTok.PAD, PTok.BOS, PTok.UNK) == \
        (JTok.NUL, JTok.PAD, JTok.BOS, JTok.UNK)
    assert ptok.vocab_size == jtok.vocab_size
    assert ptok.unk_id == jtok.unk_id
    for j, p in pairs:
        for text in _TEXTS + ['unseen words zq', 'Mixed CASE text.']:
            ids = j.encode(text)
            assert p.encode(text) == ids, text
            assert p.decode(ids) == j.decode(ids)
        for i in range(len(j.vocab) if kind == 'bpe' and j is not jtok
                       else j.vocab_size):
            assert p.id_to_token(i) == j.id_to_token(i)


class _EchoDecoder:
    """Stand-in server-mode decoder: each round's text per stream is a
    function of its window, so a transcript pins the window slicing."""
    win_size, hop_size = 96, 40

    def __init__(self, n):
        self.n = n

    def reset_stream(self, i):
        pass

    def decode(self, frames):
        scale = 32768.0 if frames.dtype == np.int16 else 1.0
        frames = np.asarray(frames, np.float32) / scale
        return [f'{int(np.round(f[0] * 1000))} ' if f.any() else ''
                for f in frames]


def _echo_expected(audio):
    dec = _EchoDecoder(1)
    n = (len(audio) - dec.win_size) // dec.hop_size + 1
    return ''.join(dec.decode(audio[None, i * dec.hop_size:
                                    i * dec.hop_size + dec.win_size])[0]
                   for i in range(n))


@pytest.mark.parametrize('server_pkg,client_pkg,int16', [
    ('port', 'jax', False), ('jax', 'port', False), ('port', 'jax', True),
    ('jax', 'port', True)])
def test_stream_client_wire_format_round_trips(server_pkg, client_pkg,
                                               int16):
    """serving.StreamServer / stream_client of the port and of the JAX
    package speak one protocol: a client of one package, a server of the
    other, float32 and int16 PCM frames."""
    import asyncio
    import threading

    from edgedict_tpu import serving as JS
    from edgedict_tpu_torch import serving as PS
    server_mod = PS if server_pkg == 'port' else JS
    client_mod = PS if client_pkg == 'port' else JS
    server = server_mod.StreamServer(_EchoDecoder(2), port=0,
                                     pcm='int16' if int16 else 'float32')
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        started.set()
        loop.run_forever()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    assert started.wait(30)
    rng = np.random.RandomState(3)
    audios = [np.round(rng.uniform(-0.9, 0.9, 1000) * 32768) / 32768
              for _ in range(2)]
    audios = [a.astype(np.float32) for a in audios]
    out = [None, None]

    def client(i):
        out[i] = client_mod.stream_client('127.0.0.1', server.port,
                                          audios[i], chunk_samples=333,
                                          int16=int16)
    try:
        cs = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for c in cs:
            c.start()
        for c in cs:
            c.join(60)
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        th.join(30)
    assert out == [_echo_expected(a) for a in audios]
    assert all(out)


def test_pyproject_ships_every_port_package_and_kernel_source():
    """pyproject.toml names every package of edgedict_tpu_torch/ (each
    directory holding an __init__.py) and its package data covers every
    kernel source and header that _build compiles and hashes."""
    import fnmatch
    import tomllib

    from edgedict_tpu_torch import _build
    with open(os.path.join(REPO, 'pyproject.toml'), 'rb') as f:
        tool = tomllib.load(f)['tool']['setuptools']
    root = os.path.join(REPO, 'edgedict_tpu_torch')
    have = {os.path.relpath(d, REPO).replace(os.sep, '.')
            for d, _, files in os.walk(root) if '__init__.py' in files}
    assert {'edgedict_tpu_torch', 'edgedict_tpu_torch.data'} <= have
    named = {p for p in tool['packages']
             if p.split('.')[0] == 'edgedict_tpu_torch'}
    assert named == have
    globs = tool['package-data']['edgedict_tpu_torch']
    for name in _build.SOURCES + _build.HEADERS:
        assert os.path.exists(os.path.join(_build.CSRC, name)), name
        assert any(fnmatch.fnmatch('csrc/' + name, g) for g in globs), name
