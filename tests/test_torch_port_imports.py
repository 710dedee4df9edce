"""The port runs without JAX: no JAX-family import anywhere in
edgedict_tpu_torch/ or chip_smoke.py, only the JAX-free modules of
edgedict_tpu, and no `jax*` module appears when the port is imported.
Without a card, every CUDA entry point fails loudly."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {'jax', 'jaxlib', 'flax', 'optax', 'absl'}
ALLOWED_REFERENCE = {'edgedict_tpu.tokenizer', 'edgedict_tpu.serving',
                     'edgedict_tpu.data.audio_io'}


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
        '_build', 'config', 'features', 'compat', 'stream',
        'ops.layers', 'ops.rnn', 'ops.rnn_kernel', 'ops.features_kernel',
        'ops.decode_kernel', 'models.transducer', 'models.decoding',
        'cli.stream', 'cli.serve')]
    code = ('import importlib, sys\n'
            'fam = lambda: {m for m in sys.modules if m.split(".")[0] in '
            f'{sorted(BANNED)!r}}}\n'
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
