"""The port's flagfile reader (edgedict_tpu_torch/config.py) and its
streaming CLI (edgedict_tpu_torch/cli/stream.py) as a real subprocess."""

import argparse
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from edgedict_tpu.data.audio_io import load_audio, save_wav
from edgedict_tpu.tokenizer import DEFAULT_TOKEN2ID, CharTokenizer
from edgedict_tpu_torch import config as C
from edgedict_tpu_torch.compat import load_reference_checkpoint
from edgedict_tpu_torch.models.transducer import Transducer
from edgedict_tpu_torch.stream import StreamingDecoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ['--tokenizer', 'char',
        '--enc_hidden_size', '16', '--enc_layers', '2', '--enc_proj_size',
        '16', '--dec_hidden_size', '16', '--dec_layers', '1',
        '--dec_proj_size', '16', '--joint_size', '16',
        '--vocab_embed_size', '8', '--feature=logfbank', '--feature_size',
        '8', '--n_fft', '256', '--win_length', '256', '--hop_length', '128',
        '--downsample', '3']


def _parse(argv):
    return C.parse_flags(C.add_model_flags(argparse.ArgumentParser()), argv)


def test_flagfile_reader_e6d2():
    flags = _parse([f'--flagfile={REPO}/flagfiles/E6D2.txt'])
    feat = C.feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = C.transducer_config_from_flags(flags, 2048, feat.input_size)
    assert (cfg.enc_hidden_size, cfg.enc_layers, cfg.enc_proj_size) == \
        (1024, 6, 640)
    assert (cfg.dec_hidden_size, cfg.dec_layers, cfg.dec_proj_size) == \
        (256, 2, 256)
    assert (cfg.joint_size, cfg.vocab_embed_size, cfg.input_size) == \
        (640, 64, 240)
    assert cfg.enc_time_reductions == (1,)
    assert (feat.feature_type, feat.n_fft, feat.win_length,
            feat.hop_length, feat.downsample, feat.delta, feat.normalize) == \
        ('logfbank', 512, 320, 200, 3, False, 'none')
    assert (flags.tokenizer, flags.bpe_size) == ('bpe', 2048)

    def lstm(n_in, h):
        return 4 * h * (n_in + h) + 8 * h

    enc = (2 * 240 + lstm(240, 1024) + 5 * lstm(1024, 1024) + 6 * 2 * 1024
           + 1024 * 640 + 640)
    dec_joint = (2048 * 64 + lstm(64, 256) + lstm(256, 256) + 256 * 256
                 + 256 + 896 * 640 + 640 + 640 * 2048 + 2048)
    assert 47.5e6 < enc < 48.0e6                   # encoder ≈47.8 M
    assert 50.5e6 < enc + dec_joint < 51.1e6       # ≈50.8 M parameters
    # the prediction net and joint at full width (the encoder cut to 1x8)
    small = dataclasses.replace(cfg, enc_hidden_size=8, enc_layers=1)
    assert dec_joint == sum(p.numel() for name, p in
                            Transducer(small, 'cpu').named_parameters()
                            if not name.startswith('encoder'))


@pytest.mark.parametrize('name', ['E4D1.txt', 'E6D2_LARGE_Batch.txt'])
def test_flagfile_reader_other_presets(name):
    flags = _parse([f'--flagfile={REPO}/flagfiles/{name}'])
    assert flags.enc_layers >= 4 and flags.feature in (
        'logfbank', 'melspec', 'mfcc')


def test_flagfile_syntax(tmp_path):
    inner = tmp_path / 'inner.txt'
    inner.write_text('# comment\n--joint_size=77\n\n--nodelta\n')
    outer = tmp_path / 'outer.txt'
    outer.write_text(f'--flagfile={inner}\n--delta\n--apex\n--noapex\n'
                     '--lr=5e-4\n// another comment\n--enc_layers=3\n')
    flags = _parse([f'--flagfile={outer}', '--cmvn'])
    assert (flags.joint_size, flags.delta, flags.enc_layers, flags.cmvn) == \
        (77, True, 3, True)
    flags = _parse(['--flagfile', str(outer), '--delta=false'])
    assert flags.delta is False
    with pytest.raises(SystemExit):
        _parse(['--no_such_flag=1'])


def _setup(tmp_path):
    logs = tmp_path / 'logs'
    os.makedirs(logs / 'char')
    tok2id = dict(DEFAULT_TOKEN2ID)
    for ch in 'abcdefgh ':
        tok2id[ch] = len(tok2id)
    with open(logs / 'char' / 'token2id.pkl', 'wb') as f:
        pickle.dump(tok2id, f)
    wav = str(tmp_path / 'x.wav')
    t = np.linspace(0, 1.2, 19200, endpoint=False)
    rng = np.random.RandomState(0)
    save_wav(wav, 0.3 * np.sin(2 * np.pi * 500 * t)
             + 0.05 * rng.randn(len(t)), 16000)
    return str(logs), wav


def _run(args, tmp_path):
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    return subprocess.run(
        [sys.executable, '-m', 'edgedict_tpu_torch.cli.stream'] + args,
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)


def test_cli_stream_transcript_equals_decode_wav(tmp_path):
    logs, wav = _setup(tmp_path)
    flags = _parse(TINY + ['--logdir_root', logs])
    tok = CharTokenizer(os.path.join(logs, 'char'))
    tok.load()
    feat = C.feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = C.transducer_config_from_flags(flags, tok.vocab_size,
                                         feat.input_size)
    model = Transducer(cfg, 'cpu', seed=7)
    with torch.no_grad():
        model.joint.out.bias[0] -= 3.0            # emit some text
    pt = str(tmp_path / 'model.pt')
    torch.save({'model': model.state_dict()}, pt)

    r = _run(['--device', 'cpu', '--path', wav, '--logdir_root', logs,
              '--pt_path', pt] + TINY, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0] == f'loaded {pt}'
    assert lines[-1].startswith('[chunks ') and 'throughput' in lines[-1]
    audio, _ = load_audio(wav)
    expect = StreamingDecoder(load_reference_checkpoint(pt, cfg, 'cpu'),
                              cfg, feat, tok, device='cpu').decode_wav(audio)
    assert expect.strip()
    assert lines[1] == expect

    r2 = _run(['--device', 'cpu', '--path', wav, '--logdir_root', logs,
               '--block_chunks', '3'] + TINY, tmp_path)
    assert r2.returncode == 0, r2.stderr[-3000:]
    assert r2.stdout.splitlines()[0] == \
        'WARNING: no checkpoint found — using random weights'


def test_cli_cuda_without_card_fails_loudly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    logs, wav = _setup(tmp_path)
    r = _run(['--path', wav, '--logdir_root', logs] + TINY, tmp_path)
    assert r.returncode != 0
    assert 'torch.cuda.is_available() is False' in r.stderr
    assert 'throughput' not in r.stdout


def test_profile_stream_cpu(capsys):
    """The chunk profiler runs end to end; on the CPU its device fields
    are null, its host clocks are filled."""
    from edgedict_tpu_torch.cli import profile_stream
    profile_stream.main(['--device', 'cpu', '--seconds', '1.2',
                         '--bpe_size', '32', '--block_chunks', '3'] + TINY)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{')]
    assert rows[0]['device'] == 'cpu' and len(rows) == 3
    assert [r['dtype'] for r in rows[1:]] == ['fp32', 'bf16']
    for r in rows[1:]:
        assert r['chunks'] == (19200 - 896) // 768 + 1   # win 896, hop 768
        assert r['wall_ms_per_chunk'] > 0 and r['block_ms'] > 0
        assert r['device_ms_per_chunk'] is None
        assert set(r['kernel_device_ms_per_chunk']) == {
            'lstm_fwd', 'mel_power', 'greedy_decode'}
        assert set(r['stage_ms']) == {'featurize', 'encoder', 'frame_loop'}


def _global_kernels():
    """(names of the __global__ functions, names of the structs) in the
    port's CUDA sources."""
    import glob
    import re
    names, structs = set(), set()
    for path in glob.glob(os.path.join(
            os.path.dirname(__file__), '..', 'edgedict_tpu_torch', 'csrc',
            '*.cu')):
        with open(path) as fh:
            src = fh.read()
        names |= set(re.findall(
            r'__global__\s+void\s+(?:__launch_bounds__\(\w+\)\s+)?'
            r'(\w+)\s*\(', src))
        structs |= set(re.findall(r'struct\s+(\w+)\s*\{', src))
    return names, structs


@pytest.mark.parametrize('module', ['profile_stream', 'profile_train'])
def test_profiler_patterns_name_kernels_of_the_sources(module):
    """Every pattern of the profilers' kernel maps is part of the name of a
    __global__ function of csrc/ (the trace names a kernel as it is
    declared), so a renamed kernel cannot leave a map reading zero."""
    import importlib
    kernels = importlib.import_module(
        f'edgedict_tpu_torch.cli.{module}').KERNELS
    names, structs = _global_kernels()
    assert 'greedy_frame_kernel' in names
    assert 'joint_lse_fwd_mma_kernel' in names
    for key, subs in kernels.items():
        # capitalised parts name a template argument (the cell's struct)
        funcs = [sub for sub in subs if not sub[0].isupper()]
        assert all(sub in structs for sub in subs if sub[0].isupper())
        assert any(all(sub in n for sub in funcs) for n in names), (key, subs)


def test_profiler_maps_split_k7_and_k3():
    """K3's one launch is the stream profiler's greedy_decode; K7's h
    launch and its product are apart in the train profiler, both inside
    joint_lse_fwd, and none of them is read as a K8 part."""
    from edgedict_tpu_torch.cli import profile_stream, profile_train
    k3 = 'void (anonymous namespace)::greedy_frame_kernel((anonymous ' \
         'namespace)::Args)'
    assert profile_stream.kernel_of(k3, 'greedy_decode')
    maps = profile_train.KERNELS

    def hits(name):
        return {k for k, subs in maps.items()
                if all(sub in name for sub in subs)}
    res = 'void (anonymous namespace)::joint_lse_fwd_mma_kernel<true>(...)'
    h = 'void (anonymous namespace)::joint_lse_fwd_h_kernel(...)'
    k8h = 'void (anonymous namespace)::joint_lse_bwd_h_kernel(...)'
    assert hits(res) == {'joint_lse_fwd', 'joint_lse_fwd_mma'}
    assert hits(h) == {'joint_lse_fwd', 'joint_lse_fwd_h'}
    assert hits(k8h) == {'joint_lse_bwd_h'}
