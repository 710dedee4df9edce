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


def test_cli_stream_and_serve_load_the_run_checkpoint(tmp_path, capsys):
    """Without --pt_path the stream CLI loads the run's checkpoint, as the
    JAX package's CLI does (cli/stream.py:83-97): logs/<name>/models/<the
    latest step>.ckpt, or the --model_name file, and prints `loaded
    <path>`; its transcript equals decode_wav on that checkpoint's state
    dict, and the server's decoder (cli/serve.py build_decoder) holds the
    same weights."""
    from test_torch_port_train import _cli_args, _write_corpus

    from edgedict_tpu_torch import checkpoint as CK
    from edgedict_tpu_torch.cli import baseline, serve, stream
    from edgedict_tpu_torch.compat import transducer_from_state_dict
    corpus = _write_corpus(str(tmp_path / 'libri'), n=4)
    logs = str(tmp_path / 'logs')
    args = _cli_args(corpus, logs, 'run')
    args[args.index('--epochs') + 1] = '1'
    trainer = baseline.main(args + ['--mode', 'train'], log_fn=lambda *_: 0)
    step = trainer.state.step
    trained = CK.checkpoint_path(trainer.logdir, step)
    # a later step whose weights emit blanks only
    later = CK.load_checkpoint(trained)['model']
    later['joint.joint.2.bias'] = later['joint.joint.2.bias'].clone()
    later['joint.joint.2.bias'][0] += 30.0
    latest = CK.save_checkpoint(trainer.logdir, step + 1, later)
    _, wav = _setup(tmp_path / 'audio')
    audio, _ = load_audio(wav)
    argv = ['--flagfile', os.path.join(trainer.logdir, 'flagfile.txt'),
            '--device', 'cpu']
    flags = C.parse_flags(stream.build_parser(''), argv)
    argv += ['--path', wav]
    assert (flags.logdir_root, flags.name) == (logs, 'run')
    tok = stream.build_tokenizer(flags)
    feat = C.feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = C.transducer_config_from_flags(flags, tok.vocab_size,
                                         feat.input_size)

    def expect(path):
        model = transducer_from_state_dict(
            CK.load_checkpoint(path)['model'], cfg, 'cpu')
        return StreamingDecoder(model, cfg, feat, tok,
                                device='cpu').decode_wav(audio)

    def run(extra):
        capsys.readouterr()
        stream.main(argv + extra)
        return capsys.readouterr().out.splitlines()

    out = run([])
    assert out[0] == f'loaded {latest}'
    assert out[1] == expect(latest)
    out = run(['--model_name', f'{step}.ckpt'])
    assert out[0] == f'loaded {trained}'
    assert out[1] == expect(trained) and out[1].strip()
    assert expect(trained) != expect(latest)

    flags.n_streams = 2
    held = serve.build_decoder(flags).model.state_dict()
    assert capsys.readouterr().out.splitlines()[0] == f'loaded {latest}'
    for key, value in later.items():
        assert torch.equal(held[key], value), key


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


def test_profile_stream_rounds_cpu(capsys):
    """--streams profiles the server's round: every stream's chunks in
    lockstep, one JSON line per dtype with the round's host clock filled
    and, on the CPU, its device fields null."""
    from edgedict_tpu_torch.cli import profile_stream
    profile_stream.main(['--device', 'cpu', '--seconds', '1.2',
                         '--bpe_size', '32', '--streams', '3',
                         '--quantize', 'int8'] + TINY)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{')]
    assert rows[0]['quantize'] == 'int8' and len(rows) == 3
    assert [r['dtype'] for r in rows[1:]] == ['fp32', 'bf16']
    for r in rows[1:]:
        assert r['streams'] == 3
        assert r['rounds'] == (19200 - 896) // 768 + 1   # win 896, hop 768
        assert r['wall_ms_per_round'] > 0
        assert r['profiled_wall_ms_per_round'] > 0
        assert r['device_ms_per_round'] is None
        assert set(r['kernel_device_ms_per_round']) == {
            'quant_matmul', 'lstm_fwd_q', 'mel_power', 'greedy_decode'}


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
            r'__global__\s+void\s+(?:__launch_bounds__\([\w, ]+\)\s+)?'
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


@pytest.mark.parametrize('dtype', ['float', '__nv_bfloat16'])
def test_profiler_map_tells_k12_from_k1(dtype):
    """K12 runs K1's kernel body under a name of its own: the stream
    profiler reads its launches as lstm_fwd_q and never as K1's."""
    from edgedict_tpu_torch.cli import profile_stream
    k1 = (f'void (anonymous namespace)::recur_fwd_kernel<{dtype}, '
          '(anonymous namespace)::LstmStep>((anonymous namespace)::FwdArgs)')
    k12 = (f'void (anonymous namespace)::recur_fwd_q_kernel<{dtype}>('
           '(anonymous namespace)::FwdArgs)')
    hits = {name: [profile_stream.kernel_of(k, name) for k in (k1, k12)]
            for name in ('lstm_fwd', 'lstm_fwd_q', 'gru_fwd')}
    assert hits == {'lstm_fwd': [True, False], 'lstm_fwd_q': [False, True],
                    'gru_fwd': [False, False]}


@pytest.mark.parametrize('dtype', ['float', '__nv_bfloat16'])
def test_profiler_map_tells_k13_from_k12(dtype):
    """K13 runs K5's kernel body under a name of its own: the stream
    profiler reads its launches as gru_fwd_q, never as K12's or K5's, and
    K12's and K5's launches never as K13's."""
    from edgedict_tpu_torch.cli import profile_stream
    k5 = (f'void (anonymous namespace)::recur_fwd_kernel<{dtype}, '
          '(anonymous namespace)::GruStep>((anonymous namespace)::FwdArgs)')
    k12 = (f'void (anonymous namespace)::recur_fwd_q_kernel<{dtype}>('
           '(anonymous namespace)::FwdArgs)')
    k13 = (f'void (anonymous namespace)::recur_fwd_gru_q_kernel<{dtype}>('
           '(anonymous namespace)::FwdArgs)')
    hits = {name: [profile_stream.kernel_of(k, name) for k in (k5, k12, k13)]
            for name in ('gru_fwd', 'lstm_fwd_q', 'gru_fwd_q', 'lstm_fwd')}
    assert hits == {'gru_fwd': [True, False, False],
                    'lstm_fwd_q': [False, True, False],
                    'gru_fwd_q': [False, False, True],
                    'lstm_fwd': [False, False, False]}


def test_profile_lattice_ablations_edit_k9_alone():
    """Each ablation of cli/profile_lattice.py finds its text once in K9's
    part of csrc/rnnt_loss.cu and leaves the rest of the source, K10's
    walk included, as it is."""
    from edgedict_tpu_torch import _build
    from edgedict_tpu_torch.cli import profile_lattice
    with open(os.path.join(_build.CSRC, 'rnnt_loss.cu')) as fh:
        src = fh.read()
    start, end = profile_lattice.k9_region(src)
    for name, edits in profile_lattice.ABLATIONS.items():
        out = profile_lattice.ablated_source(src, edits)
        assert out[:start] == src[:start] and out.endswith(src[end:])
        assert (out == src) == (name == 'shipped'), name
    with pytest.raises(ValueError, match='not found once'):
        profile_lattice.ablated_source(src, (('no such text', ''),))


def test_cli_train_lm_then_stream_beam_with_lm_fusion(tmp_path):
    """cli.train_lm --device cpu writes logs/<name>/lm.ckpt; cli.stream
    --beam_width 3 --lm_path <that file> prints the `LM fusion:` line and
    the transcript of StreamingBeamDecoder.decode_wav with that LM."""
    from test_torch_port_train import _write_corpus

    from edgedict_tpu_torch.cli import train_lm
    from edgedict_tpu_torch.models.lm import load_lm_checkpoint
    from edgedict_tpu_torch.stream import StreamingBeamDecoder
    logs, wav = _setup(tmp_path)
    corpus = _write_corpus(str(tmp_path / 'libri'), n=4)
    none = str(tmp_path / 'none')
    lines = []
    lm, lm_cfg = train_lm.main(
        ['--LibriSpeech_train_100', corpus, '--LibriSpeech_train_360', none,
         '--LibriSpeech_train_500', none, '--LibriSpeech_test', none,
         '--TEDLIUM_train', none, '--CommonVoice', none, '--YT_bloomberg2',
         none, '--YT_life', none, '--logdir_root', logs, '--name', 'lm',
         '--tokenizer', 'char', '--device', 'cpu', '--lr', '1e-3',
         '--lm_embed_size', '8', '--lm_hidden_size', '16', '--lm_layers',
         '2', '--lm_seq_len', '8', '--batch_size', '2', '--epochs', '2',
         '--loss_step', '1', '--save_step', '2'], log_fn=lines.append)
    assert len(lines) >= 4 and all('ppl' in ln for ln in lines)
    losses = [float(ln.split()[5]) for ln in lines]
    assert np.isfinite(losses).all()
    lm_path = os.path.join(logs, 'lm', 'lm.ckpt')
    assert os.path.isfile(lm_path)
    assert os.listdir(os.path.join(logs, 'lm', 'models'))
    loaded, loaded_cfg = load_lm_checkpoint(lm_path)
    assert loaded_cfg == lm_cfg and lm_cfg.hidden_size == 16

    flags = _parse(TINY + ['--logdir_root', logs])
    tok = CharTokenizer(os.path.join(logs, 'char'))
    tok.load()
    assert lm_cfg.vocab_size == tok.vocab_size
    feat = C.feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = C.transducer_config_from_flags(flags, tok.vocab_size,
                                         feat.input_size)
    model = Transducer(cfg, 'cpu', seed=7)
    with torch.no_grad():
        model.joint.out.weight *= 8.0             # emit some text
    pt = str(tmp_path / 'model.pt')
    torch.save({'model': model.state_dict()}, pt)
    r = _run(['--device', 'cpu', '--path', wav, '--logdir_root', logs,
              '--pt_path', pt, '--beam_width', '3', '--lm_path', lm_path,
              '--lm_weight', '0.1'] + TINY, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.splitlines()
    assert out[0] == f'loaded {pt}'
    assert out[1] == f'LM fusion: {lm_path} (lambda=0.1)'
    assert out[-1].startswith('[chunks ') and 'throughput' in out[-1]
    audio, _ = load_audio(wav)
    expect = StreamingBeamDecoder(
        load_reference_checkpoint(pt, cfg, 'cpu'), cfg, feat, tok,
        device='cpu', beam_width=3,
        lm=(loaded, loaded_cfg, 0.1)).decode_wav(audio)
    assert expect.strip()
    assert out[2] == expect


def test_cli_baseline_eval_beam_width_prints_beam_wer(tmp_path):
    """--eval_beam_width 2 reaches the trainer: the train loop's eval line
    and --mode eval's line carry a finite beam_WER, in the JAX package's
    format."""
    from test_torch_port_train import _cli_args, _write_corpus

    from edgedict_tpu_torch.cli import baseline
    corpus = _write_corpus(str(tmp_path / 'libri'), n=4)
    args = _cli_args(corpus, str(tmp_path / 'logs'), 'beam') + [
        '--eval_beam_width', '2']
    args[args.index('--epochs') + 1] = '1'
    args[args.index('--eval_step') + 1] = '1'
    lines = []
    trainer = baseline.main(args + ['--mode', 'train'], log_fn=lines.append)
    assert trainer.beam_eval_step is not None
    evals = [ln for ln in lines if ln.startswith('eval @')]
    assert evals and ' beam_WER ' in evals[0]
    assert np.isfinite(float(evals[0].split()[-1]))
    lines = []
    baseline.main(args + ['--mode', 'eval'], log_fn=lines.append)
    val = [ln for ln in lines if ln.startswith('val_loss')]
    assert val and val[0].split()[4] == 'beam_WER'
    assert np.isfinite(float(val[0].split()[5]))


# wav2vec pretraining at the tiny widths of test_torch_port_train._cli_args
W2V_PRETRAIN = ['--num_negatives', '4', '--latent_vars', '8',
                '--final_dim', '8', '--pretrain_audio_samples', '4000',
                '--mask_prob', '0.4', '--mask_length', '3',
                '--eval_iteration', '1', '--epochs', '2']


@pytest.fixture(scope='module')
def w2v_run(tmp_path_factory):
    """cli.pretrain_wav2vec --device cpu on a 4-utterance corpus, 2 steps
    (batch 4 in micro-batches of 2): → (trainer argv, pretrainer, log)."""
    from test_torch_port_train import _cli_args, _write_corpus

    from edgedict_tpu_torch.cli import pretrain_wav2vec
    tmp = tmp_path_factory.mktemp('w2v')
    corpus = _write_corpus(str(tmp / 'libri'), n=4)
    args = _cli_args(corpus, str(tmp / 'logs'), 'w2v')
    lines = []
    pre = pretrain_wav2vec.main(args + W2V_PRETRAIN, log_fn=lines.append)
    return args, pre, lines


def test_cli_pretrain_wav2vec_writes_pretrained_ckpt(w2v_run):
    """Two steps, an eval after each, the best held-out accuracy kept as
    logs/<name>/pretrained.ckpt: the model's state dict after the step
    that made it."""
    from edgedict_tpu_torch.checkpoint import load_checkpoint
    args, pre, lines = w2v_run
    assert pre.host_step == 2 and pre.accum_steps == 2
    steps = [ln for ln in lines if ln.startswith('epoch ')]
    evals = [ln for ln in lines if ln.startswith('eval @')]
    assert len(steps) == len(evals) == 2
    for ln in steps:
        words = ln.split()
        assert np.isfinite(float(words[5])) and 0 <= float(words[7]) <= 1
    path = os.path.join(pre.logdir, 'pretrained.ckpt')
    payload = load_checkpoint(path)
    accs = [float(ln.split()[4]) for ln in evals]
    assert payload['extra']['accuracy'] == pytest.approx(max(accs))
    assert set(payload['model']) == set(pre.state.model.state_dict())
    assert pre.cfg.input_size == 128 and pre.cfg.enc_layers == 2
    assert os.path.isfile(os.path.join(pre.logdir, 'flagfile.txt'))


def test_cli_train_use_pretrained_splices_equal_weights(w2v_run, capsys):
    """cli.train --use_pretrained (zero epochs: the splice alone, then the
    final save): the FrontEnd and encoder keys equal pretrained.ckpt's,
    the fine-tune's own keys keep the seeded init."""
    from edgedict_tpu_torch.checkpoint import load_checkpoint
    from edgedict_tpu_torch.cli import train as cli_train
    from edgedict_tpu_torch.models.wav2vec import RawTransducer
    args, pre, _ = w2v_run
    lines = []
    trainer = cli_train.main(args + ['--use_pretrained', '--epochs', '0',
                                     '--name', 'w2v'], log_fn=lines.append)
    path = os.path.join(pre.logdir, 'pretrained.ckpt')
    assert f'initialized frontend+encoder from {path}' in lines
    src = load_checkpoint(path)['model']
    sd = trainer.state.model.state_dict()
    fresh = RawTransducer(trainer.cfg, 'cpu').state_dict()
    spliced = [k for k in sd if k.split('.')[0] in ('frontend', 'encoder')
               and k in src]
    assert len(spliced) == len([k for k in src if k.split('.')[0] in
                                ('frontend', 'encoder')])
    for k, v in sd.items():
        assert torch.equal(v, src[k] if k in spliced else fresh[k]), k


def test_cli_train_resume_and_eval_reload_the_run(w2v_run):
    """cli.train --use_pretrained trains one step and saves; --mode resume
    reloads step 1 and goes on to 2; --mode eval reloads step 2 (its
    weights, not the splice's) and prints a finite val_loss and WER.  The
    steps are named: the pretraining run's best checkpoints share
    logs/<name>/models/ with the fine-tune's, as in the JAX package."""
    from edgedict_tpu_torch.checkpoint import load_checkpoint
    from edgedict_tpu_torch.cli import train as cli_train
    args, pre, _ = w2v_run
    base = args + ['--use_pretrained', '--name', 'w2v', '--save_step', '1']
    a = cli_train.main(base + ['--epochs', '1'], log_fn=lambda s: None)
    assert a.state.step == 1
    lines = []
    b = cli_train.main(base + ['--epochs', '2', '--mode', 'resume',
                               '--resume_step', '1'], log_fn=lines.append)
    assert 'resumed from step 1' in lines and b.state.step == 2
    lines = []
    c = cli_train.main(base + ['--mode', 'eval', '--resume_step', '2'],
                       log_fn=lines.append)
    saved = load_checkpoint(os.path.join(c.logdir, 'models', '2.ckpt'))
    for k, v in c.state.model.state_dict().items():
        assert torch.equal(v, saved['model'][k]), k
    val = [ln for ln in lines if ln.startswith('val_loss')]
    assert val and np.isfinite(float(val[0].split()[1])) \
        and val[0].split()[2] == 'WER' \
        and np.isfinite(float(val[0].split()[3]))


@pytest.mark.parametrize('cli', ['pretrain_wav2vec', 'train'])
def test_cli_wav2vec_entry_points_default_to_cuda(w2v_run, cli):
    """Both new CLIs default to --device cuda and, without a card, stop
    naming torch.cuda.is_available() rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    import importlib
    args, _, _ = w2v_run
    args = list(args)
    del args[args.index('--device'):args.index('--device') + 2]
    main = importlib.import_module(f'edgedict_tpu_torch.cli.{cli}').main
    with pytest.raises(RuntimeError, match='is_available'):
        main(args + W2V_PRETRAIN, log_fn=lambda s: None)


def test_cli_train_tp_cuts_the_raw_joint(w2v_run):
    """cli.train --tp_size 2 --device cpu (the raw fine-tune from a fresh
    init, one epoch of 2 steps): the joint's output layer is in two
    vocabulary slices and the run trains, evaluates and saves the
    one-device layout."""
    from edgedict_tpu_torch.checkpoint import checkpoint_path, load_checkpoint
    from edgedict_tpu_torch.cli import train as cli_train
    args, _, _ = w2v_run
    lines = []
    trainer = cli_train.main(args + ['--name', 'raw-tp', '--epochs', '1',
                                     '--tp_size', '2', '--eval_step', '1'],
                             log_fn=lines.append)
    v = trainer.cfg.vocab_size
    assert v % 2 == 0, v
    rows = sorted(p.shape[0] for k, p in
                  trainer.state.model.named_parameters()
                  if k.startswith('joint.joint.2.'))
    assert rows == [v // 2] * 4
    losses = [ln for ln in lines if ln.startswith('step ')]
    assert losses and all(np.isfinite(float(ln.split()[3])) for ln in losses)
    assert any(ln.startswith('eval @ ') for ln in lines)
    saved = load_checkpoint(checkpoint_path(trainer.logdir,
                                            trainer.state.step))
    assert saved['model']['joint.joint.2.weight'].shape[0] == v


@pytest.mark.parametrize('cli', ['pretrain_wav2vec', 'train'])
def test_cli_wav2vec_entry_points_refuse_pp(w2v_run, cli):
    """--pp_size > 1 is wired for the transducer trainer only: the raw
    fine-tune and the wav2vec pretrainer refuse it, as the JAX package's
    do (raw_trainer.py:43-47, pretrainer.py:90-93)."""
    import importlib
    args, _, _ = w2v_run
    main = importlib.import_module(f'edgedict_tpu_torch.cli.{cli}').main
    with pytest.raises(NotImplementedError, match='pp_size'):
        main(args + W2V_PRETRAIN + ['--name', 'raw-pp', '--pp_size', '2'],
             log_fn=lambda s: None)
