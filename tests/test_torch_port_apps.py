"""The port's streaming apps against the JAX package's on the same weights:
cli.youtube_live's caption_stream, cli.wav_inference (jit, exported and
int8 backends, StreamingDecoder.profile_components), cli.stream --mic and
cli.demo (both driven by a stand-in `sounddevice` that plays a seeded
waveform into their callback and then ends the program), cli.export and
cli.wer_parity (a reference-layout .pt on a LibriSpeech-layout mini
corpus, against the JAX package's eval step).  The JAX CLIs run as
subprocesses on the CPU; the port's run in this process with --device
cpu."""

import importlib.util
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cli.youtube_live import caption_stream as j_caption_stream
from edgedict_tpu import export as JE
from edgedict_tpu.checkpoint import save_checkpoint
from edgedict_tpu.data.audio_io import save_wav
from edgedict_tpu.features import FeatureConfig as JFeat
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.stream import StreamingDecoder as JStreamingDecoder
from edgedict_tpu.tokenizer import DEFAULT_TOKEN2ID
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import export as PE
from edgedict_tpu_torch.cli import demo as p_demo
from edgedict_tpu_torch.cli import export as p_export
from edgedict_tpu_torch.cli import stream as p_stream
from edgedict_tpu_torch.cli import wav_inference as p_wav_inference
from edgedict_tpu_torch.cli import wer_parity as p_wer_parity
from edgedict_tpu_torch.cli.youtube_live import caption_stream
from edgedict_tpu_torch.cli.youtube_live import main as youtube_live_main
from edgedict_tpu_torch.features import FeatureConfig as PFeat
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.stream import StreamingDecoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARS = 'abcdefghijklmnopqrstuvwxyz '
TINY = ['--tokenizer', 'char', '--enc_hidden_size', '16', '--enc_layers',
        '2', '--enc_proj_size', '16', '--dec_hidden_size', '16',
        '--dec_layers', '1', '--dec_proj_size', '16', '--joint_size', '16',
        '--vocab_embed_size', '8', '--feature', 'logfbank',
        '--feature_size', '8', '--n_fft', '256', '--win_length', '256',
        '--hop_length', '128', '--downsample', '3']
FKW = dict(feature_type='logfbank', feature_size=8, n_fft=256,
           win_length=256, hop_length=128, downsample=3,
           pad_to_divisible=False)
VOCAB = len(DEFAULT_TOKEN2ID) + len(CHARS)
KW = dict(vocab_size=VOCAB, vocab_embed_size=8, input_size=24,
          enc_hidden_size=16, enc_layers=2, enc_proj_size=16,
          dec_hidden_size=16, dec_layers=1, dec_proj_size=16,
          joint_size=16)

# a stand-in for the sounddevice package: InputStream plays the float32
# samples of $EDD_FAKE_MIC (.npy) into the callback in blocks of 700, as the
# driver's thread would, then ends the program (SystemExit 0), as ctrl-c
# would end the listening loop
FAKE_SOUNDDEVICE = '''
import os
import numpy as np


class InputStream:
    def __init__(self, samplerate, channels, callback):
        assert (samplerate, channels) == (16000, 1)
        self.callback = callback

    def __enter__(self):
        audio = np.load(os.environ['EDD_FAKE_MIC'])
        for i in range(0, len(audio), 700):
            block = audio[i:i + 700, None]
            self.callback(block, len(block), None, None)
        raise SystemExit(0)

    def __exit__(self, *exc):
        return False
'''


class _Tok:
    unk_id = 3

    def id_to_token(self, i):
        return chr(0x100 + int(i))


# ---------------------------------------------------------------------------
# caption_stream with stand-in decoders: the port's == the JAX package's
# ---------------------------------------------------------------------------

class FakeDecoder:
    """Records every chunk it decodes and its resets; emits scripted
    text (tests/test_youtube_live.py:13-29)."""

    def __init__(self, win_size, hop_size, texts=None, beam=False):
        self.win_size = win_size
        self.hop_size = hop_size
        self.chunks = []
        self.resets = 0
        self.texts = list(texts or [])
        if beam:
            self.beam = object()

    def decode(self, chunk):
        self.chunks.append(np.array(chunk))
        return self.texts.pop(0) if self.texts else ''

    def reset(self):
        self.resets += 1


def _feed(pcm, sizes):
    out, i = [], 0
    for s in sizes:
        out.append(pcm[i:i + s])
        i += s
    assert i == len(pcm)
    return out


def _poisoned():
    pcm = np.arange(500, dtype=np.float32)
    pcm[250] = np.nan
    return pcm


# (win, hop, pcm, demuxer pieces, decoder texts, beam, reset_step,
#  reset_after, expected stats) — the cases of tests/test_youtube_live.py
CASES = {
    'window_hop': (100, 60, np.arange(1000, dtype=np.float32),
                   [3, 250, 1, 400, 346], None, False, 0, 9999,
                   dict(chunks_done=16, nan_skipped=0, silence_resets=0,
                        periodic_resets=0)),
    'nan_guard': (100, 100, _poisoned(), [500], None, False, 0, 9999,
                  dict(chunks_done=4, nan_skipped=1, silence_resets=0,
                       periodic_resets=0)),
    'silence': (10, 10, np.zeros(120, np.float32), [120], None, False, 0, 5,
                dict(chunks_done=12, nan_skipped=0, silence_resets=2,
                     periodic_resets=0)),
    'periodic': (10, 10, np.zeros(170, np.float32), [170], ['x'] * 17,
                 False, 5, 9999, dict(chunks_done=17, nan_skipped=0,
                                      silence_resets=0, periodic_resets=3)),
    'beam': (10, 10, np.zeros(50, np.float32), [50],
             ['a', 'ab', 'ab', 'abc', 'abc'], True, 0, 9999,
             dict(chunks_done=5, nan_skipped=0, silence_resets=0,
                  periodic_resets=0)),
    'mixed': (10, 10, np.zeros(300, np.float32), [7, 93, 200],
              ['', '', 'x', '', '', '', 'y'] * 4, False, 11, 3,
              None),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_caption_stream_equals_jax(case):
    """Window / hop math over irregular demuxer pieces, the NaN guard, the
    silence and periodic resets and the beam's full-hypothesis semantics:
    the emitted strings, the stats, the decoded chunks and the resets of
    the port's caption_stream equal the JAX package's."""
    win, hop, pcm, sizes, texts, beam, step, after, stats = CASES[case]
    runs = []
    for fn in (caption_stream, j_caption_stream):
        dec = FakeDecoder(win, hop, texts, beam)
        emitted = []
        got = fn(dec, _feed(pcm, sizes), reset_step=step, reset_after=after,
                 emit=lambda s, **k: emitted.append(s))
        runs.append((got, emitted, dec.resets, [c.tolist() for c in
                                                dec.chunks]))
    assert runs[0] == runs[1]
    if stats is not None:
        assert runs[0][0] == stats
    if case == 'window_hop':
        for i, chunk in enumerate(runs[0][3]):
            assert chunk == pcm[i * hop:i * hop + win].tolist()
    if case == 'beam':
        assert [e.strip() for e in runs[0][1] if e.startswith('\r')] == \
            ['a', 'ab', 'abc']


def _pair(seed=0):
    """JAX params (blank column pushed down, logits widened, <unk> never
    the argmax) and the port model of the same weights."""
    jcfg, pcfg = JT.TransducerConfig(**KW), PT.TransducerConfig(**KW)
    params = JT.transducer_init(jax.random.PRNGKey(seed), jcfg)
    params['joint']['out']['b'] = params['joint']['out']['b'].at[0].add(
        -1.0).at[3].add(-100.0)
    params['joint']['out']['w'] = params['joint']['out']['w'] * 8.0
    params = jax.tree.map(np.asarray, params)
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), pcfg, 'cpu')
    return params, jcfg, model, pcfg


def _speechy(seconds, seed):
    """Seeded tones and noise with stretches of silence."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    audio = 0.3 * np.sin(2 * np.pi * (300 + 200 * np.sin(3 * t)) * t) \
        + 0.05 * rng.randn(len(t))
    audio[(t % 1.0) > 0.6] = 0.0
    return audio.astype(np.float32)


def test_caption_stream_over_real_decoders_equals_jax():
    """The port's StreamingDecoder under the port's caption_stream == the
    JAX StreamingDecoder under the JAX caption_stream: emitted strings and
    stats, with silence and periodic resets firing."""
    params, jcfg, model, pcfg = _pair()
    pcm = _speechy(3.0, 1)
    pieces = _feed(pcm, [640] * (len(pcm) // 640) + [len(pcm) % 640])
    runs = []
    for fn, dec in ((caption_stream, StreamingDecoder(
            model, pcfg, PFeat(**FKW), _Tok(), device='cpu')),
            (j_caption_stream, JStreamingDecoder(
                jax.tree.map(jnp.asarray, params), jcfg, JFeat(**FKW),
                _Tok()))):
        emitted = []
        stats = fn(dec, pieces, reset_step=7, reset_after=2,
                   emit=lambda s, **k: emitted.append(s))
        runs.append((stats, emitted))
    assert runs[0] == runs[1]
    stats, emitted = runs[0]
    assert stats['periodic_resets'] > 0 and stats['silence_resets'] > 0
    assert ''.join(e for e in emitted if not e.startswith('\n'))


# ---------------------------------------------------------------------------
# the CLIs on one run directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def run_dir(tmp_path_factory):
    """A JAX-format run: logs/char/token2id.pkl and logs/tiny/models/1.ckpt
    (the _pair weights) that both packages' CLIs load; a second logdir
    root for the JAX package's artifacts (logs_jax, its own export/);
    a wav, and a LibriSpeech-layout directory of 3 utterances."""
    root = tmp_path_factory.mktemp('apps')
    params, jcfg, model, pcfg = _pair()
    tok2id = dict(DEFAULT_TOKEN2ID)
    for ch in CHARS:
        tok2id[ch] = len(tok2id)
    assert len(tok2id) == VOCAB
    for logs in ('logs', 'logs_jax'):
        os.makedirs(root / logs / 'char')
        with open(root / logs / 'char' / 'token2id.pkl', 'wb') as f:
            pickle.dump(tok2id, f)
    save_checkpoint(str(root / 'logs' / 'tiny'), 1,
                    jax.tree.map(jnp.asarray, params))
    JE.export_transducer(jax.tree.map(jnp.asarray, params), jcfg,
                         str(root / 'logs_jax' / 'tiny' / 'export'))
    save_wav(str(root / 'x.wav'), _speechy(2.0, 2), 16000)
    d = root / 'wavs' / '9' / '9'
    os.makedirs(d)
    lines = []
    for i in range(3):
        save_wav(str(d / f'9-9-{i:04d}.wav'), _speechy(1.0 + 0.3 * i, 5 + i),
                 16000)
        lines.append(f'9-9-{i:04d} HELLO WORLD {i}')
    (d / '9-9.trans.txt').write_text('\n'.join(lines) + '\n')
    np.save(root / 'mic.npy', _speechy(3.0, 7))
    (root / 'fake').mkdir()
    (root / 'fake' / 'sounddevice.py').write_text(FAKE_SOUNDDEVICE)
    return root, params, model, pcfg


def _common(root, logs='logs'):
    return ['--logdir_root', str(root / logs), '--name', 'tiny'] + TINY


def _jax_cli(root, module, args):
    """A JAX package CLI as a subprocess on the CPU, with the stand-in
    sounddevice first on its path → stdout."""
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               EDD_FAKE_MIC=str(root / 'mic.npy'))
    env['PYTHONPATH'] = os.pathsep.join(
        [str(root / 'fake'), REPO, env.get('PYTHONPATH', '')])
    r = subprocess.run([sys.executable, '-m', module] + args, cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture
def fake_mic(run_dir, monkeypatch):
    """The stand-in sounddevice in sys.modules for the port's CLIs."""
    root = run_dir[0]
    spec = importlib.util.spec_from_file_location(
        'sounddevice', root / 'fake' / 'sounddevice.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setitem(sys.modules, 'sounddevice', mod)
    monkeypatch.setenv('EDD_FAKE_MIC', str(root / 'mic.npy'))


def _after_load_line(text):
    """stdout past the 'loaded <ckpt>' line (its path differs)."""
    lines = text.split('\n')
    assert lines[0].startswith('loaded '), lines[:2]
    return '\n'.join(lines[1:])


def test_stream_mic_equals_jax(run_dir, fake_mic, capsys):
    """cli.stream --mic --reset_after 2 over the stand-in microphone: the
    port prints what the JAX package's cli.stream prints (the text as it
    comes, '[Background]' at each silence reset) and resets as often."""
    root = run_dir[0]
    args = ['--mic', '--reset_after', '2'] + _common(root)
    want = _jax_cli(root, 'cli.stream', args)
    resets = []
    real_reset = StreamingDecoder.reset

    def counting_reset(self):
        resets.append(1)
        real_reset(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StreamingDecoder, 'reset', counting_reset)
        with pytest.raises(SystemExit) as e:
            p_stream.main(args + ['--device', 'cpu'])
    assert e.value.code == 0
    got = capsys.readouterr().out
    assert _after_load_line(got) == _after_load_line(want)
    n_background = got.count('[Background]')
    assert n_background > 0 and got.replace('[Background]', '').strip()
    assert len(resets) == 1 + n_background       # construction + silences


def test_mic_callback_beam_rerenders(run_dir):
    """A beam decoder (one with a `beam`) returns the full hypothesis: the
    line is re-rendered on a change and an unchanged hypothesis counts as
    silence."""
    dec = FakeDecoder(10, 10, ['a', 'ab', 'ab', 'ab', 'ab', 'x'], beam=True)
    out = []
    cb = p_stream.mic_callback(dec, 3, emit=lambda s, end='': out.append(s))
    cb(np.zeros((60, 1), np.float32), 60, None, None)
    assert out == ['\ra', '\rab', '\n[Background]', '\rx']
    assert dec.resets == 1


def test_demo_mic_and_path_equal_jax(run_dir, fake_mic, capsys):
    """cli.export then cli.demo --mic --demo_reset_step 4 over the stand-in
    microphone: the port's artifacts and demo print what the JAX
    package's print over its own artifacts of the same weights, with a
    reset every 4 chunks; demo --path prints the exported decoder's text
    of the wav."""
    root = run_dir[0]
    want = _jax_cli(root, 'cli.demo', ['--mic', '--demo_reset_step', '4']
                    + _common(root, 'logs_jax'))
    out_dir = p_export.main(_common(root) + ['--device', 'cpu'])
    printed = capsys.readouterr().out
    assert 'parity OK' in printed and printed.startswith('loaded ')
    assert sorted(os.listdir(out_dir)) == ['decoder.pt2', 'encoder.pt2',
                                           'joint.pt2', 'meta.json']
    resets = []
    real_reset = PE.ExportedStreamDecoder.reset

    def counting_reset(self):
        resets.append(1)
        real_reset(self)

    chunks = []
    real_decode = PE.ExportedStreamDecoder.decode

    def counting_decode(self, frame):
        chunks.append(1)
        return real_decode(self, frame)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PE.ExportedStreamDecoder, 'reset', counting_reset)
        mp.setattr(PE.ExportedStreamDecoder, 'decode', counting_decode)
        with pytest.raises(SystemExit):
            p_demo.main(['--mic', '--demo_reset_step', '4', '--device',
                         'cpu'] + _common(root))
    got = capsys.readouterr().out
    assert got == want and got.strip()
    assert len(chunks) > 8 and len(resets) == 1 + len(chunks) // 4

    p_demo.main(['--path', str(root / 'x.wav'), '--device', 'cpu']
                + _common(root))
    from edgedict_tpu_torch.data.audio_io import load_audio
    from edgedict_tpu_torch.export import build_exported_decoder
    flags = p_stream.parse_flags(p_export.build_parser('x'),
                                 _common(root) + ['--device', 'cpu'])
    dec = build_exported_decoder(flags)
    audio, _ = load_audio(str(root / 'x.wav'))
    n = (len(audio) - dec.win_size) // dec.hop_size + 1
    text = ''.join(dec.decode(audio[i * dec.hop_size:
                                    i * dec.hop_size + dec.win_size])
                   for i in range(n))
    assert capsys.readouterr().out == text + '\n' and text


def test_missing_audio_packages_raise_only_where_needed(run_dir,
                                                        monkeypatch,
                                                        capsys):
    """Without sounddevice, --mic raises ImportError and --path runs;
    without av / yt_dlp / youtube_dl, youtube_live --url raises
    ImportError and --wav runs."""
    root = run_dir[0]
    for name in ('sounddevice', 'av', 'yt_dlp', 'youtube_dl'):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        p_stream.main(['--mic', '--device', 'cpu'] + _common(root))
    p_stream.main(['--path', str(root / 'x.wav'), '--device', 'cpu']
                  + _common(root))
    with pytest.raises(ImportError):
        youtube_live_main(['--url', 'https://example.invalid/x',
                           '--device', 'cpu'] + _common(root))
    youtube_live_main(['--wav', str(root / 'x.wav'), '--device', 'cpu']
                      + _common(root))
    assert '[jit]' in capsys.readouterr().out


def test_youtube_live_wav_ab_live_equals_exported(run_dir, capsys):
    """youtube_live --wav with artifacts in the run: '[jit]' (the live
    decoder's decode_wav) == '[exported]' (the artifacts over the same
    chunks) in fp32."""
    root = run_dir[0]
    out = os.path.join(root, 'logs', 'tiny', 'export')
    if not os.path.isdir(out):
        p_export.main(_common(root) + ['--device', 'cpu'])
    capsys.readouterr()
    youtube_live_main(['--wav', str(root / 'x.wav'), '--device', 'cpu',
                       '--infer_dtype', 'fp32'] + _common(root))
    lines = dict(ln.split(' ', 1) for ln in
                 capsys.readouterr().out.splitlines()
                 if ln.startswith('[jit]') or ln.startswith('[exported]'))
    assert set(lines) == {'[jit]', '[exported]'}
    assert lines['[jit]'] == lines['[exported]'] and lines['[jit]'].strip()


def test_wav_inference_backends(run_dir, capsys):
    """cli.wav_inference --backends jit,exported,int8 --per_stage over a
    LibriSpeech-layout directory: one report line per backend with the
    JAX package's fields, the jit and exported hypotheses equal, the
    per-stage line with its four stages."""
    root = run_dir[0]
    p_export.main(_common(root) + ['--device', 'cpu'])
    capsys.readouterr()
    results = p_wav_inference.main(
        ['--wav_dir', str(root / 'wavs'), '--n_samples', '3', '--backends',
         'jit,exported,int8', '--per_stage', '--device', 'cpu',
         '--infer_dtype', 'fp32'] + _common(root))
    out = capsys.readouterr().out
    assert 'benchmarking 3 utterances' in out
    for backend in ('jit', 'int8', 'exported'):
        m = re.search(
            rf'\[{backend}\] WER (\d+\.\d+)  throughput (\d+\.\d+) '
            rf'sec/sec  mean chunk (\d+\.\d+) ms  \((\d+) utts, '
            rf'(\d+\.\d+)s audio\)', out)
        assert m, (backend, out)
        wer, rtf, ms, utts, audio_s = m.groups()
        assert 0.0 <= float(wer) <= 2.0 and float(rtf) > 0.0
        assert float(ms) > 0.0 and int(utts) == 3
        assert abs(float(audio_s) - 3.9) < 0.05       # 1.0 + 1.3 + 1.6 s
    assert results['jit'][2] == results['exported'][2]
    assert any(results['jit'][2])
    m = re.search(r'\[jit per-stage ms\] (.+)', out)
    assert m and all(s in m.group(1) for s in
                     ('featurize', 'encoder', 'joint', 'decoder'))
    with pytest.raises(SystemExit):
        p_wav_inference.main(['--backends', 'jit,onnx', '--device', 'cpu']
                             + _common(root))


def test_profile_components(run_dir):
    """StreamingDecoder.profile_components: the four stages in ms, the
    prediction net timed only where a token was emitted."""
    _, _, model, pcfg = run_dir
    dec = StreamingDecoder(model, pcfg, PFeat(**FKW), _Tok(), device='cpu')
    stages = dec.profile_components(_speechy(2.0, 3), max_chunks=8)
    assert list(stages) == ['featurize', 'encoder', 'joint', 'decoder']
    assert all(v >= 0.0 for v in stages.values())
    assert stages['featurize'] > 0 and stages['encoder'] > 0


# ---------------------------------------------------------------------------
# wer_parity against the JAX package's eval step
# ---------------------------------------------------------------------------

def _jax_wer(pt_path, corpus, tok_dir, batch, max_batches):
    """cli/wer_parity.py's loop of the JAX package, in this process: its
    make_eval_step + truncate_and_strip over its DataLoader."""
    from edgedict_tpu.compat import load_reference_checkpoint
    from edgedict_tpu.data import BucketSpec, DataLoader, Librispeech
    from edgedict_tpu.features import FeaturePipeline
    from edgedict_tpu.metrics import wer as wer_fn
    from edgedict_tpu.models.decoding import truncate_and_strip
    from edgedict_tpu.parallel import make_eval_step
    from edgedict_tpu.tokenizer import CharTokenizer
    tok = CharTokenizer(cache_dir=tok_dir)
    tok.load()
    feat = JFeat(feature_type='logfbank', feature_size=8, n_fft=256,
                 win_length=256, hop_length=128, downsample=3)
    cfg = JT.TransducerConfig(**KW)
    params = jax.tree.map(jnp.asarray,
                          load_reference_checkpoint(pt_path, cfg))
    loader = DataLoader(Librispeech(corpus, tok, audio_max_length=999),
                        batch, shuffle=False, bucket=BucketSpec(
                            t_multiple=8 * 384, u_multiple=16,
                            t_max=int(999 * 16000)),
                        drop_last=False, prefetch=0)
    eval_step = make_eval_step(cfg, mesh=None,
                               feature_pipeline=FeaturePipeline(feat))
    refs, hyps = [], []
    for i, b in enumerate(loader):
        if i >= max_batches:
            break
        _, y_seq, out_len = eval_step(params, b)
        hyps.extend(tok.decode_plus(truncate_and_strip(y_seq, out_len)))
        refs.extend(tok.decode_plus([y[:n] for y, n in zip(
            np.asarray(b['ys']), np.asarray(b['ylen']))]))
    pairs = [(r, h) for r, h in zip(refs, hyps) if r.strip()]
    return wer_fn([r for r, _ in pairs], [h for _, h in pairs]), \
        len(pairs), hyps


def test_wer_parity_equals_jax(tmp_path, run_dir, capsys):
    """cli.wer_parity on a tiny model saved as a reference-layout .pt and
    a LibriSpeech-layout mini corpus (--max_batches 2, eval batch 2): its
    JSON line == the JAX package's eval step + truncate_and_strip on the
    same weights and batches, hypothesis for hypothesis."""
    root = run_dir[0]
    pcfg = PT.TransducerConfig(**KW)
    model = PT.Transducer(pcfg, 'cpu', seed=7)
    with torch.no_grad():
        model.joint.out.bias[0] -= 2.0            # emit some text
        model.joint.out.bias[3] -= 100.0
    pt = str(tmp_path / 'ref.pt')
    torch.save({'model': model.state_dict()}, pt)
    corpus = tmp_path / 'test-clean' / '3' / '3'
    os.makedirs(corpus)
    lines = []
    for i in range(5):
        save_wav(str(corpus / f'3-3-{i:04d}.wav'),
                 _speechy(0.6 + 0.2 * i, 20 + i), 16000)
        lines.append(f'3-3-{i:04d} the quick brown fox {i}')
    (corpus / '3-3.trans.txt').write_text('\n'.join(lines) + '\n')
    args = ['--pt_path', pt, '--LibriSpeech_test',
            str(tmp_path / 'test-clean'), '--eval_batch_size', '2',
            '--audio_bucket_frames', '8', '--max_batches', '2',
            '--device', 'cpu', '--logdir_root', str(root / 'logs')] + TINY
    result, hyps = p_wer_parity.main(args)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    want_wer, want_n, want_hyps = _jax_wer(
        pt, str(tmp_path / 'test-clean'), str(root / 'logs' / 'char'), 2, 2)
    assert result['n_utts'] == want_n == 4
    assert hyps == want_hyps and any(hyps)
    assert result['wer'] == round(float(want_wer), 4)
    assert result['checkpoint'] == pt
