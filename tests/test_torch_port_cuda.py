"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and at the E6D2 main paths' shapes (serving: K1-K3, K5,
K11-K13; beam search: K1 at the prediction net's and the LM's B·W rows and
T = 1, K1/K4 at cli.train_lm's H=512 B=32 T=64; training: K1, K4, K5, K6
at H=1024 B=32 T=427 bf16; wav2vec pretraining's K1/K4 in fp32 at H=1024
B=32 T=297 and the raw fine-tune's K1/K4 bf16 at T=1597, K7-K10 at its
B=32 T=1597 U+1=65 lattice and K3 at its eval; K7/K8 in fp32
(FFMA products) and bf16 (tensor cores) at the E6D2 step, fp32 also at the
evals' B=32 T=214 U+1=65 and B=4 T=1437 U+1=33, K3's one launch
over the card at B up to 256, also at E6D2_LARGE_Batch's widths (2 x 512
prediction net, projection 640: chunks cut to the bytes) at B = 1, 4, 64, 256
with the cross-slice tie and NaN, K9/K10), K11's tiled kernels, the launch
plans' refusals, plus the
streaming decoder, a GRU train step, a wav2vec pretraining step and a raw
fine-tune step on CUDA against the CPU, the trainer's side-stream batch
prefetch, a background save of card tensors, the edgedict ops (K1,
K11, K12 through torch.library) and torch.export on the card, the
sharded multi-stream decoders (devices=[cuda:0, cuda:0]), and the
vocabulary-parallel joint (K7 / K8 once a slice) and tp = 2 / pp = 2
train steps on [cuda:0] * 2.  Marked `cuda`: every test skips where no
CUDA device is visible.  On a machine with a card (--noconftest keeps
tests/conftest.py, which configures JAX, out of a JAX-free run):

  python -m pytest tests/test_torch_port_cuda.py -q --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from edgedict_tpu_torch import features as F
from edgedict_tpu_torch import stream as S
from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.ops import decode_kernel as K3
from edgedict_tpu_torch.ops import features_kernel as K2
from edgedict_tpu_torch.ops import rnn_kernel as K1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device('cuda')


def _max_abs(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max()) \
        if a.numel() else 0.0


@pytest.mark.parametrize('hid,b,t,dtype', [
    (16, 3, 5, torch.float32), (1024, 1, 2, torch.float32),
    (1024, 8, 16, torch.float32), (1024, 8, 2, torch.bfloat16),
    (1024, 8, 16, torch.bfloat16),
    (256, 8, 1, torch.float32), (1030, 11, 3, torch.float32),
    # the persistent kernel's slabs of 32 rows (ragged B = 33, the server's
    # 256), E6D2_LARGE_Batch's H=512, one step, unaligned rows in bf16
    (1024, 33, 3, torch.bfloat16), (1024, 256, 2, torch.float32),
    (256, 256, 2, torch.bfloat16), (512, 8, 4, torch.bfloat16),
    (512, 33, 2, torch.float32), (1024, 4, 1, torch.bfloat16),
    (1024, 1, 2, torch.bfloat16), (1030, 11, 3, torch.bfloat16),
    # the CTC and legacy models' H=600 (not a multiple of the bf16 mma's
    # K of 16) over hundreds of steps, and the legacy greedy decode's T=1
    (600, 32, 214, torch.float32), (600, 32, 214, torch.bfloat16),
    (600, 1, 214, torch.float32), (600, 1, 214, torch.bfloat16),
    (600, 8, 1, torch.float32),
])
def test_k1_lstm_fwd_matches_plain(cuda, hid, b, t, dtype):
    g = torch.Generator(device='cpu').manual_seed(hid + b + t)
    k = 1.0 / hid ** 0.5
    xp = torch.randn(t, b, 4 * hid, generator=g).to(cuda, dtype)
    w = (torch.rand(4 * hid, hid, generator=g) * 2 * k - k).to(cuda, dtype)
    h0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    c0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    before = K1.lstm_recurrence.launches
    out = K1.lstm_recurrence(xp, w, h0, c0)
    ref = K1.lstm_recurrence_plain(xp, w, h0, c0)
    assert K1.lstm_recurrence.launches == before + 1
    assert out[0].dtype == dtype
    # free-running, bf16 drifts once a one-ulp flip of h's rounding feeds
    # the later steps
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(out, ref):
        assert _max_abs(a, r) <= tol
    # each step from the kernel's own carried state (ys[t-1] is h rounded
    # to x_proj's dtype, what the dot reads): cs to the fp32 bound, so fp32
    # h fed to a bf16 dot fails; bf16 ys within one ulp
    ys, cs, _ = out
    h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b, hid)
    c_prev = torch.cat([c0[None], cs[:-1]]).reshape(t * b, hid)
    step = K1.lstm_recurrence_plain(xp.reshape(1, t * b, 4 * hid), w,
                                    h_prev, c_prev)
    assert _max_abs(ys, step[0].reshape(ys.shape)) <= (
        1e-4 if dtype == torch.float32 else 1e-2)
    assert _max_abs(cs, step[1].reshape(cs.shape)) <= 1e-4


@pytest.mark.parametrize('b,n,n_fft,hop,mels', [
    (1, 1320, 512, 200, 80), (8, 1320, 512, 200, 80),
    (64, 1320, 512, 200, 80), (1, 64000, 512, 200, 80),
    (8, 64000, 512, 200, 80), (32, 256000, 512, 200, 80),
    (1, 257, 512, 200, 80), (1, 1399, 512, 200, 80), (3, 999, 64, 20, 8),
    # the padded pair table: the flags' default n_fft 400 (a 75 ms chunk
    # of 1,400 samples; the default train batch of 8 x 14 s), 320, and
    # the odd 511 (no Nyquist bin), in both splits
    (1, 1400, 400, 200, 128), (8, 224000, 400, 200, 128),
    (1, 1400, 400, 160, 80), (8, 224000, 400, 160, 80),
    (1, 1400, 320, 80, 40), (8, 224000, 320, 80, 40),
    (1, 1408, 511, 128, 80), (8, 224000, 511, 128, 80),
    (1, 6000, 2048, 512, 256), (8, 224000, 2048, 2048, 80),
])
def test_k2_mel_power_matches_plain(cuda, b, n, n_fft, hop, mels):
    """Both splits of ops/features_plan.py (few frames: chunks and servers;
    many: the train step's 32 x 16 s and 8 x 14 s), the shortest legal row,
    one off the hop grid, n_fft 400, 320, 511 and 2048: log-mel within
    5e-3 of the plain version computed in fp64 (on an H100 the fp32 one,
    cuFFT, differed from the kernel by 0.10 at n_fft 511 and 8 x 224,000,
    where the fp64 one agrees), one launch per call and the same bits on a
    second call."""
    import dataclasses
    cfg = F.FeatureConfig(feature_size=mels, n_fft=n_fft,
                          win_length=n_fft * 5 // 8, hop_length=hop)
    pipe = F.FeaturePipeline(cfg, cuda)
    x = torch.randn(b, n, generator=torch.Generator().manual_seed(n))
    x[:, : n // 4] *= 1e-4
    x = F.preemphasis(x.to(cuda))
    before = K2.mel_power.launches
    out = K2.mel_power(x, pipe.tables)
    again = K2.mel_power(x, pipe.tables)
    assert K2.mel_power.launches == before + 2
    t = pipe.tables
    ref = K2.mel_power_plain(x.double(), dataclasses.replace(
        t, window=t.window.double(), mel=t.mel.double()))
    assert out.shape == ref.shape == (b, 1 + n // hop, mels)
    diff = (torch.log(out + 1e-20) - torch.log(ref + 1e-20)).abs()
    assert float(diff.max()) <= 5e-3
    assert torch.equal(out, again)


@pytest.mark.parametrize('n_fft', [63, 4096])
def test_k2_refuses_n_fft_outside_its_plan(cuda, n_fft):
    """No fallback: a CUDA tensor at an n_fft the plan does not place raises
    ValueError naming mel_power, and launches nothing."""
    cfg = F.FeatureConfig(feature_size=40, n_fft=n_fft, win_length=n_fft,
                          hop_length=n_fft // 4)
    pipe = F.FeaturePipeline(cfg, cuda)
    before = K2.mel_power.launches
    with pytest.raises(ValueError, match='mel_power'):
        K2.mel_power(torch.zeros(1, 3 * n_fft, device=cuda), pipe.tables)
    assert K2.mel_power.launches == before


def test_k2_two_streams_keep_their_own_counters(cuda):
    """Few-frame calls issued on two streams without waiting for each other
    (each stream has its own tile counters) give the same bits as one call
    on the default stream."""
    cfg = F.FeatureConfig(feature_size=80, n_fft=512, win_length=320,
                          hop_length=200)
    pipe = F.FeaturePipeline(cfg, cuda)
    x = torch.randn(8, 1320, generator=torch.Generator().manual_seed(8))
    x = F.preemphasis(x.to(cuda))
    ref = K2.mel_power(x, pipe.tables)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    outs = [[], []]
    for _ in range(20):
        for s, out in zip(streams, outs):
            with torch.cuda.stream(s):
                out.append(K2.mel_power(x, pipe.tables))
    torch.cuda.synchronize(cuda)
    assert all(torch.equal(o, ref) for out in outs for o in out)


def _decoder_model(cuda, v, j, d, e, hid, layers, seed=1):
    cfg = T.TransducerConfig(vocab_size=v, vocab_embed_size=e,
                             enc_hidden_size=4, enc_layers=1,
                             enc_proj_size=j, dec_hidden_size=hid,
                             dec_layers=layers, dec_proj_size=d,
                             joint_size=j)
    return cfg, T.Transducer(cfg, cuda, seed=seed)


@pytest.mark.parametrize('v,j,d,e,hid,layers,b,t,emit_logp', [
    (40, 24, 16, 8, 16, 2, 3, 7, True),
    (2048, 640, 256, 64, 256, 2, 1, 16, False),
    (2048, 640, 256, 64, 256, 2, 8, 1, True),
    (100, 48, 20, 6, 12, 3, 2, 9, True),
])
def test_k3_greedy_decode_matches_plain(cuda, v, j, d, e, hid, layers, b, t,
                                        emit_logp):
    cfg, model = _decoder_model(cuda, v, j, d, e, hid, layers)
    with torch.no_grad():
        model.joint.out.bias[3] += 2.0                    # <unk> traffic
        h_dec, (hs, cs) = T.decoder_apply(
            model.decoder, cfg, torch.zeros((b, 0), dtype=torch.long,
                                            device=cuda))
    cache = K3.build_decode_cache(model)
    f = torch.randn(t, b, j, generator=torch.Generator().manual_seed(t)) \
        .to(cuda)
    args = (cache, f, h_dec[:, 0].contiguous(), hs, cs, 0, 3, emit_logp)
    out = K3.greedy_frame_loop(*args)
    ref = K3.greedy_frame_loop_plain(*args)
    assert torch.equal(out[0], ref[0])
    assert not (out[0] == 3).any()
    for a, r in zip(out[1:], ref[1:]):
        if r is not None:
            assert _max_abs(a, r) <= 1e-4


class _Tok:
    unk_id = 3

    def id_to_token(self, i):
        return chr(0x100 + int(i))


def _small_stream():
    cfg = T.TransducerConfig(vocab_size=64, vocab_embed_size=8,
                             input_size=24, enc_hidden_size=64, enc_layers=3,
                             enc_proj_size=32, dec_hidden_size=32,
                             dec_layers=2, dec_proj_size=32, joint_size=48)
    feat = F.FeatureConfig(feature_size=8, n_fft=64, win_length=40,
                           hop_length=20, downsample=3,
                           pad_to_divisible=False)
    model = T.Transducer(cfg, 'cpu', seed=2)
    with torch.no_grad():
        model.joint.out.weight *= 8.0
    audio = (np.random.RandomState(0).randn(6000) * 0.3).astype(np.float32)
    return cfg, feat, model, audio


def test_streaming_decode_cuda_equals_cpu(cuda):
    cfg, feat, model, audio = _small_stream()
    texts = []
    for device in ('cpu', 'cuda'):
        dec = S.StreamingDecoder(model, cfg, feat, _Tok(), device=device)
        texts.append((dec.decode_wav(audio), np.concatenate(dec.emitted)))
    assert texts[0][0] == texts[1][0]
    np.testing.assert_array_equal(texts[0][1], texts[1][1])
    ms = S.MultiStreamDecoder(model, cfg, feat, _Tok(), 2, device='cuda')
    frames = np.stack([audio[:ms.win_size], audio[:ms.win_size]])
    a, b = ms.decode(frames.astype(np.float32))
    assert a == b


def test_pipelined_fetch_on_cuda(cuda):
    """Lag-1 decoding through pinned host buffers and CUDA events gives
    the same text as the synchronous path."""
    cfg, feat, model, audio = _small_stream()
    dec = S.StreamingDecoder(model, cfg, feat, _Tok(), device='cuda',
                             block_chunks=4)
    n = len(S._chunks(audio, dec.win_size, dec.hop_size)) // 4 * 4
    whole = audio[:(n - 1) * dec.hop_size + dec.win_size]
    assert dec.decode_wav_pipelined(whole) == dec.decode_wav(whole)
    ms = S.MultiStreamDecoder(model, cfg, feat, _Tok(), 2, device='cuda')
    rounds = [np.stack([audio[i:i + ms.win_size]] * 2)
              for i in range(0, 5 * ms.hop_size, ms.hop_size)]
    sync = [ms.decode(r)[0] for r in rounds]
    ms.reset()
    piped = [ms.decode_pipelined(r) for r in rounds] + [ms.flush()]
    assert piped[0] is None
    assert [p[0] for p in piped[1:]] == sync


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_sharded_multistream_on_the_card_equals_one_device(cuda, quantize):
    """devices=['cuda:0', 'cuda:0']: two replicas of 2 streams, each step
    under its device guard, give the one-device decoder's text (greedy and
    a W=2 beam)."""
    cfg, feat, model, audio = _small_stream()
    audios = [np.roll(audio, 500 * s) for s in range(4)]
    for cls, kw in ((S.MultiStreamDecoder, {}),
                    (S.MultiStreamBeamDecoder, dict(beam_width=2))):
        outs = []
        for where in (dict(device='cuda'),
                      dict(devices=['cuda:0', 'cuda:0'])):
            dec = cls(model, cfg, feat, _Tok(), 4, quantize=quantize,
                      **where, **kw)
            n = len(S._chunks(audio, dec.win_size, dec.hop_size))
            outs.append([dec.decode(np.stack(
                [a[i * dec.hop_size:i * dec.hop_size + dec.win_size]
                 for a in audios])) for i in range(n)])
        assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# beam search: K1 at the prediction net's and the LM's rows (B·W, T = 1),
# K1 + K4 at cli.train_lm's step, the beam decoders on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('hid,b,dtype', [
    (256, 4, torch.float32),      # E6D2's prediction net, W=4, one stream
    (256, 16, torch.float32),     # the trainer's beam eval (batch 4)
    (256, 32, torch.float32),     # the 8-stream beam server
    (512, 4, torch.float32),      # the LM (LMConfig's defaults)
    (512, 4, torch.bfloat16),     # the LM under bf16 serving
    (512, 32, torch.float32),     # the LM of the 8-stream beam server
])
def test_k1_beam_step_shapes_match_plain_and_are_bit_stable(cuda, hid, b,
                                                            dtype):
    g = torch.Generator(device='cpu').manual_seed(hid + b)
    k = 1.0 / hid ** 0.5
    xp = torch.randn(1, b, 4 * hid, generator=g).to(cuda, dtype)
    w = (torch.rand(4 * hid, hid, generator=g) * 2 * k - k).to(cuda, dtype)
    h0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    c0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    before = K1.lstm_recurrence.launches
    out = K1.lstm_recurrence(xp, w, h0, c0)
    again = K1.lstm_recurrence(xp, w, h0, c0)
    ref = K1.lstm_recurrence_plain(xp, w, h0, c0)
    assert K1.lstm_recurrence.launches == before + 2
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, c, r in zip(out, again, ref):
        assert torch.equal(a, c)
        assert _max_abs(a, r) <= tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k1_k4_train_lm_shape_match_plain_and_are_bit_stable(cuda, dtype):
    """cli.train_lm's step at LMConfig's defaults: H=512, B=32, T=64."""
    from edgedict_tpu_torch.ops import rnn_kernel as K
    hid, b, t = 512, 32, 64
    g = torch.Generator(device='cpu').manual_seed(7)
    k = 1.0 / hid ** 0.5
    xp = torch.randn(t, b, 4 * hid, generator=g).to(cuda, dtype)
    w = (torch.rand(4 * hid, hid, generator=g) * 2 * k - k).to(cuda, dtype)
    h0 = torch.zeros(b, hid, device=cuda)
    c0 = torch.zeros(b, hid, device=cuda)
    out = K.lstm_recurrence(xp, w, h0, c0)
    again = K.lstm_recurrence(xp, w, h0, c0)
    ref = K.lstm_recurrence_plain(xp, w, h0, c0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, c, r in zip(out, again, ref):
        assert torch.equal(a, c)
        assert _max_abs(a, r) <= tol
    ys, cs, _ = out
    dys = torch.randn(t, b, hid, generator=g).to(cuda, dtype)
    bwd = K.lstm_recurrence_bwd(xp, w, h0, c0, ys, cs, dys, None, None)
    bwd2 = K.lstm_recurrence_bwd(xp, w, h0, c0, ys, cs, dys, None, None)
    bref = K.lstm_recurrence_bwd_plain(xp, w, h0, c0, ys, cs, dys, None,
                                       None)
    for a, c, r in zip(bwd, bwd2, bref):
        assert torch.equal(a, c)
        assert _rel_err(a, r) <= tol


def test_beam_decoders_cuda_equal_cpu(cuda):
    """The streaming beam decoder with LM fusion on the card gives the
    CPU run's text; the multi-stream one at 2 streams agrees with it."""
    from edgedict_tpu_torch.models.lm import LMConfig, LMModel
    cfg, feat, model, audio = _small_stream()
    lm_model = LMModel(LMConfig(vocab_size=cfg.vocab_size, embed_size=16,
                                hidden_size=32), 'cpu', seed=3)
    lm = (lm_model, lm_model.cfg, 0.05)
    texts = {}
    for device in ('cpu', 'cuda'):
        dec = S.StreamingBeamDecoder(model, cfg, feat, _Tok(), device=device,
                                     beam_width=4, lm=lm)
        texts[device] = dec.decode_wav(audio)
        assert dec.beam.logp.device.type == device
    assert texts['cuda'] == texts['cpu'] and texts['cpu']
    ms = S.MultiStreamBeamDecoder(model, cfg, feat, _Tok(), 2, device='cuda',
                                  beam_width=4, lm=lm)
    for i in range(len(S._chunks(audio, ms.win_size, ms.hop_size))):
        frame = audio[i * ms.hop_size:i * ms.hop_size + ms.win_size]
        out = ms.decode(np.stack([frame, frame]))
    assert out == [texts['cpu']] * 2


# ---------------------------------------------------------------------------
# training kernels: K4 (LSTM backward), K7/K8 (fused joint), K9/K10 (lattice)
# ---------------------------------------------------------------------------

def _rel_err(a, b):
    """max |a - b| over max(1, max |b|)."""
    b = b.float()
    scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
    return _max_abs(a, b) / scale


# the E6D2 shapes (encoder H=1024 at B=32 T=427 in bf16, prediction net
# H=256), B = 1 and a ragged B = 33, odd H, and each cotangent absent
BWD_CASES = [
    (16, 3, 5, torch.float32, 'all'), (1024, 8, 16, torch.float32, 'all'),
    (1024, 8, 16, torch.bfloat16, 'all'), (256, 8, 65, torch.float32, 'all'),
    (1030, 11, 3, torch.float32, 'all'), (64, 2, 1, torch.bfloat16, 'all'),
    (1024, 32, 427, torch.bfloat16, 'all'),
    (1024, 1, 16, torch.bfloat16, 'all'), (1024, 1, 5, torch.float32, 'all'),
    (1024, 33, 8, torch.bfloat16, 'all'), (256, 33, 6, torch.float32, 'all'),
    (1030, 11, 3, torch.bfloat16, 'all'), (40, 5, 7, torch.bfloat16, 'dys'),
    (1024, 8, 6, torch.float32, 'dys'), (1024, 8, 6, torch.bfloat16, 'dhT'),
    (64, 33, 4, torch.float32, 'dhT'),
    # the CTC and legacy models' H=600 over hundreds of steps
    (600, 32, 214, torch.float32, 'all'),
    (600, 32, 214, torch.bfloat16, 'all'),
    (600, 1, 214, torch.float32, 'all'), (600, 1, 214, torch.bfloat16, 'all'),
]


def _cotangents(cot, dys, dcs, dhT):
    """'all' keeps every cotangent, 'dys' only dys, 'dhT' only dhT."""
    return (dys if cot in ('all', 'dys') else None,
            dcs if cot == 'all' else None,
            dhT if cot in ('all', 'dhT') else None)


@pytest.mark.parametrize('hid,b,t,dtype,cot', BWD_CASES)
def test_k4_lstm_bwd_matches_plain(cuda, hid, b, t, dtype, cot):
    from edgedict_tpu_torch.ops import rnn_kernel as K
    g = torch.Generator(device='cpu').manual_seed(hid + b + t)
    k = 1.0 / hid ** 0.5
    xp = torch.randn(t, b, 4 * hid, generator=g).to(cuda, dtype)
    w = (torch.rand(4 * hid, hid, generator=g) * 2 * k - k).to(cuda, dtype)
    h0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    c0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    ys, cs, _ = K.lstm_recurrence(xp, w, h0, c0)
    dys = torch.randn(t, b, hid, generator=g).to(cuda, dtype)
    dcs = torch.zeros_like(cs)
    dcs[-1] = torch.randn(b, hid, generator=g).to(cuda)
    dhT = torch.randn(b, hid, generator=g).to(cuda)
    cots = _cotangents(cot, dys, dcs, dhT)
    before = K.lstm_recurrence_bwd.launches
    out = K.lstm_recurrence_bwd(xp, w, h0, c0, ys, cs, *cots)
    assert K.lstm_recurrence_bwd.launches == before + 1
    ref = K.lstm_recurrence_bwd_plain(xp, w, h0, c0, ys, cs, *cots)
    assert out[0].dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(out, ref):
        assert _rel_err(a, r) <= tol
    # through the autograd.Function: K1 forward, K4 backward, dW matmul
    xq = xp.clone().requires_grad_()
    wq = w.clone().requires_grad_()
    ys2, _, _ = K.lstm_recurrence(xq, wq, h0, c0)
    ys2.backward(dys)
    dg = K.lstm_recurrence_bwd_plain(xp, w, h0, c0, ys, cs, dys, None,
                                     None)[0].float()
    dw_ref = dg[0].t() @ h0.to(dtype).float()
    if t > 1:
        dw_ref = dw_ref + dg[1:].reshape(-1, 4 * hid).t() @ \
            ys[:-1].reshape(-1, hid).float()
    assert xq.grad.shape == xp.shape and _rel_err(wq.grad, dw_ref) <= (
        1e-3 if dtype == torch.float32 else 5e-2)


def _joint_case(cuda, b, t, u1, j, v, dtype, seed):
    g = torch.Generator(device='cpu').manual_seed(seed)
    f = torch.randn(b, t, j, generator=g).to(cuda, dtype)
    gg = torch.randn(b, u1, j, generator=g).to(cuda, dtype)
    w_t = (torch.randn(j, v, generator=g) / j ** 0.5).to(cuda)
    bias = (torch.randn(v, generator=g) * 0.1).to(cuda)
    labels = torch.randint(1, v, (b, u1 - 1), generator=g,
                           dtype=torch.int32).to(cuda)
    db = torch.randn(b, t, u1, generator=g).to(cuda)
    dl = torch.randn(b, t, u1 - 1, generator=g).to(cuda)
    return f, gg, w_t, bias, labels, db, dl


@pytest.mark.parametrize('b,t,u1,j,v,dtype', [
    (2, 5, 7, 16, 32, torch.float32), (3, 9, 4, 40, 300, torch.float32),
    (2, 20, 65, 640, 2048, torch.float32),
    (2, 20, 65, 640, 2048, torch.bfloat16),
    (1, 3, 300, 64, 200, torch.float32), (1, 2, 700, 24, 50, torch.float32),
    (3, 9, 4, 40, 300, torch.bfloat16), (1, 4, 300, 1000, 70, torch.bfloat16),
    (2, 6, 33, 768, 400, torch.bfloat16), (2, 5, 17, 64, 48, torch.bfloat16),
    # fp32 on the CUDA cores: U+1 = 1 (64 x 1 tiles), U+1 = 1100, and
    # J = 1000 (padded to 1008: h through the slab scratch in K7)
    (2, 37, 1, 48, 80, torch.float32), (2, 6, 1100, 640, 2048, torch.float32),
    (1, 4, 300, 1000, 70, torch.float32),
])
def test_k7_k8_fused_joint_matches_plain(cuda, b, t, u1, j, v, dtype):
    from edgedict_tpu_torch.ops import joint_lse_kernel as K
    f, g, w_t, bias, labels, db, dl = _joint_case(cuda, b, t, u1, j, v,
                                                  dtype, b * t + u1)
    leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
    before = (K.joint_lse_fwd.launches, K.joint_lse_bwd.launches)
    out = K.fused_joint_lse(*leaves, labels, 0)
    ((out[0] * db).sum() + (out[1] * dl).sum()).backward()
    assert (K.joint_lse_fwd.launches, K.joint_lse_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref_leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
    ref = K.fused_joint_lse_plain(*ref_leaves, labels, 0)
    ((ref[0] * db).sum() + (ref[1] * dl).sum()).backward()
    for a, r in zip(out, ref):
        assert a.shape == r.shape
        if r.numel():               # label_lp is empty at U+1 = 1
            scale = max(1.0, float(r.detach().abs().max()))
            assert _max_abs(a, r) <= 1e-4 * scale
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(leaves, ref_leaves):
        assert a.grad.dtype == r.grad.dtype
        assert _rel_err(a.grad, r.grad) <= tol


def _k8_case(cuda, b, t, u1, j, v, seed, dtype=torch.bfloat16):
    """joint_lse_bwd (the slab plan, in `dtype`) and the plain version's
    gradients from the same inputs and K7's lse → (grads, ref grads)."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as K
    f, g, w_t, bias, labels, db, dl = _joint_case(
        cuda, b, t, u1, j, v, dtype, seed)
    wt_e = w_t.to(dtype)
    lse = K.joint_lse_fwd(f, g, wt_e, bias, labels, 0)[2]
    before = K.joint_lse_bwd.launches
    grads = K.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse, db, dl)
    assert K.joint_lse_bwd.launches == before + 1
    leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
    ref = K.fused_joint_lse_plain(*leaves, labels, 0)
    ref_g = torch.autograd.grad(ref, leaves, (db, dl))
    return grads, ref_g, (f, g, wt_e, bias, labels, lse, db, dl)


@pytest.mark.parametrize('b,t,u1,j,v', [
    (32, 214, 65, 640, 2048),     # the E6D2 training step
    (3, 13, 11, 64, 128),         # T, U+1 not multiples of the 8 x 8 tile
    (2, 37, 1, 48, 80),           # U+1 = 1: 64 x 1 tiles
    (2, 6, 1100, 640, 2048),      # U+1 = 1100
    (2, 6, 33, 768, 400),         # J, V not multiples of 128
])
def test_k8_tensor_core_backward_matches_plain(cuda, b, t, u1, j, v):
    """K8's tensor-core path within 2e-2 of max(1, |ref|) (bf16 h and
    dlogits feed the products); dW and dbias the same bits on a second
    call (fixed-order partial sums)."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as K
    grads, ref_g, args = _k8_case(cuda, b, t, u1, j, v, b + t + u1)
    for a, r in zip(grads, ref_g):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert _rel_err(a, r) <= 2e-2
    again = K.joint_lse_bwd(*args[:5], 0, *args[5:])
    assert torch.equal(again[2], grads[2]) and torch.equal(again[3], grads[3])


def test_k8_crosses_slab_boundaries(cuda, monkeypatch):
    """Slabs of two tiles (five slabs, the last one a single tile) give
    the one-slab gradients."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as K
    from edgedict_tpu_torch.ops import joint_lse_plan as P
    b, t, u1, j, v = 3, 17, 5, 64, 96
    whole, ref_g, args = _k8_case(cuda, b, t, u1, j, v, 5)
    monkeypatch.setattr(P, 'SLAB_BYTES', 1)
    plan = P.bwd_plan(b, t, u1, j, v, 132)
    assert plan.slab_tiles == 2 and plan.slabs > 2 and plan.tiles % 2 == 1
    sliced = K.joint_lse_bwd(*args[:5], 0, *args[5:])
    for a, w, r in zip(sliced, whole, ref_g):
        assert _rel_err(a, r) <= 2e-2
        assert _max_abs(a, w) <= 1e-5 * max(1.0, float(w.abs().max()))


def test_k8_wide_joint_with_one_label_slot_matches_plain(cuda):
    """J = 4096 at U+1 = 1 (64 x 1 tiles): the h launch stages f and g in
    column chunks, so the plan takes any J."""
    grads, ref_g, _ = _k8_case(cuda, 2, 200, 1, 4096, 256, 1)
    for a, r in zip(grads, ref_g):
        assert _rel_err(a, r) <= 2e-2


@pytest.mark.parametrize('b,t,u1,j,v', [
    (32, 214, 65, 640, 2048),     # the E6D2 step (--bf16 false) and eval
    (4, 1437, 33, 640, 2048),     # the raw fine-tune's eval
    (3, 13, 11, 64, 128),         # T, U+1 not multiples of the 8 x 8 tile
    (2, 37, 1, 48, 80),           # U+1 = 1: 64 x 1 tiles
    (2, 6, 1100, 640, 2048),      # U+1 = 1100
    (2, 6, 33, 768, 400),         # J, V not multiples of 128
    (1, 4, 300, 1000, 70),        # J, V padded to 16
])
def test_k8_fp32_backward_matches_plain_and_is_bit_stable(cuda, b, t, u1, j,
                                                          v):
    """K8 in fp32 (FFMA products, dlogits not rounded) within 1e-4 of
    max(1, |ref|) of the plain gradients, all four the same bits on a
    second call (fixed-order partial sums, no atomics)."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as K
    grads, ref_g, args = _k8_case(cuda, b, t, u1, j, v, b + t + u1,
                                  torch.float32)
    for a, r in zip(grads, ref_g):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert _rel_err(a, r) <= 1e-4
    again = K.joint_lse_bwd(*args[:5], 0, *args[5:])
    assert all(torch.equal(a, c) for a, c in zip(again, grads))


@pytest.mark.parametrize('b,t,u1,j,v', [(32, 214, 65, 640, 2048),
                                        (3, 13, 11, 64, 128)])
def test_k8_bf16_gradients_are_bit_stable(cuda, b, t, u1, j, v):
    """bf16 K8's df and dg (per-tile partials added in tile order) as well
    as dW and dbias are the same bits on a second call."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as K
    grads, _, args = _k8_case(cuda, b, t, u1, j, v, 7)
    again = K.joint_lse_bwd(*args[:5], 0, *args[5:])
    assert all(torch.equal(a, c) for a, c in zip(again, grads))


def test_k8_fp32_crosses_slab_boundaries(cuda, monkeypatch):
    """fp32 slabs of two tiles (the last one a single tile) give the
    one-slab gradients."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as K
    from edgedict_tpu_torch.ops import joint_lse_plan as P
    b, t, u1, j, v = 3, 17, 5, 64, 96
    whole, ref_g, args = _k8_case(cuda, b, t, u1, j, v, 5, torch.float32)
    monkeypatch.setattr(P, 'SLAB_BYTES', 1)
    plan = P.bwd_plan(b, t, u1, j, v, 132, 4)
    assert plan.slab_tiles == 2 and plan.slabs > 2 and plan.tiles % 2 == 1
    sliced = K.joint_lse_bwd(*args[:5], 0, *args[5:])
    for a, w, r in zip(sliced, whole, ref_g):
        assert _rel_err(a, r) <= 1e-4
        assert _max_abs(a, w) <= 1e-5 * max(1.0, float(w.abs().max()))


def _traced(case):
    """{'kernels': [(name, grid)] of the device kernels of one call, by
    torch.profiler in this process, 'blocks': K3's planned grid or None} for
    `case`: (cell, dtype name) for K1 / K5 at H=256 B=8 T=16, ('k7',) for
    bf16 K7 at the E6D2 joint (J 640, V 2048), ('k3',) for K3 at E6D2's
    decoder widths, B=1 T=16, ('k12', dtype name) for K12 at H=1024 B=1
    T=16, ('k13', dtype name) for K13 at the same shape, ('k9',) and
    ('k10',) for K9 and K10 at the E6D2 lattice (B=32 T=214 U+1=65),
    ('k2',) for K2 at a 75 ms chunk, ('k2', B, L, n_fft, hop, window) at
    that shape."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    cuda, blocks = torch.device('cuda'), None
    if case[0] in ('LSTM', 'GRU'):
        from edgedict_tpu_torch.ops import gru_kernel as K5
        args = _fwd_case(cuda, case[0], 256, 8, 16, getattr(torch, case[1]),
                         16)
        fn = K1.lstm_recurrence if case[0] == 'LSTM' else K5.gru_recurrence
    elif case[0] == 'k12':
        from edgedict_tpu_torch.ops import quant as Q
        xp, w, h0, c0 = _fwd_case(cuda, 'LSTM', 1024, 1, 16,
                                  getattr(torch, case[1]), 12)
        q, sc = Q.quantize_int8(w.float())
        args, fn = (xp, q, sc, h0, c0), Q.lstm_recurrence_q
    elif case[0] == 'k13':
        from edgedict_tpu_torch.ops import quant as Q
        xp, w, b_hh, h0 = _fwd_case(cuda, 'GRU', 1024, 1, 16,
                                    getattr(torch, case[1]), 13)
        q, sc = Q.quantize_int8(w.float())
        args, fn = (xp, q, sc, b_hh, h0), Q.gru_recurrence_q
    elif case[0] == 'k9':
        from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
        args = _lattice_case(cuda, 32, 214, 65, 'mixed')
        fn = KL.lattice_alpha
    elif case[0] == 'k10':
        from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
        blank, label, xlen, ylen = _lattice_case(cuda, 32, 214, 65, 'mixed')
        alpha, logz = KL.lattice_alpha(blank, label, xlen, ylen)
        args = (blank, label, alpha, logz, xlen, ylen)
        fn = KL.lattice_beta_grad
    elif case[0] == 'k2':
        b, n, n_fft, hop, win = case[1:] or (1, 1320, 512, 200, 320)
        cfg = F.FeatureConfig(feature_size=80, n_fft=n_fft, win_length=win,
                              hop_length=hop)
        x = torch.randn(b, n, generator=torch.Generator().manual_seed(2))
        args = (x.to(cuda), F.FeaturePipeline(cfg, cuda).tables)
        fn = K2.mel_power
    elif case[0] == 'k7':
        from edgedict_tpu_torch.ops import joint_lse_kernel as K
        f, g, w_t, bias, labels, _, _ = _joint_case(
            cuda, 2, 20, 65, 640, 2048, torch.bfloat16, 3)
        args, fn = (f, g, w_t.bfloat16(), bias, labels, 0), K.joint_lse_fwd
    else:
        cfg, model = _k3_model(cuda, 1.8)
        cache = K3.build_decode_cache(model)
        args = (cache, *_k3_args(cuda, cfg, model, 1, 16, 5), 0, 3, False)
        fn = K3.greedy_frame_loop
        blocks = K3.card_plan(cache, args[1], args[3]).blocks
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    return {'kernels': [(e['name'], e.get('args', {}).get('grid'))
                        for e in trace['traceEvents']
                        if e.get('cat') == 'kernel'],
            'blocks': blocks}


def _kernel_events(case):
    """_traced(case) in a fresh interpreter.  In the long pytest process on
    the card machine, torch.profiler recorded no kernel of some calls, on
    repeated runs too, where a fresh process recorded every launch
    (PERF.md §7)."""
    import json
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f'import json, sys; sys.path[:0] = [{here!r}, '
            f'{os.path.dirname(here)!r}]; import test_torch_port_cuda as t; '
            f'print(json.dumps(t._traced({case!r})))')
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('b,t,u1,j,v,dtype,staged', [
    (32, 214, 65, 640, 2048, torch.bfloat16, False),  # E6D2 step, resident
    (32, 214, 65, 640, 2048, torch.bfloat16, True),   # through the scratch
    (33, 214, 65, 640, 2048, torch.bfloat16, False),  # ragged B
    (4, 50, 1, 640, 2048, torch.bfloat16, False),     # U+1 = 1
    (2, 20, 300, 640, 2048, torch.bfloat16, False),   # U+1 = 300
    (2, 6, 1100, 640, 2048, torch.bfloat16, False),   # U+1 = 1100
    (2, 9, 33, 600, 2000, torch.bfloat16, False),     # J, V padded to 16
    (2, 6, 33, 768, 400, torch.bfloat16, False),      # wide J: staged
    (2, 20, 65, 640, 2048, torch.float32, False),     # CUDA cores
    (32, 214, 65, 640, 2048, torch.float32, False),   # E6D2 eval, fp32
    (4, 1437, 33, 640, 2048, torch.float32, False),   # raw fine-tune eval
    (32, 214, 65, 640, 2048, torch.float32, True),    # fp32 through scratch
    (2, 6, 33, 768, 400, torch.float32, False),       # fp32 wide J: staged
    (4, 50, 1, 640, 2000, torch.float32, False),      # U+1 = 1, V padded
])
def test_k7_forward_matches_plain_and_is_bit_stable(cuda, b, t, u1, j, v,
                                                    dtype, staged):
    """K7 within 1e-4 of max(1, |ref|) of its plain version (blank and
    label log-probs and the logsumexp), labels equal to blank included,
    one count per call, and the same bits on a second call."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as K
    f, g, w_t, bias, labels, _, _ = _joint_case(cuda, b, t, u1, j, v, dtype,
                                                b + t + u1 + j)
    labels[:, ::3] = 0
    wt_e = w_t.to(dtype)
    before = K.joint_lse_fwd.launches
    out = K.joint_lse_fwd(f, g, wt_e, bias, labels, 0, staged)
    assert K.joint_lse_fwd.launches == before + 1
    again = K.joint_lse_fwd(f, g, wt_e, bias, labels, 0, staged)
    ref = K.fused_joint_lse_plain(f, g, w_t, bias, labels, 0)
    h = torch.tanh(f.float()[:, :, None] + g.float()[:, None])
    lse = torch.logsumexp(h.to(dtype).float() @ wt_e.float() + bias, -1)
    del h
    for a, r in zip(out, (*ref, lse)):
        assert a.shape == r.shape
        if r.numel():
            assert _max_abs(a, r) <= 1e-4 * max(1.0, float(r.abs().max()))
    assert all(torch.equal(a, c) for a, c in zip(out, again))


def test_k7_resident_path_is_one_launch(cuda):
    """At the E6D2 joint (J = 640) the bf16 forward is one launch of the
    resident kernel and no h launch."""
    names = [n for n, _ in _kernel_events(('k7',))['kernels']
             if 'joint_lse' in n]
    assert len(names) == 1 and 'joint_lse_fwd_mma_kernel' in names[0]


def _k3_model(cuda, blank_bias, seed=1, hid=256, d=256):
    """E6D2's joint and prediction net (V 2048, J 640, 2 x 256 LSTM, D 256,
    E 64; E6D2_LARGE_Batch's with hid 512, d 640) with seeded random
    weights; blank biased by `blank_bias`, and <unk> (3) by 4 where blank
    is not."""
    cfg, model = _decoder_model(cuda, 2048, 640, d, 64, hid, 2, seed)
    with torch.no_grad():
        model.joint.out.bias[0] += blank_bias
        model.joint.out.bias[3] += 0.0 if blank_bias else 4.0
    return cfg, model


def _k3_args(cuda, cfg, model, b, t, seed):
    with torch.no_grad():
        h_dec, (hs, cs) = T.decoder_apply(
            model.decoder, cfg, torch.zeros((b, 0), dtype=torch.long,
                                            device=cuda))
    f = torch.randn(t, b, 640, generator=torch.Generator().manual_seed(
        seed)).to(cuda)
    return f, h_dec[:, 0].contiguous(), hs, cs


def _k3_check(out, ref):
    assert torch.equal(out[0], ref[0])
    for a, r in zip(out[1:], ref[1:]):
        if r is not None:
            both_nan = torch.isnan(a) & torch.isnan(r)
            assert torch.equal(torch.isnan(a), torch.isnan(r))
            assert _max_abs(a[~both_nan], r[~both_nan]) <= 1e-4


@pytest.mark.parametrize('blank_bias', [0.0, 1.8, 6.0])
@pytest.mark.parametrize('t', [1, 16, 214])
@pytest.mark.parametrize('b', [1, 8, 64, 256])
def test_k3_one_launch_over_the_card_matches_plain(cuda, b, t, blank_bias):
    """K3 at E6D2's widths: tokens equal to the plain loop's, log-probs and
    state within 1e-4, <unk> re-argmaxed; blank bias 0 (every frame
    emits), 1.8 (about half), 6 (all blank)."""
    cfg, model = _k3_model(cuda, blank_bias)
    cache = K3.build_decode_cache(model)
    args = (cache, *_k3_args(cuda, cfg, model, b, t, b + t), 0, 3, True)
    before = K3.greedy_frame_loop.launches
    out = K3.greedy_frame_loop(*args)
    assert K3.greedy_frame_loop.launches == before + 1
    ref = K3.greedy_frame_loop_plain(*args)
    _k3_check(out, ref)
    assert not (out[0] == 3).any()
    if blank_bias == 6.0:
        assert (out[0] == 0).all()


@pytest.mark.parametrize('case', ['tie', 'nan'])
def test_k3_cross_slice_tie_and_nan(cuda, case):
    """Column 100 (another block's slice) made equal to column 5 and both
    lifted: the token is 5 every frame; a NaN logit at column 2000 (a
    later slice) is the token every frame with a NaN log-prob."""
    _k3_cross_slice(cuda, case, 256, 256)


@pytest.mark.parametrize('case', ['tie', 'nan'])
def test_k3_large_cross_slice_tie_and_nan(cuda, case):
    """The same at E6D2_LARGE_Batch's widths."""
    _k3_cross_slice(cuda, case, 512, 640)


def _k3_cross_slice(cuda, case, hid, d):
    cfg, model = _k3_model(cuda, 0.0, hid=hid, d=d)
    cache = K3.build_decode_cache(model)
    plan = K3.card_plan(cache, torch.zeros(1, 3, 640, device=cuda),
                        torch.zeros(2, 3, hid, device=cuda))
    from edgedict_tpu_torch.ops import decode_plan as DP
    assert plan.smem == 4 * DP.layout_floats(
        3, 640, 2048, 64, 2, hid, d, plan.blocks, plan.stream_chunk,
        plan.part_chunk)[0]
    slice_of = [g for g in range(plan.blocks)
                if DP.split(2048, g, plan.blocks) <= 100
                < DP.split(2048, g + 1, plan.blocks)]
    assert slice_of[0] > 0
    if case == 'tie':
        cache['w_out_t'][:, 100] = cache['w_out_t'][:, 5]
        cache['b_out'][5] += 30.0
        cache['b_out'][100] = cache['b_out'][5]
        want = 5
    else:
        cache['b_out'][2000] = float('nan')
        want = 2000
    args = (cache, *_k3_args(cuda, cfg, model, 3, 6, 7), 0, 3, True)
    out = K3.greedy_frame_loop(*args)
    ref = K3.greedy_frame_loop_plain(*args)
    _k3_check(out, ref)
    assert (out[0] == want).all()
    assert torch.isnan(out[1]).all() == (case == 'nan')


@pytest.mark.parametrize('blank_bias', [0.0, 1.8, 6.0])
@pytest.mark.parametrize('b,t', [(1, 1), (1, 16), (4, 1), (4, 214), (64, 1),
                                 (64, 16), (256, 1), (256, 16)])
def test_k3_large_matches_plain(cuda, b, t, blank_bias):
    """K3 at E6D2_LARGE_Batch's widths (2 x 512 prediction net, projection
    640, J 640, V 2048, E 64): B = 1 (a stream), 4 (its eval batch,
    T = 214 a whole utterance), 64 and 256 (servers; at 256 the partials'
    and the stream chunk cut to the bytes left: 8 and 160); tokens equal to
    the plain loop's, log-probs and state within 1e-4, one launch."""
    cfg, model = _k3_model(cuda, blank_bias, hid=512, d=640)
    cache = K3.build_decode_cache(model)
    args = (cache, *_k3_args(cuda, cfg, model, b, t, b + t), 0, 3, True)
    plan = K3.card_plan(cache, args[1], args[3])
    assert (plan.part_chunk, plan.stream_chunk) == (
        (8, 160) if b == 256 else (min(b, 16), b))
    before = K3.greedy_frame_loop.launches
    out = K3.greedy_frame_loop(*args)
    assert K3.greedy_frame_loop.launches == before + 1
    ref = K3.greedy_frame_loop_plain(*args)
    _k3_check(out, ref)
    assert not (out[0] == 3).any()
    if blank_bias == 6.0:
        assert (out[0] == 0).all()


def _lattice_case(cuda, b, t, u1, edge):
    """Seeded blank / label log-probs (B, T, U+1), (B, T, U) and lengths on
    the card: 'mixed' ragged (xlen within 5 of T, any ylen), 'xlen0' the
    first utterance empty, 'full' xlen = T and ylen = U."""
    g = torch.Generator(device='cpu').manual_seed(b * t + u1)
    logits = torch.randn(b, t, u1, 2, generator=g)
    lp = logits - torch.logsumexp(logits, -1, keepdim=True)
    blank = lp[..., 0].contiguous().to(cuda)
    label = lp[:, :, :u1 - 1, 1].contiguous().to(cuda)
    xlen = torch.full((b,), t, dtype=torch.int32)
    ylen = torch.full((b,), u1 - 1, dtype=torch.int32)
    if edge == 'mixed':
        xlen = torch.randint(max(1, t - 5), t + 1, (b,), generator=g,
                             dtype=torch.int32)
        ylen = torch.randint(0, u1, (b,), generator=g, dtype=torch.int32)
    elif edge == 'xlen0':
        xlen[0], ylen[0] = 0, 0
    return blank, label, xlen.to(cuda), ylen.to(cuda)


@pytest.mark.parametrize('b,t,u1,edge', [
    (4, 30, 20, 'mixed'), (3, 7, 1, 'full'), (2, 12, 9, 'xlen0'),
    (32, 214, 65, 'mixed'), (2, 6, 1100, 'full'),
    # K10's other geometries: 2 and 10 warps of one column a lane
    (3, 7, 49, 'mixed'), (2, 3, 300, 'mixed'),
    # the raw-waveform fine-tune's lattice: 16 s, no time reduction
    (32, 1597, 65, 'mixed'),
])
def test_k9_k10_lattice_matches_plain(cuda, b, t, u1, edge):
    from edgedict_tpu_torch.ops import rnnt_loss as PL
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as K
    blank, label, xlen, ylen = _lattice_case(cuda, b, t, u1, edge)
    alpha, logz = K.lattice_alpha(blank, label, xlen, ylen)
    # the plain chain in fp64: in fp32 its own occupancies are 2.0e-4 off
    # at the E6D2 lattice, over the tolerance, where K9 and K10, both
    # carrying their chains in fp64, are ~1e-5 off
    wide = (blank.double(), label.double())
    r_alpha, r_logz = PL.lattice_alpha_plain(*wide, xlen, ylen)
    assert _max_abs(logz, r_logz) <= 1e-4 * max(1.0, float(r_logz.abs()
                                                           .max()))
    gb, gl = K.lattice_beta_grad(blank, label, alpha, logz, xlen, ylen)
    again = K.lattice_beta_grad(blank, label, alpha, logz, xlen, ylen)
    assert torch.equal(gb, again[0]) and torch.equal(gl, again[1])
    r_gb, r_gl = PL.lattice_beta_grad_plain(*wide, r_alpha, r_logz, xlen,
                                            ylen)
    # an occupancy exp(alpha + beta - logZ) carries the absolute rounding of
    # its O(|logZ|) exponent: a few fp32 ulps of |logZ|
    occ_tol = max(1e-5, 1e-6 * float(r_logz.abs().max()))
    assert _max_abs(gb, r_gb) <= occ_tol and _max_abs(gl, r_gl) <= occ_tol
    # occupancies: every path passes one blank per frame < xlen
    per_frame = gb.sum(-1)[:, :t]
    valid = torch.arange(t, device=cuda)[None] < xlen[:, None]
    assert _max_abs(per_frame[valid], torch.ones_like(per_frame[valid])) \
        <= 1e-3


# every geometry of the lattice plan (beta_plan: 1 to 16 warps of one
# column a lane, 9 warps of 2, of 4 and of 8), T = 1, xlen = 0
LATTICE_CASES = [
    (32, 214, 65, 'mixed'), (4, 9, 1, 'full'), (3, 1, 7, 'full'),
    (2, 12, 9, 'xlen0'), (3, 7, 33, 'mixed'), (2, 1, 65, 'full'),
    (2, 6, 128, 'mixed'), (2, 3, 300, 'mixed'), (2, 4, 512, 'mixed'),
    (2, 3, 600, 'mixed'), (2, 2, 1100, 'full'), (2, 1, 1100, 'xlen0'),
    (1, 2, 2100, 'full'),
]


@pytest.mark.parametrize('b,t,u1,edge', LATTICE_CASES)
def test_k9_matches_plain(cuda, b, t, u1, edge):
    """K9 alone, every geometry of its plan: alpha on the cells t <=
    xlen, u <= ylen and logZ within max(1e-5, 1e-6 |logZ|) of its plain
    version run in fp64 throughout (the fp32 plain version's own error
    against it stated beside K9's), logZ the stored alpha[xlen, ylen] bit
    for bit, one count per call, the same bits on a second call, and no
    memory past alpha and logz."""
    from edgedict_tpu_torch.ops import rnnt_loss as PL
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as K
    blank, label, xlen, ylen = _lattice_case(cuda, b, t, u1, edge)
    torch.cuda.synchronize()
    before = K.lattice_alpha.launches
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    alpha, logz = K.lattice_alpha(blank, label, xlen, ylen)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert K.lattice_alpha.launches == before + 1
    # the outputs, each rounded up to the allocator's 512-byte blocks
    assert extra <= sum(-(-x.numel() * 4 // 512) * 512 for x in (alpha, logz))
    again = K.lattice_alpha(blank, label, xlen, ylen)
    assert torch.equal(alpha, again[0]) and torch.equal(logz, again[1])
    idx = torch.arange(b, device=cuda)
    assert torch.equal(logz, alpha[idx, xlen.long(), ylen.long()])
    wide = (blank.double(), label.double(), xlen, ylen)
    assert all(m.dtype == torch.float64 for m in PL.masked_transitions(*wide))
    r_alpha, r_logz = PL.lattice_alpha_plain(*wide)
    assert r_alpha.dtype == r_logz.dtype == torch.float64
    p_alpha, p_logz = PL.lattice_alpha_plain(blank, label, xlen, ylen)
    valid = (torch.arange(t + 1, device=cuda)[None, :, None]
             <= xlen.long()[:, None, None]) \
        & (torch.arange(u1, device=cuda)[None, None, :]
           <= ylen.long()[:, None, None])

    def err(a, z):
        return max(float((a.double() - r_alpha)[valid].abs().max()),
                   float((z.double() - r_logz).abs().max()))
    tol = max(1e-5, 1e-6 * float(r_logz.abs().max()))
    k9, plain = err(alpha, logz), err(p_alpha, p_logz)
    assert k9 <= tol, f'K9 {k9:.3e}, fp32 plain {plain:.3e}, tol {tol:.3e}'


def test_k9_is_one_launch_per_call(cuda):
    """One K9 call at the E6D2 lattice is one launch of the wavefront
    kernel and nothing else on the card: no scratch, no memset."""
    names = [n for n, _ in _kernel_events(('k9',))['kernels']]
    assert len(names) == 1 and 'lattice_alpha_kernel' in names[0], names


@pytest.mark.parametrize('b,t,u1,edge', LATTICE_CASES)
def test_k10_matches_plain_on_the_same_alpha(cuda, b, t, u1, edge):
    """K10 alone, every geometry of its plan (1 to 16 warps of one column a
    lane, 9 warps of 2, of 4 and of 8), T = 1, xlen = 0:
    its occupancies within max(1e-5, 1e-6 |logZ|) of its plain version
    given the same alpha and logZ (K9's), one count per call, the same
    bits on a second call, and no memory past its two outputs."""
    from edgedict_tpu_torch.ops import rnnt_loss as PL
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as K
    blank, label, xlen, ylen = _lattice_case(cuda, b, t, u1, edge)
    alpha, logz = K.lattice_alpha(blank, label, xlen, ylen)
    torch.cuda.synchronize()
    before = K.lattice_beta_grad.launches
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gb, gl = K.lattice_beta_grad(blank, label, alpha, logz, xlen, ylen)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert K.lattice_beta_grad.launches == before + 1
    # the outputs, each rounded up to the allocator's 512-byte blocks
    assert extra <= sum(-(-x.numel() * 4 // 512) * 512 for x in (gb, gl))
    again = K.lattice_beta_grad(blank, label, alpha, logz, xlen, ylen)
    assert torch.equal(gb, again[0]) and torch.equal(gl, again[1])
    r_gb, r_gl = PL.lattice_beta_grad_plain(blank, label, alpha, logz, xlen,
                                            ylen)
    occ_tol = max(1e-5, 1e-6 * float(logz.abs().max()))
    assert _max_abs(gb, r_gb) <= occ_tol and _max_abs(gl, r_gl) <= occ_tol


def test_k10_is_one_launch_per_call(cuda):
    """One K10 call at the E6D2 lattice is one launch of the wavefront
    kernel and nothing else on the card: no beta scratch, no memset."""
    names = [n for n, _ in _kernel_events(('k10',))['kernels']]
    assert len(names) == 1 and 'lattice_beta_grad_kernel' in names[0], names


# ---------------------------------------------------------------------------
# GRU and int8 serving: K5 (GRU forward), K11 (int8 matmul), K12 / K13
# (int8 LSTM / GRU recurrences)
# ---------------------------------------------------------------------------

def _step_from_own_state(plain, xp, ys, h0, *args):
    """Each step of a plain GRU recurrence from the state the kernel itself
    carried into it (h0 at t=0, else ys[t-1], h rounded to x_proj's dtype:
    exact in fp32, the same cast the dot reads in bf16)."""
    t, b, h3 = xp.shape
    h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b, -1)
    return plain(xp.reshape(1, t * b, h3), *args, h_prev).reshape(ys.shape)


@pytest.mark.parametrize('hid,b,t,dtype,int8', [
    (16, 3, 5, torch.float32, False), (1024, 1, 2, torch.float32, False),
    (1024, 64, 2, torch.bfloat16, False), (1030, 11, 3, torch.float32, False),
    (1024, 1, 2, torch.float32, True), (1024, 64, 2, torch.bfloat16, True),
    (72, 9, 4, torch.float32, True),
    (1024, 33, 3, torch.bfloat16, False), (1024, 256, 2, torch.float32, False),
    (512, 8, 4, torch.bfloat16, False), (256, 33, 1, torch.float32, False),
    (1024, 4, 1, torch.bfloat16, False), (1030, 11, 3, torch.bfloat16, False),
    # K13 on K5's persistent launch: the int8 server's B=64 in fp32, a
    # 16-step call in both dtypes
    (1024, 64, 2, torch.float32, True), (1024, 1, 16, torch.float32, True),
    (1024, 1, 16, torch.bfloat16, True),
])
def test_k5_k13_gru_fwd_matches_plain(cuda, hid, b, t, dtype, int8):
    from edgedict_tpu_torch.ops import gru_kernel as K5
    from edgedict_tpu_torch.ops import quant as Q
    g = torch.Generator(device='cpu').manual_seed(hid + b + t)
    k = 1.0 / hid ** 0.5
    xp = torch.randn(t, b, 3 * hid, generator=g).to(cuda, dtype)
    w = torch.rand(3 * hid, hid, generator=g) * 2 * k - k
    b_hh = (torch.rand(3 * hid, generator=g) - 0.5).to(cuda)
    h0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    if int8:
        q, s = (x.to(cuda) for x in Q.quantize_int8(w))
        fn, plain, args = Q.gru_recurrence_q, Q.gru_recurrence_q_plain, \
            (q, s, b_hh)
    else:
        w = w.to(cuda, dtype)
        fn, plain, args = K5.gru_recurrence, K5.gru_recurrence_plain, \
            (w, b_hh)
    before = fn.launches
    ys = fn(xp, *args, h0)
    if not int8:                                     # K5 returns (ys, hT)
        ys, hT = ys
        assert torch.equal(hT, ys[-1])
    ref = plain(xp, *args, h0)
    assert fn.launches == before + 1
    assert ys.dtype == dtype and ys.shape == (t, b, hid)
    # free-running: fp32 to the forward bound, bf16 drifts once a one-ulp
    # flip of h's rounding feeds the later steps; step by step from the
    # kernel's own state, bf16 is held to one ulp
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _max_abs(ys, ref) <= tol
    step = _step_from_own_state(plain, xp, ys, h0, *args)
    if dtype == torch.float32:
        assert _max_abs(ys, step) <= 1e-4
    else:       # one bf16 ulp: the fp32 h of the update is rounded here
        assert bool(((ys.float() - step.float()).abs()
                     <= 1e-2 + 2.0 ** -7 * step.float().abs()).all())


@pytest.mark.parametrize('hid,b,t,dtype', [
    (1024, 1, 2, torch.float32), (1024, 64, 2, torch.bfloat16),
    (1024, 64, 2, torch.float32), (1024, 1, 2, torch.bfloat16),
    (1024, 1, 16, torch.float32), (1024, 1, 16, torch.bfloat16),
    (1024, 64, 16, torch.float32), (1024, 64, 16, torch.bfloat16),
    (16, 3, 5, torch.float32), (1030, 11, 3, torch.float32),
    (1030, 11, 3, torch.bfloat16), (1024, 33, 3, torch.bfloat16),
])
def test_k12_lstm_fwd_q_matches_plain(cuda, hid, b, t, dtype):
    """K12 free-running to 1e-4 (fp32) / 2e-2 (bf16) of its plain version,
    each step from its own carried state (cs to 1e-4, bf16 ys to one ulp),
    hT the last step's fp32 h, one count per call, the same bits on a
    second call.  H=1030 and H=16 take the scalar prologue."""
    from edgedict_tpu_torch.ops import quant as Q
    g = torch.Generator(device='cpu').manual_seed(hid * 3 + b + t)
    k = 1.0 / hid ** 0.5
    xp = torch.randn(t, b, 4 * hid, generator=g).to(cuda, dtype)
    q, s = (x.to(cuda) for x in
            Q.quantize_int8(torch.rand(4 * hid, hid, generator=g) * 2 * k - k))
    h0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    c0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    before = Q.lstm_recurrence_q.launches
    ys, cs, hT = Q.lstm_recurrence_q(xp, q, s, h0, c0)
    again = Q.lstm_recurrence_q(xp, q, s, h0, c0)
    ref = Q.lstm_recurrence_q_plain(xp, q, s, h0, c0)
    assert Q.lstm_recurrence_q.launches == before + 2
    assert ys.dtype == dtype and hT.dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip((ys, cs, hT), ref):
        assert _max_abs(a, r) <= tol
    assert all(torch.equal(a, c) for a, c in zip((ys, cs, hT), again))
    assert _max_abs(hT.to(dtype), ys[-1]) == 0.0
    h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b, hid)
    c_prev = torch.cat([c0[None], cs[:-1]]).reshape(t * b, hid)
    step = Q.lstm_recurrence_q_plain(xp.reshape(1, t * b, 4 * hid), q, s,
                                     h_prev, c_prev)
    assert _max_abs(cs, step[1].reshape(cs.shape)) <= 1e-4
    sy = step[0].reshape(ys.shape).float()
    assert bool(((ys.float() - sy).abs()
                 <= (1e-4 if dtype == torch.float32 else 1e-2)
                 + (0.0 if dtype == torch.float32 else 2.0 ** -7)
                 * sy.abs()).all())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_k12_is_one_launch_per_call_under_its_own_name(cuda, dtype):
    """One K12 call of T=16 steps is one launch of recur_fwd_q_kernel
    (torch.profiler's device trace), which the profilers' K1 pattern
    ('recur_fwd_kernel' with 'LstmStep') does not match."""
    from edgedict_tpu_torch.cli import profile_stream
    names = [n for n, _ in _kernel_events(('k12', dtype))['kernels']]
    assert sum('recur_fwd_q_kernel' in n for n in names) == 1, names
    assert [n for n in names if profile_stream.kernel_of(n, 'lstm_fwd_q')] \
        and not any(profile_stream.kernel_of(n, 'lstm_fwd') for n in names)
    assert not any('step_kernel' in n for n in names)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_k13_is_one_launch_per_call_under_its_own_name(cuda, dtype):
    """One K13 call of T=16 steps is one launch of recur_fwd_gru_q_kernel
    (torch.profiler's device trace), which neither the profilers' K5
    pattern ('recur_fwd_kernel' with 'GruStep') nor K12's matches; no
    per-step kernel runs."""
    from edgedict_tpu_torch.cli import profile_stream
    names = [n for n, _ in _kernel_events(('k13', dtype))['kernels']]
    assert sum('recur_fwd_gru_q_kernel' in n for n in names) == 1, names
    assert [n for n in names if profile_stream.kernel_of(n, 'gru_fwd_q')]
    assert not any(profile_stream.kernel_of(n, k) for n in names
                   for k in ('gru_fwd', 'lstm_fwd_q', 'lstm_fwd'))
    assert not any('step_kernel' in n for n in names)


def test_k2_is_one_launch_per_call(cuda):
    """One K2 call (the 75 ms chunk: the few-frame split) is one kernel
    launch on the card: no padding copy, no memset."""
    names = [n for n, _ in _kernel_events(('k2',))['kernels']]
    assert names and all('mel_power_kernel' in n for n in names), names
    assert len(names) == 1


@pytest.mark.parametrize('b,n,n_fft,hop', [
    (1, 1400, 400, 200), (8, 224000, 400, 200), (1, 1400, 400, 160),
    (1, 1408, 511, 128), (8, 224000, 511, 128)])
def test_k2_is_one_launch_per_call_at_any_n_fft(cuda, b, n, n_fft, hop):
    """The padded table keeps one launch per call in both splits (the
    flags' default n_fft 400 at a chunk and at the train batch; odd 511)."""
    names = [name for name, _ in _kernel_events(('k2', b, n, n_fft, hop,
                                                 n_fft))['kernels']]
    assert names and all('mel_power_kernel' in n for n in names), names
    assert len(names) == 1


@pytest.mark.parametrize('r,k,n,dtype', [
    (2, 240, 4096, torch.float32), (2, 1024, 3072, torch.bfloat16),
    (512, 1024, 4096, torch.float32), (512, 1024, 640, torch.bfloat16),
    (33, 9, 130, torch.float32), (5, 13, 7, torch.bfloat16),
    (1, 1024, 640, torch.float32),
])
def test_k11_quant_matmul_matches_plain(cuda, r, k, n, dtype):
    """Both launch shapes (matrix-vector up to 32 rows, tiled above), K
    not a multiple of 4 included; fp32 to 1e-4 of the output scale, bf16
    to one bf16 rounding of the output."""
    from edgedict_tpu_torch.ops import quant as Q
    g = torch.Generator(device='cpu').manual_seed(r + k + n)
    x = torch.randn(r, k, generator=g).to(cuda, dtype)
    q, s = (t.to(cuda) for t in
            Q.quantize_int8(torch.randn(n, k, generator=g) / k ** 0.5))
    bias = torch.randn(n, generator=g).to(cuda)
    before = Q.quant_matmul.launches
    out = Q.quant_matmul(x, q, s, bias)
    ref = Q.quant_matmul_plain(x, q, s, bias)
    assert Q.quant_matmul.launches == before + 1
    assert out.dtype == dtype and out.shape == (r, n)
    scale = max(1.0, float(ref.float().abs().max()))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _max_abs(out, ref) <= tol * scale


@pytest.mark.parametrize('r', [33, 128, 512])
@pytest.mark.parametrize('k', [13, 240, 1024])
@pytest.mark.parametrize('n', [7, 640, 4096])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k11_tile_path_matches_plain(cuda, r, k, n, dtype):
    """K11's tiled kernels (R > 32): tensor cores in bf16, FFMA in fp32,
    ragged R, K and N; one launch, counted as a tile launch."""
    from edgedict_tpu_torch.ops import quant as Q
    g = torch.Generator(device='cpu').manual_seed(r * k + n)
    x = torch.randn(r, k, generator=g).to(cuda, dtype)
    q, s = (t.to(cuda) for t in
            Q.quantize_int8(torch.randn(n, k, generator=g) / k ** 0.5))
    bias = torch.randn(n, generator=g).to(cuda)
    before = (Q.quant_matmul.launches, Q.quant_matmul.tile_launches)
    out = Q.quant_matmul(x, q, s, bias)
    assert (Q.quant_matmul.launches, Q.quant_matmul.tile_launches) == (
        before[0] + 1, before[1] + 1)
    ref = Q.quant_matmul_plain(x, q, s, bias)
    assert out.dtype == dtype and out.shape == (r, n)
    scale = max(1.0, float(ref.float().abs().max()))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _max_abs(out, ref) <= tol * scale


@pytest.mark.parametrize('hid,b,t,dtype,cot', BWD_CASES)
def test_k6_gru_bwd_matches_plain(cuda, hid, b, t, dtype, cot):
    """K6 against its plain reverse loop on the same forward (dgx, dgh,
    dh0 to 1e-4 of max(1, max|ref|) in fp32, 2e-2 in bf16, as K4), then
    through the autograd.Function: K5 forward, K6 backward, the dW_hh
    matmul and the db_hh sum."""
    from edgedict_tpu_torch.ops import gru_kernel as K
    g = torch.Generator(device='cpu').manual_seed(hid + b + t)
    k = 1.0 / hid ** 0.5
    xp = torch.randn(t, b, 3 * hid, generator=g).to(cuda, dtype)
    w = (torch.rand(3 * hid, hid, generator=g) * 2 * k - k).to(cuda, dtype)
    b_hh = (torch.rand(3 * hid, generator=g) - 0.5).to(cuda)
    h0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    ys, _ = K.gru_recurrence(xp, w, b_hh, h0)
    dys = torch.randn(t, b, hid, generator=g).to(cuda, dtype)
    dhT = torch.randn(b, hid, generator=g).to(cuda)
    c_dys, _, c_dhT = _cotangents(cot, dys, None, dhT)
    before = K.gru_recurrence_bwd.launches
    out = K.gru_recurrence_bwd(xp, w, b_hh, h0, ys, c_dys, c_dhT)
    assert K.gru_recurrence_bwd.launches == before + 1
    ref = K.gru_recurrence_bwd_plain(xp, w, b_hh, h0, ys, c_dys, c_dhT)
    assert out[0].dtype == out[1].dtype == dtype
    assert out[2].dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(out, ref):
        assert _rel_err(a, r) <= tol
    leaves = [x.clone().requires_grad_() for x in (xp, w, b_hh, h0)]
    ys2, hT2 = K.gru_recurrence(*leaves)
    torch.autograd.backward((ys2, hT2), (dys, dhT.to(dtype)))
    dgx, dgh, dh0 = K.gru_recurrence_bwd_plain(xp, w, b_hh, h0, ys, dys,
                                               dhT.to(dtype).float())
    h_prev = torch.cat([h0.to(dtype)[None], ys[:-1]]).float()
    dw_ref = dgh.float().reshape(-1, 3 * hid).t() @ h_prev.reshape(-1, hid)
    assert _rel_err(leaves[0].grad, dgx) <= tol
    assert _rel_err(leaves[1].grad, dw_ref) <= (
        1e-3 if dtype == torch.float32 else 5e-2)
    assert _rel_err(leaves[2].grad, dgh.float().sum((0, 1))) <= (
        1e-3 if dtype == torch.float32 else 5e-2)
    assert _rel_err(leaves[3].grad, dh0) <= tol


@pytest.mark.parametrize('cell,hid,dtype', [('LSTM', 2048, torch.float32),
                                            ('GRU', 3000, torch.float32),
                                            ('LSTM', 4096, torch.bfloat16)])
def test_k4_k6_shape_outside_the_plan_raises(cuda, cell, hid, dtype):
    """A hidden size whose W_hh column slice does not fit one block's
    shared memory is refused with ValueError naming the shape, before any
    launch."""
    from edgedict_tpu_torch.ops import gru_kernel as KG
    from edgedict_tpu_torch.ops import rnn_kernel as KL
    t, b = 2, 4
    g = 4 if cell == 'LSTM' else 3
    xp = torch.zeros(t, b, g * hid, device=cuda, dtype=dtype)
    w = torch.zeros(g * hid, hid, device=cuda, dtype=dtype)
    h0 = torch.zeros(b, hid, device=cuda)
    ys = torch.zeros(t, b, hid, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match=f'H={hid}'):
        if cell == 'LSTM':
            cs = torch.zeros(t, b, hid, device=cuda)
            KL.lstm_recurrence_bwd(xp, w, h0, h0, ys, cs, ys, None, None)
        else:
            b_hh = torch.zeros(g * hid, device=cuda)
            KG.gru_recurrence_bwd(xp, w, b_hh, h0, ys, ys, None)


def _fwd_case(cuda, cell, hid, b, t, dtype, seed):
    g = torch.Generator(device='cpu').manual_seed(seed)
    gates = 4 if cell == 'LSTM' else 3
    k = 1.0 / hid ** 0.5
    xp = torch.randn(t, b, gates * hid, generator=g).to(cuda, dtype)
    w = (torch.rand(gates * hid, hid, generator=g) * 2 * k - k).to(cuda, dtype)
    h0 = torch.randn(b, hid, generator=g).to(cuda) * 0.5
    if cell == 'LSTM':
        return (xp, w, h0, torch.randn(b, hid, generator=g).to(cuda) * 0.5)
    return (xp, w, (torch.rand(gates * hid, generator=g) - 0.5).to(cuda), h0)


@pytest.mark.parametrize('cell', ['LSTM', 'GRU'])
def test_k1_k5_training_shape_held_step_by_step(cuda, cell):
    """E6D2's encoder layer in training (H=1024 B=32 T=427 bf16).  Over 427
    steps a one-ulp flip of h's bf16 rounding feeds every later step, so the
    free-running output is not held: each step is, from the kernel's own
    carried state (ys[t-1], the LSTM's cs[t-1]): ys within one bf16 ulp, cs
    to 1e-4."""
    from edgedict_tpu_torch.ops import gru_kernel as K5
    hid, b, t = 1024, 32, 427
    args = _fwd_case(cuda, cell, hid, b, t, torch.bfloat16, 427)
    xp, w = args[0], args[1]
    h0 = args[2] if cell == 'LSTM' else args[3]
    if cell == 'LSTM':
        ys, cs, hT = K1.lstm_recurrence(*args)
        c0 = args[3]
        h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b, hid)
        c_prev = torch.cat([c0[None], cs[:-1]]).reshape(t * b, hid)
        step = K1.lstm_recurrence_plain(xp.reshape(1, t * b, 4 * hid), w,
                                        h_prev, c_prev)
        step_ys = step[0].reshape(ys.shape)
        assert _max_abs(cs, step[1].reshape(cs.shape)) <= 1e-4
        # hT is the last step's fp32 h, of which ys[-1] is the rounding
        assert _max_abs(hT.to(ys.dtype), ys[-1]) == 0.0
    else:
        ys, hT = K5.gru_recurrence(*args)
        assert torch.equal(hT, ys[-1])
        step_ys = _step_from_own_state(K5.gru_recurrence_plain, xp, ys, h0,
                                       w, args[2])
    assert bool(((ys.float() - step_ys.float()).abs()
                 <= 1e-2 + 2.0 ** -7 * step_ys.float().abs()).all())


@pytest.mark.parametrize('cell', ['LSTM', 'GRU'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k1_k5_one_launch_per_call(cuda, cell, dtype):
    """One K1 or K5 call of T steps is one launch of the persistent kernel
    (torch.profiler's device trace), not T, and no per-step kernel runs."""
    names = [n for n, _ in _kernel_events(
        (cell, str(dtype).split('.')[-1]))['kernels']]
    step = 'LstmStep' if cell == 'LSTM' else 'GruStep'
    assert sum('recur_fwd_kernel' in n and step in n for n in names) == 1
    assert not any('step_kernel' in n for n in names)


@pytest.mark.parametrize('cell,hid,b,dtype', [('LSTM', 2048, 4, torch.float32),
                                              ('GRU', 3000, 4, torch.float32),
                                              ('LSTM', 4096, 4, torch.bfloat16),
                                              ('GRU', 1024, 8192,
                                               torch.float32)])
def test_k1_k5_shape_outside_the_plan_raises(cuda, cell, hid, b, dtype):
    """A shape whose W_hh slice and carries do not fit one block's shared
    memory is refused with ValueError naming it, before any launch."""
    from edgedict_tpu_torch.ops import gru_kernel as K5
    g = 4 if cell == 'LSTM' else 3
    xp = torch.zeros(2, b, g * hid, device=cuda, dtype=dtype)
    w = torch.zeros(g * hid, hid, device=cuda, dtype=dtype)
    h0 = torch.zeros(b, hid, device=cuda)
    fn = K1.lstm_recurrence if cell == 'LSTM' else K5.gru_recurrence
    before = fn.launches
    with pytest.raises(ValueError, match=f'H={hid}'):
        if cell == 'LSTM':
            K1.lstm_recurrence(xp, w, h0, h0)
        else:
            K5.gru_recurrence(xp, w, torch.zeros(g * hid, device=cuda), h0)
    assert fn.launches == before


def test_gru_train_step_cuda_matches_cpu(cuda):
    """One fp32 make_train_step step of a small GRU-encoder transducer
    (adam, accum 2) on CUDA against the CPU plain path from the same
    weights and batch: loss 1e-5 rel, grad_norm 1e-4 rel, params within
    2 lr (Adam's first step is g/|g|), and K5/K6 each launched once per
    layer and micro-batch."""
    import dataclasses
    from edgedict_tpu_torch import optim
    from edgedict_tpu_torch import train as TR
    from edgedict_tpu_torch.ops import gru_kernel as K
    cfg, _, _, _ = _small_stream()
    cfg = dataclasses.replace(cfg, module_type='GRU', vocab_size=40)
    rng = np.random.RandomState(0)
    host = {'xs': rng.randn(4, 12, cfg.input_size).astype(np.float32),
            'xlen': np.array([12, 10, 12, 9], np.int32),
            'ys': rng.randint(4, 40, (4, 5)).astype(np.int32),
            'ylen': np.array([5, 4, 3, 5], np.int32)}
    opt = optim.build_optimizer('adam', gradclip=1.0)
    lr, res = 1e-3, []
    for dev in ('cpu', cuda):
        state = TR.make_train_state(cfg, opt, dev, seed=3)
        step = TR.make_train_step(cfg, opt, bf16=False)
        counts = (K.gru_recurrence.launches, K.gru_recurrence_bwd.launches)
        state, m = step(state, TR.device_batch(host, 2, dev), lr)
        counts = (K.gru_recurrence.launches - counts[0],
                  K.gru_recurrence_bwd.launches - counts[1])
        res.append((float(m['loss']), float(m['grad_norm']), counts,
                    {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()}))
    (l0, g0, c0, p0), (l1, g1, c1, p1) = res
    assert c0 == (0, 0) and c1 == (2 * cfg.enc_layers, 2 * cfg.enc_layers)
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert abs(g1 - g0) <= 1e-4 * g0
    for k, v in p0.items():
        assert _max_abs(p1[k], v) <= 2 * lr + 1e-6, k


@pytest.mark.parametrize('module_type,quantize', [
    ('LSTM', 'int8'), ('GRU', None), ('GRU', 'int8')])
def test_gru_and_int8_streaming_cuda_equals_cpu(cuda, module_type, quantize):
    import dataclasses
    from edgedict_tpu_torch.ops import gru_kernel as K5
    from edgedict_tpu_torch.ops import quant as Q
    cfg, feat, _, audio = _small_stream()
    cfg = dataclasses.replace(cfg, module_type=module_type)
    model = T.Transducer(cfg, 'cpu', seed=2)
    with torch.no_grad():
        model.joint.out.weight *= 8.0
    out = []
    for device in ('cpu', 'cuda'):
        dec = S.StreamingDecoder(model, cfg, feat, _Tok(), device=device,
                                 quantize=quantize)
        counts = [f.launches for f in (K1.lstm_recurrence, K5.gru_recurrence,
                                       Q.quant_matmul, Q.lstm_recurrence_q,
                                       Q.gru_recurrence_q)]
        out.append((dec.decode_wav(audio), np.concatenate(dec.emitted)))
        counts = [f.launches - c for f, c in zip(
            (K1.lstm_recurrence, K5.gru_recurrence, Q.quant_matmul,
             Q.lstm_recurrence_q, Q.gru_recurrence_q), counts)]
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    n_chunks = len(dec.elapsed)
    layers = cfg.enc_layers * n_chunks
    want = {('LSTM', 'int8'): [0, 0, layers + n_chunks, layers, 0],
            ('GRU', None): [0, layers, 0, 0, 0],
            ('GRU', 'int8'): [0, 0, layers + n_chunks, 0, layers]}
    assert counts == want[module_type, quantize]


def test_k3_is_one_launch_over_many_blocks(cuda):
    """One K3 call of 16 frames at B=1 is one launch (torch.profiler's
    device trace) whose grid is the plan's, more than one block."""
    out = _kernel_events(('k3',))
    events = [e for e in out['kernels'] if 'greedy_frame_kernel' in e[0]]
    assert len(events) == 1
    assert out['blocks'] > 1 and events[0][1] == [out['blocks'], 1, 1]


# ---------------------------------------------------------------------------
# wav2vec pretraining and the raw-waveform fine-tune
# ---------------------------------------------------------------------------

def _lstm_case(cuda, hid, b, t, dtype, seed):
    g = torch.Generator(device='cpu').manual_seed(seed)
    k = 1.0 / hid ** 0.5
    xp = torch.randn(t, b, 4 * hid, generator=g).to(cuda, dtype)
    w = (torch.rand(4 * hid, hid, generator=g) * 2 * k - k).to(cuda, dtype)
    h0 = (torch.randn(b, hid, generator=g) * 0.5).to(cuda)
    c0 = (torch.randn(b, hid, generator=g) * 0.5).to(cuda)
    dys = torch.randn(t, b, hid, generator=g).to(cuda, dtype)
    return xp, w, h0, c0, dys


@pytest.mark.parametrize('b,t,backward', [(32, 297, True), (4, 297, False),
                                          (4, 1597, False)])
def test_k1_k4_wav2vec_fp32_shapes_match_plain(cuda, b, t, backward):
    """Pretraining's encoder in fp32 (H=1024 B=32 T=297), its eval's B=4,
    and the fine-tune eval's B=4 T=1597: K1 free-running to 1e-4, K4
    given the same forward to 1e-4 of max(1, max|ref|)."""
    xp, w, h0, c0, dys = _lstm_case(cuda, 1024, b, t, torch.float32, t + b)
    out = K1.lstm_recurrence(xp, w, h0, c0)
    ref = K1.lstm_recurrence_plain(xp, w, h0, c0)
    for a, r in zip(out, ref):
        assert _max_abs(a, r) <= 1e-4
    if backward:
        args = (xp, w, h0, c0, out[0], out[1], dys, None, None)
        for a, r in zip(K1.lstm_recurrence_bwd(*args),
                        K1.lstm_recurrence_bwd_plain(*args)):
            assert _rel_err(a, r) <= 1e-4


def test_k1_k4_raw_finetune_bf16_shape_match_plain(cuda):
    """The fine-tune's encoder layer in bf16, H=1024 B=32 T=1597: K1 held
    step by step from its own carried state (ys to one bf16 ulp, cs to
    1e-4), K4 given that forward to 2e-2 of max(1, max|ref|)."""
    hid, b, t = 1024, 32, 1597
    xp, w, h0, c0, dys = _lstm_case(cuda, hid, b, t, torch.bfloat16, 11)
    ys, cs, _ = K1.lstm_recurrence(xp, w, h0, c0)
    h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b, hid)
    c_prev = torch.cat([c0[None], cs[:-1]]).reshape(t * b, hid)
    y1, c1, _ = K1.lstm_recurrence_plain(xp.reshape(1, t * b, 4 * hid), w,
                                         h_prev, c_prev)
    y1, c1 = y1.reshape(ys.shape), c1.reshape(cs.shape)
    diff = (ys.float() - y1.float()).abs()
    assert bool((diff <= 1e-2 + 2.0 ** -7 * y1.float().abs()).all())
    assert _max_abs(cs, c1) <= 1e-4
    args = (xp, w, h0, c0, ys, cs, dys, None, None)
    for a, r in zip(K1.lstm_recurrence_bwd(*args),
                    K1.lstm_recurrence_bwd_plain(*args)):
        assert _rel_err(a, r) <= 2e-2


def _joint_by_chunks(f, g, w_t, bias, labels, cot, chunk=100):
    """The plain joint 100 frames at a time: → (blank_lp, label_lp) and
    the gradients of (f, g, w_t, bias) under the cotangents `cot`."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    lps, df, rest = [], [], None
    for s0 in range(0, f.shape[1], chunk):
        leaves = [x.detach().clone().requires_grad_()
                  for x in (f[:, s0:s0 + chunk], g, w_t, bias)]
        out = KJ.fused_joint_lse_plain(*leaves, labels, 0)
        gr = torch.autograd.grad(out, leaves, tuple(
            c[:, s0:s0 + chunk] for c in cot))
        lps.append([o.detach() for o in out])
        df.append(gr[0])
        rest = list(gr[1:]) if rest is None else [
            a + c for a, c in zip(rest, gr[1:])]
    return [torch.cat(p, 1) for p in zip(*lps)], [torch.cat(df, 1), *rest]


@pytest.mark.parametrize('b,u1,dtype', [(32, 65, torch.bfloat16),
                                        (4, 49, torch.float32)])
def test_k7_k8_raw_finetune_lattice_match_plain_by_chunks(cuda, b, u1,
                                                          dtype):
    """The fused joint at the fine-tune's T=1597 (J=640, V=2048): the B=32
    bf16 step (K7 and K8) and the eval's B=4 fp32 forward, against the
    plain joint by time chunks (the whole logits do not fit the card):
    log-probs to 1e-4 and grads to 2e-2 of max(1, max|ref|)."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    t = 1597
    f, g, w_t, bias, labels, db, dl = _joint_case(cuda, b, t, u1, 640, 2048,
                                                  dtype, 13)
    wt_e = w_t.to(dtype).contiguous()
    blank_lp, label_lp, lse = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0)
    (r_b, r_l), ref_g = _joint_by_chunks(f, g, w_t, bias, labels, (db, dl))
    assert _rel_err(blank_lp, r_b) <= 1e-4 and _rel_err(label_lp, r_l) <= 1e-4
    if dtype == torch.bfloat16:
        grads = KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse, db, dl)
        for a, r in zip(grads, ref_g):
            assert _rel_err(a, r) <= 2e-2


def test_k3_raw_finetune_eval_decode_matches_plain(cuda):
    """K3 at the fine-tune eval's decode: B=4 over T=1597 frames at E6D2's
    joint and prediction-net widths, about half the frames blank."""
    cfg, model = _decoder_model(cuda, 2048, 640, 256, 64, 256, 2)
    b, t = 4, 1597
    with torch.no_grad():
        model.joint.out.bias[0] += 1.2
        h_dec, (hs, cs) = T.decoder_apply(
            model.decoder, cfg, torch.zeros((b, 0), dtype=torch.long,
                                            device=cuda))
    cache = K3.build_decode_cache(model)
    f = torch.randn(t, b, 640, generator=torch.Generator().manual_seed(3)) \
        .to(cuda)
    args = (cache, f, h_dec[:, 0].contiguous(), hs, cs, 0, 3, True)
    out = K3.greedy_frame_loop(*args)
    ref = K3.greedy_frame_loop_plain(*args)
    assert torch.equal(out[0], ref[0])
    assert 0.1 < float((ref[0] == 0).float().mean()) < 0.9
    for a, r in zip(out[1:], ref[1:]):
        if r is not None:
            assert _max_abs(a, r) <= 1e-4


def _w2v_small():
    from edgedict_tpu_torch.models import wav2vec as W
    return W, W.Wav2VecConfig(input_size=128, enc_hidden_size=64,
                              enc_layers=2, enc_dropout=0.0,
                              enc_proj_size=32, num_negatives=10,
                              latent_vars=16, final_dim=32)


def test_pretrain_step_cuda_matches_cpu(cuda):
    """One step of a small wav2vec model (the DEFAULT FrontEnd, 2 x 64
    LSTM) with the pretrainer's loss under its AdamW without decay of 1-D
    params (accum 2, bf16=True: the loss takes no cast) on CUDA against
    the CPU from the same weights, masks and draws: loss 1e-5 rel,
    grad_norm 1e-4 rel, params within 2 lr; K1 and K4 once per layer and
    micro-batch."""
    from edgedict_tpu_torch import optim
    from edgedict_tpu_torch import train as TR
    from edgedict_tpu_torch.pretrainer import plan_masks
    W, cfg = _w2v_small()
    b, n, lr = 4, 8000, 1e-3
    t = W.frontend_output_length(cfg.frontend_params, n)
    host = {'audio': np.random.RandomState(0).randn(b, n)
            .astype(np.float32) * 0.1,
            'alen': np.full((b,), n, np.int32),
            'mask_idx': plan_masks(cfg, b, t, np.random.RandomState(1))}
    m = host['mask_idx'].shape[1]
    draws = [W.make_draws(cfg, b // 2, t, m, torch.Generator().manual_seed(i),
                          'cpu') for i in range(2)]
    opt = optim.adamw_no_ln_decay(0.9, 0.998, 0.01, 10.0)
    res = []
    for dev in ('cpu', cuda):
        model = W.Wav2Vec(cfg, dev, seed=4)
        queue = [{k: v.to(dev) for k, v in d.items()} for d in draws]

        def loss_fn(model, micro, generator, aux):
            out = W.wav2vec_forward(model, cfg, micro['audio'],
                                    micro['mask_idx'], temp=aux['temp'],
                                    draws=queue.pop(0), training=True)
            loss, met = W.contrastive_loss(out)
            return loss, {'correct': met['correct'], 'count': met['count']}
        state = TR.TrainState(model, opt.init(dict(model.named_parameters())))
        step = TR.make_train_step(cfg, opt, bf16=True, loss_fn=loss_fn,
                                  loss_has_aux=True)
        counts = (K1.lstm_recurrence.launches,
                  K1.lstm_recurrence_bwd.launches)
        state, met = step(state, TR.device_batch(host, 2, dev), lr, None,
                          {'temp': 1.0})
        counts = (K1.lstm_recurrence.launches - counts[0],
                  K1.lstm_recurrence_bwd.launches - counts[1])
        res.append((float(met['loss']), float(met['grad_norm']), counts,
                    {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()}))
    (l0, g0, c0, p0), (l1, g1, c1, p1) = res
    assert c0 == (0, 0) and c1 == (2 * cfg.enc_layers, 2 * cfg.enc_layers)
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert abs(g1 - g0) <= 1e-4 * g0
    for k, v in p0.items():
        assert _max_abs(p1[k], v) <= 2 * lr + 1e-6, k


def test_raw_finetune_step_cuda_matches_cpu(cuda):
    """One fp32 step of a small RawTransducer (the DEFAULT FrontEnd, 2 x 64
    LSTM encoder without time reduction, int16 audio) with the raw
    trainer's loss on CUDA against the CPU: loss 1e-5 rel, grad_norm 1e-4
    rel, params within 2 lr; K7-K10 once per micro-batch."""
    import dataclasses
    from edgedict_tpu_torch import optim
    from edgedict_tpu_torch import train as TR
    from edgedict_tpu_torch.models.wav2vec import RawTransducer
    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
    from edgedict_tpu_torch.raw_trainer import raw_features
    from edgedict_tpu_torch.models.wav2vec import DEFAULT_FRONTEND
    cfg, _, _, _ = _small_stream()
    cfg = dataclasses.replace(cfg, vocab_size=40, input_size=128,
                              enc_time_reductions=())
    rng = np.random.RandomState(0)
    host = {'audio': (rng.randn(4, 9600) * 3000).astype(np.int16),
            'alen': np.array([9600, 8000, 9600, 7000], np.int32),
            'ys': rng.randint(4, 40, (4, 5)).astype(np.int32),
            'ylen': np.array([5, 4, 3, 5], np.int32)}

    def loss_fn(model, micro, generator, aux):
        xs, xlen = raw_features(model, DEFAULT_FRONTEND, micro['audio'],
                                micro['alen'])
        return T.transducer_loss(model, cfg, xs, micro['ys'], xlen,
                                 micro['ylen'])
    opt = optim.build_optimizer('adam', gradclip=1.0)
    kernels = (KJ.joint_lse_fwd, KJ.joint_lse_bwd, KL.lattice_alpha,
               KL.lattice_beta_grad)
    lr, res = 1e-3, []
    for dev in ('cpu', cuda):
        model = RawTransducer(cfg, dev, seed=5)
        state = TR.TrainState(model, opt.init(dict(model.named_parameters())))
        step = TR.make_train_step(cfg, opt, bf16=False, loss_fn=loss_fn)
        before = [k.launches for k in kernels]
        state, met = step(state, TR.device_batch(host, 2, dev), lr)
        res.append((float(met['loss']), float(met['grad_norm']),
                    [k.launches - c for k, c in zip(kernels, before)],
                    {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()}))
    (l0, g0, c0, p0), (l1, g1, c1, p1) = res
    assert c0 == [0] * 4 and c1 == [2] * 4
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert abs(g1 - g0) <= 1e-4 * g0
    for k, v in p0.items():
        assert _max_abs(p1[k], v) <= 2 * lr + 1e-6, k


def test_prefetch_batches_on_cuda_equal_device_batch(cuda):
    """The side-stream prefetch of page-locked batches hands over, in
    order, the tensors device_batch makes, while the consumer's work on
    the previous batch is still queued on the compute stream."""
    from edgedict_tpu_torch.data.collate import pin_batch
    from edgedict_tpu_torch.train import device_batch, prefetch_batches
    rng = np.random.RandomState(0)
    host = [{'audio': rng.randint(-2 ** 15, 2 ** 15, (8, 40000))
             .astype(np.int16),
             'ys': rng.randint(4, 40, (8, 9)).astype(np.int32)}
            for _ in range(4)]
    pinned = [pin_batch(b) for b in host]
    assert all(v.is_pinned() for b in pinned for v in b.values())
    sink = torch.zeros((), device=cuda)
    for i, dev in enumerate(prefetch_batches(iter(pinned), 2, cuda)):
        want = device_batch(host[i], 2, cuda)
        for k in want:
            assert dev[k].is_cuda and torch.equal(dev[k], want[k]), (i, k)
        big = torch.randn(2048, 2048, device=cuda)
        sink += (big @ big).sum() * 0 + dev['audio'].float().mean() * 0
    torch.cuda.synchronize()
    assert i == 3 and float(sink) == 0.0


def test_background_save_snapshots_cuda_state(cuda, tmp_path):
    """A background save of card tensors copies them off the card at
    submit: an in-place update right after does not reach the file."""
    from edgedict_tpu_torch import checkpoint as C
    sd = {'w': torch.zeros(256, 256, device=cuda)}
    opt = {'mu': {'w': torch.zeros(256, 256, device=cuda)},
           'count': torch.zeros((), dtype=torch.int32, device=cuda)}
    path = C.save_checkpoint(str(tmp_path), 1, sd, opt, background=True)
    sd['w'].add_(5.0)
    opt['mu']['w'].add_(5.0)
    C.wait_for_checkpoints()
    payload = C.load_checkpoint(path)
    assert float(payload['model']['w'].abs().max()) == 0.0
    assert float(payload['optim']['mu']['w'].abs().max()) == 0.0
    assert payload['model']['w'].device.type == 'cpu'


# ---------------------------------------------------------------------------
# the edgedict ops (K1, K11, K12 registered with torch.library) and export
# ---------------------------------------------------------------------------

def _edgedict_op_args(name, hid, b, t):
    from edgedict_tpu_torch.ops import quant as Q
    g = torch.Generator().manual_seed(hid + b + t)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    h0, c0 = r(b, hid), r(b, hid)
    if name == 'quant_matmul':
        q, s = Q.quantize_int8(r(4 * hid, hid))
        return (torch.ops.edgedict.quant_matmul.default, Q.quant_matmul,
                (r(b * t, hid), q, s, r(4 * hid)))
    if name == 'lstm_fwd_q':
        q, s = Q.quantize_int8(r(4 * hid, hid))
        return (torch.ops.edgedict.lstm_fwd_q.default, Q.lstm_recurrence_q,
                (r(t, b, 4 * hid), q, s, h0, c0))
    return (torch.ops.edgedict.lstm_fwd.default, K1.lstm_recurrence,
            (r(t, b, 4 * hid), r(4 * hid, hid) / hid ** 0.5, h0, c0))


@pytest.mark.parametrize('name', ['lstm_fwd', 'quant_matmul', 'lstm_fwd_q'])
@pytest.mark.parametrize('hid,b,t', [(16, 3, 5), (1024, 1, 2)])
def test_edgedict_op_on_cuda_matches_its_cpu_implementation(cuda, name, hid,
                                                            b, t):
    """Each op on card tensors launches its kernel once (its counter) and
    agrees with the op on the same CPU tensors (the plain version), at
    fp32's kernel tolerance; torch.library.opcheck passes on the card."""
    op, wrapper, args = _edgedict_op_args(name, hid, b, t)
    want = op(*args)
    dev_args = tuple(a.to(cuda) for a in args)
    before = wrapper.launches
    got = op(*dev_args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for g_, w_ in zip(*(x if isinstance(x, tuple) else (x,)
                        for x in (got, want))):
        assert g_.device.type == 'cuda'
        torch.testing.assert_close(g_.cpu(), w_, rtol=1e-4, atol=1e-5)
    torch.library.opcheck(op, dev_args)


def test_edgedict_op_mixed_devices_raises(cuda):
    """A CUDA tensor reaching an op launches its kernel or raises: never
    the CPU version."""
    op, _, args = _edgedict_op_args('lstm_fwd', 16, 3, 5)
    with pytest.raises(ValueError, match='CUDA tensor'):
        op(args[0].to(cuda), *args[1:])


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_export_and_reload_on_cuda(cuda, tmp_path, quantize):
    """export_transducer on the card (E6D2 layer widths, 2 layers): the
    reloaded artifacts launch K1 (int8: K11 and K12) and the exported
    decoder's text equals the live decoder's on the card; an artifact of
    the card does not load for the CPU."""
    from edgedict_tpu_torch import export as E
    from edgedict_tpu_torch.ops import quant as Q
    cfg = T.TransducerConfig(vocab_size=64, vocab_embed_size=16,
                             input_size=240, enc_hidden_size=1024,
                             enc_layers=2, enc_proj_size=640,
                             dec_hidden_size=256, dec_layers=2,
                             dec_proj_size=256, joint_size=640)
    feat = F.FeatureConfig(feature_type='logfbank', feature_size=80,
                           n_fft=512, win_length=320, hop_length=200,
                           downsample=3, pad_to_divisible=False)
    model = T.Transducer(cfg, 'cpu', seed=3)
    with torch.no_grad():
        model.joint.out.bias[0] -= 1.0
        model.joint.out.bias[3] -= 100.0

    class Tok:
        def id_to_token(self, i):
            return chr(0x100 + int(i))
    out = E.export_transducer(model, cfg, str(tmp_path / 'e'),
                              quantize=quantize, device='cuda')
    dec = E.ExportedStreamDecoder(out, F.FeaturePipeline(feat, cuda),
                                  Tok(), device='cuda')
    live = S.StreamingDecoder(model, cfg, feat, Tok(), device='cuda',
                              quantize=quantize)
    audio = (np.random.RandomState(0).randn(16000) * 0.3).astype(np.float32)
    n = (len(audio) - live.win_size) // live.hop_size + 1
    counters = (Q.quant_matmul, Q.lstm_recurrence_q, K1.lstm_recurrence,
                K2.mel_power)
    before = [c.launches for c in counters]
    text = ''.join(dec.decode(audio[i * live.hop_size:
                                    i * live.hop_size + live.win_size])
                   for i in range(n))
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched[3] == n
    if quantize:
        assert launched[0] == 3 * n and launched[1] == 2 * n
    else:
        assert launched[:2] == [0, 0] and launched[2] >= 2 * n
    assert text == live.decode_wav(audio)
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        E.ExportedStreamDecoder(out, F.FeaturePipeline(feat, 'cpu'), Tok(),
                                device='cpu')


def test_ctc_step_and_decode_cuda_match_cpu(cuda):
    """A small CTC model (models/ctc.py) on CUDA against the CPU from the
    same weights and batch, one utterance whose labels need more frames
    than it has among them: each utterance's loss 1e-5 rel (the
    infeasible one's ~1e5 would set the mean), gradients within 1e-3 of
    their largest entry, K1 and K4 once per encoder layer; greedy tokens
    equal."""
    from edgedict_tpu_torch.models import ctc as C
    from edgedict_tpu_torch.ops import rnn_kernel as K
    cfg = C.CTCConfig(vocab_size=40, input_size=24, enc_hidden_size=64,
                      enc_layers=3, enc_proj_size=48)
    rng = np.random.RandomState(0)
    xs = rng.randn(4, 30, 24).astype(np.float32)
    ys = rng.randint(1, 40, (4, 18)).astype(np.int32)
    xlen = np.array([30, 26, 30, 21])
    ylen = np.array([8, 5, 18, 3])            # item 2: 18 labels, 15 frames
    res = []
    for dev in ('cpu', cuda):
        model = C.CTCModel(cfg, dev, seed=2)
        args = [torch.as_tensor(a, device=dev) for a in (xs, ys, xlen, ylen)]
        counts = (K.lstm_recurrence.launches, K.lstm_recurrence_bwd.launches)
        loss = C.ctc_loss(model, *args)
        loss.backward()
        counts = (K.lstm_recurrence.launches - counts[0],
                  K.lstm_recurrence_bwd.launches - counts[1])
        with torch.no_grad():
            seqs, _ = C.ctc_greedy_decode(model, args[0], args[2])
            logp = C.ctc_apply(model, args[0])
            xl = T.scale_length(cfg.encoder_cfg, args[2], xs.shape[1],
                                logp.shape[1])
            per_utt = C.ctc_losses(logp, xl, args[1], args[3]).cpu()
        res.append((loss.item(), counts, seqs, per_utt,
                    {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (l0, c0, s0, u0, g0), (l1, c1, s1, u1, g1) = res
    assert c0 == (0, 0) and c1 == (cfg.enc_layers, cfg.enc_layers)
    assert l0 > 1e5 / 4 and float(u0[2]) > 1e5
    assert abs(float(u0.mean()) - l0) <= 1e-6 * abs(l0)
    for i in range(len(xlen)):
        assert abs(float(u1[i] - u0[i])) <= 1e-5 * abs(float(u0[i])), i
    for k, v in g0.items():
        assert _max_abs(g1[k], v) <= 1e-3 * float(v.abs().max()) + 1e-7, k
    assert all(np.array_equal(a, b) for a, b in zip(s0, s1))


def test_legacy_transducer_cuda_matches_cpu(cuda):
    """A small legacy transducer (models/legacy.py, H=600 as the legacy
    family's width) on CUDA against the CPU: loss 1e-5 rel and gradients
    within 1e-3 of their largest entry, through K1/K4 and the lattice's
    K9/K10; its greedy decode's tokens equal, K1 at T=1 each frame."""
    from edgedict_tpu_torch.models import legacy as L
    from edgedict_tpu_torch.ops import rnn_kernel as K
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
    cfg = L.LegacyTransducerConfig(input_size=20, vocab_size=73,
                                   vocab_embed_size=16, hidden_size=600,
                                   num_layers=2)
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 40, 20).astype(np.float32)
    ys = rng.randint(4, 73, (3, 12)).astype(np.int32)
    xlen = np.array([40, 33, 37])
    ylen = np.array([12, 7, 0])
    res = []
    for dev in ('cpu', cuda):
        model = L.LegacyTransducer(cfg, dev, seed=4)
        args = [torch.as_tensor(a, device=dev) for a in (xs, ys, xlen, ylen)]
        before = (K.lstm_recurrence.launches, KL.lattice_alpha.launches,
                  KL.lattice_beta_grad.launches)
        loss = L.legacy_transducer_loss(model, *args)
        loss.backward()
        counts = (K.lstm_recurrence.launches - before[0],
                  KL.lattice_alpha.launches - before[1],
                  KL.lattice_beta_grad.launches - before[2])
        with torch.no_grad():
            y_seq, neg = L.legacy_greedy_decode(model, args[0], args[2])
        res.append((loss.item(), counts, y_seq.cpu(), neg.cpu(),
                    {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (l0, c0, y0, n0, g0), (l1, c1, y1, n1, g1) = res
    assert c0 == (0, 0, 0) and c1 == (cfg.num_layers + 1, 1, 1)
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for k, v in g0.items():
        assert _max_abs(g1[k], v) <= 1e-3 * float(v.abs().max()) + 1e-7, k
    assert torch.equal(y0, y1)
    assert _max_abs(n1, n0) <= 1e-4 * float(n0.abs().max())


def test_spline_time_warp_cuda_matches_cpu(cuda):
    """features.time_warp(method='spline') on a (32, 427, 80) batch on
    CUDA (cuSOLVER's fp32 solve) against the CPU's resample on the same
    draws, within the flow's fp32 error (1e-4 of W + 1e-5) times the
    largest neighbour step."""
    from edgedict_tpu_torch.ops import image_warp as W
    w = 80
    feat = torch.randn(32, 427, 80, generator=torch.Generator().manual_seed(5))
    g = torch.Generator(device=cuda).manual_seed(9)
    out = F.time_warp(feat.to(cuda), w, g, method='spline')
    g = torch.Generator(device=cuda).manual_seed(9)
    center = torch.randint(w, 427 - w, (32,), generator=g, device=cuda)
    shift = torch.randint(-w, w + 1, (32,), generator=g, device=cuda)
    ref = W.time_warp_spline_resample(feat, center.cpu(), shift.cpu())
    step = max(float(feat.diff(dim=1).abs().max()),
               float(feat.diff(dim=2).abs().max()))
    assert _max_abs(out.cpu(), ref) <= (1e-4 * (w + 1) + 1e-5) * step + 1e-5
    assert _max_abs(out.cpu(), feat) > 1e-2


@pytest.mark.parametrize('tp,vs,dtype', [
    (2, 16, torch.bfloat16), (4, 5, torch.bfloat16), (2, 1024, torch.bfloat16),
    (2, 16, torch.float32), (4, 5, torch.float32)])
def test_vocab_parallel_joint_on_the_card_matches_plain(cuda, tp, vs, dtype):
    """parallel/vocab.py on the card (K7 and K8 once a slice, the sentinel
    column alone in its pad tile at V/tp = 16) against its plain version
    on the card: log-probs to 1e-4, gradients to 2e-2 of max(1, max|ref|),
    -inf nowhere."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.parallel import vocab as PV
    rng = np.random.RandomState(tp * 100 + vs)
    b, t, u, j = 3, 7, 5, 64
    v = tp * vs

    def t_(*shape, scale=1.0):
        return torch.tensor(rng.randn(*shape) * scale, dtype=torch.float32,
                            device=cuda)
    f, g = t_(b, t, j).to(dtype), t_(b, u + 1, j).to(dtype)
    w_t, bias = t_(j, v, scale=j ** -0.5), t_(v, scale=0.1)
    labels = torch.tensor(rng.randint(1, v, (b, u)), dtype=torch.int32,
                          device=cuda)
    labels[0, :tp] = torch.arange(tp, device=cuda) * vs  # every slice owns
    cot = (t_(b, t, u + 1), t_(b, t, u))
    outs = []
    for fn in (PV.vocab_parallel_joint_lse, PV.vocab_parallel_joint_lse_plain):
        leaves = [x.detach().clone().requires_grad_()
                  for x in (f, g, w_t, bias)]
        before = KJ.joint_lse_fwd.launches
        out = fn(leaves[0], leaves[1], list(leaves[2].chunk(tp, 1)),
                 list(leaves[3].chunk(tp)), labels, 0)
        launched = KJ.joint_lse_fwd.launches - before
        grads = torch.autograd.grad(out, leaves, cot)
        outs.append((out, grads, launched))
    (got, got_g, n), (want, want_g, n_plain) = outs
    assert n == tp and n_plain == 0
    for a, r in zip(got, want):
        assert torch.isfinite(a).all()
        ref_max = float(r.detach().abs().max())
        assert _max_abs(a, r) <= 1e-4 * max(1.0, ref_max)
    for a, r in zip(got_g, want_g):
        assert _max_abs(a, r) <= 2e-2 * max(1.0, float(r.float().abs().max()))


def test_vocab_parallel_fp32_matches_the_whole_vocabulary_joint(cuda):
    """Two fp32 vocabulary slices (1,024 columns + the -inf sentinel each, a
    padded chunk of -inf past it) through K7 / K8 once a slice, against the
    whole-vocabulary K7 / K8 on the same inputs: log-probs 1e-4 of max(1,
    |ref|), gradients 1e-4 relative, nothing non-finite."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.parallel import vocab as PV
    rng = np.random.RandomState(19)
    b, t, u, j, v = 2, 20, 16, 640, 2048

    def t_(*shape, scale=1.0):
        return torch.tensor(rng.randn(*shape) * scale, dtype=torch.float32,
                            device=cuda)
    f, g = t_(b, t, j), t_(b, u + 1, j)
    w_t, bias = t_(j, v, scale=j ** -0.5), t_(v, scale=0.1)
    labels = torch.tensor(rng.randint(1, v, (b, u)), dtype=torch.int32,
                          device=cuda)
    cot = (t_(b, t, u + 1), t_(b, t, u))
    outs = []
    for sliced in (True, False):
        leaves = [x.detach().clone().requires_grad_()
                  for x in (f, g, w_t, bias)]
        before = (KJ.joint_lse_fwd.launches, KJ.joint_lse_bwd.launches)
        if sliced:
            out = PV.vocab_parallel_joint_lse(
                leaves[0], leaves[1], list(leaves[2].chunk(2, 1)),
                list(leaves[3].chunk(2)), labels, 0)
        else:
            out = KJ.fused_joint_lse(*leaves, labels, 0)
        grads = torch.autograd.grad(out, leaves, cot)
        outs.append((out, grads, (KJ.joint_lse_fwd.launches - before[0],
                                  KJ.joint_lse_bwd.launches - before[1])))
    (got, got_g, n), (want, want_g, n_whole) = outs
    assert n == (2, 2) and n_whole == (1, 1)
    for a, r in zip(got, want):
        assert torch.isfinite(a).all()
        assert _max_abs(a, r) <= 1e-4 * max(1.0, float(r.abs().max()))
    for a, r in zip(got_g, want_g):
        assert torch.isfinite(a).all() and _rel_err(a, r) <= 1e-4


def test_tp_and_pp_train_steps_on_the_card_match_the_one_device_step(cuda):
    """A tiny fp32 train step at tp = 2 and at pp = 2 on [cuda:0] * 2
    against the one-device step on the card: loss rel 1e-5, params within
    2 lr (Adam's first step is g / |g|)."""
    from edgedict_tpu_torch import parallel
    from edgedict_tpu_torch import train as TR
    from edgedict_tpu_torch.parallel.pipeline import make_train_step_pp
    cfg = T.TransducerConfig(vocab_size=24, vocab_embed_size=8, input_size=20,
                             enc_hidden_size=48, enc_layers=4,
                             enc_proj_size=28, dec_hidden_size=24,
                             dec_layers=1, dec_proj_size=20, joint_size=24)
    rng = np.random.RandomState(3)
    batch = {'xs': torch.tensor(rng.randn(2, 4, 18, 20), dtype=torch.float32),
             'xlen': torch.full((2, 4), 18, dtype=torch.int32),
             'ys': torch.tensor(rng.randint(1, 24, (2, 4, 5)),
                                dtype=torch.int32),
             'ylen': torch.full((2, 4), 5, dtype=torch.int32)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    out = {}
    for name, tp, pp in (('one', 1, 1), ('tp', 2, 1), ('pp', 1, 2)):
        layout = parallel.make_layout(tp, pp, ['cuda:0'] * (tp * pp))
        opt = T.build_optimizer(cfg, 'adam', shards=parallel.vocab_shards(
            cfg, layout))
        state = TR.make_train_state(cfg, opt, cuda, seed=1, layout=layout)
        step = make_train_step_pp(cfg, opt, layout, bf16=False) if pp > 1 \
            else TR.make_train_step(cfg, opt, bf16=False)
        state, m = step(state, batch, 1e-3)
        out[name] = (float(m['loss']), state.model.state_dict())
    loss, sd = out['one']
    for name in ('tp', 'pp'):
        assert abs(out[name][0] - loss) <= 1e-5 * abs(loss)
        for k, v in sd.items():
            assert _max_abs(out[name][1][k], v) <= 2e-3 + 1e-6, (name, k)


@pytest.mark.parametrize('b,u1,v', [(64, 151, 29), (64, 61, 29),
                                    (32, 65, 2048)])
def test_embedding_table_gradient_is_bit_stable(cuda, b, u1, v):
    """The prediction net's table gradient on the card (ops/layers.py
    _Embedding: index_put_ accumulate) is the same bits on every call,
    also past F.embedding's 3,072-id sort path, whose sums vary from run
    to run (the soak's 64 x 151 and 64 x 61 char ids), and equals
    F.embedding's up to the order of the sums: within 1e-5 of its largest
    magnitude."""
    from edgedict_tpu_torch.ops import layers as L
    g = torch.Generator().manual_seed(b + u1)
    table = torch.randn(v, 64, generator=g).to(cuda).requires_grad_()
    ids = torch.randint(0, v, (b, u1), generator=g).to(cuda)
    grad = torch.randn(b, u1, 64, generator=g).to(cuda)
    grads = []
    for _ in range(5):
        table.grad = None
        L.embedding(table, ids).backward(grad)
        grads.append(table.grad.clone())
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    table.grad = None
    torch.nn.functional.embedding(ids, table).backward(grad)
    assert _max_abs(grads[0], table.grad) <= \
        1e-5 * float(table.grad.abs().max())


@pytest.mark.parametrize('b,seconds,u', [(64, 14.0, 150), (16, 8.0, 60)])
def test_soak_step_gradients_are_bit_reproducible(cuda, b, seconds, u):
    """E6D2's bf16 loss and every parameter gradient at the soak's shapes
    (edgedict_tpu_torch/scripts/soak_train.py flags: 64 x 14 s with 150
    labels, the full soak's; 16 x 8 s with 60, the smoke's; a char
    vocabulary of 29; the feature pipeline's augmentation from one seed),
    computed three times from the same parameters: the same bits every
    time, as a double resume needs."""
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import (
        feature_config_from_flags, parse_flags, transducer_config_from_flags)
    from edgedict_tpu_torch.features import FeaturePipeline
    from edgedict_tpu_torch.scripts import soak_train as SOAK
    args = SOAK.build_parser().parse_args(
        ['--batch', str(b), '--utt_seconds', str(seconds)])
    flags = parse_flags(baseline.build_parser(),
                        SOAK.flags_for(args, '/c', '/l', 1))
    fc = feature_config_from_flags(flags)
    cfg = transducer_config_from_flags(flags, 29, fc.input_size)
    pipe = FeaturePipeline(fc, cuda)
    model = T.Transducer(cfg, cuda, seed=0)
    rng = np.random.RandomState(0)
    n = int(seconds * 16000)
    audio = torch.as_tensor((rng.randn(b, n) * 0.1).astype(np.float32),
                            device=cuda)
    alen = torch.as_tensor(rng.randint(n * 3 // 4, n + 1, b),
                           dtype=torch.int32, device=cuda)
    ys = torch.as_tensor(rng.randint(1, 29, (b, u)), dtype=torch.int32,
                         device=cuda)
    ylen = torch.as_tensor(rng.randint(u * 3 // 4, u + 1, b),
                           dtype=torch.int32, device=cuda)
    runs = []
    for _ in range(3):
        g = torch.Generator(device=cuda).manual_seed(1234)
        xs, xlen = pipe(audio, alen, train=True, generator=g)
        for p in model.parameters():
            p.grad = None
        loss = T.transducer_loss(model, cfg, xs.to(torch.bfloat16), ys,
                                 xlen, ylen)
        loss.backward()
        runs.append({'loss': loss.detach().clone(),
                     **{k: p.grad.clone()
                        for k, p in model.named_parameters()}})
    for other in runs[1:]:
        differ = [k for k, v in runs[0].items() if not torch.equal(v,
                                                                   other[k])]
        assert not differ, differ
