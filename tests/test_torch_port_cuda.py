"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and at the E6D2 main path's shapes, plus the streaming
decoder on CUDA against the CPU.  Marked `cuda`: every test skips where no
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
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


@pytest.mark.parametrize('hid,b,t,dtype', [
    (16, 3, 5, torch.float32), (1024, 1, 2, torch.float32),
    (1024, 8, 16, torch.float32), (1024, 8, 2, torch.bfloat16),
    (1024, 8, 16, torch.bfloat16),
    (256, 8, 1, torch.float32), (1030, 11, 3, torch.float32),
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
    (1, 1320, 512, 200, 80), (8, 64000, 512, 200, 80), (3, 999, 64, 20, 8),
])
def test_k2_mel_power_matches_plain(cuda, b, n, n_fft, hop, mels):
    cfg = F.FeatureConfig(feature_size=mels, n_fft=n_fft,
                          win_length=n_fft * 5 // 8, hop_length=hop)
    pipe = F.FeaturePipeline(cfg, cuda)
    x = torch.randn(b, n, generator=torch.Generator().manual_seed(n))
    x[:, : n // 4] *= 1e-4
    x = F.preemphasis(x.to(cuda))
    out = K2.mel_power(x, pipe.tables)
    ref = K2.mel_power_plain(x, pipe.tables)
    assert out.shape == ref.shape == (b, 1 + n // hop, mels)
    diff = (torch.log(out + 1e-20) - torch.log(ref + 1e-20)).abs()
    assert float(diff.max()) <= 5e-3


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
