"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and at the E6D2 main paths' shapes (serving: K1-K3;
training: K4, K7/K8 in fp32 and bf16, K9/K10), plus the streaming decoder
on CUDA against the CPU.  Marked `cuda`: every test skips where no
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


# ---------------------------------------------------------------------------
# training kernels: K4 (LSTM backward), K7/K8 (fused joint), K9/K10 (lattice)
# ---------------------------------------------------------------------------

def _rel_err(a, b):
    """max |a - b| over max(1, max |b|)."""
    b = b.float()
    scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
    return _max_abs(a, b) / scale


@pytest.mark.parametrize('hid,b,t,dtype', [
    (16, 3, 5, torch.float32), (1024, 8, 16, torch.float32),
    (1024, 8, 16, torch.bfloat16), (256, 8, 65, torch.float32),
    (1030, 11, 3, torch.float32), (64, 2, 1, torch.bfloat16),
])
def test_k4_lstm_bwd_matches_plain(cuda, hid, b, t, dtype):
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
    before = K.lstm_recurrence_bwd.launches
    out = K.lstm_recurrence_bwd(xp, w, h0, c0, ys, cs, dys, dcs, dhT)
    assert K.lstm_recurrence_bwd.launches == before + 1
    ref = K.lstm_recurrence_bwd_plain(xp, w, h0, c0, ys, cs, dys, dcs, dhT)
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
        scale = max(1.0, float(r.detach().abs().max()))
        assert _max_abs(a, r) <= 1e-4 * scale
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(leaves, ref_leaves):
        assert a.grad.dtype == r.grad.dtype
        assert _rel_err(a.grad, r.grad) <= tol


@pytest.mark.parametrize('b,t,u1,edge', [
    (4, 30, 20, 'mixed'), (3, 7, 1, 'full'), (2, 12, 9, 'xlen0'),
    (32, 214, 65, 'mixed'), (2, 6, 1100, 'full'),
])
def test_k9_k10_lattice_matches_plain(cuda, b, t, u1, edge):
    from edgedict_tpu_torch.ops import rnnt_loss as PL
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as K
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
    xlen, ylen = xlen.to(cuda), ylen.to(cuda)
    alpha, logz = K.lattice_alpha(blank, label, xlen, ylen)
    r_alpha, r_logz = PL.lattice_alpha_plain(blank, label, xlen, ylen)
    assert _max_abs(logz, r_logz) <= 1e-4 * max(1.0, float(r_logz.abs()
                                                           .max()))
    gb, gl = K.lattice_beta_grad(blank, label, alpha, logz, xlen, ylen)
    r_gb, r_gl = PL.lattice_beta_grad_plain(blank, label, r_alpha, r_logz,
                                            xlen, ylen)
    # an occupancy exp(alpha + beta - logZ) carries the absolute rounding of
    # its O(|logZ|) exponent: a few fp32 ulps of |logZ|
    occ_tol = max(1e-5, 1e-6 * float(r_logz.abs().max()))
    assert _max_abs(gb, r_gb) <= occ_tol and _max_abs(gl, r_gl) <= occ_tol
    # occupancies: every path passes one blank per frame < xlen
    per_frame = gb.sum(-1)[:, :t]
    valid = torch.arange(t, device=cuda)[None] < xlen[:, None]
    assert _max_abs(per_frame[valid], torch.ones_like(per_frame[valid])) \
        <= 1e-3
