"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and at the E6D2 main paths' shapes (serving: K1-K3, K5,
K11-K13; training: K1, K4, K5, K6 at H=1024 B=32 T=427 bf16, K7/K8 in fp32
and bf16, K7's and K8's tensor-core paths at the E6D2 step, K3's one launch
over the card at B up to 256, K9/K10), K11's tiled kernels, the launch
plans' refusals, plus the
streaming decoder and a GRU train step on CUDA against the CPU.  Marked `cuda`: every test skips where no
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


def _k8_case(cuda, b, t, u1, j, v, seed):
    """joint_lse_bwd (bf16, tensor-core plan) and the plain version's
    gradients from the same inputs and K7's lse → (grads, ref grads)."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as K
    f, g, w_t, bias, labels, db, dl = _joint_case(
        cuda, b, t, u1, j, v, torch.bfloat16, seed)
    wt_e = w_t.to(torch.bfloat16)
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


def _traced(case):
    """{'kernels': [(name, grid)] of the device kernels of one call, by
    torch.profiler in this process, 'blocks': K3's planned grid or None} for
    `case`: (cell, dtype name) for K1 / K5 at H=256 B=8 T=16, ('k7',) for
    bf16 K7 at the E6D2 joint (J 640, V 2048), ('k3',) for K3 at E6D2's
    decoder widths, B=1 T=16."""
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


def _k3_model(cuda, blank_bias, seed=1):
    """E6D2's joint and prediction net (V 2048, J 640, 2 x 256 LSTM, D 256,
    E 64) with seeded random weights; blank biased by `blank_bias`, and
    <unk> (3) by 4 where blank is not."""
    cfg, model = _decoder_model(cuda, 2048, 640, 256, 64, 256, 2, seed)
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
    cfg, model = _k3_model(cuda, 0.0)
    cache = K3.build_decode_cache(model)
    plan = K3.card_plan(cache, torch.zeros(1, 3, 640, device=cuda),
                        torch.zeros(2, 3, 256, device=cuda))
    from edgedict_tpu_torch.ops import decode_plan as DP
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
    (16, 3, 5, torch.float32), (1030, 11, 3, torch.float32),
])
def test_k12_lstm_fwd_q_matches_plain(cuda, hid, b, t, dtype):
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
    ref = Q.lstm_recurrence_q_plain(xp, q, s, h0, c0)
    assert Q.lstm_recurrence_q.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip((ys, cs, hT), ref):
        assert _max_abs(a, r) <= tol
    h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b, hid)
    c_prev = torch.cat([c0[None], cs[:-1]]).reshape(t * b, hid)
    step = Q.lstm_recurrence_q_plain(xp.reshape(1, t * b, 4 * hid), q, s,
                                     h_prev, c_prev)
    assert _max_abs(cs, step[1].reshape(cs.shape)) <= 1e-4


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
