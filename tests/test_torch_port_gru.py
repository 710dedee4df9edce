"""Port GRU encoder (edgedict_tpu_torch/ops/rnn.py:gru_layer_tm, K5's plain
version in ops/gru_kernel.py, models/transducer.py module_type='GRU') ==
the JAX GRU: the lax.scan layer, the Pallas recurrence in interpret mode,
encoder_apply and the streaming decoders on the same weights; the
state_dict round trip; cli.baseline training a GRU encoder (train →
resume replaying the same losses)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.features import FeatureConfig as JFeat
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.ops import rnn as JR
from edgedict_tpu.ops import rnn_pallas
from edgedict_tpu.stream import StreamingDecoder as JStreamingDecoder
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import checkpoint as C
from edgedict_tpu_torch import stream as PS
from edgedict_tpu_torch.features import FeatureConfig as PFeat
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops import gru_kernel as K5
from edgedict_tpu_torch.ops import rnn as port_rnn

RTOL, ATOL = 1e-4, 1e-5     # forward activations and states
UNK = 3
KW = dict(vocab_size=40, vocab_embed_size=8, input_size=24,
          enc_hidden_size=32, enc_layers=2, enc_proj_size=24,
          dec_hidden_size=16, dec_layers=2, dec_proj_size=16,
          joint_size=24, enc_time_reductions=(1,), module_type='GRU')
FKW = dict(feature_type='logfbank', feature_size=8, n_fft=64, win_length=40,
           hop_length=20, downsample=3, pad_to_divisible=False)
JCFG, PCFG = JT.TransducerConfig(**KW), PT.TransducerConfig(**KW)


class _Tok:
    """One distinct character per id: equal text ⇔ equal tokens (>UNK)."""
    unk_id = UNK

    def id_to_token(self, i):
        return chr(0x100 + int(i))


def _params(rng, n_in, hid):
    k = 1.0 / np.sqrt(hid)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    # distinct b_ih / b_hh: b_hh sits inside the reset gate, b_ih outside
    return {'w_ih': u(3 * hid, n_in), 'w_hh': u(3 * hid, hid),
            'b_ih': u(3 * hid) + 0.3, 'b_hh': u(3 * hid) - 0.2}


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize('t,b', [(1, 1), (5, 3), (2, 8)])
def test_gru_layer_tm_matches_jax_scan(t, b):
    rng = np.random.RandomState(t * 10 + b)
    p = _params(rng, 7, 16)
    xs = rng.randn(t, b, 7).astype(np.float32)
    h0 = rng.randn(b, 16).astype(np.float32) * 0.5
    ys_j, h_j = JR.gru_layer_tm(_j(p), jnp.asarray(xs), jnp.asarray(h0))
    ys_p, h_p = port_rnn.gru_layer_tm(_t(p), torch.from_numpy(xs),
                                      torch.from_numpy(h0))
    for a, r in ((ys_p, ys_j), (h_p, h_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), RTOL, ATOL)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_recurrence_matches_pallas_interpret(dtype):
    """K5's plain version == rnn_pallas.gru_recurrence_tm (the TPU kernel,
    interpret mode on the CPU) on the same x_proj / W_hh / b_hh: fp32 to
    the forward tolerance, bf16 (h cast to bf16 for the dot, ys stored in
    bf16) to one bf16 ulp of h."""
    rng = np.random.RandomState(7)
    t, b, hid = 6, 3, 16
    xp = rng.randn(t, b, 3 * hid).astype(np.float32)
    w_hh = rng.uniform(-0.25, 0.25, (3 * hid, hid)).astype(np.float32)
    b_hh = rng.uniform(-0.3, 0.3, 3 * hid).astype(np.float32)
    h0 = rng.randn(b, hid).astype(np.float32) * 0.5
    jdt = jnp.dtype(dtype)
    ys_j, h_j = rnn_pallas.gru_recurrence_tm(
        jnp.asarray(xp).astype(jdt), jnp.asarray(w_hh.T).astype(jdt),
        jnp.asarray(b_hh), jnp.asarray(h0))
    tdt = getattr(torch, dtype)
    ys_p, h_p = K5.gru_recurrence(torch.from_numpy(xp).to(tdt),
                                  torch.from_numpy(w_hh).to(tdt),
                                  torch.from_numpy(b_hh), torch.from_numpy(h0))
    assert ys_p.dtype == h_p.dtype == tdt
    assert torch.equal(h_p, ys_p[-1])
    tol = (RTOL, ATOL) if dtype == 'float32' else (0.0, 1e-2)
    np.testing.assert_allclose(ys_p.float().numpy(),
                               np.asarray(ys_j.astype(jnp.float32)), *tol)
    np.testing.assert_allclose(h_p.float().numpy(),
                               np.asarray(h_j.astype(jnp.float32)), *tol)


def test_gru_layer_gradients_match_jax():
    """On the CPU the GRU layer's backward is K6's plain reverse loop:
    d(sum of outputs)/d(params, xs, h0) == jax.grad of the JAX scan
    layer."""
    rng = np.random.RandomState(3)
    t, b, n_in, hid = 4, 2, 5, 8
    p = _params(rng, n_in, hid)
    xs = rng.randn(t, b, n_in).astype(np.float32)
    h0 = rng.randn(b, hid).astype(np.float32) * 0.5
    wts = rng.randn(t, b, hid).astype(np.float32)

    def jloss(pp, x, h):
        ys, hT = JR.gru_layer_tm(pp, x, h)
        return jnp.sum(ys * wts) + jnp.sum(hT)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_j(p), jnp.asarray(xs),
                                             jnp.asarray(h0))
    tp = {k: v.requires_grad_() for k, v in _t(p).items()}
    tx = torch.from_numpy(xs).requires_grad_()
    th = torch.from_numpy(h0).requires_grad_()
    ys, hT = port_rnn.gru_layer_tm(tp, tx, th)
    ((ys * torch.from_numpy(wts)).sum() + hT.sum()).backward()
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   1e-4, 1e-5, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), 1e-4,
                               1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg[2]), 1e-4,
                               1e-5)


@pytest.fixture(scope='module')
def pair():
    params = JT.transducer_init(jax.random.PRNGKey(4), JCFG)
    # push the blank column down so random audio decodes non-empty text,
    # and widen the logits so greedy decisions sit far from near-ties
    params['joint']['out']['b'] = params['joint']['out']['b'].at[0].add(-1.0)
    params['joint']['out']['w'] = params['joint']['out']['w'] * 8.0
    params = jax.tree.map(np.asarray, params)
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), PCFG, 'cpu')
    return jax.tree.map(jnp.asarray, params), model


def test_state_dict_round_trip(pair):
    """JAX GRU params → reference state_dict (3H rows under the
    encoder.lstm.lstms.{i} keys) → the port's GRU model → state_dict →
    JAX params again, unchanged."""
    from edgedict_tpu.compat.torch_import import transducer_from_state_dict
    params, model = pair
    sd = PC.state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    hid = PCFG.enc_hidden_size
    assert sd['encoder.lstm.lstms.0.weight_ih_l0'].shape == \
        (3 * hid, PCFG.input_size)
    assert sd['encoder.lstm.lstms.1.weight_hh_l0'].shape == (3 * hid, hid)
    out = model.state_dict()
    assert set(out) == set(sd)
    for k, v in sd.items():
        assert torch.equal(out[k], v), k
    back = transducer_from_state_dict({k: v.numpy() for k, v in out.items()},
                                      JCFG)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_encoder_apply_matches_jax_with_carried_state(pair):
    """GRU encoder_apply (LayerNorm, residual, time reduction, projection)
    == JAX's, over two calls carrying the (L, B, H) state."""
    params, model = pair
    rng = np.random.RandomState(5)
    xs = rng.randn(3, 8, PCFG.input_size).astype(np.float32)
    state_j, state_p = None, None
    for half in (xs[:, :4], xs[:, 4:]):
        out_j, state_j = JT.encoder_apply(params['encoder'], JCFG,
                                          jnp.asarray(half), state_j)
        with torch.no_grad():
            out_p, state_p = PT.encoder_apply(model.encoder, PCFG,
                                              torch.from_numpy(half),
                                              state_p)
        assert state_p.shape == (2, 3, PCFG.enc_hidden_size)
        np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), RTOL,
                                   ATOL)
        np.testing.assert_allclose(state_p.numpy(), np.asarray(state_j),
                                   RTOL, ATOL)


def _audio(seed, n=4000):
    return (np.random.RandomState(seed).randn(n) * 0.3).astype(np.float32)


def test_streaming_decoder_tokens_equal_jax(pair):
    """A full GRU StreamingDecoder decode is token-exact against JAX's,
    per chunk and in layer-major blocks."""
    params, model = pair
    audio = _audio(0)
    ref = JStreamingDecoder(params, JCFG, JFeat(**FKW), _Tok(),
                            step_n_frame=2).decode_wav(audio)
    dec = PS.StreamingDecoder(model, PCFG, PFeat(**FKW), _Tok(),
                              device='cpu', step_n_frame=2)
    out = dec.decode_wav(audio)
    assert len(out) > 3
    assert out == ref
    block = PS.StreamingDecoder(model, PCFG, PFeat(**FKW), _Tok(),
                                device='cpu', step_n_frame=2, block_chunks=4)
    assert block.decode_wav(audio) == out


def test_multistream_gru_state_and_reset(pair):
    """MultiStreamDecoder carries the GRU's single (L, B, H) state: each
    stream's text equals its single-stream decode, and reset_stream
    resets one stream's row only."""
    _, model = pair
    feat = PFeat(**FKW)
    ms = PS.MultiStreamDecoder(model, PCFG, feat, _Tok(), 3, device='cpu')
    audios = [_audio(10 + i, 1500) for i in range(3)]
    chunks = [PS._chunks(a, ms.win_size, ms.hop_size) for a in audios]
    texts = [''] * 3
    for r in range(len(chunks[0])):
        out = ms.decode(np.stack([c[r] for c in chunks]))
        texts = [t + o for t, o in zip(texts, out)]
    single = PS.StreamingDecoder(model, PCFG, feat, _Tok(), device='cpu')
    assert texts == [single.decode_wav(a) for a in audios]
    assert isinstance(ms.state.enc_state, torch.Tensor)
    before = ms.state.enc_state.clone()
    ms.reset_stream(1)
    after = ms.state.enc_state
    assert torch.equal(after[:, 1], ms._fresh.enc_state[:, 1])
    assert torch.equal(after[:, 0], before[:, 0])
    assert torch.equal(after[:, 2], before[:, 2])


def test_gru_cli_baseline_train_resume_replays_losses(tmp_path):
    """cli.baseline --enc_type GRU on the CPU (the K5/K6 plain versions):
    train 6 steps (checkpoints at 3 and 6); resume from 3 in a copy of the
    run: steps 4-6 replay the same losses and end on the same params, bit
    for bit, and the GRU weights moved."""
    from test_torch_port_train import _cli_args, _write_corpus

    from edgedict_tpu_torch.cli import baseline
    corpus = _write_corpus(str(tmp_path / 'libri'))
    args = _cli_args(corpus, str(tmp_path / 'logs'), 'gru') + [
        '--enc_type', 'GRU']
    lines_a = []
    a = baseline.main(args + ['--mode', 'train'], log_fn=lines_a.append)
    assert a.state.step == 6 and a.cfg.module_type == 'GRU'
    steps_a = [ln for ln in lines_a if ln.startswith('step ')]
    assert len(steps_a) == 6
    ckpt = C.checkpoint_path(a.logdir, 6)
    final_a = C.load_checkpoint(ckpt)['model']
    first = C.load_checkpoint(C.checkpoint_path(a.logdir, 3))['model']
    key = 'encoder.lstm.lstms.0.weight_hh_l0'
    assert final_a[key].shape == (3 * 16, 16)
    assert not torch.equal(final_a[key], first[key])
    os.remove(ckpt)
    lines_b = []
    b = baseline.main(args + ['--mode', 'resume', '--resume_step', '3'],
                      log_fn=lines_b.append)
    assert 'resumed from step 3' in lines_b
    steps_b = [ln for ln in lines_b if ln.startswith('step ')]
    strip = lambda ln: ln.rsplit(' (', 1)[0]  # noqa: E731  (drop the clock)
    assert [strip(x) for x in steps_b] == [strip(x) for x in steps_a[3:]]
    for k, v in b.state.model.state_dict().items():
        assert torch.equal(v, final_a[k]), k
