"""Port greedy frame loop (K3's plain version, edgedict_tpu_torch/ops/
decode_kernel.py) and offline greedy decode (models/decoding.py) == JAX:
the Pallas frame-loop kernel called directly in interpret mode, and the
stream.py lax.scan frame loop with EDGEDICT_PALLAS_DECODE=0.  Tokens are
exact, and every frame's top-2 logit gap is asserted > 1e-3 so that a
flip would be a fault, not a near-tie."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.models import decoding as JD
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.ops import decode_pallas
from edgedict_tpu.stream import (
    _make_chunk_step_fn, make_stream_state as j_make_state,
    prepare_inference_params as j_prepare)
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import stream as PS
from edgedict_tpu_torch.models import decoding as PD
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops import decode_kernel as K3

RTOL, ATOL = 1e-4, 1e-5          # states
LRTOL, LATOL = 1e-3, 1e-4        # log-probs (logit-derived)
UNK = 3

KW = dict(vocab_size=40, vocab_embed_size=8, input_size=9,
          enc_hidden_size=8, enc_layers=1, enc_proj_size=12,
          dec_hidden_size=16, dec_layers=2, dec_proj_size=16,
          joint_size=24, enc_time_reductions=())
JCFG, PCFG = JT.TransducerConfig(**KW), PT.TransducerConfig(**KW)


def _pair(seed=0, bias=None):
    params = JT.transducer_init(jax.random.PRNGKey(seed), JCFG)
    if bias is not None:
        col, bump = bias
        params['joint']['out']['b'] = \
            params['joint']['out']['b'].at[col].add(bump)
    params = jax.tree.map(np.asarray, params)
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), PCFG, 'cpu')
    return jax.tree.map(jnp.asarray, params), model


def _min_gap(cache, f, h_dec, hs, cs, blank, unk):
    """Smallest top-2 logit gap over the frames the greedy loop decides
    (the <unk>-masked logits where <unk> wins the raw argmax)."""
    gaps = []
    for t in range(f.shape[0]):
        g = h_dec @ cache['w_dec_t'] + cache['b_joint']
        logits = torch.tanh(f[t] + g) @ cache['w_out_t'] + cache['b_out']
        top = torch.topk(logits, 2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        if unk is not None:
            masked = logits.clone()
            masked[:, unk] = float('-inf')
            top = torch.topk(masked, 2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
        _, _, h_dec, hs, cs = K3.greedy_frame_loop_plain(
            cache, f[t:t + 1], h_dec, hs, cs, blank, unk)
    return float(torch.cat(gaps).min())


@pytest.mark.parametrize('x,expect', [
    ([1.0, 3.0, 3.0, 2.0], 1),                    # tie → first max
    ([float('-inf')] * 4, 0),                     # all -inf → first
    ([1.0, float('nan'), 5.0, float('nan')], 1),  # NaN wins, first NaN
    ([7.0, 7.0, 7.0, 7.0], 0),
    ([-2.0, -1.0, float('inf'), float('inf')], 2),
])
def test_first_argmax_ties_and_nan(x, expect):
    xs = np.array([x], np.float32)
    ref = np.asarray(decode_pallas._first_argmax(jnp.asarray(xs)))[:, 0]
    out = K3.first_argmax(torch.from_numpy(xs)).numpy()
    assert int(ref[0]) == expect
    np.testing.assert_array_equal(out, ref)


def _inputs(model, b, t, seed):
    rng = np.random.RandomState(seed)
    f = rng.randn(t, b, KW['joint_size']).astype(np.float32)
    state = PS.make_stream_state(model, PCFG, b, 'cpu')
    return f, state


@pytest.mark.parametrize('b,t,unk,emit_logp,bias', [
    (1, 6, UNK, False, None),
    (8, 1, UNK, True, None),
    (4, 10, None, True, None),
    (2, 8, UNK, False, (0, 4.0)),      # blank-heavy: state must hold
    (2, 6, UNK, True, (UNK, 6.0)),     # <unk> re-argmax everywhere
])
def test_frame_loop_matches_pallas_interpret(b, t, unk, emit_logp, bias):
    params, model = _pair(1, bias)
    f, state = _inputs(model, b, t, seed=b * 10 + t + 100)
    cache = K3.build_decode_cache(model)
    hs, cs = state.dec_state
    out = K3.greedy_frame_loop(cache, torch.from_numpy(f), state.h_dec, hs,
                               cs, 0, unk, emit_logp=emit_logp)
    ref = decode_pallas._call_kernel(
        decode_pallas.build_decode_cache(params), jnp.asarray(f),
        jnp.asarray(state.h_dec.numpy()), jnp.asarray(hs.numpy()),
        jnp.asarray(cs.numpy()), 0, unk, emit_logp=emit_logp)
    assert _min_gap(cache, torch.from_numpy(f), state.h_dec, hs, cs, 0,
                    unk) > 1e-3
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    if emit_logp:
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   LRTOL, LATOL)
    for a, r in zip(out[2:], ref[2 if emit_logp else 1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), RTOL, ATOL)
    if bias == (0, 4.0):
        assert (out[0].numpy() == 0).mean() > 0.5
    if bias == (UNK, 6.0):
        assert not (out[0].numpy() == UNK).any()


@pytest.mark.parametrize('b,t', [(1, 7), (3, 5)])
def test_frame_loop_matches_jax_scan(monkeypatch, b, t):
    """The port's stream frame loop (f = enc W_enc^T for all frames, then
    K3) == stream.py's lax.scan frame loop, the exact-math oracle."""
    monkeypatch.setenv('EDGEDICT_PALLAS_DECODE', '0')
    params, model = _pair(2)
    jp = j_prepare(params)
    enc = np.random.RandomState(t).randn(b, t, 12).astype(np.float32)
    jstate = j_make_state(jp, JCFG, batch=b)
    tok_j, hd_j, (hs_j, cs_j) = _make_chunk_step_fn(
        jp, JCFG, None, UNK).frame_loop(jp, jstate, jnp.asarray(enc))
    pm = PS.prepare_inference_params(model)
    step = PS.make_chunk_step(pm, PCFG, None, unk_id=UNK)
    pstate = PS.make_stream_state(pm, PCFG, b, 'cpu')
    tok_p, hd_p, (hs_p, cs_p) = step.frame_loop(pstate,
                                                torch.from_numpy(enc))
    f = torch.from_numpy(enc) @ pm.joint.w_enc.t()
    assert _min_gap(pm.decode_cache, f.transpose(0, 1), pstate.h_dec,
                    *pstate.dec_state, 0, UNK) > 1e-3
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
    for a, r in ((hd_p, hd_j), (hs_p, hs_j), (cs_p, cs_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), RTOL, ATOL)


def test_offline_greedy_decode_matches_jax():
    params, model = _pair(3)
    rng = np.random.RandomState(9)
    xs = rng.randn(2, 7, 9).astype(np.float32)
    xlen = np.array([7, 5], np.int32)
    y_j, len_j, nl_j = JD.transducer_greedy_decode(
        params, JCFG, jnp.asarray(xs), jnp.asarray(xlen))
    with torch.no_grad():
        y_p, len_p, nl_p = PD.transducer_greedy_decode(
            model, PCFG, torch.from_numpy(xs), torch.from_numpy(xlen))
    np.testing.assert_array_equal(y_p.numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
    np.testing.assert_allclose(nl_p.numpy(), np.asarray(nl_j), LRTOL, LATOL)


def test_decode_cache_layout_and_presummed_bias():
    """Cache layout of decode_pallas.build_decode_cache: right-multiply
    matrices, fp32, the LSTM bias summed in the param dtype first
    (decode_pallas.py:75-86), the PAD row zeroed."""
    _, model = _pair(4)
    dec = model.decoder
    with torch.no_grad():
        dec.lstm.bias_ih_l0.copy_(torch.full_like(dec.lstm.bias_ih_l0, 1.0))
        dec.lstm.bias_hh_l0.copy_(torch.full_like(dec.lstm.bias_hh_l0,
                                                  2.0 ** -9))
        dec.embed.weight[1] = 3.0
    cache = K3.build_decode_cache(model.to(torch.bfloat16))
    bias = cache['layers'][0]['bias']
    assert bias.dtype == torch.float32
    # 1 + 2^-9 rounds to 1 in bf16: summed in the param dtype, then cast
    assert torch.equal(bias, torch.ones_like(bias))
    assert cache['w_out_t'].shape == (KW['joint_size'], KW['vocab_size'])
    assert cache['w_dec_t'].shape == (KW['dec_proj_size'], KW['joint_size'])
    assert not cache['table'][1].any()


def test_cpu_wrapper_uses_plain_path():
    _, model = _pair(5)
    f, state = _inputs(model, 1, 2, seed=0)
    before = K3.greedy_frame_loop.launches
    K3.greedy_frame_loop(K3.build_decode_cache(model), torch.from_numpy(f),
                         state.h_dec, *state.dec_state, 0, UNK)
    assert K3.greedy_frame_loop.launches == before
