"""Port LSTM (edgedict_tpu_torch/ops/rnn.py, K1's plain version in
ops/rnn_kernel.py) == the JAX LSTM: the lax.scan layer and the Pallas
recurrence kernel called directly in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgedict_tpu.ops import rnn as JR
from edgedict_tpu.ops import rnn_pallas
from edgedict_tpu_torch.ops import rnn as port_rnn
from edgedict_tpu_torch.ops import rnn_kernel as K1

RTOL, ATOL = 1e-4, 1e-5     # forward activations and states


def _params(rng, n_in, hid):
    k = 1.0 / np.sqrt(hid)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    # distinct b_ih / b_hh so a dropped or doubled bias shows
    return {'w_ih': u(4 * hid, n_in), 'w_hh': u(4 * hid, hid),
            'b_ih': u(4 * hid) + 0.3, 'b_hh': u(4 * hid) - 0.1}


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize('t,b', [(1, 1), (5, 3), (2, 8)])
def test_lstm_layer_tm_matches_jax_scan(t, b):
    rng = np.random.RandomState(t * 10 + b)
    p = _params(rng, 7, 16)
    xs = rng.randn(t, b, 7).astype(np.float32)
    h0 = rng.randn(b, 16).astype(np.float32) * 0.5
    c0 = rng.randn(b, 16).astype(np.float32) * 0.5
    ys_j, (h_j, c_j) = JR.lstm_layer_tm(_j(p), jnp.asarray(xs),
                                        (jnp.asarray(h0), jnp.asarray(c0)))
    ys_p, (h_p, c_p) = port_rnn.lstm_layer_tm(
        _t(p), torch.from_numpy(xs),
        (torch.from_numpy(h0), torch.from_numpy(c0)))
    for a, r in ((ys_p, ys_j), (h_p, h_j), (c_p, c_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), RTOL, ATOL)


@pytest.mark.parametrize('t,b', [(1, 2), (6, 3)])
def test_recurrence_matches_pallas_interpret(t, b):
    """K1's plain version == rnn_pallas.lstm_recurrence_tm (the TPU
    kernel, interpret mode on the CPU) on the same x_proj / W_hh."""
    rng = np.random.RandomState(40 + t)
    hid = 16
    xp = rng.randn(t, b, 4 * hid).astype(np.float32)
    w_hh = rng.uniform(-0.25, 0.25, (4 * hid, hid)).astype(np.float32)
    h0 = rng.randn(b, hid).astype(np.float32) * 0.5
    c0 = rng.randn(b, hid).astype(np.float32) * 0.5
    ys_j, h_j, c_j = rnn_pallas.lstm_recurrence_tm(
        jnp.asarray(xp), jnp.asarray(w_hh.T), jnp.asarray(h0),
        jnp.asarray(c0))
    ys_p, cs_p, h_p = K1.lstm_recurrence(
        torch.from_numpy(xp), torch.from_numpy(w_hh), torch.from_numpy(h0),
        torch.from_numpy(c0))
    np.testing.assert_allclose(ys_p.numpy(), np.asarray(ys_j), RTOL, ATOL)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), RTOL, ATOL)
    np.testing.assert_allclose(cs_p[-1].numpy(), np.asarray(c_j), RTOL, ATOL)


def test_lstm_bias_order_pinned():
    """Gate order i,f,g,o with the bias (b_ih + b_hh) applied to the input
    projection (rnn.py:245): a unit input with all weights zero isolates
    the bias, so each gate's value is checkable by hand."""
    hid = 3
    p = {'w_ih': np.zeros((4 * hid, 2), np.float32),
         'w_hh': np.zeros((4 * hid, hid), np.float32),
         'b_ih': np.array([0.5] * 3 + [-1.0] * 3 + [0.25] * 3 + [2.0] * 3,
                          np.float32),
         'b_hh': np.array([0.1] * 3 + [0.2] * 3 + [0.3] * 3 + [-0.4] * 3,
                          np.float32)}
    c0 = np.full((1, hid), 0.7, np.float32)
    ys, (h, c) = port_rnn.lstm_layer_tm(
        _t(p), torch.zeros(1, 1, 2),
        (torch.zeros(1, hid), torch.from_numpy(c0)))
    sig = lambda x: 1 / (1 + np.exp(-x))  # noqa: E731
    c_ref = sig(-0.8) * 0.7 + sig(0.6) * np.tanh(0.55)
    h_ref = sig(1.6) * np.tanh(c_ref)
    np.testing.assert_allclose(c.numpy(), np.full((1, hid), c_ref), 1e-6)
    np.testing.assert_allclose(h.numpy(), np.full((1, hid), h_ref), 1e-6)
    ys_j, _ = JR.lstm_layer_tm(_j(p), jnp.zeros((1, 1, 2)),
                               (jnp.zeros((1, hid)), jnp.asarray(c0)))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), RTOL, ATOL)


def test_stacked_lstm_matches_jax():
    rng = np.random.RandomState(7)
    layers = [_params(rng, 5, 12), _params(rng, 12, 12)]
    xs = rng.randn(2, 4, 5).astype(np.float32)         # batch-major
    hs = rng.randn(2, 2, 12).astype(np.float32) * 0.3
    cs = rng.randn(2, 2, 12).astype(np.float32) * 0.3
    out_j, (h_j, c_j) = JR.stacked_lstm(
        {'layers': [_j(p) for p in layers]}, jnp.asarray(xs),
        (jnp.asarray(hs), jnp.asarray(cs)))
    out_p, (h_p, c_p) = port_rnn.stacked_lstm(
        [_t(p) for p in layers], torch.from_numpy(xs),
        (torch.from_numpy(hs), torch.from_numpy(cs)))
    for a, r in ((out_p, out_j), (h_p, h_j), (c_p, c_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), RTOL, ATOL)


def test_bf16_recurrence_rounds_h_to_weight_dtype():
    """With bf16 W_hh the recurrent product takes h in bf16 (the TPU and
    CUDA kernels cast it) and accumulates fp32; ys come back in bf16."""
    rng = np.random.RandomState(8)
    xp = torch.from_numpy(rng.randn(3, 2, 32).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.3, 0.3, (32, 8)).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(2, 8).astype(np.float32))
    c0 = torch.zeros(2, 8)
    ys, cs, h = K1.lstm_recurrence(xp.bfloat16(), w.bfloat16(), h0, c0)
    assert ys.dtype == torch.bfloat16 and cs.dtype == h.dtype == torch.float32
    gates = xp[0].bfloat16().float() + h0.bfloat16().float() @ \
        w.bfloat16().float().t()
    i, f, g, o = gates.chunk(4, -1)
    c1 = torch.sigmoid(i) * torch.tanh(g)
    np.testing.assert_allclose(cs[0].numpy(), c1.numpy(), 1e-6, 1e-7)


def test_cpu_wrapper_uses_plain_path():
    before = K1.lstm_recurrence.launches
    K1.lstm_recurrence(torch.zeros(2, 1, 8), torch.zeros(8, 2),
                       torch.zeros(1, 2), torch.zeros(1, 2))
    assert K1.lstm_recurrence.launches == before


def test_init_and_zero_state():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = port_rnn.lstm_init(3, 4, g1), port_rnn.lstm_init(3, 4, g2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a['w_ih'].shape == (16, 3) and a['w_hh'].shape == (16, 4)
    h, c = port_rnn.lstm_zero_state(2, 3, 4, 'cpu')
    assert h.shape == c.shape == (2, 3, 4) and not h.any()
