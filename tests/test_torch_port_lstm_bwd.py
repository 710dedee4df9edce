"""K4's plain version (ops/rnn_kernel.py:lstm_recurrence_bwd_plain) and the
port's LSTM autograd.Function (CPU path) against jax.vjp of the JAX
package's custom-vjp recurrence, rnn_pallas.lstm_recurrence_tm, whose
forward and backward Pallas kernels run in interpret mode on the CPU.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (tests/test_rnn_pallas.py); bf16
values are compared in fp32 at 2e-2, two bf16 ulps of the unit-scale
dgates, because one-ulp flips of a rounded dgate move the sums that follow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu.ops import rnn_pallas
from edgedict_tpu_torch.ops import rnn as port_rnn
from edgedict_tpu_torch.ops import rnn_kernel as K

HID = 16


def _case(t, b, seed):
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(HID)
    f32 = np.float32
    return dict(
        xp=rng.randn(t, b, 4 * HID).astype(f32),
        w=rng.uniform(-2 * k, 2 * k, (4 * HID, HID)).astype(f32),
        h0=(rng.randn(b, HID) * 0.5).astype(f32),
        c0=(rng.randn(b, HID) * 0.5).astype(f32),
        dys=rng.randn(t, b, HID).astype(f32),
        dhT=rng.randn(b, HID).astype(f32),
        dcT=rng.randn(b, HID).astype(f32))


def _round(x, dtype):
    """numpy fp32 → values representable in `dtype` (bf16 rounding)."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def _jax_grads(c, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xp = jnp.asarray(c['xp']).astype(jdt)
    w_t = jnp.asarray(c['w'].T).astype(jdt)
    out, vjp = jax.vjp(rnn_pallas.lstm_recurrence_tm, xp, w_t,
                       jnp.asarray(c['h0']), jnp.asarray(c['c0']))
    cot = (jnp.asarray(c['dys']).astype(jdt),
           jnp.asarray(c['dhT']).astype(out[1].dtype),
           jnp.asarray(c['dcT']))
    dxp, dw_t, dh0, dc0 = vjp(cot)
    f = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f(dxp), f(dw_t).T, f(dh0), f(dc0)


def _tol(dtype):
    return (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('t,b', [(1, 1), (3, 3), (5, 8), (1, 8), (5, 1)])
def test_autograd_function_matches_jax_vjp(t, b, dtype):
    c = _case(t, b, seed=10 * t + b)
    if dtype == torch.bfloat16:
        c['dhT'] = _round(c['dhT'], dtype)   # JAX's hT is bf16 there
    want = _jax_grads(c, dtype)
    xp = torch.from_numpy(c['xp']).to(dtype).requires_grad_()
    w = torch.from_numpy(c['w']).to(dtype).requires_grad_()
    h0 = torch.from_numpy(c['h0']).requires_grad_()
    c0 = torch.from_numpy(c['c0']).requires_grad_()
    ys, cs, hT = K.lstm_recurrence(xp, w, h0, c0)
    torch.autograd.backward(
        (ys, hT, cs[-1]),
        (torch.from_numpy(c['dys']).to(dtype), torch.from_numpy(c['dhT']),
         torch.from_numpy(c['dcT'])))
    got = (xp.grad, w.grad, h0.grad, c0.grad)
    assert xp.grad.dtype == w.grad.dtype == dtype
    rtol, atol = _tol(dtype)
    for name, a, r in zip(('dx_proj', 'dw_hh', 'dh0', 'dc0'), got, want):
        np.testing.assert_allclose(a.float().numpy(), r, rtol, atol,
                                   err_msg=name)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('t,b', [(1, 3), (3, 1), (5, 3), (3, 8)])
def test_bwd_plain_matches_jax_vjp(t, b, dtype):
    """The reverse loop itself, with the forward's ys/cs and a dcs that
    carries the final-state cotangent in its last row."""
    c = _case(t, b, seed=7 * t + b)
    if dtype == torch.bfloat16:
        c['dhT'] = _round(c['dhT'], dtype)
    want = _jax_grads(c, dtype)
    xp = torch.from_numpy(c['xp']).to(dtype)
    w = torch.from_numpy(c['w']).to(dtype)
    h0, c0 = torch.from_numpy(c['h0']), torch.from_numpy(c['c0'])
    ys, cs, _ = K.lstm_recurrence_plain(xp, w, h0, c0)
    dcs = torch.zeros_like(cs)
    dcs[-1] = torch.from_numpy(c['dcT'])
    dgates, dh0, dc0 = K.lstm_recurrence_bwd_plain(
        xp, w, h0, c0, ys, cs, torch.from_numpy(c['dys']).to(dtype), dcs,
        torch.from_numpy(c['dhT']))
    assert dgates.dtype == dtype and dh0.dtype == dc0.dtype == torch.float32
    rtol, atol = _tol(dtype)
    for a, r in ((dgates, want[0]), (dh0, want[2]), (dc0, want[3])):
        np.testing.assert_allclose(a.float().numpy(), r, rtol, atol)


def test_cpu_backward_takes_plain_path():
    before = K.lstm_recurrence_bwd.launches
    xp = torch.randn(3, 2, 8, requires_grad=True)
    ys, _, _ = K.lstm_recurrence(xp, torch.zeros(8, 2), torch.zeros(2, 2),
                                 torch.zeros(2, 2))
    ys.sum().backward()
    assert xp.grad is not None
    assert K.lstm_recurrence_bwd.launches == before


def test_layer_grads_match_torch_autograd_of_plain_loop():
    """Through ops/rnn.py (input projection, bias, recurrence): the
    Function's gradients equal autograd through the plain loop."""
    rng = np.random.RandomState(3)
    p = {k: torch.from_numpy(rng.uniform(-0.3, 0.3, s).astype(np.float32))
         for k, s in (('w_ih', (32, 5)), ('w_hh', (32, 8)), ('b_ih', (32,)),
                      ('b_hh', (32,)))}
    xs = torch.from_numpy(rng.randn(4, 3, 5).astype(np.float32))
    state = (torch.zeros(3, 8), torch.zeros(3, 8))
    pa = {k: v.clone().requires_grad_() for k, v in p.items()}
    ys, _ = port_rnn.lstm_layer_tm(pa, xs, state)
    (ys ** 2).sum().backward()
    pb = {k: v.clone().requires_grad_() for k, v in p.items()}
    x_proj = xs @ pb['w_ih'].t() + (pb['b_ih'] + pb['b_hh'])
    ref, _, _ = K.lstm_recurrence_plain(x_proj, pb['w_hh'], *state)
    (ref ** 2).sum().backward()
    for k in p:
        np.testing.assert_allclose(pa[k].grad.numpy(), pb[k].grad.numpy(),
                                   1e-5, 1e-6, err_msg=k)
