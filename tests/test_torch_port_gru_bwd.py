"""K6's plain version (ops/gru_kernel.py:gru_recurrence_bwd_plain) and the
port's GRU autograd.Function (CPU path) against jax.vjp of the JAX
package's custom-vjp recurrence, rnn_pallas.gru_recurrence_tm, whose
forward (K5) and backward (K6) Pallas kernels run in interpret mode on the
CPU.  Non-zero dhT and distinct b_ih / b_hh throughout.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (tests/test_rnn_pallas.py); bf16
values are compared in fp32 at 2e-2, two bf16 ulps of the unit-scale
gate grads, because one-ulp flips of a rounded dgh move the sums that
follow (as for K4, tests/test_torch_port_lstm_bwd.py).  On these inputs
the CPU path rounds as the JAX package does, so the bf16 grads are also
held to one bf16 ulp (the fp32 db_hh and dh0 to 1e-5): that pins h0's cast at t = 0,
dgh's cast to W's dtype before the dh product, hT's cotangent joining in
fp32, and dW_hh / db_hh as single fp32-accumulated reductions, none of
which the 2e-2 bound sees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu.ops import rnn_pallas
from edgedict_tpu_torch.ops import gru_kernel as K
from edgedict_tpu_torch.ops import rnn as port_rnn

HID = 16
SHAPES = [(1, 1), (3, 3), (5, 8), (1, 8), (5, 1)]
DTYPES = [torch.float32, torch.bfloat16]


def _case(t, b, seed):
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(HID)
    f32 = np.float32
    return dict(
        xp=(rng.randn(t, b, 3 * HID) + 0.1).astype(f32),   # incl. b_ih
        w=rng.uniform(-2 * k, 2 * k, (3 * HID, HID)).astype(f32),
        b_hh=rng.uniform(-0.5, 0.5, 3 * HID).astype(f32),
        h0=(rng.randn(b, HID) * 0.5).astype(f32),
        dys=rng.randn(t, b, HID).astype(f32),
        dhT=rng.randn(b, HID).astype(f32))


def _round(x, dtype):
    """numpy fp32 → values representable in `dtype` (bf16 rounding)."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def _jax_grads(c, dtype):
    """jax.vjp of the Pallas recurrence → (dx_proj, dW_hh (3H, H), db_hh,
    dh0) in fp32 numpy."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xp = jnp.asarray(c['xp']).astype(jdt)
    w_t = jnp.asarray(c['w'].T).astype(jdt)
    out, vjp = jax.vjp(rnn_pallas.gru_recurrence_tm, xp, w_t,
                       jnp.asarray(c['b_hh']), jnp.asarray(c['h0']))
    cot = (jnp.asarray(c['dys']).astype(jdt),
           jnp.asarray(c['dhT']).astype(out[1].dtype))
    dxp, dw_t, db, dh0 = vjp(cot)
    f = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f(dxp), f(dw_t).T, f(db), f(dh0)


def _tol(dtype):
    return (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)


def _inputs(c, dtype):
    if dtype == torch.bfloat16:
        c['dhT'] = _round(c['dhT'], dtype)   # JAX's hT is bf16 there
    return (torch.from_numpy(c['xp']).to(dtype),
            torch.from_numpy(c['w']).to(dtype), torch.from_numpy(c['b_hh']),
            torch.from_numpy(c['h0']))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('t,b', SHAPES)
def test_autograd_function_matches_jax_vjp(t, b, dtype):
    """dx_proj, dW_hh, db_hh and dh0 through gru_recurrence's backward,
    with ys and the separate hT output each carrying a cotangent."""
    c = _case(t, b, seed=10 * t + b)
    leaves = [x.requires_grad_() for x in _inputs(c, dtype)]
    want = _jax_grads(c, dtype)
    before = K.gru_recurrence_bwd.launches
    ys, hT = K.gru_recurrence(*leaves)
    assert ys.dtype == hT.dtype == dtype and hT.shape == (b, HID)
    torch.autograd.backward(
        (ys, hT), (torch.from_numpy(c['dys']).to(dtype),
                   torch.from_numpy(c['dhT']).to(dtype)))
    assert K.gru_recurrence_bwd.launches == before      # plain on the CPU
    xp, w, b_hh, h0 = leaves
    assert xp.grad.dtype == w.grad.dtype == dtype
    assert b_hh.grad.dtype == h0.grad.dtype == torch.float32
    rtol, atol = _tol(dtype)
    for name, a, r in zip(('dx_proj', 'dw_hh', 'db_hh', 'dh0'),
                          (xp.grad, w.grad, b_hh.grad, h0.grad), want):
        np.testing.assert_allclose(a.float().numpy(), r, rtol, atol,
                                   err_msg=name)


@pytest.mark.parametrize('t,b', SHAPES)
def test_bf16_grads_match_jax_to_one_ulp(t, b):
    c = _case(t, b, seed=10 * t + b)
    leaves = [x.requires_grad_() for x in _inputs(c, torch.bfloat16)]
    want = _jax_grads(c, torch.bfloat16)
    ys, hT = K.gru_recurrence(*leaves)
    torch.autograd.backward(
        (ys, hT), (torch.from_numpy(c['dys']).to(torch.bfloat16),
                   torch.from_numpy(c['dhT']).to(torch.bfloat16)))
    ulp, f32 = (2.0 ** -8, 1e-30), (1e-5, 1e-6)    # db_hh, dh0 are fp32
    for name, leaf, r, tol in zip(('dx_proj', 'dw_hh', 'db_hh', 'dh0'),
                                  leaves, want, (ulp, ulp, f32, f32)):
        np.testing.assert_allclose(leaf.grad.float().numpy(), r, *tol,
                                   err_msg=name)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('t,b', SHAPES)
def test_bwd_plain_matches_jax_vjp(t, b, dtype):
    """The reverse loop itself, on the forward's ys: dgx is dx_proj, dgh
    sums to db_hh, dh0 in fp32."""
    c = _case(t, b, seed=7 * t + b)
    xp, w, b_hh, h0 = _inputs(c, dtype)
    want = _jax_grads(c, dtype)
    ys = K.gru_recurrence_plain(xp, w, b_hh, h0)
    dgx, dgh, dh0 = K.gru_recurrence_bwd_plain(
        xp, w, b_hh, h0, ys, torch.from_numpy(c['dys']).to(dtype),
        torch.from_numpy(c['dhT']))
    assert dgx.dtype == dgh.dtype == dtype and dh0.dtype == torch.float32
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(dgx.float().numpy(), want[0], rtol, atol)
    np.testing.assert_allclose(dgh.float().sum((0, 1)).numpy(), want[2],
                               rtol, atol)
    np.testing.assert_allclose(dh0.numpy(), want[3], rtol, atol)
    # dgh differs from dgx only in the n block: da_n · r
    np.testing.assert_array_equal(dgh[..., :2 * HID].float().numpy(),
                                  dgx[..., :2 * HID].float().numpy())


def test_hT_cotangent_alone_reaches_dh0():
    """Only hT used: its cotangent enters the reverse loop at t = T-1 in
    fp32, with no dys."""
    c = _case(4, 2, seed=1)
    xp, w, b_hh, h0 = (x.requires_grad_() for x in
                       _inputs(c, torch.float32))
    _, hT = K.gru_recurrence(xp, w, b_hh, h0)
    hT.sum().backward()
    ys = K.gru_recurrence_plain(xp.detach(), w.detach(), b_hh.detach(),
                                h0.detach())
    _, _, dh0 = K.gru_recurrence_bwd_plain(
        xp.detach(), w.detach(), b_hh.detach(), h0.detach(), ys, None,
        torch.ones(2, HID))
    np.testing.assert_allclose(h0.grad.numpy(), dh0.numpy(), 1e-6, 1e-7)
    assert float(xp.grad.abs().sum()) > 0


def test_cpu_backward_takes_plain_path():
    before = (K.gru_recurrence.launches, K.gru_recurrence_bwd.launches)
    xp = torch.randn(3, 2, 12, requires_grad=True)
    ys, _ = K.gru_recurrence(xp, torch.zeros(12, 4), torch.zeros(12),
                             torch.zeros(2, 4))
    ys.sum().backward()
    assert xp.grad is not None
    assert (K.gru_recurrence.launches, K.gru_recurrence_bwd.launches) == \
        before


def test_layer_grads_match_torch_autograd_of_plain_loop():
    """Through ops/rnn.py (input projection with b_ih, b_hh inside the
    reset gate, the recurrence, hT): the Function's gradients equal
    autograd through the plain forward loop (fp32)."""
    rng = np.random.RandomState(3)
    p = {k: torch.from_numpy(rng.uniform(-0.3, 0.3, s).astype(np.float32))
         for k, s in (('w_ih', (24, 5)), ('w_hh', (24, 8)), ('b_ih', (24,)),
                      ('b_hh', (24,)))}
    xs = torch.from_numpy(rng.randn(4, 3, 5).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(3, 8).astype(np.float32) * 0.5)
    pa = {k: v.clone().requires_grad_() for k, v in p.items()}
    ha = h0.clone().requires_grad_()
    ys, hT = port_rnn.gru_layer_tm(pa, xs, ha)
    ((ys ** 2).sum() + (3.0 * hT).sum()).backward()
    pb = {k: v.clone().requires_grad_() for k, v in p.items()}
    hb = h0.clone().requires_grad_()
    x_proj = xs @ pb['w_ih'].t() + pb['b_ih']
    ref = K.gru_recurrence_plain(x_proj, pb['w_hh'], pb['b_hh'], hb)
    ((ref ** 2).sum() + (3.0 * ref[-1]).sum()).backward()
    for k in p:
        np.testing.assert_allclose(pa[k].grad.numpy(), pb[k].grad.numpy(),
                                   1e-5, 1e-6, err_msg=k)
    np.testing.assert_allclose(ha.grad.numpy(), hb.grad.numpy(), 1e-5, 1e-6)
