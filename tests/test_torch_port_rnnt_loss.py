"""The port's RNN-T lattice core (ops/rnnt_loss.py:rnnt_loss_core_plain,
and rnnt_loss_kernel.rnnt_loss_core on CPU tensors, i.e. K9/K10's plain
versions) against the JAX package: rnnt_loss_pallas.rnnt_loss_core_pallas
(the TPU kernels in interpret mode) and rnnt_loss.rnnt_loss_reference.
Values rtol 1e-4 and grads rtol 1e-3 / atol 1e-4, as
tests/test_rnnt_loss_pallas.py holds them.  Edge cases: ylen = 0,
ylen = U, xlen = T, xlen = 0 (with ylen = 0, the one path that exists)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu.ops import rnnt_loss as JL
from edgedict_tpu.ops.rnnt_loss_pallas import rnnt_loss_core_pallas
from edgedict_tpu_torch.ops import rnnt_loss as PL
from edgedict_tpu_torch.ops import rnnt_loss_kernel as K


def _lp(rng, b, t, u):
    """Normalised-looking blank/label log-probs (B,T,U+1), (B,T,U)."""
    logits = rng.randn(b, t, u + 1, 3).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return lp[..., 0], lp[:, :, :u, 1]


def _lens(b, t, u, edge):
    xlen = np.full(b, t, np.int32)
    ylen = np.full(b, u, np.int32)
    if edge == 'mixed':
        xlen = np.array([t, t - 1, max(1, t - 3)][:b], np.int32)
        ylen = np.array([u, max(0, u - 1), max(0, u - 2)][:b], np.int32)
    elif edge == 'ylen0':
        ylen[:] = 0
    elif edge == 'xlen0':
        xlen[0], ylen[0] = 0, 0
    return xlen, ylen


CASES = [(3, 7, 5, 'mixed'), (2, 5, 4, 'ylen0'), (2, 6, 3, 'full'),
         (3, 4, 6, 'xlen0'), (1, 1, 1, 'full'), (2, 9, 1, 'mixed')]


def _jax_core(blank, label, xlen, ylen, w):
    def f(bl, la):
        return jnp.sum(w * rnnt_loss_core_pallas(bl, la, jnp.asarray(xlen),
                                                 jnp.asarray(ylen)))
    loss = rnnt_loss_core_pallas(jnp.asarray(blank), jnp.asarray(label),
                                 jnp.asarray(xlen), jnp.asarray(ylen))
    gb, gl = jax.grad(f, argnums=(0, 1))(jnp.asarray(blank),
                                         jnp.asarray(label))
    return np.asarray(loss), np.asarray(gb), np.asarray(gl)


@pytest.mark.parametrize('core', ['plain', 'dispatch'])
@pytest.mark.parametrize('b,t,u,edge', CASES)
def test_core_matches_pallas_core(b, t, u, edge, core):
    rng = np.random.RandomState(t * 10 + u)
    blank, label = _lp(rng, b, t, u)
    xlen, ylen = _lens(b, t, u, edge)
    w = rng.uniform(0.5, 2.0, b).astype(np.float32)   # weighted cotangent
    want = _jax_core(blank, label, xlen, ylen, w)
    fn = PL.rnnt_loss_core_plain if core == 'plain' else K.rnnt_loss_core
    bl = torch.from_numpy(blank).requires_grad_()
    la = torch.from_numpy(label).requires_grad_()
    loss = fn(bl, la, torch.from_numpy(xlen), torch.from_numpy(ylen))
    (loss * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), want[0], 1e-4, 1e-4)
    np.testing.assert_allclose(bl.grad.numpy(), want[1], 1e-3, 1e-4)
    np.testing.assert_allclose(la.grad.numpy(), want[2], 1e-3, 1e-4)


@pytest.mark.parametrize('b,t,u,edge', [(3, 4, 3, 'mixed'),
                                         (2, 3, 2, 'ylen0'),
                                         (2, 3, 3, 'xlen0'),
                                         (1, 3, 2, 'full')])
def test_rnnt_loss_matches_reference_both_packages(b, t, u, edge):
    rng = np.random.RandomState(b + t + u)
    logits = rng.randn(b, t, u + 1, 7).astype(np.float32)
    labels = rng.randint(1, 7, (b, u)).astype(np.int32)
    xlen, ylen = _lens(b, t, u, edge)
    want = np.asarray(JL.rnnt_loss_reference(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(xlen),
        jnp.asarray(ylen)))
    want_g = np.asarray(jax.grad(lambda lg: jnp.sum(JL.rnnt_loss_reference(
        lg, jnp.asarray(labels), jnp.asarray(xlen),
        jnp.asarray(ylen))))(jnp.asarray(logits)))
    args = (torch.from_numpy(labels), torch.from_numpy(xlen),
            torch.from_numpy(ylen))
    lg = torch.from_numpy(logits).requires_grad_()
    got = PL.rnnt_loss(lg, *args)
    got.sum().backward()
    ref = PL.rnnt_loss_reference(torch.from_numpy(logits), *args)
    np.testing.assert_allclose(got.detach().numpy(), want, 1e-4, 1e-4)
    np.testing.assert_allclose(ref.numpy(), want, 1e-4, 1e-4)
    np.testing.assert_allclose(lg.grad.numpy(), want_g, 1e-3, 1e-4)


def test_alpha_logz_and_no_label_transition_at_T():
    """alpha[xlen, ylen] is logZ; a path may not emit a label at t = T:
    with one frame and one label, the only path is label-then-blank."""
    blank = np.log(np.full((1, 1, 2), 0.5, np.float32))
    label = np.log(np.full((1, 1, 1), 0.25, np.float32))
    alpha, logz = PL.lattice_alpha_plain(
        torch.from_numpy(blank), torch.from_numpy(label),
        torch.tensor([1], dtype=torch.int32),
        torch.tensor([1], dtype=torch.int32))
    assert alpha.shape == (1, 2, 2)
    np.testing.assert_allclose(float(logz[0]), np.log(0.25 * 0.5), 1e-6)
    np.testing.assert_allclose(float(alpha[0, 1, 1]), float(logz[0]))


def test_cpu_core_launches_no_kernel():
    before = (K.lattice_alpha.launches, K.lattice_beta_grad.launches)
    rng = np.random.RandomState(0)
    blank, label = _lp(rng, 2, 3, 2)
    bl = torch.from_numpy(blank).requires_grad_()
    K.rnnt_loss_core(bl, torch.from_numpy(label),
                     torch.tensor([3, 2], dtype=torch.int32),
                     torch.tensor([2, 1], dtype=torch.int32)).sum().backward()
    assert bl.grad is not None
    assert (K.lattice_alpha.launches, K.lattice_beta_grad.launches) == before
