"""K7/K8's plain version (ops/joint_lse_kernel.py:fused_joint_lse_plain,
what `fused_joint_lse` runs for CPU tensors) against the JAX package's
fused kernel joint_lse_pallas.fused_joint_lse in interpret mode, forward
and all four gradients (rtol 1e-5 / 1e-4, as tests/test_joint_lse_pallas.py).
The TPU kernel refuses U+1 > 256; the port has no envelope, so at U+1 in
{300, 511, 700} the port's rnnt_loss_from_joint is held against the JAX
package's chunked rnnt_loss_from_joint instead: loss rtol 1e-5, each grad
to 1e-3 of its largest entry, because logZ of such a lattice is O(1e3), so
each occupancy exp(alpha + beta - logZ) carries about 1e3 fp32 ulps of
relative error in either package, and the grads sum hundreds of them with
cancellation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu.ops import joint_lse_pallas
from edgedict_tpu.ops import rnnt_loss as JL
from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.ops import joint_lse_kernel as K
from edgedict_tpu_torch.ops import rnnt_loss as PL


def _case(seed, b=2, t=5, u=6, j=16, v=32):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return dict(f=rng.randn(b, t, j).astype(f32),
                g=rng.randn(b, u + 1, j).astype(f32),
                w_t=(rng.randn(j, v) * 0.3).astype(f32),
                bias=(rng.randn(v) * 0.1).astype(f32),
                labels=rng.randint(1, v, (b, u)).astype(np.int32),
                wb=rng.randn(b, t, u + 1).astype(f32),
                wl=rng.randn(b, t, u).astype(f32))


@pytest.mark.parametrize('b,t,u,blank', [(2, 5, 6, 0), (1, 7, 3, 0),
                                          (3, 4, 9, 2)])
def test_forward_and_grads_match_pallas(b, t, u, blank):
    c = _case(b * 100 + t * 10 + u, b=b, t=t, u=u)
    keys = ('f', 'g', 'w_t', 'bias')

    def jloss(f, g, w_t, bias):
        bl, la = joint_lse_pallas.fused_joint_lse(
            f, g, w_t, bias, jnp.asarray(c['labels']), blank)
        return jnp.sum(bl * c['wb']) + jnp.sum(la * c['wl']), (bl, la)

    (_, (jb, jl)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(c[k]) for k in keys])
    tt = {k: torch.from_numpy(c[k]).requires_grad_() for k in keys}
    pb, pl = K.fused_joint_lse(tt['f'], tt['g'], tt['w_t'], tt['bias'],
                               torch.from_numpy(c['labels']), blank)
    ((pb * torch.from_numpy(c['wb'])).sum()
     + (pl * torch.from_numpy(c['wl'])).sum()).backward()
    np.testing.assert_allclose(pb.detach().numpy(), np.asarray(jb), 1e-5,
                               1e-5)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl), 1e-5,
                               1e-5)
    for k, want in zip(keys, jg):
        np.testing.assert_allclose(tt[k].grad.numpy(), np.asarray(want),
                                   1e-4, 1e-5, err_msg=k)


def test_bf16_products_round_h_and_w():
    """bf16 f/g: h is rounded to bf16 before the product and W is used in
    bf16, the sum in fp32 (the kernel's numerics)."""
    c = _case(5)
    f = torch.from_numpy(c['f']).bfloat16()
    g = torch.from_numpy(c['g']).bfloat16()
    bl, _ = K.fused_joint_lse_plain(f, g, torch.from_numpy(c['w_t']),
                                    torch.from_numpy(c['bias']),
                                    torch.from_numpy(c['labels']), 0)
    h = torch.tanh(f.float()[:, :, None] + g.float()[:, None])
    logits = h.bfloat16().float() @ torch.from_numpy(c['w_t']).bfloat16() \
        .float() + torch.from_numpy(c['bias'])
    want = logits[..., 0] - torch.logsumexp(logits, -1)
    assert bl.dtype == torch.float32
    np.testing.assert_allclose(bl.numpy(), want.numpy(), 1e-6, 1e-6)


def _joint_params(rng, e, d, j, v):
    k = 1.0 / np.sqrt(e + d)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {'w_enc': u(j, e), 'w_dec': u(j, d), 'b': u(j),
            'out': {'w': u(v, j) * 4, 'b': u(v)}}


def _port_joint(p, e, d, j, v):
    cfg = T.TransducerConfig(vocab_size=v, enc_proj_size=e, dec_proj_size=d,
                             joint_size=j)
    joint = T.Joint(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        joint.joint[0].weight.copy_(torch.from_numpy(
            np.concatenate([p['w_enc'], p['w_dec']], 1)))
        joint.joint[0].bias.copy_(torch.from_numpy(p['b']))
        joint.joint[2].weight.copy_(torch.from_numpy(p['out']['w']))
        joint.joint[2].bias.copy_(torch.from_numpy(p['out']['b']))
    return joint


@pytest.mark.parametrize('u1', [300, 511, 700])
def test_no_u_envelope_matches_jax_chunked_joint(u1):
    e, d, j, v, b, t = 6, 5, 8, 12, 1, 3
    rng = np.random.RandomState(u1)
    p = _joint_params(rng, e, d, j, v)
    h_enc = rng.randn(b, t, e).astype(np.float32)
    h_dec = rng.randn(b, u1, d).astype(np.float32)
    labels = rng.randint(1, v, (b, u1 - 1)).astype(np.int32)
    xlen = np.array([t], np.int32)
    ylen = np.array([u1 - 1], np.int32)

    def jloss(pp, he, hd):
        return jnp.sum(JL.rnnt_loss_from_joint(
            pp, he, hd, jnp.asarray(labels), jnp.asarray(xlen),
            jnp.asarray(ylen), time_chunk=2))

    jp = jax.tree.map(jnp.asarray, p)
    want, (gp, ge, gd) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jp, jnp.asarray(h_enc), jnp.asarray(h_dec))
    joint = _port_joint(p, e, d, j, v)
    he = torch.from_numpy(h_enc).requires_grad_()
    hd = torch.from_numpy(h_dec).requires_grad_()
    got = PL.rnnt_loss_from_joint(joint, he, hd, torch.from_numpy(labels),
                                  torch.from_numpy(xlen),
                                  torch.from_numpy(ylen), time_chunk=2)
    got.sum().backward()
    np.testing.assert_allclose(float(got.detach().sum()), float(want), 1e-5)
    w0_want = np.concatenate([gp['w_enc'], gp['w_dec']], 1)
    for a, r in ((he.grad, ge), (hd.grad, gd),
                 (joint.joint[2].weight.grad, gp['out']['w']),
                 (joint.joint[2].bias.grad, gp['out']['b']),
                 (joint.joint[0].bias.grad, gp['b']),
                 (joint.joint[0].weight.grad, w0_want)):
        a, r = np.asarray(a), np.asarray(r)
        assert np.abs(a - r).max() <= 1e-3 * np.abs(r).max()


def test_cpu_wrapper_uses_plain_path():
    c = _case(9)
    before = (K.joint_lse_fwd.launches, K.joint_lse_bwd.launches)
    f = torch.from_numpy(c['f']).requires_grad_()
    bl, _ = K.fused_joint_lse(f, torch.from_numpy(c['g']),
                              torch.from_numpy(c['w_t']),
                              torch.from_numpy(c['bias']),
                              torch.from_numpy(c['labels']), 0)
    bl.sum().backward()
    assert f.grad is not None
    assert (K.joint_lse_fwd.launches, K.joint_lse_bwd.launches) == before
