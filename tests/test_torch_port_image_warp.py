"""The port's polyharmonic sparse image warp and legacy spline time warp
(edgedict_tpu_torch/ops/image_warp.py, features.time_warp(method='spline'))
== the JAX package's (edgedict_tpu/ops/image_warp.py) on the same inputs,
the time warp on JAX's own draws; and the spline's exact properties (it
interpolates its control values, reproduces affine functions, a zero flow
leaves the image as it is, content moves toward dst) held by the port
itself.

Tolerances.  Both packages solve the spline system in fp32 (LAPACK through
XLA and through torch), and the system is ill-conditioned: its entries grow
as r² log r² (~1e6 at the 427-frame width of a spectrogram) beside the
1e-6 ridge, so two solves agree elementwise only relative to the output's
scale (measured: the dense flow to ~3e-5 of its largest value, 1.6 and
1.8e-3 pixels at flows of 49 and 59; spline values to 1e-5 of their
largest).  Outputs are therefore held at 1e-4 of the reference's largest
magnitude (+ 1e-5), the ROADMAP's rtol 1e-4 taken against that scale; the
warped image, whose bilinear sample moves by at most the flow's error times
the largest step between neighbouring pixels, at that product.  Without
boundary anchors two control points leave the affine part to the ridge
alone (singular but for it), so that case is held to the exact properties
only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu import features as JF
from edgedict_tpu.ops import image_warp as JW
from edgedict_tpu_torch import features as PF
from edgedict_tpu_torch.ops import image_warp as PW

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _close(a, r, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol, atol)


def _close_to_scale(a, r):
    """|a - r| <= 1e-4 max|r| + 1e-5 (the module note)."""
    r = np.asarray(r)
    np.testing.assert_allclose(a.numpy(), r, 0,
                               RTOL * np.abs(r).max() + ATOL)


def test_spline_interpolates_and_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.rand(2, 7, 2) * 10
    vals = rng.randn(2, 7, 3)
    query = rng.rand(2, 11, 2) * 10
    out = PW.polyharmonic_interpolate(_t(pts), _t(vals), _t(pts),
                                      regularization=1e-9)
    _close(out, vals, 1e-3, 1e-3)
    for order in (1, 2, 3, 4):
        got = PW.polyharmonic_interpolate(_t(pts), _t(vals), _t(query),
                                          order=order)
        want = JW.polyharmonic_interpolate(jnp.asarray(pts, jnp.float32),
                                           jnp.asarray(vals, jnp.float32),
                                           jnp.asarray(query, jnp.float32),
                                           order=order)
        _close_to_scale(got, want)
    w, v = PW.polyharmonic_solve(_t(pts), _t(vals))
    assert w.shape == (2, 7, 3) and v.shape == (2, 3, 3)


def test_spline_reproduces_affine_functions():
    """Affine training values: the rbf weights vanish and the interpolant
    is exact everywhere."""
    rng = np.random.RandomState(1)
    pts = rng.rand(1, 6, 2) * 8
    a, bb = rng.randn(2, 2), rng.randn(2)
    vals = pts @ a + bb
    q = rng.rand(1, 20, 2) * 8
    out = PW.polyharmonic_interpolate(_t(pts), _t(vals), _t(q),
                                      regularization=1e-9)
    _close(out, q @ a + bb, 1e-3, 1e-3)


@pytest.mark.parametrize('boundary', [0, 1, 3])
def test_sparse_image_warp_matches_jax(boundary):
    """With anchors, the dense flows and the warped image == JAX's; for
    every anchor count a zero flow leaves the image as it is."""
    rng = np.random.RandomState(2 + boundary)
    img = rng.randn(2, 12, 16).astype(np.float32)
    src = np.array([[[4.0, 5.0], [8.0, 11.0]]] * 2, np.float32)
    dst = src + rng.uniform(-2, 2, src.shape).astype(np.float32)
    warped, flows = PW.sparse_image_warp(_t(img), _t(src), _t(dst),
                                         num_boundary_points=boundary)
    wj, fj = JW.sparse_image_warp(jnp.asarray(img), jnp.asarray(src),
                                  jnp.asarray(dst),
                                  num_boundary_points=boundary)
    assert warped.shape == (2, 12, 16) and flows.shape == (2, 12, 16, 2)
    if boundary:
        _close_to_scale(flows, fj)
        step = max(np.abs(np.diff(img, axis=1)).max(),
                   np.abs(np.diff(img, axis=2)).max())
        _close(warped, wj, 0, (RTOL * np.abs(np.asarray(fj)).max() + ATOL)
               * step + ATOL)
    # zero flow: the image as it is
    same, zero = PW.sparse_image_warp(_t(img), _t(src), _t(src),
                                      num_boundary_points=boundary)
    _close(same, img, 0, 1e-4)
    _close(zero, np.zeros_like(fj), 0, 1e-5)


def test_warp_moves_content_toward_dst():
    """A +3 pixel shift of the one control point: the bright column at
    t=10 reads back at t=13 on the control row (output[p] =
    input[p - flow])."""
    img = np.zeros((1, 8, 32), np.float32)
    img[0, :, 10] = 1.0
    warped, _ = PW.sparse_image_warp(_t(img), _t([[[4.0, 10.0]]]),
                                     _t([[[4.0, 13.0]]]))
    assert int(warped[0, 4].argmax()) == 13


def _jax_draws(key, b, t, w):
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, (b,), w, t - w)),
            np.array(jax.random.randint(k2, (b,), -w, w + 1)))


@pytest.mark.parametrize('b,t,f,w', [(4, 40, 6, 5), (3, 12, 6, 3),
                                     (2, 64, 12, 8), (4, 200, 80, 40),
                                     (2, 427, 80, 80)])
def test_time_warp_spline_matches_jax_on_its_draws(b, t, f, w):
    """time_warp_spline_resample on the (t0, shift) that JAX's
    time_warp_spline draws from its key == its output (tolerances in the
    module note), and the dense flows behind it likewise."""
    feat = np.random.RandomState(t).randn(b, t, f).astype(np.float32)
    key = jax.random.PRNGKey(b * t)
    ref = np.asarray(JW.time_warp_spline(key, jnp.asarray(feat),
                                         warp_param=w))
    t0, shift = _jax_draws(key, b, t, w)
    out = PW.time_warp_spline_resample(_t(feat), torch.from_numpy(t0),
                                       torch.from_numpy(shift))
    assert out.shape == feat.shape and out.dtype == torch.float32
    # the flows the warp used (the reference's (F, T) image orientation)
    y = np.full((b,), f // 2, np.float32)
    src = np.stack([y, t0.astype(np.float32)], -1)[:, None]
    dst = np.stack([y, (t0 + shift).astype(np.float32)], -1)[:, None]
    img = feat.transpose(0, 2, 1)
    _, fj = JW.sparse_image_warp(jnp.asarray(img), jnp.asarray(src),
                                 jnp.asarray(dst), num_boundary_points=1)
    _, fp = PW.sparse_image_warp(_t(img), _t(src), _t(dst),
                                 num_boundary_points=1)
    flow_tol = 1e-4 * np.abs(np.asarray(fj)).max() + ATOL
    _close(fp, fj, 0, flow_tol)
    step = max(np.abs(np.diff(feat, axis=1)).max(),
               np.abs(np.diff(feat, axis=2)).max())
    _close(out, ref, 0, flow_tol * step + ATOL)
    assert np.abs(ref - feat).max() > 1e-3


@pytest.mark.parametrize('b,t,w', [(2, 48, 6), (3, 12, 6)])
def test_features_time_warp_spline_method(b, t, w):
    """features.time_warp(method='spline') draws from its generator as the
    linear warp does, then resamples with the spline: the same draws give
    time_warp_spline_resample's output; a short sequence passes through
    (T <= 2W+1), as in JAX's features.time_warp."""
    feat = _t(np.random.RandomState(4).randn(b, t, 8))
    out = PF.time_warp(feat, w, torch.Generator().manual_seed(7),
                       method='spline')
    assert out.shape == feat.shape
    if t <= 2 * w + 1:
        assert torch.equal(out, feat)
        ref = JF.time_warp(jax.random.PRNGKey(7), jnp.asarray(feat.numpy()),
                           warp_param=w, method='spline')
        np.testing.assert_array_equal(np.asarray(ref), feat.numpy())
        return
    g = torch.Generator().manual_seed(7)
    center = torch.randint(w, t - w, (b,), generator=g)
    shift = torch.randint(-w, w + 1, (b,), generator=g)
    assert torch.equal(out, PW.time_warp_spline_resample(feat, center,
                                                         shift))
    assert not torch.equal(out, PF.time_warp(
        feat, w, torch.Generator().manual_seed(7)))
