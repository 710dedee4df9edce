"""Polyharmonic-spline sparse image warp, the legacy SpecAugment time warp
(counterpart of edgedict_tpu/ops/image_warp.py; reference
sparse_img_wrap.py, augmentation.py:26-51).

  1. fit a polyharmonic spline (order 2 = thin-plate) to the control
     points' flows (dst - src),
  2. evaluate it on the dense pixel grid → the dense flow field,
  3. resample the image bilinearly at grid - flow (edge-clamped).

The JAX package's two documented deviations from the reference are kept:
a deterministic ridge (`regularization`) on both diagonal blocks of the
spline system instead of the reference's random jitter, and the chosen
time index (not the spectrogram value there) as the control point's
coordinate.  The solve is torch.linalg.solve in fp32, as jnp.linalg.solve
in the JAX package.  Plain PyTorch: the JAX package runs it outside
Pallas too.  `time_warp_spline_resample` is the warp as a pure function
of its draws (t0, shift); features.time_warp(method='spline') draws them.
"""

import torch

_EPS = 1e-10


def _phi(r2, order):
    """The polyharmonic radial basis on SQUARED distances r2."""
    r2 = torch.clamp(r2, min=_EPS)
    if order == 1:
        return torch.sqrt(r2)
    if order == 2:
        return 0.5 * r2 * torch.log(r2)
    if order == 4:
        return 0.5 * torch.square(r2) * torch.log(r2)
    if order % 2 == 0:
        return 0.5 * torch.pow(r2, 0.5 * order) * torch.log(r2)
    return torch.pow(r2, 0.5 * order)


def _cross_sq_dist(x, y):
    """(b, n, d) × (b, m, d) → (b, n, m) pairwise squared distances."""
    xn = (x * x).sum(-1)
    yn = (y * y).sum(-1)
    return xn[:, :, None] - 2.0 * torch.einsum('bnd,bmd->bnm', x, y) \
        + yn[:, None, :]


def polyharmonic_solve(train_points, train_values, order=2,
                       regularization=1e-6):
    """→ (w (b, n, k) rbf weights, v (b, d+1, k) affine term) with f(x) =
    Σ_i w_i φ(|x - c_i|) + [x, 1]·v interpolating train_values; the ridge
    on both diagonal blocks keeps the one-control-point system solvable."""
    b, n, d = train_points.shape
    k = train_values.shape[-1]
    dev = train_points.device
    c = train_points.float()
    f = train_values.float()
    mat_a = _phi(_cross_sq_dist(c, c), order) \
        + regularization * torch.eye(n, device=dev)[None]
    mat_b = torch.cat([c, torch.ones((b, n, 1), device=dev)], 2)
    left = torch.cat([mat_a, mat_b.transpose(1, 2)], 1)
    lower_right = (regularization * torch.eye(d + 1, device=dev))[None] \
        * torch.ones((b, 1, 1), device=dev)
    right = torch.cat([mat_b, lower_right], 1)
    lhs = torch.cat([left, right], 2)                     # (b, n+d+1, …)
    rhs = torch.cat([f, torch.zeros((b, d + 1, k), device=dev)], 1)
    sol = torch.linalg.solve(lhs, rhs)
    return sol[:, :n], sol[:, n:]


def polyharmonic_interpolate(train_points, train_values, query_points,
                             order=2, regularization=1e-6):
    """The fitted spline at query_points (b, m, d) → (b, m, k)."""
    w, v = polyharmonic_solve(train_points, train_values, order,
                              regularization)
    q = query_points.float()
    rbf = torch.einsum('bmn,bnk->bmk', _phi(
        _cross_sq_dist(q, train_points.float()), order), w)
    ones = torch.ones(q.shape[:-1] + (1,), device=q.device)
    return rbf + torch.einsum('bmd,bdk->bmk', torch.cat([q, ones], -1), v)


def _bilinear_sample(image, coords):
    """image (b, h, w), coords (b, m, 2) as (y, x) → (b, m), edge-clamped
    bilinear interpolation (reference interpolate_bilinear)."""
    b, h, w = image.shape
    y = torch.clamp(coords[..., 0], 0.0, h - 1.0)
    x = torch.clamp(coords[..., 1], 0.0, w - 1.0)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 2)
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 2)
    wy = y - y0
    wx = x - x0
    flat = image.reshape(b, h * w)

    def take(yy, xx):
        return torch.gather(flat, 1, yy * w + xx)

    top = take(y0, x0) * (1 - wx) + take(y0, x0 + 1) * wx
    bot = take(y0 + 1, x0) * (1 - wx) + take(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def sparse_image_warp(image, src_points, dst_points, order=2,
                      regularization=1e-6, num_boundary_points=0):
    """Warp `image` (b, h, w) so that the content at src_points moves to
    dst_points; num_boundary_points > 0 adds that many zero-flow anchors
    along each edge (keeps the warp local).  → (warped (b, h, w), dense
    flows (b, h, w, 2))."""
    b, h, w = image.shape
    dev = image.device
    flows = (dst_points - src_points).float()
    ctrl = dst_points.float()
    if num_boundary_points > 0:
        ys = torch.linspace(0.0, h - 1.0, num_boundary_points + 2,
                            device=dev)
        xs = torch.linspace(0.0, w - 1.0, num_boundary_points + 2,
                            device=dev)
        inner = xs[1:-1]
        edge = torch.cat([
            torch.stack([ys, torch.zeros_like(ys)], -1),
            torch.stack([ys, torch.full_like(ys, w - 1.0)], -1),
            torch.stack([torch.zeros_like(inner), inner], -1),
            torch.stack([torch.full_like(inner, h - 1.0), inner], -1),
        ], 0)                                             # (e, 2)
        edge = edge[None].expand(b, -1, -1)
        ctrl = torch.cat([ctrl, edge], 1)
        flows = torch.cat([flows, torch.zeros_like(edge)], 1)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing='ij')
    grid = torch.stack([yy, xx], -1).reshape(1, h * w, 2).expand(b, -1, -1)
    dense = polyharmonic_interpolate(ctrl, flows, grid, order,
                                     regularization)      # (b, h*w, 2)
    warped = _bilinear_sample(image.float(), grid - dense)
    return warped.reshape(b, h, w), dense.reshape(b, h, w, 2)


def time_warp_spline_resample(feat, t0, shift, num_boundary_points=1):
    """The legacy spline time warp of feat (B, T, F) as a pure function of
    its draws: per sample a control point at (F // 2, t0) moves along time
    to (F // 2, t0 + shift); boundary anchors keep the warp local.  The
    (F, T) image orientation of the reference, transposed inside."""
    b, _, f = feat.shape
    y = torch.full((b,), float(f // 2), device=feat.device)
    t0 = t0.to(feat.device)
    src = torch.stack([y, t0.float()], -1)[:, None]             # (b, 1, 2)
    dst = torch.stack([y, (t0 + shift.to(feat.device)).float()], -1)[:, None]
    warped, _ = sparse_image_warp(
        feat.transpose(1, 2).float(), src, dst,
        num_boundary_points=num_boundary_points)
    return warped.transpose(1, 2).to(feat.dtype)
