"""K9 and K10, the lattice alpha and beta + occupancy gradients
(csrc/rnnt_loss.cu), on the CPU: their plan (ops/rnnt_loss_kernel.py:
beta_plan) and models of their register wavefronts written out in PyTorch.

The K10 model runs the kernel's algorithm as the kernel arranges it: a block of
W warps per utterance, lane l of warp w owning the K columns u = 32 K w +
32 k + l and the beta of each of its cells on the diagonal before in a
register; beta[t, u+1] comes from lane l+1's item k through one shuffle
per k, lane 31 taking lane 0's item k+1 and, for k = K-1, the value warp
w+1 handed over through a ring of RING slots in shared memory, guarded by a
flag per warp.  The warps run in an order drawn from a seed, as far apart
as the flags allow.  The model's cell is the kernel's: beta =
log_add(log_add(term, bm + b'), lm + b_right), log_add(a, b) = max +
log1p(exp(-|a - b|)) with beta and the sums in fp64 and the correction
term in fp32, occupancies exp(alpha + lp + b' - logZ) summed in fp64 and
taken in fp32.  It is held against
ops/rnnt_loss.py:lattice_beta_grad_plain and against the JAX package's
_beta_grad_kernel in interpret mode (edgedict_tpu/ops/rnnt_loss_pallas.py),
within the tolerance chip_smoke.py holds the card to: occupancies to
max(1e-5, 1e-6 |logZ|).  T stays small at large U+1 so that interpret mode
runs in seconds.

The K9 model is the same walk run forwards, with the same lanes, items,
ring and flags mirrored: alpha[t-1, u] is the lane's own register,
alpha[t, u-1] comes from lane l-1 (lane 0 taking lane 31's item k-1 and,
for k = 0, the value warp w-1 handed over), and warp w-1 runs ahead of
warp w.  Its cell is alpha = log_add(up + bm, left + lm) in fp64 with the
correction term in fp32, stored in fp32, and logZ is the stored
alpha[xlen, ylen].  It is held against lattice_alpha_plain and the JAX
package's _alpha_kernel in interpret mode: alpha on the cells t <= xlen,
u <= ylen to max(1e-5, 1e-6 |logZ|), logZ to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu.ops import rnnt_loss_pallas as JP
from edgedict_tpu_torch.ops import rnnt_loss as PL
from edgedict_tpu_torch.ops import rnnt_loss_kernel as K

NEG = np.float32(-1e30)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('u1,warps,items', [
    (1, 1, 1), (7, 1, 1), (32, 1, 1), (33, 2, 1), (49, 2, 1), (65, 3, 1),
    (300, 10, 1), (512, 16, 1), (513, 9, 2), (1024, 16, 2), (1100, 9, 4),
    (2048, 16, 4), (2049, 9, 8), (4096, 16, 8)])
def test_beta_plan_geometry(u1, warps, items):
    plan = K.beta_plan(u1)
    assert (plan.warps, plan.items) == (warps, items)
    assert 1 <= plan.warps <= K.MAX_WARPS and plan.items in (1, 2, 4, 8)
    slots = 32 * plan.items * plan.warps
    assert slots >= u1
    # no warp owns nothing, and one column a lane up to 512 columns
    assert 32 * plan.items * (plan.warps - 1) < u1
    assert (plan.items == 1) == (u1 <= 32 * K.MAX_WARPS)
    # every column is owned by exactly one (warp, item, lane)
    owners = np.zeros(u1, int)
    for w in range(plan.warps):
        for k in range(plan.items):
            for lane in range(32):
                u = 32 * plan.items * w + 32 * k + lane
                if u < u1:
                    owners[u] += 1
    assert (owners == 1).all()


@pytest.mark.parametrize('u1', [0, -3, 4097, 10000])
def test_beta_plan_refuses(u1):
    with pytest.raises(ValueError, match=f'U\\+1={u1}'):
        K.beta_plan(u1)


# ---------------------------------------------------------------------------
# a model of the kernel
# ---------------------------------------------------------------------------

def _log_add(a, b):
    """fp64 a, b: the sums in fp64, log1p(exp(-|a - b|)) in fp32."""
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-(a - b).abs().float())).double()


def _schedule(warps, steps, seed):
    """An order of (warp, step) in which the kernel's flags let the warps
    run: warp w takes step s once warp w+1 has done step s-1 (its edge
    value) and warp w-1 has done step s - RING + 1 (the last reader of the
    ring slot step s overwrites).  Seed None: all warps in lockstep."""
    done = [0] * warps
    order = []
    rng = None if seed is None else np.random.RandomState(seed)
    while min(done) < steps:
        ready = [w for w in range(warps) if done[w] < steps
                 and (w + 1 >= warps or done[w] == 0
                      or done[w + 1] >= done[w])
                 and (w == 0 or done[w - 1] >= done[w] - K.RING + 2)]
        assert ready, 'the flags deadlock'
        if rng is None:
            batch = ready
        else:
            batch = [ready[rng.randint(len(ready))]]
        for w in batch:
            order.append((w, done[w]))
            done[w] += 1
    return order


def beta_grad_model(blank, label, alpha, logz, xlen, ylen, seed=None):
    """K10's wavefront (see the module docstring) on CPU tensors: blank
    (B, T, U+1), label (B, T, U), alpha (B, T+1, U+1), logz (B,), xlen /
    ylen (B,) → (gb, gl) as csrc/rnnt_loss.cu writes them."""
    b_n, t_len, u1 = blank.shape
    u_max = u1 - 1
    plan = K.beta_plan(u1)
    w_n, k_n = plan.warps, plan.items
    lane = torch.arange(32)
    # u of (warp, item, lane)
    u = (32 * k_n * torch.arange(w_n)[:, None, None]
         + 32 * torch.arange(k_n)[None, :, None] + lane)
    xl = xlen.long()[:, None, None]
    yl = ylen.long()[:, None, None]
    z = logz.double()[:, None, None]
    be = torch.full((b_n, w_n, k_n, 32), float(NEG), dtype=torch.float64)
    ring = torch.full((b_n, w_n, K.RING), float(NEG), dtype=torch.float64)
    gb = torch.full_like(blank, float('nan'))
    gl = torch.full_like(label, float('nan'))
    bidx = torch.arange(b_n)[:, None, None]
    steps = t_len + u_max + 1
    for w, s in _schedule(w_n, steps, seed):
        d = t_len + u_max - s
        edge = torch.full((b_n,), float(NEG), dtype=torch.float64)
        if w + 1 < w_n and s > 0:
            edge = ring[:, w + 1, (s - 1) % K.RING]
        # the shuffle: lane l reads what lane (l+1) % 32 sent; lane 0 sends
        # its item k+1, or for the last item the edge value
        mine = be[:, w]
        send = mine.clone()
        send[:, :, 0] = torch.cat([mine[:, 1:, 0], edge[:, None]], 1)
        right = send[:, :, (lane + 1) % 32]
        uu = u[w][None].expand(b_n, -1, -1)
        t = d - uu
        cell = (uu <= u_max) & (t >= 0) & (t <= t_len)
        inner = cell & (t < t_len)
        tc, uc = t.clamp(0, t_len - 1), uu.clamp(0, u_max)
        ul = uu.clamp(0, max(u_max - 1, 0))
        raw_b = blank[bidx, tc, uc]
        raw_a = alpha[bidx, tc, uc]
        raw_l = label[bidx, tc, ul] if u_max else torch.zeros_like(raw_b)
        bm = torch.where((t < xl) & (uu <= yl), raw_b, NEG).double()
        lm = torch.where((t < xl) & (uu < yl), raw_l, NEG).double()
        term = torch.where((t == xl) & (uu == yl), 0.0, NEG).double()
        raw_a = raw_a.double()
        occ_b = torch.exp((raw_a + bm + mine - z).float())
        occ_l = torch.exp((raw_a + lm + right - z).float())
        v = _log_add(term, bm + mine)
        has_right = inner & (uu < u_max)
        v = torch.where(has_right, _log_add(v, lm + right), v)
        v = torch.where(inner, v, term)
        be[:, w] = torch.where(cell, v, mine)
        bi, ki, li = torch.nonzero(inner, as_tuple=True)
        gb[bi, t[bi, ki, li], uu[bi, ki, li]] = occ_b[bi, ki, li]
        bi, ki, li = torch.nonzero(has_right, as_tuple=True)
        gl[bi, t[bi, ki, li], uu[bi, ki, li]] = occ_l[bi, ki, li]
        if w > 0:
            ring[:, w, s % K.RING] = be[:, w, 0, 0]
    return gb, gl


def alpha_model(blank, label, xlen, ylen, seed=None):
    """K9's wavefront (see the module docstring) on CPU tensors: blank
    (B, T, U+1), label (B, T, U), xlen / ylen (B,) → (alpha (B, T+1, U+1),
    logz (B,)) as csrc/rnnt_loss.cu writes them."""
    b_n, t_len, u1 = blank.shape
    u_max = u1 - 1
    plan = K.beta_plan(u1)
    w_n, k_n = plan.warps, plan.items
    lane = torch.arange(32)
    # u of (warp, item, lane)
    u = (32 * k_n * torch.arange(w_n)[:, None, None]
         + 32 * torch.arange(k_n)[None, :, None] + lane)
    xl = xlen.long().clamp(0, t_len)[:, None, None]
    yl = ylen.long().clamp(0, u_max)[:, None, None]
    up = torch.full((b_n, w_n, k_n, 32), float(NEG), dtype=torch.float64)
    ring = torch.full((b_n, w_n, K.RING), float(NEG), dtype=torch.float64)
    alpha = torch.full((b_n, t_len + 1, u1), float('nan'))
    logz = torch.full((b_n,), float('nan'))
    bidx = torch.arange(b_n)[:, None, None]
    steps = t_len + u_max + 1
    # K10's flags mirrored: warp w waits on warp w-1 (its edge value) and
    # on warp w+1 (the last reader of the ring slot it overwrites)
    order = [(w_n - 1 - w, s) for w, s in _schedule(w_n, steps, seed)]
    for w, s in order:
        edge = torch.full((b_n,), float(NEG), dtype=torch.float64)
        if w > 0 and s > 0:
            edge = ring[:, w - 1, (s - 1) % K.RING]
        # the shuffle: lane l reads what lane (l-1) % 32 sent; lane 31
        # sends its item k-1, or for the first item the edge value
        mine = up[:, w]
        send = mine.clone()
        send[:, :, 31] = torch.cat([edge[:, None], mine[:, :-1, 31]], 1)
        left = send[:, :, (lane - 1) % 32]
        uu = u[w][None].expand(b_n, -1, -1)
        t = s - uu
        cell = (uu <= u_max) & (t >= 0) & (t <= t_len)
        raw_b = blank[bidx, (t - 1).clamp(0, t_len - 1), uu.clamp(0, u_max)]
        raw_l = label[bidx, t.clamp(0, t_len - 1),
                      (uu - 1).clamp(0, max(u_max - 1, 0))] if u_max \
            else torch.zeros_like(raw_b)
        bm = torch.where((t >= 1) & (t <= xl) & (uu <= yl), raw_b,
                         NEG).double()
        lm = torch.where((t < xl) & (uu >= 1) & (uu <= yl), raw_l,
                         NEG).double()
        v = _log_add(mine + bm, left + lm)
        v = torch.where((t == 0) & (uu == 0), 0.0, v)
        up[:, w] = torch.where(cell, v, mine)
        bi, ki, li = torch.nonzero(cell, as_tuple=True)
        alpha[bi, t[bi, ki, li], uu[bi, ki, li]] = v[bi, ki, li].float()
        bi, ki, li = torch.nonzero(cell & (t == xl) & (uu == yl),
                                   as_tuple=True)
        logz[bi] = v[bi, ki, li].float()
        if w + 1 < w_n:
            ring[:, w, s % K.RING] = up[:, w, k_n - 1, 31]
    return alpha, logz


def _case(b, t, u1, edge, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, u1, 2).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    blank = np.ascontiguousarray(lp[..., 0])
    label = np.ascontiguousarray(lp[:, :, :u1 - 1, 1])
    xlen = np.full(b, t, np.int32)
    ylen = np.full(b, u1 - 1, np.int32)
    if edge == 'ragged':
        xlen = rng.randint(max(1, t - 3), t + 1, b).astype(np.int32)
        ylen = rng.randint(0, u1, b).astype(np.int32)
    elif edge == 'xlen0':
        xlen[0], ylen[0] = 0, 0
    elif edge == 'ylen0':
        ylen[:] = 0
    return blank, label, xlen, ylen


def _jax_beta_grad(blank, label, xlen, ylen):
    """The JAX package's _alpha_kernel and _beta_grad_kernel (interpret
    mode on the CPU) → (alpha, logz, gb, gl) cut to the unpadded shape."""
    b, t, u1 = blank.shape
    blank_m, label_full, labsh, xlen_p, ylen_p, dims = JP._prep(
        jnp.asarray(blank), jnp.asarray(label), jnp.asarray(xlen),
        jnp.asarray(ylen))
    alpha, logz = JP._run_alpha(blank_m, labsh, xlen_p, ylen_p, dims)
    gb, gl = JP._run_beta_grad(blank_m, label_full, alpha, logz, xlen_p,
                               ylen_p, dims)
    return (np.array(alpha)[:b, :, :u1], np.array(logz)[:b, 0],
            np.array(gb)[:b, :, :u1], np.array(gl)[:b, :, :u1 - 1])


def _jax_alpha(blank, label, xlen, ylen):
    """The JAX package's _alpha_kernel (interpret mode on the CPU) →
    (alpha, logz) cut to the unpadded shape."""
    b, t, u1 = blank.shape
    blank_m, _, labsh, xlen_p, ylen_p, dims = JP._prep(
        jnp.asarray(blank), jnp.asarray(label), jnp.asarray(xlen),
        jnp.asarray(ylen))
    alpha, logz = JP._run_alpha(blank_m, labsh, xlen_p, ylen_p, dims)
    return np.array(alpha)[:b, :, :u1], np.array(logz)[:b, 0]


def _valid(alpha, xlen, ylen):
    """The cells t <= xlen, u <= ylen of (B, T+1, U+1)."""
    _, t1, u1 = alpha.shape
    return (torch.arange(t1)[None, :, None] <= xlen.long()[:, None, None]) \
        & (torch.arange(u1)[None, None, :] <= ylen.long()[:, None, None])


# (B, T, U+1, lengths): every geometry of the plan (1, 2, 3 and 10 warps
# of one column a lane, 9 warps of 2 and of 4), T = 1, xlen = 0, ylen = 0
MODEL_CASES = [(2, 5, 1, 'full'), (3, 6, 7, 'ragged'), (2, 4, 7, 'xlen0'),
               (2, 5, 49, 'ragged'), (3, 9, 65, 'ragged'),
               (2, 1, 65, 'full'), (2, 4, 65, 'ylen0'),
               (2, 3, 300, 'ragged'), (1, 2, 600, 'ragged'),
               (1, 2, 1100, 'full'), (2, 2, 1100, 'xlen0')]


@pytest.mark.parametrize('b,t,u1,edge', MODEL_CASES)
def test_model_matches_plain_and_jax_kernel(b, t, u1, edge):
    blank, label, xlen, ylen = _case(b, t, u1, edge, b * 1000 + t * 7 + u1)
    j_alpha, j_logz, j_gb, j_gl = _jax_beta_grad(blank, label, xlen, ylen)
    args = [torch.from_numpy(x) for x in (blank, label)]
    lens = [torch.from_numpy(x) for x in (xlen, ylen)]
    alpha, logz = PL.lattice_alpha_plain(*args, *lens)
    ref_gb, ref_gl = PL.lattice_beta_grad_plain(*args, alpha, logz, *lens)
    gb, gl = beta_grad_model(*args, alpha, logz, *lens)
    tol = max(1e-5, 1e-6 * float(logz.abs().max()))
    assert not torch.isnan(gb).any() and not torch.isnan(gl).any()
    assert float((gb - ref_gb).abs().max()) <= tol
    if u1 > 1:
        assert float((gl - ref_gl).abs().max()) <= tol
    # the JAX kernel from its own alpha / logZ
    np.testing.assert_allclose(logz.numpy(), j_logz, rtol=1e-5, atol=1e-5)
    gb_j, gl_j = beta_grad_model(*args, torch.from_numpy(j_alpha),
                                 torch.from_numpy(j_logz), *lens)
    assert np.abs(gb_j.numpy() - j_gb).max() <= tol
    if u1 > 1:
        assert np.abs(gl_j.numpy() - j_gl).max() <= tol


@pytest.mark.parametrize('b,t,u1,seed', [(2, 6, 130, 1), (2, 4, 300, 2),
                                         (1, 3, 1100, 3)])
def test_model_is_the_same_in_any_order_the_flags_allow(b, t, u1, seed):
    """Warps run as far apart as the ring and the flags allow (drawn from
    a seed): the same bits as all warps in lockstep."""
    blank, label, xlen, ylen = _case(b, t, u1, 'ragged', seed)
    args = [torch.from_numpy(x) for x in (blank, label)]
    lens = [torch.from_numpy(x) for x in (xlen, ylen)]
    alpha, logz = PL.lattice_alpha_plain(*args, *lens)
    lock = beta_grad_model(*args, alpha, logz, *lens)
    loose = beta_grad_model(*args, alpha, logz, *lens, seed=seed)
    assert all(torch.equal(a, c) for a, c in zip(lock, loose))


def test_schedule_lets_warps_run_ahead_within_the_ring():
    """The flags let warp w+1 run up to RING - 1 diagonals ahead of warp
    w, never more: a producer never overwrites a slot its consumer still
    has to read."""
    order = _schedule(4, 200, seed=0)
    done = [0] * 4
    widest = 0
    for w, s in order:
        assert s == done[w]
        done[w] += 1
        for v in range(3):
            widest = max(widest, done[v + 1] - done[v])
            assert done[v + 1] - done[v] <= K.RING - 1
            assert done[v] <= done[v + 1] + 1 or done[v + 1] == 200
    assert widest > 1
    assert done == [200] * 4


@pytest.mark.parametrize('b,t,u1,edge', MODEL_CASES)
def test_alpha_model_matches_plain_and_jax_kernel(b, t, u1, edge):
    """K9's model: alpha on the cells t <= xlen, u <= ylen within
    max(1e-5, 1e-6 |logZ|) of the plain version's and the JAX kernel's,
    logZ to 1e-5, and logZ the model's stored alpha[xlen, ylen]."""
    blank, label, xlen, ylen = _case(b, t, u1, edge, b * 1000 + t * 7 + u1)
    j_alpha, j_logz = _jax_alpha(blank, label, xlen, ylen)
    args = [torch.from_numpy(x) for x in (blank, label, xlen, ylen)]
    ref_alpha, ref_logz = PL.lattice_alpha_plain(*args)
    alpha, logz = alpha_model(*args)
    valid = _valid(alpha, args[2], args[3])
    tol = max(1e-5, 1e-6 * float(ref_logz.abs().max()))
    assert not torch.isnan(alpha).any() and not torch.isnan(logz).any()
    assert float((alpha - ref_alpha)[valid].abs().max()) <= tol
    assert float((alpha - torch.from_numpy(j_alpha))[valid].abs().max()) \
        <= tol
    np.testing.assert_allclose(logz.numpy(), ref_logz.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(logz.numpy(), j_logz, rtol=1e-5, atol=1e-5)
    idx = torch.arange(b)
    assert torch.equal(logz, alpha[idx, args[2].long(), args[3].long()])
    # the masked cells are NEG-ish, as the plain version's
    assert bool((alpha[~valid] < -1e29).all())


@pytest.mark.parametrize('b,t,u1,seed', [(2, 6, 130, 1), (2, 4, 300, 2),
                                         (1, 3, 1100, 3)])
def test_alpha_model_is_the_same_in_any_order_the_flags_allow(b, t, u1,
                                                              seed):
    """K9's warps run as far apart as the mirrored ring and flags allow
    (drawn from a seed): the same bits as all warps in lockstep."""
    blank, label, xlen, ylen = _case(b, t, u1, 'ragged', seed)
    args = [torch.from_numpy(x) for x in (blank, label, xlen, ylen)]
    lock = alpha_model(*args)
    loose = alpha_model(*args, seed=seed)
    assert all(torch.equal(a, c) for a, c in zip(lock, loose))


def test_mirrored_schedule_lets_warp_w_minus_1_run_ahead():
    """K9's order: warp w takes step s only after warp w-1 has done step
    s-1 (its edge value), and warp w-1 runs at most RING - 1 steps
    ahead."""
    w_n = 4
    order = [(w_n - 1 - w, s) for w, s in _schedule(w_n, 200, seed=5)]
    done = [0] * w_n
    widest = 0
    for w, s in order:
        assert s == done[w]
        assert w == 0 or s == 0 or done[w - 1] >= s
        done[w] += 1
        for v in range(1, w_n):
            widest = max(widest, done[v - 1] - done[v])
            assert done[v - 1] - done[v] <= K.RING - 1
    assert widest > 1 and done == [200] * w_n


def test_fp64_chains_stay_within_the_tolerance_at_the_e6d2_lattice():
    """At the card tests' E6D2 lattice (B=32 T=214 U+1=65, ragged), the
    K9 -> K10 models' occupancies are within max(1e-5, 1e-6 |logZ|) of the
    plain chain run in fp64, and several times closer to it than the plain
    chain in fp32: the reason the card's chain test holds the kernels to
    the plain chain in fp64."""
    b, t, u1 = 32, 214, 65
    g = torch.Generator().manual_seed(b * t + u1)
    logits = torch.randn(b, t, u1, 2, generator=g)
    lp = logits - torch.logsumexp(logits, -1, keepdim=True)
    blank, label = lp[..., 0].contiguous(), lp[:, :, :-1, 1].contiguous()
    xlen = torch.randint(t - 5, t + 1, (b,), generator=g, dtype=torch.int32)
    ylen = torch.randint(0, u1, (b,), generator=g, dtype=torch.int32)
    wide = (blank.double(), label.double())
    r_alpha, r_logz = PL.lattice_alpha_plain(*wide, xlen, ylen)
    ref = PL.lattice_beta_grad_plain(*wide, r_alpha, r_logz, xlen, ylen)
    alpha, logz = alpha_model(blank, label, xlen, ylen)
    model = beta_grad_model(blank, label, alpha, logz, xlen, ylen)
    p_alpha, p_logz = PL.lattice_alpha_plain(blank, label, xlen, ylen)
    plain = PL.lattice_beta_grad_plain(blank, label, p_alpha, p_logz, xlen,
                                       ylen)

    def err(occ):
        return max(float((o.double() - r).abs().max())
                   for o, r in zip(occ, ref))
    tol = max(1e-5, 1e-6 * float(r_logz.abs().max()))
    assert err(model) <= tol, (err(model), err(plain), tol)
    assert 4 * err(model) < err(plain), (err(model), err(plain), tol)
