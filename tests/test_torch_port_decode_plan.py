"""K3's one-launch design on the CPU: its launch plan (ops/decode_plan.py)
and its algorithm written out in PyTorch.

The algorithm (`_sliced_loop`): G blocks each own a balanced slice of J,
V, the hidden units (4 gate columns each) and D; per frame jh and the
logits are formed slice by slice, each slice gives every stream a
partial (first max with NaN first, first max without <unk>, sum of exp
relative to the first), and the partials are combined in the kernel's
fixed order (w lanes per stream each fold a share in block order, then a
butterfly over the lanes) into the token and the log-prob; the LSTM
layers and the projection run per slice on the state of emitting streams
only. Held against greedy_frame_loop_plain and the JAX package's Pallas
frame loop in interpret mode: tokens exact, state and log-probs to 1e-5
/ 1e-4, with ties between columns of different slices (the first wins),
a NaN in a later slice, <unk> best with its runner-up in another slice,
all-blank and never-blank runs, B = 1, 3, 8 and block counts that divide
none of J, V, 4H and D (also more blocks than columns: empty slices).
The plan places every B from 1 to 256 at E6D2's widths on the H100 and
refuses what it cannot place."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu.ops import decode_pallas
from edgedict_tpu_torch.ops import decode_kernel as K3
from edgedict_tpu_torch.ops import decode_plan as P

from test_torch_port_decode import KW, _inputs, _pair

H100_SMS = 132
UNK = 3
NEG = float('-inf')


def _better(v, i, v2, i2):
    """The kernel's combine: NaN beats numbers (first NaN), larger wins,
    ties keep the smaller column."""
    n1, n2 = np.isnan(v), np.isnan(v2)
    if n1 and n2:
        return v, min(i, i2)
    if n2 or (not n1 and (v2 > v or (v2 == v and i2 < i))):
        return v2, i2
    return v, i


def _partial(x, v0, unk):
    """A slice's partial over its logits x (columns v0 ..): (first max,
    its column, first max without <unk>, its column, sum exp(x - max))."""
    bv, bi, b2v, b2i = NEG, None, NEG, None
    for c, val in enumerate(x):
        bv, bi = _better(bv, np.inf if bi is None else bi, val, v0 + c)
        b2v, b2i = _better(b2v, np.inf if b2i is None else b2i,
                           NEG if v0 + c == unk else val, v0 + c)
    s = np.float32(0.0)
    if bv != NEG:
        s = np.float32(np.exp(np.float32(x) - np.float32(bv)).sum())
    return bv, bi, b2v, b2i, s


def _part_lanes(pc):
    """Lanes per stream in the kernel's step 3 (part_lanes)."""
    w = 32
    while w > 1 and w * pc > 256:
        w //= 2
    return w


class _Pick:
    """The kernel's running pick over partials (struct Pick): first max
    (NaN first) and its column, the same without <unk>, and (m, s), s the
    sum of exp(x - m) over the numbers seen."""

    def __init__(self):
        self.bv, self.bi, self.b2v, self.b2i = NEG, np.inf, NEG, np.inf
        self.m, self.s = NEG, np.float32(0.0)

    def _lse(self, m2, s2):
        if np.isnan(m2) or m2 == NEG:
            return
        mn = max(self.m, m2)
        self.s = np.float32(self.s * np.exp(np.float32(self.m - mn))
                            + s2 * np.exp(np.float32(m2 - mn)))
        self.m = mn

    def add(self, p):
        self.bv, self.bi = _better(self.bv, self.bi, p[0],
                                   np.inf if p[1] is None else p[1])
        self.b2v, self.b2i = _better(self.b2v, self.b2i, p[2],
                                     np.inf if p[3] is None else p[3])
        self._lse(p[0], p[4])

    def merged(self, other):
        out = _Pick()
        out.__dict__.update(self.__dict__)
        out.bv, out.bi = _better(out.bv, out.bi, other.bv, other.bi)
        out.b2v, out.b2i = _better(out.b2v, out.b2i, other.b2v, other.b2i)
        out._lse(other.m, other.s)
        return out


def _sliced_loop(cache, f, h_dec, hs, cs, blank, unk, emit_logp, blocks):
    """K3's algorithm over `blocks` slices (fp32) → the plain loop's
    outputs."""
    t_n, b_n, j = f.shape
    v = cache['w_out_t'].shape[1]
    hid = hs.shape[2]
    d = cache['w_proj_t'].shape[1]
    sl = {n: [(P.split(n, g, blocks), P.split(n, g + 1, blocks))
              for g in range(blocks)] for n in {j, v, hid, d}}
    hs, cs = hs.clone(), cs.clone()
    h_dec = h_dec.clone()
    tokens, logps = [], []
    for t in range(t_n):
        jh = torch.cat([torch.tanh(
            f[t][:, a:z] + (h_dec @ cache['w_dec_t'][:, a:z]
                            + cache['b_joint'][a:z])) for a, z in sl[j]], 1)
        parts = [[_partial((jh[b] @ cache['w_out_t'][:, a:z]
                            + cache['b_out'][a:z]).numpy(), a, unk)
                  for a, z in sl[v]] for b in range(b_n)]
        pred, lp = [], []
        w = _part_lanes(min(b_n, P.PART_CHUNK))
        for b in range(b_n):
            # lane ln folds partials ln, ln + w, .. in block order, then a
            # butterfly over the w lanes merges them
            lanes = [_Pick() for _ in range(w)]
            for q, p in enumerate(parts[b]):
                lanes[q % w].add(p)
            off = 1
            while off < w:
                lanes = [lanes[i].merged(lanes[i ^ off]) for i in range(w)]
                off *= 2
            pk = lanes[0]
            tok = int(pk.b2i if unk is not None and pk.bi == unk else pk.bi)
            pred.append(tok)
            lp.append(np.nan if np.isnan(pk.bv) or pk.m == NEG
                      else -np.log(pk.s))
        emit = torch.tensor([p != blank for p in pred])
        tokens.append(pred)
        logps.append(lp)
        if not emit.any():
            continue
        x = cache['table'][torch.tensor(pred)]
        for li, lay in enumerate(cache['layers']):
            h_new = hs[li].clone()
            c_new = cs[li].clone()
            for a, z in sl[hid]:                  # the block's units
                if a == z:
                    continue
                cols = torch.cat([torch.arange(a, z) + q * hid
                                  for q in range(4)])
                gates = (x @ lay['w_ih_t'][:, cols] + hs[li]
                         @ lay['w_hh_t'][:, cols]) + lay['bias'][cols]
                gi, gf, gg, go = gates.split(z - a, dim=1)
                c = torch.sigmoid(gf) * cs[li][:, a:z] \
                    + torch.sigmoid(gi) * torch.tanh(gg)
                c_new[:, a:z] = torch.where(emit[:, None], c, cs[li][:, a:z])
                h_new[:, a:z] = torch.where(
                    emit[:, None], torch.sigmoid(go) * torch.tanh(c),
                    hs[li][:, a:z])
            hs[li], cs[li] = h_new, c_new
            x = h_new
        for a, z in sl[d]:
            h_dec[:, a:z] = torch.where(
                emit[:, None], x @ cache['w_proj_t'][:, a:z]
                + cache['b_proj'][a:z], h_dec[:, a:z])
    tokens = torch.tensor(tokens, dtype=torch.int32).reshape(t_n, b_n)
    logp = torch.tensor(logps, dtype=torch.float32).reshape(t_n, b_n) \
        if emit_logp else None
    return tokens, logp, h_dec, hs, cs


def _setup(seed, b, t, bias=None, tie=None, nan_col=None):
    params, model = _pair(seed, bias)
    cache = K3.build_decode_cache(model)
    if tie is not None:                           # column tie[1] := tie[0]
        c1, c2 = tie
        cache['w_out_t'][:, c2] = cache['w_out_t'][:, c1]
        cache['b_out'][c2] = cache['b_out'][c1]
        params['joint']['out']['w'] = jnp.asarray(
            cache['w_out_t'].t().numpy())
        params['joint']['out']['b'] = jnp.asarray(cache['b_out'].numpy())
    if nan_col is not None:
        cache['b_out'][nan_col] = float('nan')
        params['joint']['out']['b'] = jnp.asarray(cache['b_out'].numpy())
    f, state = _inputs(model, b, t, seed=b * 10 + t + 300)
    hs, cs = state.dec_state
    return params, cache, torch.from_numpy(f), state.h_dec, hs, cs


def _check(out, ref, emit_logp):
    np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
    if emit_logp:
        np.testing.assert_allclose(out[1].numpy(), ref[1].numpy(), 1e-4,
                                   1e-5)
    for a, r in zip(out[2:], ref[2:]):
        np.testing.assert_allclose(a.numpy(), r.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize('blocks', [7, 132])
@pytest.mark.parametrize('b,t,bias,emit_logp', [
    (1, 6, None, True),
    (3, 5, None, False),
    (8, 4, None, True),
    (3, 6, (0, 20.0), True),           # all blank: the state must hold
    (3, 6, (0, -20.0), False),         # never blank
    (3, 5, (UNK, 6.0), True),          # <unk> best, the runner-up elsewhere
])
def test_sliced_loop_matches_plain_and_pallas(blocks, b, t, bias,
                                              emit_logp):
    params, cache, f, h_dec, hs, cs = _setup(1, b, t, bias)
    args = (cache, f, h_dec, hs, cs, 0, UNK, emit_logp)
    out = _sliced_loop(*args, blocks)
    ref = K3.greedy_frame_loop_plain(*args)
    _check(out, ref, emit_logp)
    jref = decode_pallas._call_kernel(
        decode_pallas.build_decode_cache(params), jnp.asarray(f.numpy()),
        jnp.asarray(h_dec.numpy()), jnp.asarray(hs.numpy()),
        jnp.asarray(cs.numpy()), 0, UNK, emit_logp=emit_logp)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jref[0]))
    for a, r in zip(out[2:], jref[2 if emit_logp else 1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), 1e-4, 1e-5)
    if bias == (0, 20.0):
        assert (out[0] == 0).all()
        for a, r in zip(out[2:], (h_dec, hs, cs)):
            assert torch.equal(a, r)
    if bias == (0, -20.0):
        assert (out[0] != 0).all()
    if bias == (UNK, 6.0):
        assert not (out[0] == UNK).any()


def test_tie_across_slices_keeps_the_first_column():
    """Columns 5 and 33 (slices 0 and 5 of 7 over V = 40) give equal
    logits and win every frame: the token is 5, in the model, the plain
    loop and the Pallas kernel."""
    v = KW['vocab_size']
    assert P.split(v, 1, 7) <= 5 < 33 and P.split(v, 5, 7) <= 33
    params, cache, f, h_dec, hs, cs = _setup(2, 3, 4, (5, 30.0), tie=(5, 33))
    args = (cache, f, h_dec, hs, cs, 0, UNK, True)
    out = _sliced_loop(*args, 7)
    ref = K3.greedy_frame_loop_plain(*args)
    _check(out, ref, True)
    assert (out[0] == 5).all()
    jref = decode_pallas._call_kernel(
        decode_pallas.build_decode_cache(params), jnp.asarray(f.numpy()),
        jnp.asarray(h_dec.numpy()), jnp.asarray(hs.numpy()),
        jnp.asarray(cs.numpy()), 0, UNK, emit_logp=True)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jref[0]))


def test_nan_in_a_later_slice_wins():
    """A NaN logit at column 37 (the last slice of 7) is the token of every
    frame (the first NaN beats every number) and its log-prob is NaN."""
    params, cache, f, h_dec, hs, cs = _setup(3, 2, 3, nan_col=37)
    args = (cache, f, h_dec, hs, cs, 0, UNK, True)
    out = _sliced_loop(*args, 7)
    ref = K3.greedy_frame_loop_plain(*args)
    np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
    assert (out[0] == 37).all()
    assert torch.isnan(out[1]).all() and torch.isnan(ref[1]).all()
    for a, r in zip(out[2:], ref[2:]):
        np.testing.assert_allclose(a.numpy(), r.numpy(), 1e-5, 1e-5)
    jref = decode_pallas._call_kernel(
        decode_pallas.build_decode_cache(params), jnp.asarray(f.numpy()),
        jnp.asarray(h_dec.numpy()), jnp.asarray(hs.numpy()),
        jnp.asarray(cs.numpy()), 0, UNK, emit_logp=False)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jref[0]))


def test_split_gives_balanced_slices_covering_each_dimension():
    for n, blocks in ((640, 132), (2048, 132), (256, 132), (40, 7),
                      (16, 132), (24, 7)):
        bounds = [P.split(n, g, blocks) for g in range(blocks + 1)]
        assert bounds[0] == 0 and bounds[-1] == n
        sizes = [z - a for a, z in zip(bounds, bounds[1:])]
        assert min(sizes) >= 0 and max(sizes) <= -(-n // blocks)
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize('b', range(1, 257))
def test_decode_plan_places_every_server_batch_at_e6d2(b):
    plan = P.decode_plan(b, 640, 2048, 64, 2, 256, 256, H100_SMS, 1)
    assert plan.blocks == H100_SMS and plan.cols == (5, 16, 2, 2)
    assert plan.stream_chunk == b and plan.smem <= P.SMEM_PER_BLOCK
    assert (plan.barriers_blank, plan.barriers_emit) == (2, 5)
    smem, scratch = P.layout_floats(b, 640, 2048, 64, 2, 256, 256, H100_SMS,
                                    b)
    assert plan.smem == 4 * smem and plan.scratch_floats == scratch
    # the weight slices alone: ~9.6 MB over 132 blocks plus row padding
    weights = 256 * 12 + 640 * 20 + (64 + 256) * 12 + (256 + 256) * 12 \
        + 256 * 4
    assert smem >= weights and 4 * weights < 120_000


def test_decode_plan_chunks_streams_and_refuses():
    big = P.decode_plan(1000, 640, 2048, 64, 2, 256, 256, H100_SMS, 1)
    assert big.stream_chunk == P.STREAM_CHUNK
    with pytest.raises(ValueError, match='L=5'):
        P.decode_plan(1, 640, 2048, 64, 5, 256, 256, H100_SMS, 1)
    with pytest.raises(ValueError, match='shared memory'):
        P.decode_plan(20000, 640, 2048, 64, 2, 256, 256, H100_SMS, 1)
    with pytest.raises(ValueError, match='holds 0'):
        P.decode_plan(1, 640, 2048, 64, 2, 256, 256, H100_SMS, 0)
    with pytest.raises(ValueError, match='16 bits'):
        P.decode_plan(1, 64, 70000, 8, 1, 16, 16, 1, 1)
    with pytest.raises(ValueError, match='B=0'):
        P.decode_plan(0, 640, 2048, 64, 2, 256, 256, H100_SMS, 1)
