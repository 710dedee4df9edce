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
none of J, V, 4H and D (also more blocks than columns: empty slices), and
at E6D2_LARGE_Batch's prediction-net widths (H = 512, D = 640, E = 64)
with partials' chunks smaller than B, as its plan stages them there.
The plan places every B from 1 to 256 at E6D2's widths on the H100, each
bundled preset at the batches its paths run, and refuses what it cannot
place; the rows' swizzle keeps a warp's float4 reads on 8 bank groups."""

import argparse
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu.models import transducer as JT
from edgedict_tpu.ops import decode_pallas
from edgedict_tpu_torch import _build
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import config as C
from edgedict_tpu_torch import stream as PS
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops import decode_kernel as K3
from edgedict_tpu_torch.ops import decode_plan as P

from test_torch_port_decode import KW, _inputs, _pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def _sliced_loop(cache, f, h_dec, hs, cs, blank, unk, emit_logp, blocks,
                 part_chunk=None):
    """K3's algorithm over `blocks` slices (fp32), the partials staged
    part_chunk streams at a time (the plan's; default min(B, PART_CHUNK))
    → the plain loop's outputs."""
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
        w = _part_lanes(part_chunk or min(b_n, P.PART_CHUNK))
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
    # the weight slices alone: ~9.6 MB over 132 blocks, rows of whole
    # float4s
    weights = 256 * 8 + 640 * 16 + (64 + 256) * 8 + (256 + 256) * 8 \
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


# E6D2_LARGE_Batch's prediction net and embedding (2 x 512, projection 640,
# E 64) behind a narrow joint (J 24, V 40)
LKW = dict(KW, vocab_embed_size=64, dec_hidden_size=512, dec_proj_size=640)


def _large_setup(seed, b, t):
    jcfg, pcfg = JT.TransducerConfig(**LKW), PT.TransducerConfig(**LKW)
    params = jax.tree.map(np.asarray,
                          JT.transducer_init(jax.random.PRNGKey(seed), jcfg))
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), pcfg, 'cpu')
    f = np.random.RandomState(seed + b).randn(
        t, b, LKW['joint_size']).astype(np.float32)
    state = PS.make_stream_state(model, pcfg, b, 'cpu')
    hs, cs = state.dec_state
    return (jax.tree.map(jnp.asarray, params), K3.build_decode_cache(model),
            torch.from_numpy(f), state.h_dec, hs, cs)


@pytest.mark.parametrize('blocks', [7, 132])
@pytest.mark.parametrize('b,part_chunk', [(1, 1), (4, 4), (8, 3), (9, 2)])
def test_sliced_loop_at_large_prediction_net(blocks, b, part_chunk):
    """The algorithm at E6D2_LARGE_Batch's prediction-net widths (132
    blocks: 4 units and 5 projection columns a block, as on the H100), its
    partials folded part_chunk streams at a time as its plan stages them
    at large B: tokens equal to the plain loop's and the Pallas kernel's,
    state and log-probs within the stated tolerances."""
    params, cache, f, h_dec, hs, cs = _large_setup(4, b, 5)
    args = (cache, f, h_dec, hs, cs, 0, UNK, True)
    out = _sliced_loop(*args, blocks, part_chunk)
    ref = K3.greedy_frame_loop_plain(*args)
    _check(out, ref, True)
    assert (out[0] != 0).any()                 # the prediction net ran
    jref = decode_pallas._call_kernel(
        decode_pallas.build_decode_cache(params), jnp.asarray(f.numpy()),
        jnp.asarray(h_dec.numpy()), jnp.asarray(hs.numpy()),
        jnp.asarray(cs.numpy()), 0, UNK, emit_logp=True)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jref[0]))
    for a, r in zip(out[2:], jref[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), 1e-4, 1e-5)


def _preset_widths(name):
    """(J, V, E, layers, H, D) of a bundled flagfile, as the port's config
    reads it (V: the presets' BPE 2048)."""
    flags = C.parse_flags(C.add_model_flags(argparse.ArgumentParser()),
                          [f'--flagfile={REPO}/flagfiles/{name}'])
    feat = C.feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = C.transducer_config_from_flags(flags, 2048, feat.input_size)
    return (cfg.joint_size, cfg.vocab_size, cfg.vocab_embed_size,
            cfg.dec_layers, cfg.dec_hidden_size, cfg.dec_proj_size)


LARGE = 'E6D2_LARGE_Batch.txt'
PRESET_BATCHES = {'E6D2.txt': (1, 4, 8, 64, 256, 1024),
                  'E4D1.txt': (1, 2, 4, 8, 64, 256, 1024),
                  LARGE: (1, 4, 8, 64, 256)}


@pytest.mark.parametrize('name,b', [(n, b) for n, bs in
                                    PRESET_BATCHES.items() for b in bs])
def test_decode_plan_places_each_preset(name, b):
    """Each bundled preset at its eval batch, the servers' batches and the
    largest server in the records gets a plan on the H100's 132 SMs:
    E6D2 and E4D1 with the whole chunks as before, E6D2_LARGE_Batch with
    them cut to the bytes left at B = 256; the plan's bytes are
    layout_floats' at its chunks."""
    widths = _preset_widths(name)
    if name == LARGE:
        assert widths == (640, 2048, 64, 2, 512, 640)
    plan = P.decode_plan(b, *widths, H100_SMS, 1)
    assert plan.blocks == H100_SMS and plan.smem <= P.SMEM_PER_BLOCK
    smem, scratch = P.layout_floats(b, *widths, H100_SMS, plan.stream_chunk,
                                    plan.part_chunk)
    assert plan.smem == 4 * smem and plan.scratch_floats == scratch
    if name == LARGE and b == 256:
        assert (plan.part_chunk, plan.stream_chunk) == (8, 160)
    else:
        assert (plan.part_chunk, plan.stream_chunk) == (min(b, 16),
                                                       min(b, 256))


@pytest.mark.parametrize('name', ['E6D2.txt', 'E4D1.txt'])
def test_whole_chunks_place_every_batch_to_1024(name):
    """E6D2 and E4D1 keep their chunks at every B up to 1024: min(B, 16)
    streams' partials and min(B, 256) streams a product chunk."""
    widths = _preset_widths(name)
    for b in range(1, 1025):
        plan = P.decode_plan(b, *widths, H100_SMS, 1)
        smem, _ = P.layout_floats(b, *widths, H100_SMS, min(b, 256))
        assert plan.smem == 4 * smem
        assert (plan.part_chunk, plan.stream_chunk) == (min(b, 16),
                                                       min(b, 256))


def test_large_places_522_streams_and_names_the_bytes_past_them():
    """E6D2_LARGE_Batch places every B up to 522 (the block's own state of
    every stream stays in shared memory); past that the plan raises
    ValueError naming the bytes it would need."""
    widths = _preset_widths(LARGE)
    for b in range(1, 523):
        plan = P.decode_plan(b, *widths, H100_SMS, 1)
        assert plan.stream_chunk >= min(b, P.MIN_CHUNK)
    least, _ = P.layout_floats(523, *widths, H100_SMS, P.MIN_CHUNK, 1)
    with pytest.raises(ValueError, match=f'B=523 .* needs {4 * least} bytes '
                                         'of shared memory'):
        P.decode_plan(523, *widths, H100_SMS, 1)
    with pytest.raises(ValueError, match='B=1024 .* needs 276544 bytes'):
        P.decode_plan(1024, *widths, H100_SMS, 1)


@pytest.mark.parametrize('name,whole,largest', [('E6D2.txt', 2280, 3326),
                                                 ('E4D1.txt', 5193, 6836)])
def test_largest_batches_of_e6d2_and_e4d1(name, whole, largest):
    """E6D2 keeps its whole chunks up to 2,280 streams and E4D1 up to
    5,193; cut chunks then take them to 3,326 and 6,836, past which the
    plan raises naming the bytes."""
    widths = _preset_widths(name)

    def chunks(b):
        plan = P.decode_plan(b, *widths, H100_SMS, 1)
        return plan.part_chunk, plan.stream_chunk
    assert chunks(whole) == (16, 256)
    assert chunks(whole + 1) < (16, 256)
    assert chunks(largest)[1] >= P.MIN_CHUNK
    with pytest.raises(ValueError, match=f'B={largest + 1} .* bytes of '
                                         'shared memory'):
        P.decode_plan(largest + 1, *widths, H100_SMS, 1)


def test_unpadded_slices_fit_where_padded_ones_do_not():
    """At E6D2_LARGE_Batch on 132 blocks the weight slices are 180,224
    bytes; with rows padded off multiples of 8 floats in place of the
    swizzle they alone would be 234,496, over one block's 232,448."""
    j, v, e, layers, hid, d = _preset_widths(LARGE)

    def weights(pitch):
        cj, cv, cu, cd = (-(-n // H100_SMS) for n in (j, v, hid, d))
        return 4 * (d * pitch(cj) + j * pitch(cv)
                    + sum(((e if k == 0 else hid) + hid) * pitch(4 * cu)
                          for k in range(layers))
                    + hid * pitch(cd))
    padded = lambda nc: P.pitch(nc) + 4 * (P.pitch(nc) % 8 == 0)  # noqa
    assert weights(padded) == 234_496 > P.SMEM_PER_BLOCK
    assert weights(P.pitch) == 180_224


@pytest.mark.parametrize('nc', range(1, 129))
def test_row_layout_spreads_a_warp_phase_over_the_banks(nc):
    """A warp's float4 load of a slice (lanes along rows k, one float4
    column q) runs in phases of 8 lanes: those 8 rows hit 8 different
    16-byte bank groups for every q, and the swizzle permutes each row's
    float4 columns within the row."""
    p = P.pitch(nc)
    n4 = p // 4
    assert p % 4 == 0 and nc <= p <= nc + 3
    shift, mask = P.swizzle(p)
    for k in range(32):
        assert sorted(q ^ ((k >> shift) & mask) for q in range(n4)) \
            == list(range(n4))
    for q in range(n4):
        for k0 in range(0, 64, 8):
            groups = {(k * n4 + (q ^ ((k >> shift) & mask))) % 8
                      for k in range(k0, k0 + 8)}
            assert len(groups) == 8


@pytest.mark.parametrize('entry', ['edd_greedy_decode',
                                   'edd_greedy_decode_blocks_per_sm'])
def test_launcher_signature_matches_the_c_entry(entry):
    """The ctypes argument list of K3's C entries has one type per
    parameter of csrc/greedy_decode.cu (a mismatch shows only on the
    card)."""
    with open(os.path.join(_build.CSRC, 'greedy_decode.cu')) as fh:
        src = fh.read()
    m = re.search(r'extern "C" int ' + entry + r'\((.*?)\)\s*\{', src, re.S)
    params = [x for x in m.group(1).split(',') if x.strip()]
    assert len(params) == len(_build._SIGNATURES[entry])


def test_kernel_layout_equals_the_plan(tmp_path):
    """csrc/greedy_decode.cu's make_layout (its host part, built here with
    the host C++ compiler) gives layout_floats' numbers for each plan: the
    launcher refuses a plan whose bytes or scratch fall short of it."""
    import shutil
    import subprocess
    cxx = shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        pytest.skip('needs a host C++ compiler')
    with open(os.path.join(_build.CSRC, 'greedy_decode.cu')) as fh:
        src = fh.read()
    body = src[src.index('constexpr int kThreads'):src.index('struct Args {')]
    (tmp_path / 'layout.cpp').write_text(
        '#include <cstddef>\n#include <cstdio>\n#define __host__\n'
        '#define __device__\n#define __forceinline__ inline\n' + body +
        'int main() {\n  int v[10];\n'
        '  while (scanf("%d %d %d %d %d %d %d %d %d %d", v, v + 1, v + 2,'
        ' v + 3, v + 4, v + 5, v + 6, v + 7, v + 8, v + 9) == 10) {\n'
        '    Layout y = make_layout(v[0], v[1], v[2], v[3], v[4], v[5], v[6],'
        ' v[7], v[8], v[9]);\n'
        '    printf("%zu %zu\\n", y.total, y.s_total);\n  }\n}\n')
    exe = tmp_path / 'layout'
    subprocess.run([cxx, '-std=c++17', '-w', str(tmp_path / 'layout.cpp'),
                    '-o', str(exe)], check=True, timeout=120)
    cases = []
    for name in PRESET_BATCHES:
        widths = _preset_widths(name)
        for b in (1, 3, 8, 64, 256, 522, 1024):
            for blocks in (7, H100_SMS):
                try:
                    plan = P.decode_plan(b, *widths, blocks, 1)
                except ValueError:
                    continue
                cases.append(((b, *widths, blocks, plan.stream_chunk,
                               plan.part_chunk),
                              (plan.smem // 4, plan.scratch_floats)))
    # cut chunks too
    assert sum(c[0][-1] < min(c[0][0], P.PART_CHUNK) for c in cases) >= 2
    out = subprocess.run(
        [str(exe)], input='\n'.join(' '.join(map(str, c)) for c, _ in cases),
        capture_output=True, text=True, check=True, timeout=60).stdout
    got = [tuple(map(int, ln.split())) for ln in out.splitlines()]
    assert got == [want for _, want in cases]
