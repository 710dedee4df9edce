"""K2's launch plan (ops/features_plan.py) on the CPU: the reflection by index
arithmetic against the padded copy it replaces, the tiles and bin slices of
both splits covering every (frame, bin) exactly once, shared memory within
one block's, the split chosen on the H100's 132 SMs, the shapes refused;
and the kernel's algorithm written out in PyTorch (the packed DFT pair
table, frame tiles staged as one span, depth splits added in order,
slices folded in order) against the plain mel power and the JAX Pallas
kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgedict_tpu.ops.features_pallas import mel_power_pallas
from edgedict_tpu_torch import features as PF
from edgedict_tpu_torch.ops import features_kernel as K2
from edgedict_tpu_torch.ops import features_plan as P

H100_SMS = 132
# the main paths' shapes: a 75 ms chunk at 1, 8 and 64 streams, 4 s of
# audio, the train step's 32 x 16 s, the shortest legal row, a row off
# the hop grid
SHAPES = [(1, 1320), (8, 1320), (64, 1320), (1, 64000), (8, 64000),
          (32, 256000), (1, 257), (1, 1399)]


def _plan(b, length, n_fft=512, hop=200, n_mels=80):
    return P.mel_plan(b, length, n_fft, hop, n_mels, H100_SMS)


# the kernel's own index maps (csrc/mel_power.cu: a block's tile and slice
# from blockIdx.x, slices fastest; pair 0 carries the DC and Nyquist bins),
# written out for the coverage tests and the model of the algorithm below


def _tile_frames(plan, tile):
    """(batch row, first frame) of frame tile `tile`."""
    return tile // plan.tiles_per_row, tile % plan.tiles_per_row * plan.frames


def _block_pairs(plan, block):
    """(tile, bin pairs) of block `block`: its tile and, over its passes in
    order, the pairs it sums (slices fastest in the grid)."""
    tile, slc = divmod(block, plan.slices)
    first = slc * plan.passes * plan.pairs
    return tile, range(first, first + plan.passes * plan.pairs)


def _pair_bins(pair, n_fft):
    """The bins pair `pair` carries: (bin of its cosine column, bin of its
    sine column)."""
    return (0, n_fft // 2) if pair == 0 else (pair, pair)


@pytest.mark.parametrize('length', [257, 300, 1320, 1399, 64000])
def test_reflect_index_equals_reflect_pad(length):
    x = torch.from_numpy(np.random.RandomState(length).randn(1, length)
                         .astype(np.float32))
    padded = K2.reflect_pad(x, 512)[0]
    idx = [P.reflect_index(i, length, 512) for i in range(padded.shape[0])]
    assert min(idx) == 0 and max(idx) == length - 1
    assert torch.equal(x[0, idx], padded)


@pytest.mark.parametrize('b,length', SHAPES + [(3, 999)])
def test_plan_covers_every_frame_and_bin_once(b, length):
    n_fft, hop = (64, 20) if length == 999 else (512, 200)
    plan = _plan(b, length, n_fft, hop, 8 if length == 999 else 80)
    n_frames = P.frames_of(length, hop)
    nb = n_fft // 2
    counts = np.zeros((b, n_frames, nb + 1), np.int32)
    for block in range(plan.blocks):
        tile, pairs = _block_pairs(plan, block)
        row, t0 = _tile_frames(plan, tile)
        bins = sorted({x for p in pairs for x in _pair_bins(p, n_fft)})
        counts[row, t0:t0 + plan.frames][:, bins] += 1
    assert (counts == 1).all()
    assert plan.tiles == b * plan.tiles_per_row
    assert (plan.tiles_per_row - 1) * plan.frames < n_frames
    assert plan.blocks == plan.tiles * plan.slices
    assert plan.span == (plan.frames - 1) * hop + n_fft


@pytest.mark.parametrize('b,length', SHAPES)
def test_bin_slices_partition_the_pairs_in_order(b, length):
    plan = _plan(b, length)
    nb = 256
    seen = []
    for slc in range(plan.slices):
        _, pairs = _block_pairs(plan, slc)
        seen += list(pairs)
    assert seen == list(range(nb))
    bins = [x for p in seen for x in sorted(set(_pair_bins(p, 512)))]
    assert sorted(bins) == list(range(nb + 1))
    # pair 0 carries the DC bin's cosine and the Nyquist bin's
    assert _pair_bins(0, 512) == (0, nb)


@pytest.mark.parametrize('b,length', SHAPES + [(1, 20000)])
@pytest.mark.parametrize('hop', [160, 200, 512])
def test_shared_memory_fits_one_block(b, length, hop):
    plan = P.mel_plan(b, length, 512, hop, 80, H100_SMS)
    assert plan.smem <= P.SMEM_PER_BLOCK == 232448
    floats = (2 * P.STAGE_FLOATS + -(-plan.span // 4) * 4
              + plan.frames * 80 + plan.frames)
    assert plan.smem == 4 * floats
    # the ring holds a stage pair, then the depth splits' cosine (then sine)
    # partials of every thread, then the power tile (frames x pairs)
    assert P.THREADS * P.TILE_ROWS * P.TILE_PAIRS <= 2 * P.STAGE_FLOATS
    assert plan.frames * plan.pairs <= 2 * P.STAGE_FLOATS
    if plan.depth_split > 1:    # one summing thread per (frame, pair)
        assert plan.frames * plan.pairs <= P.THREADS
    assert plan.chunk_rows * 2 * plan.pairs <= P.STAGE_FLOATS
    assert 512 % plan.chunk_rows == 0
    assert plan.chunk_rows % plan.depth_split == 0
    assert plan.row_groups * plan.col_groups * plan.depth_split == P.THREADS


@pytest.mark.parametrize('b,length,frames,split,blocks', [
    (1, 1320, 7, True, 16),             # a 75 ms chunk
    (8, 1320, 56, True, 128),           # the 8-stream server
    (64, 1320, 448, True, 1024),        # the 64-stream int8 server
    (32, 256000, 40992, False, 672),    # the train step, 32 x 16 s
])
def test_split_chosen_from_frames_and_sms(b, length, frames, split, blocks):
    plan = _plan(b, length)
    assert b * P.frames_of(length, 200) == frames
    assert plan.split is split and plan.blocks == blocks
    if split:
        assert (plan.frames, plan.pairs, plan.depth_split) == (8, 16, 64)
        assert plan.passes == 1 and plan.slices == 16
        assert plan.scratch_floats == plan.blocks * 8 * 80
    else:
        assert (plan.frames, plan.pairs, plan.depth_split) == (64, 128, 1)
        assert plan.passes == 2 and plan.slices == 1
        assert plan.scratch_floats == 0
        assert plan.smem <= P.SMEM_PER_BLOCK // 2 - 1024   # 2 blocks / SM


@pytest.mark.parametrize('b,length,n_fft,hop,n_mels', [
    (1, 256, 512, 200, 80), (1, 100, 512, 200, 80), (0, 1320, 512, 200, 80),
    (1, 1320, 500, 200, 80), (1, 1320, 511, 200, 80), (1, 1320, 16, 4, 8),
    (1, 1320, 32, 8, 8),
    (1, 1320, 512, 0, 80), (1, 1320, 512, 200, 0), (2, 40000, 512, 8000, 80)])
def test_shape_outside_the_plan_raises(b, length, n_fft, hop, n_mels):
    with pytest.raises(ValueError, match='mel_power'):
        P.mel_plan(b, length, n_fft, hop, n_mels, H100_SMS)


def _kernel_model(audio, tables, plan):
    """K2's algorithm in PyTorch (fp32): every block's tile staged as one
    span through reflect_index, the pair table's slice, the depth splits
    added in order, pair 0's sine column squared as the Nyquist bin, the
    passes' filterbank sums kept in the block's mel tile and the slices
    folded in order."""
    b, length = audio.shape
    n_fft, hop = tables.n_fft, tables.hop
    nb, n_mels = n_fft // 2, tables.mel_t.shape[1]
    n_frames = P.frames_of(length, hop)
    out = torch.zeros(b, plan.tiles_per_row * plan.frames, n_mels)
    partial = {}
    for block in range(plan.blocks):
        tile, pairs = _block_pairs(plan, block)
        row, t0 = _tile_frames(plan, tile)
        idx = [t0 * hop + i for i in range(plan.span)]
        span = torch.stack([
            audio[row, P.reflect_index(i, length, n_fft)]
            if i < length + 2 * (n_fft // 2) else torch.tensor(0.0)
            for i in idx])
        frames = torch.stack([span[f * hop:f * hop + n_fft]
                              for f in range(plan.frames)])
        mel = torch.zeros(plan.frames, n_mels)
        for pass_ in range(plan.passes):
            pb = pairs[pass_ * plan.pairs]
            cols = torch.cat([torch.arange(pb, pb + plan.pairs),
                              nb + torch.arange(pb, pb + plan.pairs)])
            table = tables.dft[:, cols]
            acc = sum(frames[:, s::plan.depth_split]
                      @ table[s::plan.depth_split]
                      for s in range(plan.depth_split))
            re, im = acc[:, :plan.pairs], acc[:, plan.pairs:]
            power = torch.zeros(plan.frames, plan.pairs + 1)   # + Nyquist
            power[:, :plan.pairs] = re * re + im * im
            if pb == 0:
                power[:, 0] = re[:, 0] ** 2
                power[:, plan.pairs] = im[:, 0] ** 2
            rows = torch.cat([torch.arange(pb, pb + plan.pairs),
                              torch.tensor([nb])])
            mel = mel + power @ tables.mel_t[rows]
        partial[block] = mel
    for tile in range(plan.tiles):
        row, t0 = _tile_frames(plan, tile)
        mel = partial[tile * plan.slices]
        for j in range(1, plan.slices):
            mel = mel + partial[tile * plan.slices + j]
        out[row, t0:t0 + plan.frames] = mel
    return out[:, :n_frames]


@pytest.mark.parametrize('b,length,n_fft,hop,n_mels,n_sms', [
    (1, 1320, 512, 200, 80, 132),       # a chunk: the few-frame split
    (2, 1399, 256, 40, 16, 1),          # the many-frame split (1 SM)
    (1, 257, 512, 200, 80, 132),        # the shortest legal row
    (3, 999, 64, 20, 8, 132),
])
def test_kernel_algorithm_matches_plain_and_pallas(b, length, n_fft, hop,
                                                   n_mels, n_sms):
    cfg = PF.FeatureConfig(feature_size=n_mels, n_fft=n_fft,
                           win_length=n_fft * 5 // 8, hop_length=hop)
    tables = PF.FeaturePipeline(cfg, 'cpu').tables
    x = np.random.RandomState(length).randn(b, length).astype(np.float32)
    x[:, : length // 4] *= 1e-4                     # near-silent stretch
    tail = min(n_fft, length)                        # a Nyquist tone
    x[:, -tail:] += np.where(np.arange(tail) % 2, 2.0, -2.0)
    audio = PF.preemphasis(torch.from_numpy(x))
    plan = P.mel_plan(b, length, n_fft, hop, n_mels, n_sms)
    assert plan.split is (n_sms == 132)
    out = _kernel_model(audio, tables, plan)
    ref = K2.mel_power_plain(audio, tables)
    pallas = np.asarray(mel_power_pallas(
        jnp.asarray(audio.numpy()), jnp.asarray(tables.window),
        jnp.asarray(tables.mel), n_fft, hop))
    assert out.shape == ref.shape == pallas.shape
    for r in (ref.numpy(), pallas):
        np.testing.assert_allclose(np.log(out.numpy() + 1e-20),
                                   np.log(r + 1e-20), 1e-3, 5e-3)


def test_pair_table_packs_the_nyquist_cosine():
    """dft's sine half: bin 0's column holds the Nyquist bin's cosine (the
    window times (-1)^n), the other columns the window-folded sines."""
    cfg = PF.FeatureConfig(feature_size=80, **{'n_fft': 512,
                                               'win_length': 320,
                                               'hop_length': 200})
    tables = PF.FeaturePipeline(cfg, 'cpu').tables
    n = torch.arange(512)
    win = tables.window.double()
    assert tables.dft.shape == (512, 512)
    torch.testing.assert_close(tables.dft[:, 256].double(),
                               win * (-1.0) ** n, rtol=0, atol=1e-6)
    ang = -2.0 * np.pi * np.outer(np.arange(512), np.arange(256)) / 512
    torch.testing.assert_close(tables.dft[:, 257:].double(),
                               win[:, None] * torch.from_numpy(
                                   np.sin(ang))[:, 1:], rtol=0, atol=1e-6)
    torch.testing.assert_close(tables.dft[:, :256].double(),
                               win[:, None] * torch.from_numpy(np.cos(ang)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize('ftype,n_fft,mels', [
    ('logfbank', 512, 80), ('logfbank', 64, 8), ('melspec', 512, 64),
    ('mfcc', 256, 40)])
def test_mel_band_holds_every_nonzero_weight(ftype, n_fft, mels):
    """The kernel sums each mel over its band only: every nonzero weight of
    the filterbank lies in [lo, hi), the band's ends are nonzero, and the
    banded sum equals the dense product on a power spectrum."""
    kw = dict(feature_type=ftype, feature_size=mels, n_fft=n_fft,
              win_length=n_fft * 5 // 8, hop_length=n_fft // 4)
    if ftype == 'mfcc':
        kw['mfcc_n_mels'] = mels
    tables = PF.FeaturePipeline(PF.FeatureConfig(**kw), 'cpu').tables
    mel, band = tables.mel.numpy(), tables.mel_band.numpy()
    assert band.shape == (mel.shape[0], 2) and band.dtype == np.int32
    cols = np.arange(mel.shape[1])
    for m, (lo, hi) in enumerate(band):
        inside = (cols >= lo) & (cols < hi)
        assert not mel[m, ~inside].any()
        if hi > lo:
            assert mel[m, lo] != 0 and mel[m, hi - 1] != 0
    power = torch.rand(3, mel.shape[1], generator=torch.Generator()
                       .manual_seed(n_fft))
    banded = torch.stack([(power[:, lo:hi] @ tables.mel_t[lo:hi, m])
                          for m, (lo, hi) in enumerate(band)], 1)
    torch.testing.assert_close(banded, power @ tables.mel_t, rtol=1e-6,
                               atol=1e-7)
