"""K2's launch plan (ops/features_plan.py) on the CPU: the reflection by index
arithmetic against the padded copy it replaces, the tiles and bin slices of
both splits covering every (frame, bin) exactly once, shared memory within
one block's, the split chosen on the H100's 132 SMs, every n_fft from 64 to
2048 (even and odd) placed at the hops the presets and the flags' defaults
use, n_fft 512's plans pinned as the unpadded table had them, the shapes
refused; and the kernel's algorithm written out in PyTorch (the padded
DFT pair table, frame tiles staged as one span, depth splits added in
order, slices folded in order) against the plain mel power and the JAX
Pallas kernel in interpret mode."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgedict_tpu.ops.features_pallas import mel_power_pallas
from edgedict_tpu_torch import _build
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
    """The bins pair `pair` carries: none for a zero pair past the real
    ones; pair 0 the DC bin and, for even n_fft, the Nyquist bin in its
    sine column."""
    if pair >= P.real_pairs(n_fft):
        return set()
    if pair == 0:
        return {0, n_fft // 2} if n_fft % 2 == 0 else {0}
    return {pair}


@pytest.mark.parametrize('length', [257, 300, 1320, 1399, 64000])
def test_reflect_index_equals_reflect_pad(length):
    x = torch.from_numpy(np.random.RandomState(length).randn(1, length)
                         .astype(np.float32))
    padded = K2.reflect_pad(x, 512)[0]
    idx = [P.reflect_index(i, length, 512) for i in range(padded.shape[0])]
    assert min(idx) == 0 and max(idx) == length - 1
    assert torch.equal(x[0, idx], padded)


def _covers_every_frame_and_bin_once(b, length, n_fft, hop, n_mels, n_sms):
    plan = P.mel_plan(b, length, n_fft, hop, n_mels, n_sms)
    n_frames = P.frames_of(length, hop)
    counts = np.zeros((b, n_frames, n_fft // 2 + 1), np.int32)
    for block in range(plan.blocks):
        tile, pairs = _block_pairs(plan, block)
        row, t0 = _tile_frames(plan, tile)
        assert pairs.stop <= P.table_pairs(n_fft)
        bins = sorted(set().union(*(_pair_bins(p, n_fft) for p in pairs)))
        counts[row, t0:t0 + plan.frames][:, bins] += 1
    assert (counts == 1).all()
    assert plan.tiles == b * plan.tiles_per_row
    assert (plan.tiles_per_row - 1) * plan.frames < n_frames
    assert plan.blocks == plan.tiles * plan.slices
    rows = -(-n_fft // plan.chunk_rows) * plan.chunk_rows
    assert n_fft <= rows <= P.table_rows(n_fft)
    assert plan.span == (plan.frames - 1) * hop + rows


@pytest.mark.parametrize('b,length', SHAPES + [(3, 999)])
def test_plan_covers_every_frame_and_bin_once(b, length):
    if length == 999:
        _covers_every_frame_and_bin_once(b, length, 64, 20, 8, H100_SMS)
    else:
        _covers_every_frame_and_bin_once(b, length, 512, 200, 80, H100_SMS)


@pytest.mark.parametrize('b,length,n_fft,hop,n_mels,n_sms', [
    (1, 1400, 400, 200, 128, H100_SMS),     # the defaults' chunk: few
    (8, 224000, 400, 200, 128, H100_SMS),   # their train batch: many
    (1, 1400, 511, 128, 80, H100_SMS), (2, 3000, 511, 128, 80, 1),
    (1, 1400, 320, 80, 40, H100_SMS), (2, 2500, 97, 97, 8, 1),
    (1, 6000, 2048, 512, 256, H100_SMS), (2, 4000, 2048, 2048, 80, 1),
])
def test_padded_plan_covers_every_frame_and_bin_once(b, length, n_fft, hop,
                                                     n_mels, n_sms):
    """With the pair table padded past the real pairs and rows: every
    (frame, bin) summed once, no pair past the table, and the span over
    the rows the stages read."""
    _covers_every_frame_and_bin_once(b, length, n_fft, hop, n_mels, n_sms)


@pytest.mark.parametrize('b,length', SHAPES)
def test_bin_slices_partition_the_pairs_in_order(b, length):
    plan = _plan(b, length)
    nb = 256
    seen = []
    for slc in range(plan.slices):
        _, pairs = _block_pairs(plan, slc)
        seen += list(pairs)
    assert seen == list(range(nb))
    bins = [x for p in seen for x in sorted(_pair_bins(p, 512))]
    assert sorted(bins) == list(range(nb + 1))
    # pair 0 carries the DC bin's cosine and the Nyquist bin's
    assert _pair_bins(0, 512) == {0, nb}


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


# each refused shape and what its error names
REFUSED = {
    (1, 256, 512, 200, 80): 'reflect-padded',
    (1, 100, 512, 200, 80): 'reflect-padded',
    (0, 1320, 512, 200, 80): 'no rows', (1, 1320, 16, 4, 8): 'n_fft outside',
    (1, 1320, 32, 8, 8): 'n_fft outside', (1, 1320, 512, 0, 80): 'hop outside',
    (1, 1320, 512, 200, 0): 'no mels',
    (2, 40000, 512, 8000, 80): 'hop outside',
    (1, 1320, 63, 16, 8): 'n_fft outside',
    (1, 9000, 4096, 1024, 80): 'n_fft outside',
    (1, 9000, 2049, 512, 80): 'n_fft outside',
    (1, 1320, 400, 401, 80): 'hop outside',
    (1, 1320, 400, 200, 8000): 'shared memory'}


@pytest.mark.parametrize('b,length,n_fft,hop,n_mels', list(REFUSED))
def test_shape_outside_the_plan_raises(b, length, n_fft, hop, n_mels):
    """Each refusal names what failed; only a mel tile too large for one
    block is reported as shared memory."""
    why = REFUSED[(b, length, n_fft, hop, n_mels)]
    with pytest.raises(ValueError, match='mel_power') as err:
        P.mel_plan(b, length, n_fft, hop, n_mels, H100_SMS)
    assert why in str(err.value)
    assert ('shared memory' in str(err.value)) is (why == 'shared memory')


# every n_fft from 64 to 2048 at the hops of the presets and the flags'
# defaults (160, 200), a quarter and a whole window, for a 1,400-sample
# chunk (the defaults' 75 ms) and a train batch of 8 x 14 s
SWEEP_HOPS = {'quarter': lambda n: n // 4, '160': lambda n: 160,
              '200': lambda n: 200, 'whole': lambda n: n}


@pytest.mark.parametrize('b,length', [(1, 1400), (8, 224000)])
@pytest.mark.parametrize('hop_of', sorted(SWEEP_HOPS))
def test_plan_places_every_n_fft(b, length, hop_of):
    """Either split's plan within one block's shared memory at n_mels up to
    256, its pair groups covering the real pairs inside the padded table
    and its stages the rows; the many-frame split wherever its tiles fill
    the card and its span fits (the few-frame split otherwise)."""
    for n_fft in range(P.MIN_FFT, P.MAX_FFT + 1):
        hop = SWEEP_HOPS[hop_of](n_fft)
        if hop > n_fft:
            continue
        for n_mels in (80, 128, 256):
            plan = P.mel_plan(b, length, n_fft, hop, n_mels, H100_SMS)
            assert plan.smem <= P.SMEM_PER_BLOCK
            groups = plan.passes * plan.slices
            assert (groups - 1) * plan.pairs < P.real_pairs(n_fft) \
                <= groups * plan.pairs <= P.table_pairs(n_fft)
            assert P.table_rows(n_fft) % plan.chunk_rows == 0
            assert plan.chunk_rows % plan.depth_split == 0
            assert plan.chunk_rows * 2 * plan.pairs <= P.STAGE_FLOATS
            n_frames = P.frames_of(length, hop)
            many = P._layout(P.MANY, b, n_frames, n_fft, hop, n_mels, False)
            fills = b * -(-n_frames // 64) >= H100_SMS
            assert plan.split is not (fills
                                      and many.smem <= P.SMEM_PER_BLOCK)


@pytest.mark.parametrize('n_sms', [1, 10 ** 6])
@pytest.mark.parametrize('n_fft', [64, 97, 320, 400, 511, 1000, 2047, 2048])
def test_each_split_places_the_train_batch(n_sms, n_fft):
    """The train batch (8 x 14 s) in the split the SM count forces: the
    few-frame one on a card of 10^6 SMs, the many-frame one on one SM
    wherever its 64-frame span fits (hops up to a quarter window)."""
    for hop in (1, 7, 160, n_fft // 4, n_fft // 2, n_fft):
        hop = min(max(hop, 1), n_fft)
        plan = P.mel_plan(8, 224000, n_fft, hop, 256, n_sms)
        if n_sms > 1:
            assert plan.split
        elif hop <= n_fft // 4 and hop <= 160:
            assert not plan.split
        assert plan.smem <= P.SMEM_PER_BLOCK


# n_fft 512's plans as the unpadded table had them (astuple), pinned so
# that the presets keep their launches: the E6D2 (hop 200), E4D1 (hop 160)
# and E6D2_LARGE_Batch (hop 320) chunks at 1, 8, 64 and 256 streams, their
# train and eval micro-batches, 80 mels, 132 SMs
PARENT_512 = {
    (1, 1320, 200): (True, 1, 4, 64, 8, 16, 1, 16, 128, 1, 1, 16, 1912,
                     43008, 10240),
    (8, 1320, 200): (True, 1, 4, 64, 8, 16, 1, 16, 128, 1, 8, 128, 1912,
                     43008, 81920),
    (64, 1320, 200): (True, 1, 4, 64, 8, 16, 1, 16, 128, 1, 64, 1024, 1912,
                      43008, 655360),
    (256, 1320, 200): (False, 8, 32, 1, 64, 128, 2, 1, 16, 1, 256, 256,
                       13112, 105952, 0),
    (4, 224000, 200): (True, 1, 4, 64, 8, 16, 1, 16, 128, 141, 564, 9024,
                       1912, 43008, 5775360),
    (32, 256000, 200): (False, 8, 32, 1, 64, 128, 2, 1, 16, 21, 672, 672,
                        13112, 105952, 0),
    (1, 1120, 160): (True, 1, 4, 64, 8, 16, 1, 16, 128, 1, 1, 16, 1632,
                     41888, 10240),
    (8, 1120, 160): (True, 1, 4, 64, 8, 16, 1, 16, 128, 1, 8, 128, 1632,
                     41888, 81920),
    (16, 256480, 160): (False, 8, 32, 1, 64, 128, 2, 1, 16, 26, 416, 416,
                        10592, 95872, 0),
    (2, 256000, 160): (True, 1, 4, 64, 8, 16, 1, 16, 128, 201, 402, 6432,
                       1632, 41888, 4116480),
    (1, 2000, 320): (True, 1, 4, 64, 8, 16, 1, 16, 128, 1, 1, 16, 2752,
                     46368, 10240),
    (64, 2000, 320): (True, 1, 4, 64, 8, 16, 1, 16, 128, 1, 64, 1024, 2752,
                      46368, 655360),
    (4, 225920, 320): (True, 1, 4, 64, 8, 16, 1, 16, 128, 89, 356, 5696,
                       2752, 46368, 3645440),
    (32, 256000, 320): (False, 8, 32, 1, 64, 128, 2, 1, 16, 13, 416, 416,
                        20672, 136192, 0),
}


@pytest.mark.parametrize('b,length,hop', sorted(PARENT_512))
def test_n_fft_512_keeps_its_plans(b, length, hop):
    """The presets' n_fft 512 run the same launch as before: every field of
    the plan as it was, and a table of the same (512, 512) shape."""
    plan = P.mel_plan(b, length, 512, hop, 80, H100_SMS)
    assert dataclasses.astuple(plan) == PARENT_512[(b, length, hop)]
    assert (P.table_rows(512), 2 * P.table_pairs(512)) == (512, 512)


def test_c_entry_takes_the_wrappers_arguments():
    """edd_mel_power's parameters, as many as the ctypes signature the
    wrapper calls it through (ops/features_kernel.py passes the table's
    pairs after n_mels)."""
    import os
    src = open(os.path.join(os.path.dirname(_build.__file__), 'csrc',
                            'mel_power.cu')).read()
    m = re.search(r'extern "C" int edd_mel_power\((.*?)\)\s*\{', src,
                  re.S)
    params = [x.split()[-1] for x in m.group(1).split(',')]
    assert len(params) == len(_build._SIGNATURES['edd_mel_power'])
    assert params[11:14] == ['M', 'nbp', 'rg']


def _kernel_model(audio, tables, plan):
    """K2's algorithm in PyTorch (fp32): every block's tile staged as one
    span through reflect_index (zero past the padded row), the padded pair
    table's slice over the rows its stages read, the depth splits added in
    order, for even n_fft pair 0's sine column squared as the Nyquist bin,
    each mel summed over the real pairs of its band, the passes'
    filterbank sums kept in the block's mel tile and the slices folded in
    order."""
    b, length = audio.shape
    n_fft, hop = tables.n_fft, tables.hop
    nbp, n_mels = tables.dft.shape[1] // 2, tables.mel_t.shape[1]
    padded = length + 2 * (n_fft // 2)
    src = torch.tensor([P.reflect_index(i, length, n_fft)
                        for i in range(padded)])
    rows = -(-n_fft // plan.chunk_rows) * plan.chunk_rows
    n_frames = P.frames_of(length, hop)
    band = tables.mel_band.long()
    out = torch.zeros(b, plan.tiles_per_row * plan.frames, n_mels)
    partial = {}
    for block in range(plan.blocks):
        tile, pairs = _block_pairs(plan, block)
        row, t0 = _tile_frames(plan, tile)
        idx = t0 * hop + torch.arange(plan.span)
        inside = idx < padded
        span = torch.where(inside, audio[row, src[idx.clamp(max=padded - 1)]],
                           torch.zeros(()))
        frames = torch.stack([span[f * hop:f * hop + rows]
                              for f in range(plan.frames)])
        mel = torch.zeros(plan.frames, n_mels)
        for pass_ in range(plan.passes):
            pb = pairs[pass_ * plan.pairs]
            cols = torch.cat([torch.arange(pb, pb + plan.pairs),
                              nbp + torch.arange(pb, pb + plan.pairs)])
            table = tables.dft[:rows, cols]
            acc = sum(frames[:, s::plan.depth_split]
                      @ table[s::plan.depth_split]
                      for s in range(plan.depth_split))
            re_, im = acc[:, :plan.pairs], acc[:, plan.pairs:]
            power = re_ * re_ + im * im
            nyq = torch.zeros(plan.frames)
            if pb == 0:
                power[:, 0] = re_[:, 0] ** 2
                nyq = im[:, 0] ** 2
            for m in range(n_mels):
                lo = max(int(band[m, 0]), pb)
                hi = min(int(band[m, 1]), pb + plan.pairs,
                         P.real_pairs(n_fft))
                if hi > lo:
                    mel[:, m] += power[:, lo - pb:hi - pb] \
                        @ tables.mel_t[lo:hi, m]
                if n_fft % 2 == 0:
                    mel[:, m] += nyq * tables.mel_t[n_fft // 2, m]
        partial[block] = mel
    for tile in range(plan.tiles):
        row, t0 = _tile_frames(plan, tile)
        mel = partial[tile * plan.slices]
        for j in range(1, plan.slices):
            mel = mel + partial[tile * plan.slices + j]
        out[row, t0:t0 + plan.frames] = mel
    return out[:, :n_frames]


def _algorithm_matches_plain_and_pallas(b, length, n_fft, win, hop, n_mels,
                                        n_sms):
    cfg = PF.FeatureConfig(feature_size=n_mels, n_fft=n_fft,
                           win_length=win, hop_length=hop)
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
    assert out.shape == ref.shape == pallas.shape \
        == (b, 1 + length // hop, n_mels)
    for r in (ref.numpy(), pallas):
        np.testing.assert_allclose(np.log(out.numpy() + 1e-20),
                                   np.log(r + 1e-20), 1e-3, 5e-3)


@pytest.mark.parametrize('b,length,n_fft,hop,n_mels,n_sms', [
    (1, 1320, 512, 200, 80, 132),       # a chunk: the few-frame split
    (2, 1399, 256, 40, 16, 1),          # the many-frame split (1 SM)
    (1, 257, 512, 200, 80, 132),        # the shortest legal row
    (3, 999, 64, 20, 8, 132),
])
def test_kernel_algorithm_matches_plain_and_pallas(b, length, n_fft, hop,
                                                   n_mels, n_sms):
    _algorithm_matches_plain_and_pallas(b, length, n_fft, n_fft * 5 // 8,
                                        hop, n_mels, n_sms)


@pytest.mark.parametrize('b,length,n_fft,win,hop,n_mels,n_sms', [
    # the flags' default window (400 of 400, hop 200; 128 mels as the
    # MFCC's) in both splits, and other n_fft the padding places
    (1, 1400, 400, 400, 200, 128, 132), (2, 3000, 400, 400, 200, 80, 1),
    (1, 1400, 400, 400, 160, 80, 132), (2, 2000, 400, 400, 160, 80, 1),
    (1, 1400, 320, 200, 80, 40, 132), (2, 1500, 320, 200, 80, 40, 1),
    (1, 1408, 511, 400, 128, 80, 132),   # odd, L a multiple of the hop
    (2, 1500, 511, 400, 128, 80, 1),
    (1, 6000, 2048, 1280, 512, 256, 132), (1, 9000, 2048, 1280, 512, 80, 1),
])
def test_kernel_algorithm_at_any_n_fft(b, length, n_fft, win, hop, n_mels,
                                       n_sms):
    """The padded table's algorithm, n_fft not a multiple of 32 or odd,
    against the plain mel power and mel_power_pallas."""
    _algorithm_matches_plain_and_pallas(b, length, n_fft, win, hop, n_mels,
                                        n_sms)


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


@pytest.mark.parametrize('n_fft', [64, 97, 400, 511, 2048])
def test_padded_pair_table(n_fft):
    """The table padded to whole pair groups and stages: the real pairs'
    window-folded cosines and sines, zero pairs and rows past them; for
    even n_fft bin 0's sine column holds the Nyquist cosine, for odd n_fft
    (no Nyquist bin) it stays zero."""
    cfg = PF.FeatureConfig(feature_size=8, n_fft=n_fft,
                           win_length=n_fft * 5 // 8, hop_length=n_fft // 4)
    tables = PF.FeaturePipeline(cfg, 'cpu').tables
    nb, nbp = P.real_pairs(n_fft), P.table_pairs(n_fft)
    assert nb == n_fft // 2 + n_fft % 2 and nbp % P.PAIR_GROUP == 0
    assert tables.dft.shape == (P.table_rows(n_fft), 2 * nbp)
    dft, win = tables.dft.double(), tables.window.double()[:, None]
    ang = -2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(nb)) / n_fft
    torch.testing.assert_close(dft[:n_fft, :nb],
                               win * torch.from_numpy(np.cos(ang)),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(dft[:n_fft, nbp + 1:nbp + nb],
                               win * torch.from_numpy(np.sin(ang))[:, 1:],
                               rtol=0, atol=1e-6)
    nyq = win[:, 0] * (-1.0) ** torch.arange(n_fft) if n_fft % 2 == 0 \
        else torch.zeros(n_fft, dtype=torch.float64)
    torch.testing.assert_close(dft[:n_fft, nbp], nyq, rtol=0, atol=1e-6)
    assert not dft[n_fft:].any()
    assert not dft[:, nb:nbp].any() and not dft[:, nbp + nb:].any()


@pytest.mark.parametrize('ftype,n_fft,mels', [
    ('logfbank', 512, 80), ('logfbank', 64, 8), ('melspec', 512, 64),
    ('mfcc', 256, 40), ('mfcc', 400, 128), ('logfbank', 511, 80)])
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
