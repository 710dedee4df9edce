"""Port layers (edgedict_tpu_torch/ops/layers.py) == the JAX layers
(edgedict_tpu/ops/layers.py) on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgedict_tpu.ops import layers as JL
from edgedict_tpu_torch.ops import layers as PL

RTOL, ATOL = 1e-4, 1e-5     # forward activations


def _rng(seed):
    return np.random.RandomState(seed)


@pytest.mark.parametrize('shape', [(5, 7), (2, 3, 7)])
def test_linear_matches_jax(shape):
    rng = _rng(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(11, 7).astype(np.float32)
    b = rng.randn(11).astype(np.float32)
    ref = JL.linear({'w': jnp.asarray(w), 'b': jnp.asarray(b)},
                    jnp.asarray(x))
    out = PL.linear(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), RTOL, ATOL)


def test_linear_bf16_keeps_input_dtype():
    rng = _rng(1)
    x = torch.from_numpy(rng.randn(4, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
    b = torch.from_numpy(rng.randn(8).astype(np.float32))
    out = PL.linear(x.bfloat16(), w, b)
    assert out.dtype == torch.bfloat16
    ref = PL.linear(x.bfloat16().float(), w.bfloat16().float(),
                    b.bfloat16().float())
    # one bf16 rounding of an fp32-accumulated sum
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize('offset', [0.0, 100.0])
def test_layer_norm_matches_jax(offset):
    rng = _rng(2)
    x = (rng.randn(3, 4, 10) + offset).astype(np.float32)
    scale = rng.randn(10).astype(np.float32)
    bias = rng.randn(10).astype(np.float32)
    ref = JL.layer_norm({'scale': jnp.asarray(scale),
                         'bias': jnp.asarray(bias)}, jnp.asarray(x))
    out = PL.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), RTOL, 1e-4)


def test_layer_norm_bf16_stats_in_fp32():
    rng = _rng(3)
    x = torch.from_numpy((rng.randn(2, 64) + 50.0).astype(np.float32))
    scale, bias = torch.ones(64), torch.zeros(64)
    out = PL.layer_norm(x.bfloat16(), scale, bias)
    ref = PL.layer_norm(x.bfloat16().float(), scale, bias)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=1e-2, atol=1e-2)


def test_embedding_pad_row_reads_zero_from_nonzero_table():
    """The PAD row reads as zero on every call, also when the stored row
    is not zero (a checkpoint's), like layers.py:56-62 — nn.Embedding's
    padding_idx only zeroes it at init."""
    rng = _rng(4)
    table = rng.randn(9, 5).astype(np.float32)
    assert np.abs(table[1]).sum() > 0
    ids = np.array([[1, 2, 1, 8], [0, 1, 3, 4]], np.int64)
    ref = JL.embedding({'table': jnp.asarray(table)},
                       jnp.asarray(ids, jnp.int32), padding_idx=1)
    out = PL.embedding(torch.from_numpy(table), torch.from_numpy(ids),
                       padding_idx=1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert not out[0, 0].any() and not out[1, 1].any()
    np.testing.assert_array_equal(out[0, 1].numpy(), table[2])


def test_linear_init_is_seeded():
    a = PL.linear_init(6, 4, torch.Generator().manual_seed(3))
    b = PL.linear_init(6, 4, torch.Generator().manual_seed(3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[0].abs().max()) <= 1 / 6 ** 0.5
