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


@pytest.mark.parametrize('b,u1,v', [(64, 151, 29), (64, 61, 29),
                                    (32, 65, 2048), (3, 4, 7)])
def test_embedding_stable_backward_matches_f_embedding(b, u1, v):
    """_Embedding (the CUDA tables' lookup: index_put_ accumulate in the
    backward) gives F.embedding's forward bit for bit and its table
    gradient up to the order of the sums (within 1e-5 of its largest
    magnitude), on the soak's batch of 64 x 151
    and 64 x 61 char ids (past F.embedding's 3,072-id sort path on CUDA),
    E6D2's 32 x 65 BPE ids and a small case; the padding row still reads
    zero through embedding()."""
    g = torch.Generator().manual_seed(b + u1)
    table = torch.randn(v, 16, generator=g, requires_grad=True)
    ids = torch.randint(0, v, (b, u1), generator=g)
    grad = torch.randn(b, u1, 16, generator=g)
    out = PL._Embedding.apply(ids, table)
    assert torch.equal(out, torch.nn.functional.embedding(ids, table))
    out.backward(grad)
    got, table.grad = table.grad.clone(), None
    torch.nn.functional.embedding(ids, table).backward(grad)
    # the two sum a row's terms in different orders
    assert float((got - table.grad).abs().max()) <= \
        1e-5 * float(table.grad.abs().max())
    counts = torch.bincount(ids.reshape(-1), minlength=v)
    assert torch.equal(got[counts == 0], torch.zeros_like(got[counts == 0]))


def test_embedding_on_the_cpu_is_f_embedding():
    """embedding() of a CPU table keeps F.embedding (and its backward):
    bit-equal outputs and gradients."""
    g = torch.Generator().manual_seed(5)
    table = torch.randn(11, 8, generator=g, requires_grad=True)
    ids = torch.randint(0, 11, (4, 9), generator=g)
    grad = torch.randn(4, 9, 8, generator=g)
    PL.embedding(table, ids).backward(grad)
    got, table.grad = table.grad.clone(), None
    torch.nn.functional.embedding(ids, table).backward(grad)
    assert torch.equal(got, table.grad)
