"""The port's RNN language model (edgedict_tpu_torch/models/lm.py) against
the JAX package's (edgedict_tpu/models/lm.py) on the same seeded weights,
handed over by compat.lm_state_dict_from_jax_params: log-probs and state,
tied and untied, the next-token loss, and the lm.ckpt round trip."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.models import lm as JL
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch.checkpoint import save_checkpoint
from edgedict_tpu_torch.models import lm as PL

KW = dict(vocab_size=20, embed_size=12, hidden_size=12, num_layers=2)


def _pair(tie, seed=0, **kw):
    kw = {**KW, **kw, 'tie_weights': tie}
    jcfg, pcfg = JL.LMConfig(**kw), PL.LMConfig(**kw)
    jparams = jax.tree.map(np.asarray, JL.lm_init(jax.random.PRNGKey(seed),
                                                  jcfg))
    if tie:     # a non-zero output bias, so that it is held too
        jparams['out_b'] = np.random.RandomState(seed).randn(
            kw['vocab_size']).astype(np.float32) * 0.1
    model = PL.LMModel(pcfg, 'cpu')
    model.load_state_dict(PC.lm_state_dict_from_jax_params(jparams))
    return jax.tree.map(jnp.asarray, jparams), jcfg, model, pcfg


def _ids(rng, b, u, v):
    return rng.randint(0, v, (b, u)).astype(np.int32)


@pytest.mark.parametrize('tie', [False, True])
def test_lm_apply_matches_jax(tie):
    jparams, jcfg, model, pcfg = _pair(tie)
    rng = np.random.RandomState(1)
    ys = _ids(rng, 3, 7, KW['vocab_size'])
    h0 = rng.randn(2, 3, 12).astype(np.float32) * 0.5
    c0 = rng.randn(2, 3, 12).astype(np.float32) * 0.5
    for state in (None, (h0, c0)):
        jlp, (jh, jc) = JL.lm_apply(
            jparams, jcfg, jnp.asarray(ys),
            None if state is None else tuple(map(jnp.asarray, state)))
        with torch.no_grad():
            plp, (ph, pc) = PL.lm_apply(
                model, pcfg, torch.from_numpy(ys),
                None if state is None else tuple(map(torch.from_numpy,
                                                     state)))
        assert plp.dtype == torch.float32 and plp.shape == (3, 7, 20)
        for a, b in ((plp, jlp), (ph, jh), (pc, jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize('tie', [False, True])
def test_lm_loss_matches_jax(tie):
    jparams, jcfg, model, pcfg = _pair(tie, seed=2)
    ys = np.asarray([[2, 4, 5, 6, 1, 0], [2, 7, 0, 9, 1, 1],
                     [2, 11, 12, 13, 14, 15]], np.int32)
    ylen = np.asarray([5, 4, 6], np.int32)
    want = float(JL.lm_loss(jparams, jcfg, jnp.asarray(ys),
                            jnp.asarray(ylen)))
    got = PL.lm_loss(model, pcfg, torch.from_numpy(ys),
                     torch.from_numpy(ylen))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    # differentiable: every parameter gets a finite gradient
    got.backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_lm_checkpoint_roundtrip(tmp_path):
    """The file cli.train_lm writes (the port's checkpoint payload with
    extra['lm_cfg']) loads back to the same config and weights."""
    _, _, model, cfg = _pair(True, seed=3)
    path = save_checkpoint(str(tmp_path), 7, model.state_dict(),
                           extra={'lm_cfg': dataclasses.asdict(cfg)})
    got, got_cfg = PL.load_lm_checkpoint(path)
    assert got_cfg == cfg
    want = model.state_dict()
    assert set(got.state_dict()) == set(want)
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_lm_seeded_init_and_tie_check():
    a = PL.LMModel(PL.LMConfig(vocab_size=30), 'cpu', seed=4)
    b = PL.LMModel(PL.LMConfig(vocab_size=30), 'cpu', seed=4)
    assert set(a.state_dict()) == {
        'embed.weight', 'out.weight', 'out.bias',
        *(f'lstm.{n}_l{k}' for n in ('weight_ih', 'weight_hh', 'bias_ih',
                                     'bias_hh') for k in range(2))}
    assert a.embed.weight.shape == (30, 256)
    assert a.lstm.weight_hh_l1.shape == (4 * 512, 512)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    with pytest.raises(ValueError):
        PL.LMModel(PL.LMConfig(vocab_size=30, tie_weights=True), 'cpu')
