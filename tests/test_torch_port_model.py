"""Port model core (edgedict_tpu_torch/models/transducer.py) and checkpoint
bridge (edgedict_tpu_torch/compat.py) == the JAX model on the same weights,
handed over through state_dict_from_jax_params."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.compat import torch_import as JC
from edgedict_tpu.models import transducer as JT
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch.models import transducer as PT

RTOL, ATOL = 1e-4, 1e-5          # forward activations and states
LRTOL, LATOL = 1e-3, 1e-4        # logits

KW = dict(vocab_size=20, vocab_embed_size=8, input_size=10,
          enc_hidden_size=16, enc_layers=3, enc_proj_size=12,
          dec_hidden_size=14, dec_layers=2, dec_proj_size=12,
          joint_size=16, enc_time_reductions=(1,))
JCFG, PCFG = JT.TransducerConfig(**KW), PT.TransducerConfig(**KW)


@pytest.fixture(scope='module')
def models():
    params = JT.transducer_init(jax.random.PRNGKey(0), JCFG)
    # a non-zero PAD row, as a trained checkpoint may carry
    params['decoder']['embed']['table'] = \
        params['decoder']['embed']['table'].at[1].set(0.5)
    params = jax.tree.map(np.asarray, params)
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), PCFG, 'cpu')
    return jax.tree.map(jnp.asarray, params), model


def _close(a, r, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), rtol, atol)


def test_state_dict_round_trips_through_jax_importer(models):
    params, model = models
    back = JC.transducer_from_state_dict(model.state_dict(), JCFG)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sd = model.state_dict()
    assert sd['joint.joint.0.weight'].shape == (16, 24)
    assert 'encoder.lstm.projs.2.0.weight' in sd
    assert 'decoder.lstm.weight_hh_l1' in sd


@pytest.mark.parametrize('t', [8, 9])
def test_encoder_matches_jax(models, t):
    params, model = models
    xs = np.random.RandomState(t).randn(2, t, 10).astype(np.float32)
    ref, (h_j, c_j) = JT.encoder_apply(params['encoder'], JCFG,
                                       jnp.asarray(xs))
    with torch.no_grad():
        out, (h_p, c_p) = PT.encoder_apply(model.encoder, PCFG,
                                           torch.from_numpy(xs))
    assert out.shape == (2, -(-t // 2), 12)
    _close(out, ref)
    _close(h_p, h_j)
    _close(c_p, c_j)


def test_encoder_state_carry_matches_jax(models):
    """Chunked encode with carried state == JAX chunked encode, chunk by
    chunk."""
    params, model = models
    xs = np.random.RandomState(3).randn(1, 8, 10).astype(np.float32)
    js, ps = None, None
    for i in range(0, 8, 2):
        ref, js = JT.encoder_apply(params['encoder'], JCFG,
                                   jnp.asarray(xs[:, i:i + 2]), js)
        with torch.no_grad():
            out, ps = PT.encoder_apply(model.encoder, PCFG,
                                       torch.from_numpy(xs[:, i:i + 2]), ps)
        _close(out, ref)


def test_decoder_bos_and_step_match_jax(models):
    params, model = models
    ys = np.array([[4, 1, 7], [2, 9, 1]], np.int64)      # PAD=1 inside
    ref, st_j = JT.decoder_apply(params['decoder'], JCFG,
                                 jnp.asarray(ys, jnp.int32))
    with torch.no_grad():
        out, st_p = PT.decoder_apply(model.decoder, PCFG,
                                     torch.from_numpy(ys))
    assert out.shape == (2, 4, 12)        # BOS prepended
    _close(out, ref)
    step = np.array([[5], [6]], np.int64)
    ref2, _ = JT.decoder_apply(params['decoder'], JCFG,
                               jnp.asarray(step, jnp.int32), st_j)
    with torch.no_grad():
        out2, _ = PT.decoder_apply(model.decoder, PCFG,
                                   torch.from_numpy(step), st_p)
    _close(out2, ref2)


def test_joint_and_full_logits_match_jax(models):
    params, model = models
    rng = np.random.RandomState(4)
    xs = rng.randn(2, 6, 10).astype(np.float32)
    ys = rng.randint(4, 20, (2, 3)).astype(np.int64)
    ref = JT.transducer_logits(params, JCFG, jnp.asarray(xs),
                               jnp.asarray(ys, jnp.int32))
    with torch.no_grad():
        out = PT.transducer_logits(model, PCFG, torch.from_numpy(xs),
                                   torch.from_numpy(ys))
    assert out.shape == (2, 3, 4, 20)
    _close(out, ref, LRTOL, LATOL)
    he = rng.randn(3, 12).astype(np.float32)
    hd = rng.randn(3, 12).astype(np.float32)
    ref_pt = JT.joint_apply(params['joint'], jnp.asarray(he), jnp.asarray(hd))
    with torch.no_grad():
        out_pt = PT.joint_apply(model.joint, torch.from_numpy(he),
                                torch.from_numpy(hd))
    _close(out_pt, ref_pt, LRTOL, LATOL)


@pytest.mark.parametrize('t', [4, 5])
def test_time_reduction_and_scale_length(t):
    x = np.random.RandomState(t).randn(2, t, 3).astype(np.float32)
    np.testing.assert_allclose(
        PT.time_reduction(torch.from_numpy(x), 2).numpy(),
        np.asarray(JT.time_reduction(jnp.asarray(x), 2)), 1e-6)
    xt = np.swapaxes(x, 0, 1).copy()
    np.testing.assert_allclose(
        PT.time_reduction_tm(torch.from_numpy(xt), 2).numpy(),
        np.asarray(JT.time_reduction_tm(jnp.asarray(xt), 2)), 1e-6)
    xlen = np.array([t, t - 1], np.int32)
    np.testing.assert_array_equal(
        PT.scale_length(PCFG, torch.from_numpy(xlen), t, -(-t // 2)).numpy(),
        np.asarray(JT.scale_length(JCFG, jnp.asarray(xlen), t, -(-t // 2))))


@pytest.mark.parametrize('lightning', [False, True])
def test_load_reference_checkpoint(tmp_path, models, lightning):
    """A reference .pt (plain {'model': sd} or lightning 'model.' keys)
    loads into the port and, through the JAX importer, into JAX: both
    give the same encoder output."""
    _, model = models
    sd = model.state_dict()
    ckpt = ({'state_dict': {'model.' + k: v for k, v in sd.items()}}
            if lightning else {'model': sd})
    path = str(tmp_path / 'ref.pt')
    torch.save(ckpt, path)
    loaded = PC.load_reference_checkpoint(path, PCFG, 'cpu')
    jparams = JC.load_reference_checkpoint(path, JCFG)
    xs = np.random.RandomState(5).randn(1, 6, 10).astype(np.float32)
    ref, _ = JT.encoder_apply(jparams['encoder'], JCFG, jnp.asarray(xs))
    with torch.no_grad():
        out, _ = PT.encoder_apply(loaded.encoder, PCFG, torch.from_numpy(xs))
    _close(out, ref)


def test_seeded_init_and_gru_refused():
    a = PT.Transducer(PCFG, device='cpu', seed=3)
    b = PT.Transducer(PCFG, device='cpu', seed=3)
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    assert not a.decoder.embed.weight[1].any()
    # the GRU encoder is ported (3H gate rows); an unknown cell is refused
    gru = PT.Transducer(PT.TransducerConfig(vocab_size=8, module_type='GRU',
                                            input_size=5, enc_hidden_size=6),
                        device='cpu')
    assert gru.encoder.lstm.lstms[0].weight_ih_l0.shape == (18, 5)
    assert gru.encoder.lstm.lstms[0].weight_hh_l0.shape == (18, 6)
    with pytest.raises(ValueError):
        PT.Transducer(PT.TransducerConfig(vocab_size=8, module_type='RNN'),
                      device='cpu')
