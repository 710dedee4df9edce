"""The port's CTC model (edgedict_tpu_torch/models/ctc.py) == the JAX one
(edgedict_tpu/models/ctc.py) on the same weights, handed over through
compat.ctc_state_dict_from_jax_params: log-probs, the mean loss (optax's
ctc_loss) and its gradients with padded frames and labels, the encoder's
time reduction (scale_length) and an utterance whose labels need more
frames than it has, greedy tokens exact; the host collapse
ctc_greedy_decode_postprocess == the JAX package's.

Tolerances: forward rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-4
(ROADMAP.md "When a slice is done"); per-utterance losses rtol 1e-5 (the
same recursion, other summation orders in fp32).  An infeasible utterance's
gradient is fixed in fp32 only to ~5e-3: its log-alphas sit near optax's
log-epsilon, -1e5, where fp32 values are 2^-7 apart, which moves each
log-add-exp weight by up to 1%; the JAX package's own fp32 gradient there
differs from its fp64 one by 2-4e-3 (measured).  So a batch holding one is
held at 1e-2 of the gradient's largest entry, and the recursion itself is
held in fp64 against optax in fp64 at rtol 1e-6."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.models import ctc as JC
from edgedict_tpu.models import decoding as JD
from edgedict_tpu_torch import compat
from edgedict_tpu_torch.models import ctc as PC
from edgedict_tpu_torch.models import decoding as PD
from edgedict_tpu_torch.optim import Optimizer

RTOL, ATOL = 1e-4, 1e-5
GRTOL, GATOL = 1e-3, 1e-4
KW = dict(vocab_size=10, input_size=8, enc_hidden_size=16, enc_layers=2,
          enc_proj_size=12)
JCFG, PCFG = JC.CTCConfig(**KW), PC.CTCConfig(**KW)


@pytest.fixture(scope='module')
def models():
    params = jax.tree.map(np.asarray,
                          JC.ctc_init(jax.random.PRNGKey(0), JCFG))
    model = PC.CTCModel(PCFG, 'cpu')
    model.load_state_dict(compat.ctc_state_dict_from_jax_params(params))
    return jax.tree.map(jnp.asarray, params), model


def _batch(seed, b=3, t=12):
    """xs (b, t, 8); labels with a repeat; item 2 needs 5 frames for its
    4 labels (one repeat) but has ceil(7 / 2) = 4 after the encoder's
    reduction: infeasible for CTC."""
    xs = np.random.RandomState(seed).randn(b, t, 8).astype(np.float32)
    ys = np.array([[4, 5, 5, 7], [7, 8, 0, 0], [3, 3, 1, 2]], np.int32)[:b]
    xlen = np.array([t, 8, 7])[:b]
    ylen = np.array([4, 2, 4])[:b]
    return xs, ys, xlen, ylen


def _close(a, r, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), rtol, atol)


def test_config_defaults_and_state_dict_layout(models):
    assert PC.CTCConfig(vocab_size=5, input_size=3) == PC.CTCConfig(
        **{f: getattr(JC.CTCConfig(vocab_size=5, input_size=3), f)
           for f in ('vocab_size', 'input_size', 'enc_hidden_size',
                     'enc_layers', 'enc_dropout', 'enc_proj_size', 'blank',
                     'module_type')})
    cfg = PC.CTCConfig(vocab_size=5, input_size=3)
    assert (cfg.enc_hidden_size, cfg.enc_layers, cfg.enc_proj_size,
            cfg.blank, cfg.encoder_cfg.enc_time_reductions) == \
        (600, 4, 600, 0, (1,))
    _, model = models
    sd = model.state_dict()
    assert sd['tovocab.weight'].shape == (10, 12)
    assert 'encoder.lstm.lstms.1.weight_hh_l0' in sd
    assert 'encoder.lstm.projs.1.0.weight' in sd


@pytest.mark.parametrize('t', [12, 11])
def test_ctc_apply_matches_jax(models, t):
    params, model = models
    xs = np.random.RandomState(t).randn(2, t, 8).astype(np.float32)
    ref = JC.ctc_apply(params, JCFG, jnp.asarray(xs))
    with torch.no_grad():
        out = PC.ctc_apply(model, torch.from_numpy(xs))
    assert out.shape == ref.shape == (2, -(-t // 2), 10)
    _close(out, ref)


def _jax_per_utterance(params, xs, ys, xlen, ylen):
    logp = JC.ctc_apply(params, JCFG, jnp.asarray(xs))
    xlen_s = np.ceil(xlen / np.ceil(xs.shape[1] / logp.shape[1]))
    t_pad = (np.arange(logp.shape[1])[None] >= xlen_s[:, None])
    u_pad = (np.arange(ys.shape[1])[None] >= ylen[:, None])
    losses = optax.ctc_loss(logp, jnp.asarray(t_pad, jnp.float32),
                            jnp.asarray(ys), jnp.asarray(u_pad, jnp.float32))
    return np.asarray(logp), xlen_s.astype(np.int32), np.asarray(losses)


def test_per_utterance_losses_match_optax(models):
    """ctc_losses (F.ctc_loss, and the optax recursion on the infeasible
    item) and ctc_loss_plain alone equal optax.ctc_loss per utterance; the
    infeasible one is finite (~1e5, optax's log-epsilon), not F.ctc_loss's
    inf."""
    params, _ = models
    xs, ys, xlen, ylen = _batch(1)
    logp, xlen_s, ref = _jax_per_utterance(params, xs, ys, xlen, ylen)
    args = (torch.from_numpy(logp), torch.from_numpy(xlen_s),
            torch.from_numpy(ys), torch.from_numpy(ylen))
    need = PC.ctc_frames_needed(args[2], args[3])
    assert need.tolist() == [5, 2, 5] and xlen_s.tolist() == [6, 4, 4]
    assert 1e5 <= ref[2] < 2e5 and np.all(ref[:2] < 100)
    raw = torch.nn.functional.ctc_loss(
        args[0].transpose(0, 1), args[2].long(), args[1].long(),
        args[3].long(), reduction='none')
    assert torch.isinf(raw[2]) and torch.isfinite(raw[:2]).all()
    np.testing.assert_allclose(PC.ctc_losses(*args).numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(PC.ctc_loss_plain(*args).numpy(), ref,
                               rtol=1e-5)


def test_empty_label_sequence_matches_optax(models):
    params, _ = models
    xs, ys, xlen, _ = _batch(2)
    ylen = np.array([0, 2, 1])
    logp, xlen_s, ref = _jax_per_utterance(params, xs, ys, xlen, ylen)
    args = (torch.from_numpy(logp), torch.from_numpy(xlen_s),
            torch.from_numpy(ys), torch.from_numpy(ylen))
    np.testing.assert_allclose(PC.ctc_losses(*args).numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(PC.ctc_loss_plain(*args).numpy(), ref,
                               rtol=1e-5)


def test_plain_recursion_matches_optax_in_fp64():
    """ctc_loss_plain in fp64 == optax.ctc_loss in fp64 (jax x64 scoped to
    the call), loss and gradient w.r.t. the logits, the infeasible
    utterance included."""
    rng = np.random.RandomState(6)
    logits = rng.randn(3, 6, 10)
    ys = np.array([[4, 5, 5, 7], [7, 8, 0, 0], [3, 3, 1, 2]], np.int32)
    xlen, ylen = np.array([6, 4, 4]), np.array([4, 2, 4])
    t_pad = (np.arange(6)[None] >= xlen[:, None]).astype(np.float64)
    u_pad = (np.arange(4)[None] >= ylen[:, None]).astype(np.float64)
    with jax.enable_x64(True):
        def f(x):
            return optax.ctc_loss(x, t_pad, ys, u_pad)
        x = jnp.asarray(logits, jnp.float64)
        ref = np.asarray(f(x))
        ref_g = np.asarray(jax.grad(lambda x: f(x).sum())(x))
    lt = torch.from_numpy(logits).requires_grad_()
    got = PC.ctc_loss_plain(lt, torch.from_numpy(xlen), torch.from_numpy(ys),
                            torch.from_numpy(ylen))
    got.sum().backward()
    assert got.dtype == torch.float64 and ref[2] > 1e5
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), ref_g, rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize('items', [(0, 1), (0, 1, 2)])
def test_ctc_loss_and_grads_match_jax(models, items):
    """The mean loss and every parameter's gradient, padding and
    scale_length included; with item 2 the batch holds the infeasible
    utterance (gradients then within 1e-2 of their largest entry, see the
    module note)."""
    params, model = models
    xs, ys, xlen, ylen = (a[list(items)] for a in _batch(3))
    inputs = [jnp.asarray(a) for a in (xs, ys, xlen, ylen)]
    loss_j, grads_j = jax.value_and_grad(
        lambda p: JC.ctc_loss(p, JCFG, *inputs))(params)
    model.zero_grad()
    loss_p = PC.ctc_loss(model, *(torch.from_numpy(a) for a in
                                  (xs, ys, xlen, ylen)))
    loss_p.backward()
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=RTOL)
    want = compat.ctc_state_dict_from_jax_params(
        jax.tree.map(np.asarray, grads_j))
    scale = max(float(g.abs().max()) for g in want.values())
    for name, p in model.named_parameters():
        if 2 in items:
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       0, 1e-2 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       GRTOL, GATOL, err_msg=name)


def test_greedy_decode_matches_jax(models):
    params, model = models
    xs, _, xlen, _ = _batch(4, t=15)
    seqs_j, neg_j = JC.ctc_greedy_decode(params, JCFG, jnp.asarray(xs),
                                         jnp.asarray(xlen))
    with torch.no_grad():
        seqs_p, neg_p = PC.ctc_greedy_decode(model, torch.from_numpy(xs),
                                             torch.from_numpy(xlen))
    assert len(seqs_p) == 3
    for a, r in zip(seqs_p, seqs_j):
        np.testing.assert_array_equal(a, r)
        assert (a != 0).all()
    np.testing.assert_allclose(neg_p, neg_j, RTOL, ATOL)


def test_postprocess_matches_jax():
    """Repeats collapse, blanks drop, frames past xlen are ignored; tensor
    inputs as well as arrays."""
    rng = np.random.RandomState(5)
    y = rng.randint(0, 4, (6, 20)).astype(np.int32)
    lp = -rng.rand(6, 20).astype(np.float32)
    xlen = np.array([20, 0, 1, 7, 13, 19])
    want_s, want_n = JD.ctc_greedy_decode_postprocess(y, lp, xlen, blank=0)
    for args in ((y, lp, xlen), tuple(torch.from_numpy(a) for a in
                                      (y, lp, xlen))):
        got_s, got_n = PD.ctc_greedy_decode_postprocess(*args, blank=0)
        assert len(got_s) == 6
        for a, r in zip(got_s, want_s):
            np.testing.assert_array_equal(a, r)
        np.testing.assert_array_equal(got_n, want_n)
    got, _ = PD.ctc_greedy_decode_postprocess(
        np.array([[1, 1, 0, 1, 2, 2, 0, 0, 3]]), np.zeros((1, 9)), [9])
    assert got[0].tolist() == [1, 1, 2, 3]


def test_adam_steps_match_optax_and_the_loss_falls(models):
    """Five Adam steps (the port's optim.py against optax.adam at lr 5e-3)
    on one batch take the same losses, and thirty lower it (the JAX
    package's test_ctc_training_reduces_loss)."""
    params, _ = models
    xs = np.random.RandomState(3).randn(4, 12, 8).astype(np.float32)
    ys = np.tile(np.array([[4, 5, 6]], np.int32), (4, 1))
    xlen, ylen = np.full((4,), 12), np.full((4,), 3)
    jin = [jnp.asarray(a) for a in (xs, ys, xlen, ylen)]
    opt = optax.adam(5e-3)
    jp, state = params, opt.init(params)
    want = []
    for _ in range(5):
        loss, grads = jax.value_and_grad(
            lambda p: JC.ctc_loss(p, JCFG, *jin))(jp)
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        want.append(float(loss))
    model = PC.CTCModel(PCFG, 'cpu')
    model.load_state_dict(compat.ctc_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)))
    popt = Optimizer('adam')
    pstate = popt.init(dict(model.named_parameters()))
    pin = [torch.from_numpy(a) for a in (xs, ys, xlen, ylen)]
    got = []
    for _ in range(30):
        model.zero_grad()
        loss = PC.ctc_loss(model, *pin)
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        updates, pstate = popt.update(grads, pstate,
                                      dict(model.named_parameters()), 5e-3)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.add_(updates[k])
        got.append(loss.item())
    np.testing.assert_allclose(got[:5], want, rtol=GRTOL)
    assert got[-1] < got[0]
