"""Tensor parallelism of the port (edgedict_tpu_torch/parallel/vocab.py:
the joint's vocabulary in tp slices) on the CPU:

  * vocab_parallel_joint_lse, plain, against the one-device plain joint
    (fused_joint_lse_plain): blank_lp, label_lp and the gradients of f, g,
    W and the bias, at tp 2 and 4, fp32 and bf16 products, with V/tp = 16
    (the sentinel column alone in its 16-column pad tile) and V/tp = 5,
    labels owned by every slice and the blank by slice 0: rtol 1e-5 / atol
    1e-5 (df, dg and dW of bf16 products: within 2^-7 of their largest
    entry, one bf16 rounding);
  * the autograd.Function the card runs (make_vocab_parallel: K8 a slice
    with the whole vocabulary's lse and the sentinel's column cut off),
    over the plain K7 / K8 of ops/joint_lse_kernel.py, against the plain
    version: the same outputs and gradients (rtol 1e-5 / atol 1e-6);
  * two Adam steps at tp = 2 against the JAX package's make_train_step on
    make_mesh(dp=4, tp=2): loss rtol 1e-5, params rtol 1e-4 / atol 1e-5,
    as tests/test_torch_port_train.py; each slice holds V/2 rows of the
    output layer and its optimizer state, also under SM3 and Novograd
    (whose statistics span the slices) against the one-device step;
  * a vocabulary that tp does not divide stays whole, as param_sharding
    leaves it replicated;
  * checkpoints keep the one-device layout: cli.baseline --device cpu
    --tp_size 2 (and --pp_size 2) trains and evaluates; its checkpoint
    loads into a one-device Trainer bit for bit, and a one-device
    checkpoint into a tp = 2 / pp = 2 Trainer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgedict_tpu import optim as jopt
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.parallel import train as jtrain
from edgedict_tpu_torch import optim as popt
from edgedict_tpu_torch import parallel as P
from edgedict_tpu_torch import train as ptrain
from edgedict_tpu_torch.compat import state_dict_from_jax_params
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
from edgedict_tpu_torch.parallel import vocab as PV

SMALL = dict(vocab_embed_size=4, input_size=6, enc_hidden_size=8,
             enc_layers=2, enc_proj_size=7, dec_hidden_size=5, dec_layers=2,
             dec_proj_size=6, joint_size=9)


def _joint_inputs(seed, tp, vs, dtype, b=2, t=3, u=4, j=9):
    """f, g (in dtype), w_t (J, V), bias (V,), labels holding the first id
    of every slice and its last, the blank 0."""
    rng = np.random.RandomState(seed)
    v = tp * vs
    f = torch.tensor(rng.randn(b, t, j), dtype=torch.float32).to(dtype)
    g = torch.tensor(rng.randn(b, u + 1, j), dtype=torch.float32).to(dtype)
    w_t = torch.tensor(rng.randn(j, v) * 0.5, dtype=torch.float32)
    bias = torch.tensor(rng.randn(v) * 0.1, dtype=torch.float32)
    owned = [k * vs + e for k in range(tp) for e in (0, vs - 1)]
    labels = rng.randint(1, v, (b, u))
    labels.flat[:len(owned)] = owned[:b * u]
    return f, g, w_t, bias, torch.tensor(labels, dtype=torch.int32)


def _grads(fn, f, g, w_t, bias, labels, cot):
    leaves = [x.detach().float().requires_grad_() for x in (f, g, w_t, bias)]
    f_, g_ = leaves[0].to(f.dtype), leaves[1].to(g.dtype)
    out = fn(f_, g_, leaves[2], leaves[3], labels)
    return out, torch.autograd.grad(out, leaves, cot)


def _close(got, want, dtype, atol):
    """blank_lp, label_lp and dbias (fp32) at rtol 1e-5; with bf16
    products df, dg and dW within 2^-7 of their largest entry, one bf16
    rounding of it (autograd of the plain version rounds dh and dW to
    bf16, slice by slice; K8 keeps both in fp32)."""
    for i, (a, r) in enumerate(zip(got, want)):
        a, r = a.detach().numpy(), r.detach().numpy()
        if dtype == torch.bfloat16 and i in (2, 3, 4):
            assert np.abs(a - r).max() <= 2 ** -7 * np.abs(r).max()
        else:
            np.testing.assert_allclose(a, r, rtol=1e-5, atol=atol)


CASES = [pytest.param(tp, vs, dt, id=f'tp{tp}-vs{vs}-{name}')
         for tp, vs, dt, name in ((2, 16, torch.float32, 'fp32'),
                                  (4, 16, torch.float32, 'fp32'),
                                  (2, 5, torch.float32, 'fp32'),
                                  (4, 5, torch.float32, 'fp32'),
                                  (2, 16, torch.bfloat16, 'bf16'),
                                  (4, 5, torch.bfloat16, 'bf16'))]


@pytest.mark.parametrize('tp,vs,dtype', CASES)
def test_vocab_parallel_joint_matches_the_one_device_joint(tp, vs, dtype):
    f, g, w_t, bias, labels = _joint_inputs(tp * 10 + vs, tp, vs, dtype)
    rng = np.random.RandomState(1)
    cot = (torch.tensor(rng.randn(2, 3, 5), dtype=torch.float32),
           torch.tensor(rng.randn(2, 3, 4), dtype=torch.float32))
    want, want_g = _grads(lambda f_, g_, w, b, lab: KJ.fused_joint_lse_plain(
        f_, g_, w, b, lab, 0), f, g, w_t, bias, labels, cot)

    def sliced(f_, g_, w, b, lab):
        return PV.vocab_parallel_joint_lse_plain(
            f_, g_, list(w.chunk(tp, 1)), list(b.chunk(tp)), lab, 0)

    got, got_g = _grads(sliced, f, g, w_t, bias, labels, cot)
    _close(got + got_g, want + want_g, dtype, atol=1e-5)


@pytest.mark.parametrize('tp,vs,dtype', CASES)
def test_the_card_function_over_plain_kernels_matches_plain(tp, vs, dtype):
    """make_vocab_parallel over joint_lse_fwd_plain / joint_lse_bwd_plain
    is the card's dataflow with the plain K7 / K8 in place of the kernels:
    each slice's problem with the sentinel, K8 with the global lse."""
    f, g, w_t, bias, labels = _joint_inputs(tp * 7 + vs, tp, vs, dtype)
    rng = np.random.RandomState(2)
    cot = (torch.tensor(rng.randn(2, 3, 5), dtype=torch.float32),
           torch.tensor(rng.randn(2, 3, 4), dtype=torch.float32))
    fn = PV.make_vocab_parallel(KJ.joint_lse_fwd_plain,
                                KJ.joint_lse_bwd_plain)
    want, want_g = _grads(lambda f_, g_, w, b, lab:
                          PV.vocab_parallel_joint_lse_plain(
                              f_, g_, list(w.chunk(tp, 1)),
                              list(b.chunk(tp)), lab, 0),
                          f, g, w_t, bias, labels, cot)
    got, got_g = _grads(lambda f_, g_, w, b, lab: fn(
        f_, g_, lab, 0, *w.chunk(tp, 1), *b.chunk(tp)),
        f, g, w_t, bias, labels, cot)
    assert all(torch.isfinite(a).all() for a in got + got_g)
    _close(got + got_g, want + want_g, dtype, atol=1e-6)


def test_slice_problem_maps_foreign_ids_to_the_sentinel():
    w_t, bias = torch.ones(3, 4), torch.zeros(4)
    labels = torch.tensor([[0, 3, 4, 7, 8]], dtype=torch.int32)
    w_p, b_p, lab, blank = PV.slice_problem(w_t, bias, labels, 0, 4)
    assert w_p.shape == (3, 5) and (w_p[:, 4] == 0).all()
    assert b_p[4] == float('-inf') and b_p.dtype == torch.float32
    assert lab.tolist() == [[4, 4, 0, 3, 4]] and blank == 4
    assert PV.slice_problem(w_t, bias, labels, 0, 0)[3] == 0


def _batch(rng, accum=2, micro=4, t=9, u=4, feat=6, vocab=24):
    return {'xs': rng.randn(accum, micro, t, feat).astype(np.float32),
            'xlen': np.tile(np.array([t, t - 2, t - 1, t - 3], np.int32),
                            (accum, 1)),
            'ys': rng.randint(1, vocab, (accum, micro, u)).astype(np.int32),
            'ylen': np.tile(np.array([u, u - 1, u - 2, u], np.int32),
                            (accum, 1))}


def test_tp_adam_steps_match_the_jax_dp_tp_mesh():
    jcfg = JT.TransducerConfig(vocab_size=24, **SMALL)
    pcfg = PT.TransducerConfig(vocab_size=24, **SMALL)
    mesh = jtrain.make_mesh(dp=4, tp=2)
    jo = jopt.build_optimizer('adam', lr=1e-2, gradclip=0.5)
    jstate = jtrain.make_train_state(jax.random.PRNGKey(3), jcfg, jo, mesh)
    layout = P.make_layout(tp=2, devices=['cpu'] * 2)
    po = PT.build_optimizer(pcfg, 'adam', gradclip=0.5,
                            shards=P.vocab_shards(pcfg, layout))
    model = PT.Transducer(pcfg, 'cpu')
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, jstate.params)))
    model = P.place_model(model, layout)
    state = ptrain.TrainState(model, po.init(dict(model.named_parameters())))
    params = dict(model.named_parameters())
    for k in range(2):
        assert params[f'joint.joint.2.weight_{k}'].shape == (12, 9)
        assert params[f'joint.joint.2.bias_{k}'].shape == (12,)
        assert state.opt_state['mu'][f'joint.joint.2.weight_{k}'].shape \
            == (12, 9)
    assert 'joint.joint.2.weight' not in params
    jstep = jtrain.make_train_step(jcfg, jo, mesh=mesh, bf16=False)
    pstep = ptrain.make_train_step(pcfg, po, bf16=False)
    batch = _batch(np.random.RandomState(0))
    for i, lr in enumerate((1e-2, 2e-2)):
        jstate, jm = jstep(jstate, jtrain.shard_batch(
            mesh, {k: v.reshape((-1,) + v.shape[2:])
                   for k, v in batch.items()}, accum_steps=2),
            jax.random.PRNGKey(i), jnp.asarray(lr))
        state, pm = pstep(state, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, lr)
        np.testing.assert_allclose(float(pm['loss']), float(jm['loss']),
                                   1e-5)
        np.testing.assert_allclose(float(pm['grad_norm']),
                                   float(jm['grad_norm']), 1e-4)
        want = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                       jstate.params))
        got = state.model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), 1e-4, 1e-5,
                                       err_msg=k)
    assert int(state.opt_state['count']) == 2


@pytest.mark.parametrize('name', ['sm3', 'novograd', 'sgd'])
def test_tp_step_equals_the_one_device_step(name):
    """SM3's accumulators of the other dims and Novograd's norm span the
    slices; the joined state equals the one-device state."""
    cfg = PT.TransducerConfig(vocab_size=24, **SMALL)
    layout = P.make_layout(tp=4, devices=['cpu'] * 4)
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(np.random.RandomState(1)).items()}
    out = []
    for lay in (None, layout):
        opt = PT.build_optimizer(cfg, name, gradclip=1.0,
                                 shards=P.vocab_shards(cfg, lay)
                                 if lay else None)
        state = ptrain.make_train_state(cfg, opt, 'cpu', seed=2, layout=lay)
        step = ptrain.make_train_step(cfg, opt, bf16=False)
        for lr in (1e-2, 2e-2):
            state, m = step(state, batch, lr)
        out.append((float(m['loss']), state.model.state_dict(),
                    popt.join_shards(state.opt_state, opt.shards)))
    (l0, sd0, st0), (l1, sd1, st1) = out
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for k, v in sd0.items():
        np.testing.assert_allclose(sd1[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)

    def leaves(tree, path=''):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f'{path}/{k}')
        else:
            yield path, tree

    a, b = dict(leaves(st0)), dict(leaves(st1))
    assert set(a) == set(b)
    for k, v in a.items():
        np.testing.assert_allclose(b[k].float().numpy(), v.float().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_a_vocabulary_tp_does_not_divide_stays_whole():
    jcfg = JT.TransducerConfig(vocab_size=11, **SMALL)
    specs = jtrain.param_sharding(
        JT.transducer_init(jax.random.PRNGKey(0), jcfg),
        jtrain.make_mesh(dp=4, tp=2))
    assert specs['joint']['out']['w'].spec == ()
    cfg = PT.TransducerConfig(vocab_size=11, **SMALL)
    layout = P.make_layout(tp=2, devices=['cpu'] * 2)
    assert P.vocab_shards(cfg, layout) == {}
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(np.random.RandomState(2), vocab=11).items()}
    sds = []
    for lay in (None, layout):
        opt = PT.build_optimizer(cfg, 'adam')
        state = ptrain.make_train_state(cfg, opt, 'cpu', seed=1, layout=lay)
        assert isinstance(state.model.joint.out, PT.Linear)
        state, _ = ptrain.make_train_step(cfg, opt, bf16=False)(state, batch,
                                                                1e-2)
        sds.append(state.model.state_dict())
    for k, v in sds[0].items():
        assert torch.equal(sds[1][k], v), k


def _trainer(argv):
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.trainer import Trainer
    return Trainer(parse_flags(baseline.build_parser(), argv))


def _opt_leaves(tree, path=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_opt_leaves(v, f'{path}/{k}'))
        return out
    return {path: tree}


@pytest.mark.parametrize('grid', [['--tp_size', '2'], ['--pp_size', '2']])
def test_cli_baseline_grid_trains_evaluates_and_moves_to_one_device(
        tmp_path, grid):
    """The run at tp = 2 or pp = 2 trains and evaluates; its checkpoint
    holds the one-device layout, a one-device Trainer loads it bit for bit
    (model and optimizer state), and the grid's Trainer loads the
    one-device run's checkpoint bit for bit back into its slices."""
    from edgedict_tpu_torch import checkpoint as C
    from edgedict_tpu_torch.cli import baseline
    from test_torch_port_pipeline import _corpus, cli_args
    corpus = _corpus(str(tmp_path / 'libri'))
    args = cli_args(corpus, str(tmp_path / 'logs'), 'grid')
    lines = []
    trainer = baseline.main(args + grid + ['--mode', 'train'],
                            log_fn=lines.append)
    assert trainer.state.step == 4
    assert sum(ln.startswith('eval @ ') for ln in lines) == 2
    if grid[0] == '--tp_size':
        v = trainer.cfg.vocab_size
        assert v % 2 == 0, v        # the corpus's char vocabulary splits
        rows = {k: p.shape[0] for k, p in
                trainer.state.model.named_parameters()
                if k.startswith('joint.joint.2.')}
        assert rows == {'joint.joint.2.weight_0': v // 2,
                        'joint.joint.2.weight_1': v // 2,
                        'joint.joint.2.bias_0': v // 2,
                        'joint.joint.2.bias_1': v // 2}
    lines = []
    baseline.main(args + grid + ['--mode', 'eval'], log_fn=lines.append)
    val = [ln for ln in lines if ln.startswith('val_loss')]
    assert val and np.isfinite(float(val[0].split()[1])) and 'WER' in val[0]

    payload = C.load_checkpoint(C.checkpoint_path(trainer.logdir, 4))
    one = _trainer(args)
    assert one.load(4) == 4
    for k, v in payload['model'].items():
        assert torch.equal(one.state.model.state_dict()[k], v), k
    want = _opt_leaves(payload['optim'])
    got = _opt_leaves(one.state.opt_state)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the one-device run's checkpoint back into the grid
    one.state.step = 5
    path = one.save()
    back = _trainer(args + grid)
    assert back.load(5) == 5
    sd = back.state.model.state_dict()
    saved = C.load_checkpoint(path)
    for k, v in saved['model'].items():
        assert torch.equal(sd[k], v), k
    joined = _opt_leaves(popt.join_shards(back.state.opt_state,
                                          back.optimizer.shards))
    for k, v in _opt_leaves(saved['optim']).items():
        assert torch.equal(joined[k], v), k
    assert os.path.isfile(path)
