"""The port's export (edgedict_tpu_torch/export.py: torch.export of the
encoder / predictor / joint with K1, K11 and K12 as the registered ops
edgedict::lstm_fwd, edgedict::quant_matmul and edgedict::lstm_fwd_q) ==
the JAX package's export (edgedict_tpu/export.py, StableHLO on the CPU)
on the same weights: the reloaded artifacts' outputs, and the text of the
port's ExportedStreamDecoder, its live StreamingDecoder and the JAX
package's ExportedStreamDecoder, in fp32 and int8 (the sizes of
tests/test_export.py)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu import export as JE
from edgedict_tpu.features import FeatureConfig as JFeat
from edgedict_tpu.features import FeaturePipeline as JPipeline
from edgedict_tpu.models import transducer as JT
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import export as PE
from edgedict_tpu_torch.features import FeatureConfig as PFeat
from edgedict_tpu_torch.features import FeaturePipeline as PPipeline
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops import quant as Q
from edgedict_tpu_torch.ops import rnn_kernel as K1
from edgedict_tpu_torch.stream import StreamingDecoder

RTOL, ATOL = 1e-4, 1e-5     # fp32 forward, ROADMAP's ladder
KW = dict(vocab_size=16, vocab_embed_size=8, input_size=9,
          enc_hidden_size=16, enc_layers=2, enc_proj_size=12,
          dec_hidden_size=16, dec_layers=1, dec_proj_size=12,
          joint_size=16, enc_time_reductions=())
FKW = dict(feature_type='logfbank', feature_size=3, n_fft=64, win_length=40,
           hop_length=20, downsample=3, pad_to_divisible=False)
# the int8 case's encoder is 128 wide (tests/test_export.py:51): the
# weights dominate the artifact
WIDE = dict(enc_hidden_size=128, enc_proj_size=128)


class _Tok:
    """One distinct character per id: equal text ⇔ equal tokens (>UNK)."""
    unk_id = 3

    def id_to_token(self, i):
        return chr(0x100 + int(i))


def _weights(kw, seed, unk_shift=-100.0):
    """JAX params from a seed, the blank column pushed down and the logits
    widened so that random audio decodes text far from near-ties, the
    <unk> column moved by `unk_shift` → (JAX params, JAX cfg, port model
    on the CPU, port cfg).  The default keeps <unk> from ever being the
    argmax: the JAX package's ExportedStreamDecoder fails on such a frame
    (its logits are a read-only view, edgedict_tpu/export.py:200), so the
    port's <unk> masking is held against its live decoder alone
    (test_exported_decoder_masks_unk_as_live)."""
    jcfg, pcfg = JT.TransducerConfig(**kw), PT.TransducerConfig(**kw)
    params = JT.transducer_init(jax.random.PRNGKey(seed), jcfg)
    params['joint']['out']['b'] = params['joint']['out']['b'].at[0].add(
        -1.0).at[3].add(unk_shift)
    params['joint']['out']['w'] = params['joint']['out']['w'] * 8.0
    params = jax.tree.map(np.asarray, params)
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), pcfg, 'cpu')
    return jax.tree.map(jnp.asarray, params), jcfg, model, pcfg


def _stream(dec, audio, win, hop):
    n = (len(audio) - win) // hop + 1
    return ''.join(dec.decode(audio[i * hop:i * hop + win]) for i in range(n))


def _jax_artifact(path):
    with open(path, 'rb') as f:
        return jax.export.deserialize(f.read())


def _seeded_args(exp, seed, vocab):
    """Numpy inputs for a JAX artifact's signature (tokens in [4, V))."""
    rng = np.random.RandomState(seed)
    return [rng.randint(4, vocab, a.shape).astype(np.int32)
            if a.dtype == jnp.int32 else
            rng.randn(*a.shape).astype(np.float32) for a in exp.in_avals]


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_export_round_trip_equals_jax(tmp_path, quantize):
    """Both packages export the same weights: the port's .pt2 outputs ==
    the JAX artifacts' at rtol 1e-4 / atol 1e-5 on seeded inputs, and the
    port's exported decoder, its live decoder and the JAX exported decoder
    give the same non-empty text on the same audio."""
    kw = dict(KW, **WIDE) if quantize else KW
    params, jcfg, model, pcfg = _weights(kw, 1 if quantize else 0)
    jdir = JE.export_transducer(params, jcfg, str(tmp_path / 'jax'),
                                step_frames=2, quantize=quantize)
    pdir = PE.export_transducer(model, pcfg, str(tmp_path / 'port'),
                                step_frames=2, quantize=quantize,
                                device='cpu')
    meta = json.load(open(os.path.join(pdir, 'meta.json')))
    assert (meta['device'], meta['quantize'], meta['step_frames']) == \
        ('cpu', quantize, 2)
    assert meta['config'] == json.load(
        open(os.path.join(jdir, 'meta.json')))['config'] | {
            'module_type': 'LSTM'}

    for i, name in enumerate(PE.COMPONENTS):
        jexp = _jax_artifact(os.path.join(jdir, f'{name}.stablehlo'))
        pmod = torch.export.load(os.path.join(pdir, f'{name}.pt2')).module()
        args = _seeded_args(jexp, 10 + i, kw['vocab_size'])
        want = jexp.call(*[jnp.asarray(a) for a in args])
        got = pmod(*[torch.from_numpy(a) for a in args])
        want = want if isinstance(want, (tuple, list)) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=name)

    pfeat = PFeat(**FKW)
    exported = PE.ExportedStreamDecoder(pdir, PPipeline(pfeat, 'cpu'),
                                        _Tok(), device='cpu')
    live = StreamingDecoder(model, pcfg, pfeat, _Tok(), device='cpu',
                            step_n_frame=2, quantize=quantize)
    jexported = JE.ExportedStreamDecoder(jdir, JPipeline(JFeat(**FKW)),
                                         _Tok())
    audio = (np.random.RandomState(2).randn(live.win_size * 6) * 0.3) \
        .astype(np.float32)
    texts = [_stream(d, audio, live.win_size, live.hop_size)
             for d in (exported, live, jexported)]
    assert texts[0], 'no token decoded'
    assert texts[0] == texts[1] == texts[2]
    assert len(exported.elapsed) == (len(audio) - live.win_size) \
        // live.hop_size + 1


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_exported_decoder_masks_unk_as_live(tmp_path, quantize):
    """<unk> the argmax at every frame: the exported decoder takes the
    next best, as the live decoder's frame loop does."""
    kw = dict(KW, **WIDE) if quantize else KW
    _, _, model, pcfg = _weights(kw, 3, unk_shift=50.0)
    with torch.no_grad():
        model.joint.out.bias[:3] -= 20.0      # the next best is a label
    out = PE.export_transducer(model, pcfg, str(tmp_path / 'e'),
                               quantize=quantize, device='cpu')
    pfeat = PFeat(**FKW)
    exported = PE.ExportedStreamDecoder(out, PPipeline(pfeat, 'cpu'),
                                        _Tok(), device='cpu')
    live = StreamingDecoder(model, pcfg, pfeat, _Tok(), device='cpu',
                            quantize=quantize)
    audio = (np.random.RandomState(4).randn(live.win_size * 6) * 0.3) \
        .astype(np.float32)
    text = _stream(exported, audio, live.win_size, live.hop_size)
    assert text and text == _stream(live, audio, live.win_size,
                                    live.hop_size)
    with torch.no_grad():
        logits = PT.joint_apply(model.joint,
                                torch.randn(4, pcfg.enc_proj_size),
                                torch.randn(4, pcfg.dec_proj_size))
    assert (logits.argmax(-1) == 3).all()


def test_int8_encoder_artifact_is_small(tmp_path):
    """The int8 encoder artifact carries int8 weight constants: under
    0.55x the fp32 one (tests/test_export.py:68)."""
    _, _, model, pcfg = _weights(dict(KW, **WIDE), 1)
    sizes = [os.path.getsize(os.path.join(PE.export_transducer(
        model, pcfg, str(tmp_path / str(q)), quantize=q, device='cpu',
        check_parity=False), 'encoder.pt2')) for q in (None, 'int8')]
    assert sizes[1] < 0.55 * sizes[0], sizes


def _op_counts(path):
    graph = torch.export.load(path).graph
    counts = {}
    for node in graph.nodes:
        if node.op == 'call_function':
            key = str(node.target)
            counts[key] = counts.get(key, 0) + 1
    return counts


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_exported_graphs_hold_the_edgedict_ops(tmp_path, quantize):
    """Each encoder layer is one edgedict op node (int8: K11 for its input
    projection and the final one, K12 for its recurrence), the predictor's
    layers edgedict.lstm_fwd; no gate nonlinearity is left in the graph
    and the encoder graph does not grow with the chunk's frames (no
    unrolled time loop)."""
    _, _, model, pcfg = _weights(dict(KW, **WIDE) if quantize else KW, 0)
    graphs = {}
    for frames in (2, 6):
        out = PE.export_transducer(model, pcfg, str(tmp_path / str(frames)),
                                   step_frames=frames, quantize=quantize,
                                   device='cpu', check_parity=False)
        graphs[frames] = {name: _op_counts(os.path.join(out, f'{name}.pt2'))
                          for name in PE.COMPONENTS}
    enc, dec = graphs[2]['encoder'], graphs[2]['decoder']
    assert graphs[6] == graphs[2]
    ours = {k: n for k, n in enc.items() if k.startswith('edgedict.')}
    if quantize:
        assert ours == {'edgedict.lstm_fwd_q.default': pcfg.enc_layers,
                        'edgedict.quant_matmul.default':
                            pcfg.enc_layers + 1}
    else:
        assert ours == {'edgedict.lstm_fwd.default': pcfg.enc_layers}
    assert {k: n for k, n in dec.items() if k.startswith('edgedict.')} == \
        {'edgedict.lstm_fwd.default': pcfg.dec_layers}
    assert not [k for g in graphs[2].values() for k in g
                if 'sigmoid' in k]


def _op_args(name):
    rng = np.random.RandomState(5)

    def t(*shape, dtype=np.float32):
        return torch.from_numpy(rng.randn(*shape).astype(dtype))
    b, t_len, hid = 3, 4, 8
    if name == 'quant_matmul':
        q, s = Q.quantize_int8(t(24, 10))
        return torch.ops.edgedict.quant_matmul.default, (t(5, 10), q, s,
                                                         t(24))
    h0, c0 = t(b, hid), t(b, hid)
    if name == 'lstm_fwd_q':
        q, s = Q.quantize_int8(t(4 * hid, hid))
        return torch.ops.edgedict.lstm_fwd_q.default, (
            t(t_len, b, 4 * hid), q, s, h0, c0)
    return torch.ops.edgedict.lstm_fwd.default, (
        t(t_len, b, 4 * hid), t(4 * hid, hid) * 0.3, h0, c0)


@pytest.mark.parametrize('name', ['lstm_fwd', 'quant_matmul', 'lstm_fwd_q'])
def test_opcheck_on_cpu(name):
    """torch.library.opcheck: schema, fake (shapes and dtypes), autograd
    registration and the dynamic-shape trace of each op, and the op's CPU
    result is its plain version's."""
    op, args = _op_args(name)
    torch.library.opcheck(op, args)
    plain = {'lstm_fwd': K1.lstm_recurrence_plain,
             'quant_matmul': Q.quant_matmul_plain,
             'lstm_fwd_q': Q.lstm_recurrence_q_plain}[name]
    got, want = op(*args), plain(*args)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert torch.equal(g, w)


def test_gru_export_raises(tmp_path):
    cfg = PT.TransducerConfig(**dict(KW, module_type='GRU'))
    with pytest.raises(ValueError, match='LSTM-only'):
        PE.export_transducer(PT.Transducer(cfg, 'cpu'), cfg,
                             str(tmp_path / 'gru'), device='cpu')


def test_artifact_runs_only_on_its_device(tmp_path):
    """An artifact whose meta.json names another device raises, and so
    does an export to a device that is not there: nothing moves to the
    CPU."""
    _, _, model, pcfg = _weights(KW, 0)
    out = PE.export_transducer(model, pcfg, str(tmp_path / 'e'),
                               device='cpu', check_parity=False)
    meta_path = os.path.join(out, 'meta.json')
    meta = json.load(open(meta_path))
    json.dump(dict(meta, device='cuda'), open(meta_path, 'w'))
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        PE.ExportedStreamDecoder(out, PPipeline(PFeat(**FKW), 'cpu'),
                                 _Tok(), device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='is_available'):
            PE.export_transducer(model, pcfg, str(tmp_path / 'c'),
                                 device='cuda')


def test_export_parity_check_catches_a_wrong_artifact(tmp_path,
                                                      monkeypatch):
    """The export-time parity check compares the reloaded artifact with
    the live model: an artifact that computes something else fails it."""
    _, _, model, pcfg = _weights(KW, 0)
    real_save = torch.export.save

    def save_other(ep, path):
        if path.endswith('joint.pt2'):
            ep = torch.export.export(
                PE._Joint(PT.Transducer(pcfg, 'cpu', seed=9).joint),
                (torch.zeros(1, pcfg.enc_proj_size),
                 torch.zeros(1, pcfg.dec_proj_size)))
        real_save(ep, path)

    monkeypatch.setattr(torch.export, 'save', save_other)
    with pytest.raises(AssertionError):
        PE.export_transducer(model, pcfg, str(tmp_path / 'e'),
                             device='cpu')
