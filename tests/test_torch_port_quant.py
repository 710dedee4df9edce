"""Port int8 weight-only serving (edgedict_tpu_torch/ops/quant.py: K11-K13's
plain versions, quantize_encoder, prepare_inference_params(quantize=
'int8')) == the JAX package's ops/quant.py on the same weights: the int8
values and scales exactly, the quantized product and recurrences against
the JAX kernels in interpret mode (EDGEDICT_QUANT_KERNELS=force under
rnn_ops.shard_local_context(), the idiom of tests/test_quant.py), and
int8 StreamingDecoder tokens against JAX's for an LSTM and a GRU
encoder."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.features import FeatureConfig as JFeat
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.ops import quant as JQ
from edgedict_tpu.ops import rnn as JR
from edgedict_tpu.stream import StreamingDecoder as JStreamingDecoder
from edgedict_tpu.stream import prepare_inference_params as j_prepare
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import stream as PS
from edgedict_tpu_torch.features import FeatureConfig as PFeat
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops import quant as Q
from edgedict_tpu_torch.ops.gru_kernel import gru_recurrence
from edgedict_tpu_torch.ops.rnn_kernel import lstm_recurrence

RTOL, ATOL = 1e-4, 1e-5     # fp32 forward, ROADMAP's ladder
UNK = 3
# H % 128 == 0 and 4H / 3H / P column-blockable: the JAX package takes its
# kernels (interpret mode) for every layer, not its dequantize fallback
KW = dict(vocab_size=24, vocab_embed_size=8, input_size=9,
          enc_hidden_size=128, enc_layers=2, enc_proj_size=128,
          dec_hidden_size=16, dec_layers=1, dec_proj_size=12,
          joint_size=16, enc_time_reductions=())
FKW = dict(feature_type='logfbank', feature_size=3, n_fft=64, win_length=40,
           hop_length=20, downsample=3, pad_to_divisible=False)


class _Tok:
    """One distinct character per id: equal text ⇔ equal tokens (>UNK)."""
    unk_id = UNK

    def id_to_token(self, i):
        return chr(0x100 + int(i))


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package's int8 Pallas kernels in interpret mode."""
    monkeypatch.setenv('EDGEDICT_QUANT_KERNELS', 'force')
    with JR.shard_local_context():
        yield


def _weights(rng, n, k):
    """(n, k) weights over several orders of magnitude per row, an
    all-zero row, and a row of exact .5 quotients (round half to even)."""
    w = rng.randn(n, k).astype(np.float32) * np.exp(rng.randn(n, 1)
                                                    ).astype(np.float32)
    w[1] = 0.0
    # absmax 15.875 = 127 / 8: scale 1/8 exactly, w / scale = ±0.5, 1.5, 2.5
    w[2] = np.resize([0.0625, -0.1875, 0.3125, -0.0625], k)
    w[2, 0] = 15.875
    return w


@pytest.mark.parametrize('n,k', [(48, 64), (384, 9), (7, 130)])
def test_quantize_int8_equals_jax_exactly(n, k):
    """q identical to JAX's (round half to even in both), scale within one
    ulp (both absmax / 127 in fp32), scale 1 for an all-zero channel."""
    w = _weights(np.random.RandomState(n + k), n, k)
    qj, sj = JQ.quantize_int8(jnp.asarray(w.T))
    qp, sp = Q.quantize_int8(torch.from_numpy(w))
    assert qp.dtype == torch.int8 and sp.dtype == torch.float32
    np.testing.assert_array_equal(qp.numpy().T, np.asarray(qj))
    np.testing.assert_array_max_ulp(sp.numpy(), np.asarray(sj)[0], 1)
    assert sp[1] == 1.0 and not qp[1].any()


def _pair(module_type, seed):
    cfg_kw = dict(KW, module_type=module_type)
    jcfg, pcfg = JT.TransducerConfig(**cfg_kw), PT.TransducerConfig(**cfg_kw)
    params = JT.transducer_init(jax.random.PRNGKey(seed), jcfg)
    # push the blank column down so random audio decodes non-empty text,
    # and widen the logits so greedy decisions sit far from near-ties
    params['joint']['out']['b'] = params['joint']['out']['b'].at[0].add(-1.0)
    params['joint']['out']['w'] = params['joint']['out']['w'] * 8.0
    params = jax.tree.map(np.asarray, params)
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), pcfg, 'cpu')
    return jcfg, pcfg, jax.tree.map(jnp.asarray, params), model


@pytest.mark.parametrize('module_type', ['LSTM', 'GRU'])
def test_quantize_encoder_equals_jax(module_type):
    """The port quantizes JAX params handed over by state_dict_from_jax_
    params itself: w_ih_q, w_hh_q and the projection's w_q equal JAX's
    quantize_encoder output exactly (JAX's zero-padded rows ignored,
    layouts transposed), scales within one ulp; the float W_ih, W_hh and
    projection weight are gone."""
    jcfg, _, params, model = _pair(module_type, 1)
    jenc = j_prepare(params, quantize='int8')['encoder']
    penc = PS.prepare_inference_params(model, quantize='int8').encoder
    assert isinstance(penc, Q.QuantEncoder)
    names = {n for n, _ in penc.named_parameters()} | \
        {n for n, _ in penc.named_buffers()}
    assert not any(n.endswith(('weight_ih_l0', 'weight_hh_l0', 'proj.weight'))
                   for n in names)
    for jl, pl in zip(jenc['layers'], penc.lstm.lstms):
        jr = jl['rnn']
        for name in ('w_ih', 'w_hh'):
            q = getattr(pl, name + '_q').numpy().T
            np.testing.assert_array_equal(
                q, np.asarray(jr[name + '_q'])[:q.shape[0]])
            np.testing.assert_array_max_ulp(
                getattr(pl, name + '_scale').numpy(),
                np.asarray(jr[name + '_scale'])[0], 1)
        assert not np.asarray(jr['w_ih_q'])[pl.w_ih_q.shape[1]:].any()
    q = penc.proj.w_q.numpy().T
    np.testing.assert_array_equal(q, np.asarray(jenc['proj']['w_q'])
                                  [:q.shape[0]])
    np.testing.assert_array_max_ulp(penc.proj.scale.numpy(),
                                    np.asarray(jenc['proj']['scale'])[0], 1)


@pytest.mark.parametrize('k,n,r', [(240, 512, 5), (128, 384, 2), (9, 128, 7)])
def test_quant_linear_matches_jax_kernel(jax_kernels, k, n, r):
    """quant_matmul (K11's plain version) and quant_linear == JAX's
    _quant_matmul kernel (interpret mode), layer-0's short K included."""
    rng = np.random.RandomState(k + n)
    w = rng.randn(n, k).astype(np.float32)
    x = rng.randn(r, k).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    qj, sj = JQ.quantize_int8(jnp.asarray(w.T))
    want = JQ._quant_matmul(jnp.asarray(x), JQ._pad_rows_to(qj, 32), sj,
                            jnp.asarray(bias)[None])
    qp, sp = Q.quantize_int8(torch.from_numpy(w))
    got = Q.quant_matmul(torch.from_numpy(x), qp, sp, torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    lin = Q.QuantLinear(type('L', (), {'weight': torch.from_numpy(w),
                                       'bias': torch.from_numpy(bias)}))
    got = Q.quant_linear(lin, torch.from_numpy(x.reshape(1, r, k)))
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want), RTOL, ATOL)


def _layer(module_type, seed, n_in=24, hid=128):
    """A quantized layer of each package from the same fp32 weights."""
    rng = np.random.RandomState(seed)
    g = 4 if module_type == 'LSTM' else 3
    kk = 1.0 / np.sqrt(hid)
    p = {'w_ih': rng.uniform(-kk, kk, (g * hid, n_in)),
         'w_hh': rng.uniform(-kk, kk, (g * hid, hid)),
         'b_ih': rng.uniform(-kk, kk, g * hid) + 0.2,
         'b_hh': rng.uniform(-kk, kk, g * hid) - 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    enc = {'norm': {'scale': jnp.ones(n_in), 'bias': jnp.zeros(n_in)},
           'layers': [{'rnn': {k: jnp.asarray(v) for k, v in p.items()},
                       'ln': {'scale': jnp.ones(hid),
                              'bias': jnp.zeros(hid)}}],
           'proj': {'w': jnp.eye(hid), 'b': jnp.zeros(hid)}}
    jq = JQ.quantize_encoder(enc)['layers'][0]['rnn']
    holder = type('R', (), {'weight_ih_l0': torch.from_numpy(p['w_ih']),
                            'weight_hh_l0': torch.from_numpy(p['w_hh']),
                            'bias_ih_l0': torch.from_numpy(p['b_ih']),
                            'bias_hh_l0': torch.from_numpy(p['b_hh'])})
    return jq, Q.QuantRNN(holder).layer(0), rng


@pytest.mark.parametrize('t,b', [(2, 1), (5, 3)])
def test_lstm_layer_tm_q_matches_jax_kernel(jax_kernels, t, b):
    """lstm_layer_tm_q (K11 + K12 plain versions) == JAX's int8 LSTM layer
    through its kernels (interpret mode), state included."""
    jq, pq, rng = _layer('LSTM', 10 + t)
    xs = rng.randn(t, b, 24).astype(np.float32)
    h0 = rng.randn(b, 128).astype(np.float32) * 0.5
    c0 = rng.randn(b, 128).astype(np.float32) * 0.5
    ys_j, (h_j, c_j) = JQ.lstm_layer_tm_q(
        jq, jnp.asarray(xs), (jnp.asarray(h0), jnp.asarray(c0)))
    ys_p, (h_p, c_p) = Q.lstm_layer_tm_q(
        pq, torch.from_numpy(xs), (torch.from_numpy(h0),
                                   torch.from_numpy(c0)))
    for a, r in ((ys_p, ys_j), (h_p, h_j), (c_p, c_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), RTOL, ATOL)


@pytest.mark.parametrize('t,b', [(2, 1), (5, 3)])
def test_gru_layer_tm_q_matches_jax_kernel(jax_kernels, t, b):
    """gru_layer_tm_q (K11 + K13 plain versions) == JAX's int8 GRU layer
    through its kernels (interpret mode)."""
    jq, pq, rng = _layer('GRU', 20 + t)
    xs = rng.randn(t, b, 24).astype(np.float32)
    h0 = rng.randn(b, 128).astype(np.float32) * 0.5
    ys_j, h_j = JQ.gru_layer_tm_q(jq, jnp.asarray(xs), jnp.asarray(h0))
    ys_p, h_p = Q.gru_layer_tm_q(pq, torch.from_numpy(xs),
                                 torch.from_numpy(h0))
    for a, r in ((ys_p, ys_j), (h_p, h_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), RTOL, ATOL)


@pytest.mark.parametrize('module_type', ['LSTM', 'GRU'])
def test_bf16_recurrence_dequantizes_to_the_compute_dtype(module_type):
    """K12/K13 round q * scale to the compute dtype BEFORE the product (the
    TPU kernels' VMEM copy of W_hh), which in bf16 differs from applying
    the scale after the accumulation."""
    rng = np.random.RandomState(2)
    hid, b = 64, 4
    g = 4 if module_type == 'LSTM' else 3
    w = torch.from_numpy(rng.uniform(-0.3, 0.3, (g * hid, hid))
                         .astype(np.float32))
    q, s = Q.quantize_int8(w)
    xp = torch.from_numpy(rng.randn(1, b, g * hid).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(b, hid).astype(np.float32))
    x16 = xp.to(torch.bfloat16)
    w16 = (q.float() * s[:, None]).to(torch.bfloat16)
    if module_type == 'LSTM':
        got = Q.lstm_recurrence_q(x16, q, s, h0, h0 * 0.5)[1]
        want = lstm_recurrence(x16, w16, h0, h0 * 0.5)[1]
    else:
        bh = torch.zeros(g * hid)
        got = Q.gru_recurrence_q(x16, q, s, bh, h0)
        want = gru_recurrence(x16, w16, bh, h0)[0]
    assert torch.equal(got, want)


def test_quantized_values_independent_of_serving_dtype():
    """q and scale come from the pre-cast fp32 weights: a bf16 and an fp32
    int8 decoder carry identical int8 values and fp32 scales; the
    pass-through tensors (biases, LayerNorms) follow the serving dtype
    (tests/test_quant.py:280)."""
    _, _, _, model = _pair('LSTM', 2)
    p32 = PS.prepare_inference_params(model, None, 'int8').encoder
    p16 = PS.prepare_inference_params(model, torch.bfloat16, 'int8').encoder
    b32, b16 = dict(p32.named_buffers()), dict(p16.named_buffers())
    assert set(b32) == set(b16)
    quantized = [k for k in b32 if k.endswith(('_q', 'scale'))]
    assert len(quantized) == 2 * 4 + 2
    for k in quantized:
        assert torch.equal(b32[k], b16[k]), k
        if k.endswith('scale'):
            assert b16[k].dtype == torch.float32
    assert b16['lstm.lstms.0.b_ih'].dtype == torch.bfloat16
    assert b16['proj.bias'].dtype == torch.bfloat16
    assert p16.norm.weight.dtype == torch.bfloat16
    # the int8 encoder holds a quarter of the fp32 encoder's weight bytes
    fp32 = Q.module_bytes(model.encoder)
    assert Q.module_bytes(p32) < 0.27 * fp32


def test_unknown_quantize_mode_raises():
    _, pcfg, _, model = _pair('LSTM', 3)
    with pytest.raises(ValueError, match='int8'):
        PS.prepare_inference_params(model, quantize='int4')
    with pytest.raises(ValueError):
        PS.StreamingDecoder(model, pcfg, PFeat(**FKW), _Tok(), device='cpu',
                            quantize='fp8')


@pytest.mark.parametrize('module_type', ['LSTM', 'GRU'])
def test_int8_streaming_decoder_tokens_equal_jax(jax_kernels, module_type):
    """int8 StreamingDecoder tokens == JAX's StreamingDecoder(quantize=
    'int8') through its kernels (interpret mode), token for token, for an
    LSTM and a GRU encoder; block mode gives the same tokens."""
    jcfg, pcfg, params, model = _pair(module_type, 4)
    audio = (np.random.RandomState(1).randn(1400) * 0.5).astype(np.float32)
    ref = JStreamingDecoder(params, jcfg, JFeat(**FKW), _Tok(),
                            step_n_frame=2, quantize='int8')
    ref_text = ref.decode_wav(audio)
    dec = PS.StreamingDecoder(model, pcfg, PFeat(**FKW), _Tok(),
                              device='cpu', step_n_frame=2, quantize='int8')
    text = dec.decode_wav(audio)
    assert len(text) > 3
    assert text == ref_text
    block = PS.StreamingDecoder(model, pcfg, PFeat(**FKW), _Tok(),
                                device='cpu', step_n_frame=2,
                                quantize='int8', block_chunks=3)
    assert block.decode_wav(audio) == text


def test_int8_multistream_equals_single_stream():
    """MultiStreamDecoder(quantize='int8') over a GRU encoder: each
    stream's text equals the single-stream int8 decode of its audio."""
    _, pcfg, _, model = _pair('GRU', 5)
    feat = PFeat(**FKW)
    ms = PS.MultiStreamDecoder(model, pcfg, feat, _Tok(), 2, device='cpu',
                               quantize='int8')
    audios = [(np.random.RandomState(7 + i).randn(900) * 0.5)
              .astype(np.float32) for i in range(2)]
    chunks = [PS._chunks(a, ms.win_size, ms.hop_size) for a in audios]
    texts = ['', '']
    for r in range(len(chunks[0])):
        out = ms.decode(np.stack([c[r] for c in chunks]))
        texts = [t + o for t, o in zip(texts, out)]
    single = PS.StreamingDecoder(model, pcfg, feat, _Tok(), device='cpu',
                                 quantize='int8')
    assert texts == [single.decode_wav(a) for a in audios]
