"""The port's beam search with LM shallow fusion
(edgedict_tpu_torch/models/beam_search.py and the beam decoders of
edgedict_tpu_torch/stream.py) against the JAX package's on the same seeded
weights: top-k tie order, the prefix merge, the offline search over beam
widths, expansion budgets, merging, xlen, the token cap and fusion, the
streaming decoder, plus the port's own multi-stream, reset, int16, server
and bf16 contracts (the patterns of tests/test_stream.py and
tests/test_serving.py).  Tokens are held exactly, the best log-prob
within rtol 1e-5."""

import asyncio
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.features import FeatureConfig as JFeat
from edgedict_tpu.models import beam_search as JB
from edgedict_tpu.models import lm as JL
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.serving import stream_client
from edgedict_tpu.stream import StreamingBeamDecoder as JStreamingBeamDecoder
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import stream as PS
from edgedict_tpu_torch.cli.serve import build_server
from edgedict_tpu_torch.features import FeatureConfig as PFeat
from edgedict_tpu_torch.models import beam_search as PB
from edgedict_tpu_torch.models import lm as PL
from edgedict_tpu_torch.models import transducer as PT

NEG = PB.NEG
# the offline search: toy widths as tests/test_beam_search.py
OKW = dict(vocab_size=12, vocab_embed_size=8, input_size=10,
           enc_hidden_size=16, enc_layers=2, enc_proj_size=12,
           dec_hidden_size=16, dec_layers=1, dec_proj_size=12,
           joint_size=16, enc_time_reductions=(1,))
# the streaming decoders: tests/test_torch_port_stream.py's widths
SKW = dict(vocab_size=40, vocab_embed_size=8, input_size=24,
           enc_hidden_size=32, enc_layers=2, enc_proj_size=24,
           dec_hidden_size=16, dec_layers=2, dec_proj_size=16,
           joint_size=24, enc_time_reductions=(1,))
FKW = dict(feature_type='logfbank', feature_size=8, n_fft=64, win_length=40,
           hop_length=20, downsample=3, pad_to_divisible=False)
PFEAT = PFeat(**FKW)


def _emitting(params, enc_scale=1.0):
    """Random weights spread so that label paths win over the all-blank
    one: a wide output layer, a prediction net that moves the joint."""
    params = jax.tree.map(np.array, params)
    params['joint']['out']['w'] *= 16.0
    params['joint']['w_dec'] *= 6.0
    params['decoder']['embed']['table'] *= 4.0
    params['encoder']['proj']['w'] *= enc_scale
    params['encoder']['proj']['b'] *= enc_scale
    return params


def _pair(kw, seed, enc_scale=1.0):
    jcfg, pcfg = JT.TransducerConfig(**kw), PT.TransducerConfig(**kw)
    params = _emitting(JT.transducer_init(jax.random.PRNGKey(seed), jcfg),
                       enc_scale)
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), pcfg, 'cpu')
    return jax.tree.map(jnp.asarray, params), jcfg, model, pcfg


def _lm_pair(vocab, seed, weight, out_scale=1.0):
    """(JAX lm triple, port lm triple) on the same seeded weights;
    out_scale > 1 makes the LM peaky."""
    kw = dict(vocab_size=vocab, embed_size=8, hidden_size=16, num_layers=2)
    jcfg, pcfg = JL.LMConfig(**kw), PL.LMConfig(**kw)
    jparams = jax.tree.map(np.array, JL.lm_init(jax.random.PRNGKey(seed),
                                                jcfg))
    jparams['out']['w'] *= out_scale
    model = PL.LMModel(pcfg, 'cpu')
    model.load_state_dict(PC.lm_state_dict_from_jax_params(jparams))
    return ((jax.tree.map(jnp.asarray, jparams), jcfg, weight),
            (model, pcfg, weight))


@pytest.fixture(scope='module')
def offline():
    return _pair(OKW, 0), _lm_pair(12, 3, 0.5)


@pytest.fixture(scope='module')
def streaming():
    # a peaky LM at a small weight: it changes the streamed texts and
    # leaves them non-empty
    return _pair(SKW, 1, enc_scale=3.0), _lm_pair(40, 5, 0.02, 8.0)


class _Tok:
    """One distinct character per id: equal text ⇔ equal tokens (> UNK)."""
    unk_id = 3

    def id_to_token(self, i):
        return chr(0x100 + int(i))


def _audio(seed, n=4000):
    return (np.random.RandomState(seed).randn(n) * 0.3).astype(np.float32)


# ---------------------------------------------------------------------------
# the fixed-shape search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('row,k', [
    ([1, 3, 3, 0, 3, NEG, NEG, NEG], 5),
    ([NEG] * 5 + [0.0] + [NEG] * 8186, 4),
    ([NEG] * 16, 16),
])
def test_top_k_breaks_ties_lowest_index_first(row, k):
    x = np.asarray([row, row[::-1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    pv, pi = PB.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_merge_duplicate_prefixes_matches_jax():
    """Duplicates (summed into the lowest index), distinct prefixes of one
    length, a prefix of another length and dead entries (never merged)."""
    tokens = np.zeros((2, 6, 5), np.int32)
    tokens[0, :, :3] = [[4, 5, 6], [4, 5, 6], [4, 5, 7], [4, 5, 6],
                        [4, 5, 6], [4, 5, 9]]
    n_tok = np.asarray([[3, 3, 3, 2, 3, 3], [0, 0, 1, 0, 1, 1]], np.int32)
    tokens[1, :, 0] = [8, 9, 4, 4, 4, 5]
    logp = np.asarray([[-3.0, -2.5, -1.0, -4.0, NEG, -7.0],
                       [-1.5, -0.5, -2.0, NEG, -2.25, -6.0]], np.float32)
    dec_out = np.random.RandomState(0).randn(2, 6, 3).astype(np.float32)
    dstate = np.random.RandomState(1).randn(1, 2, 6, 4).astype(np.float32)
    jbeam = JB.BeamState(jnp.asarray(tokens), jnp.asarray(n_tok),
                         jnp.asarray(logp), jnp.asarray(dec_out),
                         (jnp.asarray(dstate),) * 2, None, None)
    pbeam = PB.BeamState(torch.from_numpy(tokens), torch.from_numpy(n_tok),
                         torch.from_numpy(logp), torch.from_numpy(dec_out),
                         (torch.from_numpy(dstate),) * 2, None, None)
    want = np.asarray(JB.merge_duplicate_prefixes(jbeam).logp)
    got = PB.merge_duplicate_prefixes(pbeam).logp.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the merged classes: {0, 1, 4-dead} and {1: 0, 3} etc.
    assert got[0, 0] == pytest.approx(np.logaddexp(-3.0, -2.5), abs=1e-6)
    assert (got[0, [1, 4]] == NEG).all() and got[0, 2] == -1.0
    assert got[1, 0] == pytest.approx(np.logaddexp(-1.5, -0.5), abs=1e-6)
    assert got[1, 1] == NEG and got[1, 3] == NEG
    assert got[1, 2] == pytest.approx(np.logaddexp(-2.0, -2.25), abs=1e-6)


def _search_both(offline, h, xlen, lm, **kw):
    (jparams, jcfg, model, pcfg), (jlm, plm) = offline
    jt, jn, jp = JB.beam_search_from_encoder(
        jparams, jcfg, jnp.asarray(h),
        None if xlen is None else jnp.asarray(xlen),
        lm=jlm if lm else None, **kw)
    pt, pn, pp = PB.beam_search_from_encoder(
        model, pcfg, torch.from_numpy(h),
        None if xlen is None else torch.from_numpy(xlen),
        lm=plm if lm else None, **kw)
    return (np.asarray(jt), np.asarray(jn), np.asarray(jp)), \
        (pt.numpy(), pn.numpy(), pp.numpy())


@pytest.mark.parametrize('w,sym,merge,lm,cap', [
    (1, 1, True, False, 200), (1, 3, True, True, 200),
    (3, 1, True, False, 200), (3, 3, False, True, 200),
    (3, 3, True, True, 4), (4, 1, False, False, 200),
    (4, 3, True, False, 200), (4, 3, True, True, 200),
    (4, 3, False, False, 4), (4, 1, True, True, 3),
])
def test_beam_search_from_encoder_matches_jax(offline, w, sym, merge, lm,
                                              cap):
    h = np.random.RandomState(1).randn(2, 9, 12).astype(np.float32) * 6
    xlen = np.asarray([9, 6], np.int32)        # the second stops early
    (jt, jn, jp), (pt, pn, pp) = _search_both(
        offline, h, xlen, lm, beam_width=w, max_sym_per_frame=sym,
        max_tokens=cap, merge_prefixes=merge)
    assert pt.dtype == np.int32 and pt.shape == (2, cap)
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(pp, jp, rtol=1e-5)
    assert jn.max() > 0                        # the search emitted labels
    if cap < 10:
        assert jn.max() == cap                 # and reached the cap


def test_beam_search_xlen_equals_truncated_input(offline):
    h = np.random.RandomState(2).randn(2, 9, 12).astype(np.float32) * 6
    (_, _, model, cfg), _ = offline
    kw = dict(beam_width=4, max_sym_per_frame=2, max_tokens=32)
    toks, n_tok, _ = PB.beam_search_from_encoder(
        model, cfg, torch.from_numpy(h), torch.tensor([9, 5]), **kw)
    toks2, n2, _ = PB.beam_search_from_encoder(
        model, cfg, torch.from_numpy(h[1:, :5]), None, **kw)
    assert int(n_tok[1]) == int(n2[0])
    assert torch.equal(toks[1], toks2[0])


def test_transducer_beam_search_matches_jax(offline):
    """Features → encoder → beam, with the encoder's time reduction
    rescaling xlen."""
    (jparams, jcfg, model, pcfg), (jlm, plm) = offline
    xs = np.random.RandomState(3).randn(2, 14, 10).astype(np.float32) * 3
    xlen = np.asarray([14, 9], np.int32)
    jt, jn, jp = JB.transducer_beam_search(
        jparams, jcfg, jnp.asarray(xs), jnp.asarray(xlen), beam_width=3,
        max_sym_per_frame=2, max_tokens=16, lm=jlm)
    pt, pn, pp = PB.transducer_beam_search(
        model, pcfg, torch.from_numpy(xs), torch.from_numpy(xlen),
        beam_width=3, max_sym_per_frame=2, max_tokens=16, lm=plm)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-5)


# ---------------------------------------------------------------------------
# the streaming decoders
# ---------------------------------------------------------------------------

def _dec(streaming, lm=False, **kw):
    (_, _, model, cfg), (_, plm) = streaming
    return PS.StreamingBeamDecoder(
        model, cfg, PFEAT, _Tok(), device='cpu', step_n_frame=2,
        beam_width=kw.pop('beam_width', 4), lm=plm if lm else None, **kw)


@pytest.mark.parametrize('block_chunks', [1, 2])
@pytest.mark.parametrize('lm', [False, True])
def test_streaming_beam_decoder_matches_jax(streaming, lm, block_chunks):
    (jparams, jcfg, _, _), (jlm, _) = streaming
    audio = _audio(0)
    ref = JStreamingBeamDecoder(
        jparams, jcfg, JFeat(**FKW), _Tok(), step_n_frame=2, beam_width=4,
        lm=jlm if lm else None, block_chunks=block_chunks).decode_wav(audio)
    dec = _dec(streaming, lm, block_chunks=block_chunks)
    out = dec.decode_wav(audio)
    n_chunks = (4000 - 140) // 120 + 1
    assert len(dec.elapsed) == (n_chunks if block_chunks == 1
                                else n_chunks // 2 + n_chunks % 2)
    assert len(out) > 3
    assert out == ref


def test_reset_reuses_the_initial_beam(streaming):
    dec = _dec(streaming, lm=True)
    first = dec.beam
    dec.decode(_audio(1, dec.win_size))
    assert dec.beam is not first
    dec.reset()
    assert dec.beam is first
    assert dec.beam.logp[0, 0] == 0.0 and (dec.beam.logp[0, 1:] == NEG).all()


def _rounds(dec, audios):
    n = min(len(PS._chunks(a, dec.win_size, dec.hop_size)) for a in audios)
    for i in range(n):
        yield np.stack([a[i * dec.hop_size:i * dec.hop_size + dec.win_size]
                        for a in audios])


def _multi(streaming, n, lm=True, **kw):
    (_, _, model, cfg), (_, plm) = streaming
    return PS.MultiStreamBeamDecoder(model, cfg, PFEAT, _Tok(), n,
                                     device='cpu', beam_width=3,
                                     lm=plm if lm else None, **kw)


def test_multistream_beam_equals_single_streams_and_int16(streaming):
    audios = [_audio(10 + i, 3000) for i in range(3)]
    audios16 = [np.round(a.clip(-1, 1) * 32767).astype(np.int16)
                for a in audios]
    expect = [_dec(streaming, lm=True, beam_width=3).decode_wav(
        a.astype(np.float32) / 32768.0) for a in audios16]
    ms = _multi(streaming, 3)
    for frames in _rounds(ms, audios16):
        texts = ms.decode(frames)                    # int16 ingest
    assert texts == expect and any(texts)
    ms.reset()
    for frames in _rounds(ms, audios16):
        texts = ms.decode(frames.astype(np.float32) / 32768.0)
    assert texts == expect


def test_multistream_beam_reset_stream(streaming):
    ms = _multi(streaming, 3)
    audios = [_audio(20 + i, 2000) for i in range(3)]
    for frames in _rounds(ms, audios):
        ms.decode(frames)
    before_enc, before = ms.enc_state, ms.beam
    ms.reset_stream(1)
    fresh = ms.rt.init_beam()
    for new, old, ref in zip((*ms.enc_state, *ms.beam.dec_state,
                              *ms.beam.lm_state),
                             (*before_enc, *before.dec_state,
                              *before.lm_state),
                             (*ms.rt.fresh_enc, *fresh.dec_state,
                              *fresh.lm_state)):
        assert torch.equal(new[:, 1], ref[:, 1])
        assert torch.equal(new[:, 0], old[:, 0])
        assert torch.equal(new[:, 2], old[:, 2])
    for name in ('tokens', 'n_tok', 'logp', 'dec_out', 'lm_next'):
        new, old, ref = (getattr(b, name) for b in (ms.beam, before, fresh))
        assert torch.equal(new[1], ref[1]), name
        assert torch.equal(new[0], old[0]) and torch.equal(new[2], old[2])
    # stream 1 now decodes new audio exactly like a fresh single stream
    new = _audio(30, 2000)
    for frames in _rounds(ms, [audios[0], new, audios[2]]):
        text = ms.decode(frames)[1]
    assert text == _dec(streaming, lm=True, beam_width=3).decode_wav(new)


def test_streamserver_beam_mode(streaming):
    """The port's StreamServer over MultiStreamBeamDecoder, built as
    cli/serve.py builds it: '=' replace messages, each client's final
    transcript equals decode_wav of its audio."""
    audios = [_audio(40, 3200), _audio(41, 2600)]
    expect = [_dec(streaming, lm=True, beam_width=3).decode_wav(a)
              for a in audios]
    server = build_server(_multi(streaming, 2), port=0, round_timeout_ms=0)
    assert server.full_hypothesis
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        started.set()
        loop.run_forever()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    assert started.wait(60)
    results = [None, None]

    def client(i):
        results[i] = stream_client('127.0.0.1', server.port, audios[i],
                                   chunk_samples=700)

    try:
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(120)
        assert not any(c.is_alive() for c in clients)
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(60)
    assert results == expect and all(expect)
    assert server.rounds > 0


def test_bf16_beam_decode_keeps_fp32_scores(streaming):
    """bf16 serving: the encoder and the LM in bf16, the prediction net
    and the joint fp32, the beam's log-probs fp32."""
    dec = _dec(streaming, lm=True, compute_dtype=torch.bfloat16)
    assert dec.model.encoder.lstm.lstms[0].weight_hh_l0.dtype == \
        torch.bfloat16
    assert dec.model.decoder.proj.weight.dtype == torch.float32
    assert dec.rt.lm[0].lstm.weight_hh_l0.dtype == torch.bfloat16
    text = dec.decode_wav(_audio(3, 3000))
    assert isinstance(text, str)
    beam = dec.beam
    assert beam.logp.dtype == torch.float32 and beam.lm_next.dtype == \
        torch.float32
    assert torch.isfinite(beam.logp[0, 0]) and beam.dec_out.dtype == \
        torch.float32


def test_beam_decoders_refuse_mesh_and_a_missing_card(streaming):
    (_, _, model, cfg), _ = streaming
    with pytest.raises(NotImplementedError):
        PS.MultiStreamBeamDecoder(model, cfg, PFEAT, _Tok(), 2, device='cpu',
                                  mesh=object())
    with pytest.raises(NotImplementedError):
        PS.StreamingBeamDecoder(model, cfg, PFEAT, _Tok(), device='cpu',
                                mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PS.StreamingBeamDecoder(model, cfg, PFEAT, _Tok(), device='cuda')
