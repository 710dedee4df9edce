"""The port at the bundled E6D2_LARGE_Batch preset's prediction net and
joint (2 x 512 LSTM, projection 640, J 640, V 2048, embedding 64, hop 320)
against the JAX package, behind an encoder narrowed to 2 x 64 so that it
runs in seconds on the CPU; and at the flags' own defaults (no flagfile:
MFCC of 80 over 128 mels, n_fft 400, hop 200, a 4 x 600 LSTM encoder, 2 x
150 prediction net, joint 512, a character vocabulary), at full width.
The same numpy-seeded weights go to both through
compat.state_dict_from_jax_params.  The streaming decoder (StreamingDecoder,
as cli.stream builds it: step_n_frame 2) and the offline greedy decode
(models/decoding.py, the trainers' eval) give the JAX package's tokens
exactly, and the final stream state within rtol 1e-4 / atol 1e-5; every
greedy decision's top-2 logit gap is asserted over 1e-3, so a flip would
be a fault, not a near-tie.  At the defaults one fp32 train step's loss
(rtol 1e-5) and gradients (rtol 1e-3 / atol 1e-4) equal the JAX
package's, features included."""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.features import FeatureConfig as JFeat
from edgedict_tpu.features import FeaturePipeline as JPipeline
from edgedict_tpu.models import decoding as JD
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.stream import StreamingDecoder as JStreamingDecoder
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import config as C
from edgedict_tpu_torch import stream as PS
from edgedict_tpu_torch.features import FeaturePipeline as PPipeline
from edgedict_tpu_torch.models import decoding as PD
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops import decode_kernel as K3
from edgedict_tpu_torch.tokenizer import CharTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5          # states
UNK = 3


def _preset(name, vocab=2048, **narrow):
    """The port's (TransducerConfig, FeatureConfig) of a bundled flagfile
    (name None: the flags' defaults) at `vocab` ids (no dither), with
    `narrow`'s fields replaced."""
    argv = [f'--flagfile={REPO}/flagfiles/{name}'] if name else []
    flags = C.parse_flags(C.add_model_flags(argparse.ArgumentParser()),
                          argv)
    feat = dataclasses.replace(
        C.feature_config_from_flags(flags, pad_to_divisible=False),
        dither=0.0)
    cfg = C.transducer_config_from_flags(flags, vocab, feat.input_size)
    return dataclasses.replace(cfg, **narrow), feat


PCFG, PFEAT = _preset('E6D2_LARGE_Batch.txt', enc_hidden_size=64,
                      enc_layers=2)
JCFG = JT.TransducerConfig(**dataclasses.asdict(PCFG))
JFEAT = JFeat(**dataclasses.asdict(PFEAT))

# the flags' defaults at full width, the character vocabulary of texts over
# a-z and the space (4 specials + 27 characters)
CHAR_TEXTS = ['the quick brown fox', 'jumps over a lazy dog',
              'pack my box with five dozen liquor jugs']


def _char_tokenizer(tmp):
    tok = CharTokenizer(str(tmp))
    tok.build(CHAR_TEXTS)
    return tok


DCFG, DFEAT = _preset(None, vocab=31)
JDCFG = JT.TransducerConfig(**dataclasses.asdict(DCFG))
JDFEAT = JFeat(**dataclasses.asdict(DFEAT))


class _Tok:
    """One distinct character per id: equal text ⇔ equal tokens (>UNK)."""
    unk_id = UNK

    def id_to_token(self, i):
        return chr(0x4E00 + int(i))


def _pair(jcfg, pcfg):
    """(JAX params, port model): every weight uniform in ±1/sqrt(fan-in)
    from numpy seed 0 (the JAX init's tree for the shapes); the joint's
    output widened 8x and blank pushed down by 2 so random audio decodes
    non-empty text far from near-ties."""
    rng = np.random.RandomState(0)
    shapes = JT.transducer_init(jax.random.PRNGKey(0), jcfg)

    def draw(x):
        k = x.shape[-1] ** -0.5 if x.ndim > 1 else 0.1
        return rng.uniform(-k, k, x.shape).astype(np.float32)
    params = jax.tree.map(draw, shapes)
    params['joint']['out']['w'] = params['joint']['out']['w'] * 8.0
    params['joint']['out']['b'][0] -= 2.0
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), pcfg, 'cpu')
    return jax.tree.map(jnp.asarray, params), model


@pytest.fixture(scope='module')
def pair():
    return _pair(JCFG, PCFG)


@pytest.fixture(scope='module')
def defaults_pair():
    return _pair(JDCFG, DCFG)


def _audio(seed, seconds=2.0):
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    return synthetic_audio(seed, seconds)


def _min_gap(dec, audio, cfg=PCFG):
    """Smallest top-2 logit gap over every greedy decision of a streamed
    decode (the <unk>-masked gap where <unk> wins), replayed chunk by
    chunk on the port's plain frame loop."""
    cache, state, gaps = dec.model.decode_cache, dec._fresh, []
    for chunk in PS._chunks(audio, dec.win_size, dec.hop_size):
        x = torch.from_numpy(chunk[None].astype(np.float32))
        with torch.no_grad():
            xs, _ = dec.pipeline(x, torch.tensor([x.shape[1]]))
            enc, _ = PT.encoder_apply(dec.model.encoder, cfg, xs,
                                      state.enc_state)
            f = (enc @ dec.model.joint.w_enc.t()).transpose(0, 1)
            h_dec, (hs, cs) = state.h_dec, state.dec_state
            for t in range(f.shape[0]):
                logits = torch.tanh(f[t] + h_dec @ cache['w_dec_t']
                                    + cache['b_joint']) @ cache['w_out_t'] \
                    + cache['b_out']
                top = torch.topk(logits, 3, dim=-1).values[0]
                gaps.append(float(top[0] - top[1]))
                if int(logits.argmax()) == UNK:
                    gaps.append(float(top[1] - top[2]))
                _, _, h_dec, hs, cs = K3.greedy_frame_loop_plain(
                    cache, f[t:t + 1], h_dec, hs, cs, 0, UNK)
        _, state = dec.chunk_step(state, x)
    return min(gaps)


def test_preset_widths():
    assert (PCFG.dec_layers, PCFG.dec_hidden_size, PCFG.dec_proj_size,
            PCFG.joint_size, PCFG.vocab_size, PCFG.vocab_embed_size) == \
        (2, 512, 640, 640, 2048, 64)
    assert (PCFG.enc_layers, PCFG.enc_hidden_size, PFEAT.hop_length) == \
        (2, 64, 320)


@pytest.mark.parametrize('seed', [0, 1])
def test_stream_decode_equals_jax(pair, seed):
    """StreamingDecoder.decode_wav of 2 s (120 ms chunks, two encoder
    frames each) == the JAX package's StreamingDecoder, token for token,
    and the final stream state within rtol 1e-4 / atol 1e-5."""
    params, model = pair
    audio = _audio(seed)
    jdec = JStreamingDecoder(params, JCFG, JFEAT, _Tok(), step_n_frame=2)
    ref = jdec.decode_wav(audio)
    dec = PS.StreamingDecoder(model, PCFG, PFEAT, _Tok(), device='cpu',
                              step_n_frame=2)
    assert dec.hop_size == 1920
    out = dec.decode_wav(audio)
    tokens = np.concatenate(dec.emitted)
    assert len(out) >= 4 and (tokens != 0).sum() == len(out)
    assert _min_gap(dec, audio) > 1e-3
    assert out == ref
    jstate = jdec.state
    for a, r in ((dec.state.h_dec, jstate.h_dec),
                 (dec.state.dec_state[0], jstate.dec_state[0]),
                 (dec.state.dec_state[1], jstate.dec_state[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), RTOL, ATOL)
    for a, r in zip(jax.tree.leaves(dec.state.enc_state),
                    jax.tree.leaves(jstate.enc_state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), RTOL, ATOL)


def test_offline_greedy_decode_equals_jax(pair):
    """The eval's greedy decode (models/decoding.py) at the preset's
    prediction net and joint, B = 4 (its --eval_batch_size) of ragged
    lengths: tokens and lengths exact."""
    params, model = pair
    rng = np.random.RandomState(5)
    xs = rng.randn(4, 30, PCFG.input_size).astype(np.float32)
    xlen = np.array([30, 24, 17, 9], np.int32)
    y_j, len_j, _ = JD.transducer_greedy_decode(
        params, JCFG, jnp.asarray(xs), jnp.asarray(xlen))
    with torch.no_grad():
        y_p, len_p, _ = PD.transducer_greedy_decode(
            model, PCFG, torch.from_numpy(xs), torch.from_numpy(xlen))
    np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
    np.testing.assert_array_equal(y_p.numpy(), np.asarray(y_j))
    assert int(np.asarray(len_j).sum()) > 0


def test_defaults_widths(tmp_path):
    """No flagfile: the flags' defaults, 11,746,641 parameters at the
    character vocabulary of 31 (11,751,402 at 40)."""
    assert (DCFG.enc_layers, DCFG.enc_hidden_size, DCFG.enc_proj_size,
            DCFG.dec_layers, DCFG.dec_hidden_size, DCFG.dec_proj_size,
            DCFG.joint_size, DCFG.vocab_embed_size, DCFG.input_size) == \
        (4, 600, 600, 2, 150, 150, 512, 16, 240)
    assert (DFEAT.feature_type, DFEAT.feature_size, DFEAT.mfcc_n_mels,
            DFEAT.n_fft, DFEAT.win_length, DFEAT.hop_length,
            DFEAT.downsample) == ('mfcc', 80, 128, 400, 400, 200, 3)
    assert _char_tokenizer(tmp_path).vocab_size == DCFG.vocab_size == 31
    for v, n in ((31, 11746641), (40, 11751402)):
        model = PT.Transducer(dataclasses.replace(DCFG, vocab_size=v),
                              device='cpu', seed=0)
        assert sum(p.numel() for p in model.parameters()) == n


@pytest.mark.parametrize('seed', [0, 1])
def test_defaults_stream_decode_equals_jax(defaults_pair, tmp_path, seed):
    """The defaults' StreamingDecoder (75 ms chunks of 1,400 samples, two
    encoder frames each) == the JAX package's, token for token, and the
    final stream state within rtol 1e-4 / atol 1e-5."""
    params, model = defaults_pair
    tok = _char_tokenizer(tmp_path)
    audio = _audio(seed)
    jdec = JStreamingDecoder(params, JDCFG, JDFEAT, tok, step_n_frame=2)
    ref = jdec.decode_wav(audio)
    dec = PS.StreamingDecoder(model, DCFG, DFEAT, tok, device='cpu',
                              step_n_frame=2)
    assert (dec.win_size, dec.hop_size) == (1400, 1200)
    out = dec.decode_wav(audio)
    tokens = np.concatenate(dec.emitted)
    assert (tokens != 0).sum() >= 4
    assert _min_gap(dec, audio, DCFG) > 1e-3
    assert out == ref
    jstate = jdec.state
    for a, r in ((dec.state.h_dec, jstate.h_dec),
                 (dec.state.dec_state[0], jstate.dec_state[0]),
                 (dec.state.dec_state[1], jstate.dec_state[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), RTOL, ATOL)
    for a, r in zip(jax.tree.leaves(dec.state.enc_state),
                    jax.tree.leaves(jstate.enc_state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), RTOL, ATOL)


def _defaults_batch(tmp_path):
    """Two utterances (1.6 s and 1.1 s) with their character labels → the
    host batch."""
    tok = _char_tokenizer(tmp_path)
    audio = np.zeros((2, 25600), np.float32)
    audio[0] = _audio(7, 1.6)
    audio[1, :17600] = _audio(8, 1.1)
    ys = [tok.encode(t) for t in CHAR_TEXTS[:2]]
    u = max(len(y) for y in ys)
    return {'audio': audio, 'alen': np.array([25600, 17600], np.int32),
            'ys': np.array([y + [0] * (u - len(y)) for y in ys], np.int32),
            'ylen': np.array([len(y) for y in ys], np.int32)}


def test_defaults_offline_greedy_decode_equals_jax(defaults_pair, tmp_path):
    """The eval's greedy decode (models/decoding.py) at the defaults, B = 4
    (the default --eval_batch_size) of ragged lengths, on the features of
    both packages' pipelines: features to the featurizer tests' bound,
    tokens and lengths exact."""
    params, model = defaults_pair
    cfg = dataclasses.replace(DFEAT, pad_to_divisible=True)
    audio = np.stack([_audio(20 + i, 1.5) for i in range(4)])
    alen = np.array([24000, 20000, 13000, 6000], np.int32)
    for i, n in enumerate(alen):
        audio[i, n:] = 0.0
    jx, jlen = JPipeline(JFeat(**dataclasses.asdict(cfg)))(
        jnp.asarray(audio), jnp.asarray(alen))
    px, plen = PPipeline(cfg, 'cpu')(torch.from_numpy(audio),
                                     torch.from_numpy(alen))
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), 1e-3, 5e-3)
    y_j, len_j, _ = JD.transducer_greedy_decode(params, JDCFG, jx, jlen)
    with torch.no_grad():
        y_p, len_p, _ = PD.transducer_greedy_decode(
            model, DCFG, torch.from_numpy(np.array(jx)), plen)
    np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
    np.testing.assert_array_equal(y_p.numpy(), np.asarray(y_j))
    assert int(np.asarray(len_j).sum()) > 0


def test_defaults_train_step_loss_and_grads_equal_jax(defaults_pair,
                                                      tmp_path):
    """One fp32 train step's loss and gradients at the defaults, from the
    raw audio (the trainer's pipeline, dither and SpecAugment off) through
    the 4 x 600 encoder, the prediction net and the fused joint loss: loss
    rtol 1e-5, every gradient rtol 1e-3 / atol 1e-4, against
    jax.value_and_grad of the JAX package's transducer_loss."""
    params, model = defaults_pair
    batch = _defaults_batch(tmp_path)
    cfg = dataclasses.replace(DFEAT, pad_to_divisible=True)
    jpipe = JPipeline(JFeat(**dataclasses.asdict(cfg)))

    def jloss(p):
        xs, xlen = jpipe(jnp.asarray(batch['audio']),
                         jnp.asarray(batch['alen']))
        return JT.transducer_loss(p, JDCFG, xs, jnp.asarray(batch['ys']),
                                  xlen, jnp.asarray(batch['ylen']))
    want, jgrads = jax.value_and_grad(jloss)(params)
    xs, xlen = PPipeline(cfg, 'cpu')(torch.from_numpy(batch['audio']),
                                     torch.from_numpy(batch['alen']))
    model.zero_grad()
    loss = PT.transducer_loss(model, DCFG, xs,
                              torch.from_numpy(batch['ys']).long(), xlen,
                              torch.from_numpy(batch['ylen']))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), 1e-5)
    grads = PC.state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), 1e-3,
                                   1e-4, err_msg=k)
