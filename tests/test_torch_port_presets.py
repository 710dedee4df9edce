"""The port at the bundled E6D2_LARGE_Batch preset's prediction net and
joint (2 x 512 LSTM, projection 640, J 640, V 2048, embedding 64, hop 320)
against the JAX package, behind an encoder narrowed to 2 x 64 so that it
runs in seconds on the CPU: the same numpy-seeded weights go to both
through compat.state_dict_from_jax_params.  The streaming decoder
(StreamingDecoder, as cli.stream builds it: step_n_frame 2) and the offline
greedy decode (models/decoding.py, the trainers' eval) give the JAX
package's tokens exactly, and the final stream state within rtol 1e-4 /
atol 1e-5; every greedy decision's top-2 logit gap is asserted over 1e-3,
so a flip would be a fault, not a near-tie."""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.features import FeatureConfig as JFeat
from edgedict_tpu.models import decoding as JD
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.stream import StreamingDecoder as JStreamingDecoder
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import config as C
from edgedict_tpu_torch import stream as PS
from edgedict_tpu_torch.models import decoding as PD
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops import decode_kernel as K3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5          # states
UNK = 3


def _preset(name, **narrow):
    """The port's (TransducerConfig, FeatureConfig) of a bundled flagfile
    (BPE 2048, no dither), with `narrow`'s fields replaced."""
    flags = C.parse_flags(C.add_model_flags(argparse.ArgumentParser()),
                          [f'--flagfile={REPO}/flagfiles/{name}'])
    feat = dataclasses.replace(
        C.feature_config_from_flags(flags, pad_to_divisible=False),
        dither=0.0)
    cfg = C.transducer_config_from_flags(flags, 2048, feat.input_size)
    return dataclasses.replace(cfg, **narrow), feat


PCFG, PFEAT = _preset('E6D2_LARGE_Batch.txt', enc_hidden_size=64,
                      enc_layers=2)
JCFG = JT.TransducerConfig(**dataclasses.asdict(PCFG))
JFEAT = JFeat(**dataclasses.asdict(PFEAT))


class _Tok:
    """One distinct character per id: equal text ⇔ equal tokens (>UNK)."""
    unk_id = UNK

    def id_to_token(self, i):
        return chr(0x4E00 + int(i))


@pytest.fixture(scope='module')
def pair():
    """(JAX params, port model): every weight uniform in ±1/sqrt(fan-in)
    from numpy seed 0 (the JAX init's tree for the shapes); the joint's
    output widened 8x and blank pushed down by 2 so random audio decodes
    non-empty text far from near-ties."""
    rng = np.random.RandomState(0)
    shapes = JT.transducer_init(jax.random.PRNGKey(0), JCFG)

    def draw(x):
        k = x.shape[-1] ** -0.5 if x.ndim > 1 else 0.1
        return rng.uniform(-k, k, x.shape).astype(np.float32)
    params = jax.tree.map(draw, shapes)
    params['joint']['out']['w'] = params['joint']['out']['w'] * 8.0
    params['joint']['out']['b'][0] -= 2.0
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), PCFG, 'cpu')
    return jax.tree.map(jnp.asarray, params), model


def _audio(seed, seconds=2.0):
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    return synthetic_audio(seed, seconds)


def _min_gap(dec, audio):
    """Smallest top-2 logit gap over every greedy decision of a streamed
    decode (the <unk>-masked gap where <unk> wins), replayed chunk by
    chunk on the port's plain frame loop."""
    cache, state, gaps = dec.model.decode_cache, dec._fresh, []
    for chunk in PS._chunks(audio, dec.win_size, dec.hop_size):
        x = torch.from_numpy(chunk[None].astype(np.float32))
        with torch.no_grad():
            xs, _ = dec.pipeline(x, torch.tensor([x.shape[1]]))
            enc, _ = PT.encoder_apply(dec.model.encoder, PCFG, xs,
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
