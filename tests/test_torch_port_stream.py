"""Port streaming runtime (edgedict_tpu_torch/stream.py) == the JAX
streaming decoders on the same weights and audio, plus the port's own
block / multi-stream / reset / server contracts (the patterns of
tests/test_stream.py and tests/test_serving.py)."""

import asyncio
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgedict_tpu.features import FeatureConfig as JFeat
from edgedict_tpu.models import transducer as JT
from edgedict_tpu.serving import stream_client
from edgedict_tpu.stream import StreamingDecoder as JStreamingDecoder
from edgedict_tpu_torch import compat as PC
from edgedict_tpu_torch import stream as PS
from edgedict_tpu_torch.cli.serve import build_server
from edgedict_tpu_torch.features import FeatureConfig as PFeat
from edgedict_tpu_torch.models import transducer as PT
from edgedict_tpu_torch.ops import decode_kernel as K3

UNK = 3
KW = dict(vocab_size=40, vocab_embed_size=8, input_size=24,
          enc_hidden_size=32, enc_layers=2, enc_proj_size=24,
          dec_hidden_size=16, dec_layers=2, dec_proj_size=16,
          joint_size=24, enc_time_reductions=(1,))
FKW = dict(feature_type='logfbank', feature_size=8, n_fft=64, win_length=40,
           hop_length=20, downsample=3, pad_to_divisible=False)
JCFG, PCFG = JT.TransducerConfig(**KW), PT.TransducerConfig(**KW)
PFEAT = PFeat(**FKW)


class _Tok:
    """One distinct character per id: equal text ⇔ equal tokens (>UNK)."""
    unk_id = UNK

    def id_to_token(self, i):
        return chr(0x100 + int(i))


@pytest.fixture(scope='module')
def pair():
    params = JT.transducer_init(jax.random.PRNGKey(0), JCFG)
    # push the blank column down so random audio decodes non-empty text,
    # and widen the logits so greedy decisions sit far from near-ties
    params['joint']['out']['b'] = params['joint']['out']['b'].at[0].add(-1.0)
    params['joint']['out']['w'] = params['joint']['out']['w'] * 8.0
    params = jax.tree.map(np.asarray, params)
    model = PC.transducer_from_state_dict(
        PC.state_dict_from_jax_params(params), PCFG, 'cpu')
    return jax.tree.map(jnp.asarray, params), model


def _audio(seed, n=4000):
    return (np.random.RandomState(seed).randn(n) * 0.3).astype(np.float32)


def _dec(model, **kw):
    return PS.StreamingDecoder(model, PCFG, PFEAT, _Tok(), device='cpu',
                               step_n_frame=2, **kw)


def _min_gap(dec, audio):
    """Smallest top-2 logit gap over every greedy decision of a streamed
    decode (the <unk>-masked gap too), replayed chunk by chunk."""
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
                top = torch.topk(logits, 2, dim=-1).values
                gaps.append(float((top[:, 0] - top[:, 1]).min()))
                if int(logits.argmax()) == UNK:
                    top = torch.topk(logits, 3, dim=-1).values
                    gaps.append(float((top[:, 1] - top[:, 2]).min()))
                _, _, h_dec, hs, cs = K3.greedy_frame_loop_plain(
                    cache, f[t:t + 1], h_dec, hs, cs, 0, UNK)
        _, state = dec.chunk_step(state, x)
    return min(gaps)


def test_decode_wav_equals_jax(pair):
    """Token-exact streaming decode against JAX's StreamingDecoder with
    time reduction, downsample 3 and step_n_frame 2 (one encoder frame per
    chunk, as E6D2)."""
    params, model = pair
    audio = _audio(0)
    ref = JStreamingDecoder(params, JCFG, JFeat(**FKW), _Tok(),
                            step_n_frame=2).decode_wav(audio)
    dec = _dec(model)
    out = dec.decode_wav(audio)
    tokens = np.concatenate(dec.emitted)
    assert len(tokens) == len(dec.elapsed) == (4000 - 140) // 120 + 1
    assert len(out) > 3
    assert _min_gap(dec, audio) > 1e-3
    assert out == ref


def test_block_decode_equals_per_chunk(pair):
    _, model = pair
    audio = _audio(1)
    per_chunk = _dec(model)
    text = per_chunk.decode_wav(audio)
    block = _dec(model, block_chunks=4)
    assert block.decode_wav(audio) == text
    np.testing.assert_array_equal(np.concatenate(block.emitted),
                                  np.concatenate(per_chunk.emitted))
    # the pipelined variant drops a trailing partial block
    n = len(per_chunk.emitted) // 4 * 4
    whole = audio[:(n - 1) * block.hop_size + block.win_size]
    assert block.decode_wav_pipelined(whole) == per_chunk.decode_wav(whole)


def test_reset_step_policy(pair):
    """A periodic reset inside a block fires at the same chunk as in
    per-chunk decode."""
    _, model = pair
    audio = _audio(2)
    a = _dec(model, reset_step=3).decode_wav(audio)
    b = _dec(model, reset_step=3, block_chunks=2).decode_wav(audio)
    assert a == b
    dec = _dec(model, reset_step=2)
    dec.decode(np.zeros(dec.win_size, np.float32))
    dec.decode(np.zeros(dec.win_size, np.float32))
    assert dec._steps == 0 and dec.state is dec._fresh


def _rounds(dec, audios):
    n = min(len(PS._chunks(a, dec.win_size, dec.hop_size)) for a in audios)
    for i in range(n):
        yield np.stack([a[i * dec.hop_size:i * dec.hop_size + dec.win_size]
                        for a in audios])


def test_multistream_equals_single_streams_and_int16(pair):
    _, model = pair
    audios = [_audio(10 + i, 3000) for i in range(3)]
    audios16 = [np.round(a.clip(-1, 1) * 32767).astype(np.int16)
                for a in audios]
    expect = [_dec(model).decode_wav(a.astype(np.float32) / 32768.0)
              for a in audios16]
    ms = PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 3, device='cpu')
    texts = [''] * 3
    for frames in _rounds(ms, audios16):
        for s, t in enumerate(ms.decode(frames)):            # int16 ingest
            texts[s] += t
    assert texts == expect
    ms.reset()
    piped = [''] * 3
    for frames in _rounds(ms, audios16):
        out = ms.decode_pipelined(frames.astype(np.float32) / 32768.0)
        for s, t in enumerate(out or [''] * 3):
            piped[s] += t
    for s, t in enumerate(ms.flush()):
        piped[s] += t
    assert piped == expect


def test_reset_stream(pair):
    _, model = pair
    ms = PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 3, device='cpu')
    audios = [_audio(20 + i, 2000) for i in range(3)]
    for frames in _rounds(ms, audios):
        ms.decode(frames)
    before = ms.state
    ms.reset_stream(1)
    fresh = ms._fresh
    for new, old, ref in zip(
            (*ms.state.enc_state, *ms.state.dec_state),
            (*before.enc_state, *before.dec_state),
            (*fresh.enc_state, *fresh.dec_state)):
        assert torch.equal(new[:, 1], ref[:, 1])
        assert torch.equal(new[:, 0], old[:, 0])
        assert torch.equal(new[:, 2], old[:, 2])
    assert torch.equal(ms.state.h_dec[1], fresh.h_dec[1])
    # stream 1 now decodes new audio exactly like a fresh single stream
    new = _audio(30, 2000)
    text = ''
    for frames in _rounds(ms, [audios[0], new, audios[2]]):
        text += ms.decode(frames)[1]
    assert text == _dec(model).decode_wav(new)


def test_streamserver_two_clients(pair):
    """The reused StreamServer over the port's MultiStreamDecoder, built
    as cli/serve.py builds it: each client's transcript equals
    decode_wav of its audio."""
    _, model = pair
    audios = [_audio(40, 3200), _audio(41, 2600)]
    expect = [_dec(model).decode_wav(a) for a in audios]
    dec = PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 2, device='cpu')
    server = build_server(dec, port=0, round_timeout_ms=0)
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
    assert results == expect
    assert server.rounds > 0


def test_prepare_inference_params_policy(pair):
    """bf16 serving casts only the encoder; joint and prediction net stay
    fp32 (stream.py:71-139) and the caller's model is untouched."""
    _, model = pair
    prepared = PS.prepare_inference_params(model, torch.bfloat16)
    assert prepared.encoder.lstm.lstms[0].weight_hh_l0.dtype == torch.bfloat16
    assert prepared.joint.out.weight.dtype == torch.float32
    assert prepared.decoder.proj.weight.dtype == torch.float32
    assert prepared.decode_cache['w_out_t'].dtype == torch.float32
    assert model.encoder.lstm.lstms[0].weight_hh_l0.dtype == torch.float32
    dec = _dec(model, compute_dtype=torch.bfloat16)
    text = dec.decode_wav(_audio(3, 2000))
    assert isinstance(text, str)
    assert dec.state.h_dec.dtype == torch.float32


def test_unported_options_and_missing_card_raise(pair):
    _, model = pair
    # int8 is ported; another mode is refused as in the JAX package
    with pytest.raises(ValueError):
        _dec(model, quantize='fp8')
    with pytest.raises(NotImplementedError):
        PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 2, device='cpu',
                              mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 2,
                                  device='cuda')


def test_chunk_geometry():
    assert PS.stream_chunk_geometry(320, 200, 3, 2) == (1320, 1200)
    assert PS.stream_chunk_geometry(40, 20, 3, 2) == (140, 120)


# ---------------------------------------------------------------------------
# sharded serving: devices= against the JAX decoders' dp mesh
# ---------------------------------------------------------------------------

def _dp_mesh():
    from edgedict_tpu.parallel import make_mesh
    return make_mesh(dp=2, devices=jax.devices()[:2])


def _serve_rounds(decoders, audios, full_hypothesis):
    """Drive every decoder over the same rounds → {name: texts}; greedy
    texts are appended, beam texts replace (the current best)."""
    first = next(iter(decoders.values()))
    texts = {name: [''] * len(audios) for name in decoders}
    for frames in _rounds(first, audios):
        for name, dec in decoders.items():
            for s, t in enumerate(dec.decode(frames)):
                texts[name][s] = t if full_hypothesis else texts[name][s] + t
    return texts


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_sharded_multistream_equals_the_jax_mesh_decoder(pair, quantize):
    """MultiStreamDecoder(devices=['cpu', 'cpu']) == the JAX
    MultiStreamDecoder on a dp=2 mesh == the port's one-device decoder,
    4 streams (2 a replica), fp32 and int8; then reset_stream of a stream
    of the second replica and the pipelined rounds."""
    from edgedict_tpu.stream import MultiStreamDecoder as JMulti
    params, model = pair
    audios = [_audio(60 + i, 3000) for i in range(4)]
    decs = {
        'jax': JMulti(params, JCFG, JFeat(**FKW), _Tok(), n_streams=4,
                      step_n_frame=2, mesh=_dp_mesh(), quantize=quantize),
        'sharded': PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 4,
                                         devices=['cpu', 'cpu'],
                                         quantize=quantize),
        'one': PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 4,
                                     device='cpu', quantize=quantize)}
    sharded = decs['sharded']
    assert len(sharded.replicas) == 2 and sharded.per_replica == 2
    assert sharded.replicas[0].model is not sharded.replicas[1].model
    texts = _serve_rounds(decs, audios, False)
    assert texts['sharded'] == texts['jax'] == texts['one']
    assert sum(map(len, texts['one'])) > 4
    for dec in decs.values():
        dec.reset_stream(3)
    new = [audios[0], audios[1], audios[2], _audio(70, 2000)]
    texts = _serve_rounds(decs, new, False)
    assert texts['sharded'] == texts['jax'] == texts['one']
    assert texts['one'][3] == _dec(model, quantize=quantize).decode_wav(
        new[3])
    for name in ('sharded', 'one'):
        decs[name].reset()
    piped = {name: [''] * 4 for name in ('sharded', 'one')}
    for frames in _rounds(sharded, audios):
        for name in piped:
            for s, t in enumerate(decs[name].decode_pipelined(frames)
                                  or [''] * 4):
                piped[name][s] += t
    for name in piped:
        for s, t in enumerate(decs[name].flush()):
            piped[name][s] += t
    assert piped['sharded'] == piped['one']


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_sharded_multistream_beam_equals_the_jax_mesh_decoder(pair,
                                                              quantize):
    from edgedict_tpu.stream import MultiStreamBeamDecoder as JBeam
    params, model = pair
    audios = [_audio(80 + i, 3000) for i in range(4)]
    beam = dict(beam_width=3, max_sym_per_frame=2, max_tokens=40)
    decs = {
        'jax': JBeam(params, JCFG, JFeat(**FKW), _Tok(), n_streams=4,
                     step_n_frame=2, mesh=_dp_mesh(), quantize=quantize,
                     **beam),
        'sharded': PS.MultiStreamBeamDecoder(
            model, PCFG, PFEAT, _Tok(), 4, devices=['cpu', 'cpu'],
            quantize=quantize, **beam),
        'one': PS.MultiStreamBeamDecoder(model, PCFG, PFEAT, _Tok(), 4,
                                         device='cpu', quantize=quantize,
                                         **beam)}
    assert len(decs['sharded'].rts) == 2
    texts = _serve_rounds(decs, audios, True)
    assert texts['sharded'] == texts['jax'] == texts['one']
    assert all(texts['one'])
    for dec in decs.values():
        dec.reset_stream(2)
    new = [audios[0], audios[1], _audio(90, 2000), audios[3]]
    texts = _serve_rounds(decs, new, True)
    assert texts['sharded'] == texts['jax'] == texts['one']


def test_devices_must_split_the_streams(pair):
    _, model = pair
    with pytest.raises(ValueError, match='split evenly'):
        PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 3,
                              devices=['cpu', 'cpu'])
    with pytest.raises(ValueError, match='split evenly'):
        PS.MultiStreamBeamDecoder(model, PCFG, PFEAT, _Tok(), 5,
                                  devices=['cpu', 'cpu'])
    with pytest.raises(ValueError, match='device'):
        PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PS.MultiStreamDecoder(model, PCFG, PFEAT, _Tok(), 2,
                                  devices=['cuda:0', 'cuda:1'])


def test_cli_serve_dp_size_two_cpu_replicas(tmp_path):
    """cli.serve --serve_dp_size 2 --device cpu builds two CPU replicas of
    the --pt_path weights; its rounds equal the one-device server's, and
    cli.stream refuses the flag."""
    from test_torch_port_cli import TINY, _setup

    from edgedict_tpu_torch import config as C
    from edgedict_tpu_torch.cli import serve
    from edgedict_tpu_torch.cli import stream as cli_stream
    from edgedict_tpu_torch.data.audio_io import load_audio
    logs, wav = _setup(tmp_path)
    base = TINY + ['--logdir_root', logs, '--device', 'cpu', '--n_streams',
                   '4']
    flags = C.parse_flags(serve.build_parser(), base)
    tok = cli_stream.build_tokenizer(flags)
    feat = C.feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = C.transducer_config_from_flags(flags, tok.vocab_size,
                                         feat.input_size)
    model = PT.Transducer(cfg, 'cpu', seed=7)
    with torch.no_grad():
        model.joint.out.bias[0] -= 3.0            # emit some text
    pt = str(tmp_path / 'model.pt')
    torch.save({'model': model.state_dict()}, pt)
    base += ['--pt_path', pt]
    two = serve.build_decoder(C.parse_flags(
        serve.build_parser(), base + ['--serve_dp_size', '2']))
    one = serve.build_decoder(C.parse_flags(serve.build_parser(), base))
    assert [r.device.type for r in two.replicas] == ['cpu', 'cpu']
    assert len(one.replicas) == 1
    audio, _ = load_audio(wav)
    audios = [np.roll(audio, 700 * i) for i in range(4)]
    texts = _serve_rounds({'two': two, 'one': one}, audios, False)
    assert texts['two'] == texts['one'] and any(texts['one'])
    with pytest.raises(SystemExit) as exc:
        cli_stream.main(base + ['--path', wav, '--serve_dp_size', '2'])
    assert exc.value.code == 2
