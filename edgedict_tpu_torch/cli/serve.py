"""Serving CLI of the port (counterpart of cli/serve.py, greedy, one
device): N concurrent PCM streams over TCP through serving.StreamServer,
one chunk step of the port's MultiStreamDecoder per round.

  python -m edgedict_tpu_torch.cli.serve --flagfile flagfiles/E6D2.txt \
      --port 8765 --n_streams 64 [--pt_path reference.pt | --model_name \
      <step>.ckpt] [--quantize int8] [--enc_type GRU]

Clients speak the protocol of serving.py (the JAX package's, unchanged); a
minimal client is edgedict_tpu_torch.serving.stream_client.  Beam search
and multi-device serving are not ported yet.  The weights are loaded as
cli/stream.py loads them: --pt_path, else the run's checkpoint.
"""

import asyncio
import sys

from edgedict_tpu_torch.cli.stream import (
    build_parser, load_inference_bundle, set_numerics)
from edgedict_tpu_torch.config import parse_flags
from edgedict_tpu_torch.serving import StreamServer
from edgedict_tpu_torch.stream import MultiStreamDecoder


def build_decoder(flags):
    model, cfg, feature_cfg, tokenizer, dtype, device = \
        load_inference_bundle(flags)
    return MultiStreamDecoder(model, cfg, feature_cfg, tokenizer,
                              n_streams=flags.n_streams, device=device,
                              step_n_frame=flags.step_n_frame,
                              compute_dtype=dtype, quantize=flags.quantize)


def build_server(decoder, host='127.0.0.1', port=0, round_timeout_ms=75,
                 pcm_int16=False):
    """StreamServer over `decoder`; round_timeout_ms 0 = lockstep rounds."""
    timeout = round_timeout_ms / 1e3 if round_timeout_ms > 0 else None
    return StreamServer(decoder, host=host, port=port, round_timeout=timeout,
                        pcm='int16' if pcm_int16 else 'float32')


def main(argv=None):
    parser = build_parser('multi-stream greedy decode server')
    parser.add_argument('--serve_host', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8765,
                        help='listen port (0 = ephemeral)')
    parser.add_argument('--n_streams', type=int, default=64,
                        help='concurrent stream slots (the batch axis)')
    parser.add_argument('--round_timeout_ms', type=int, default=75,
                        help='dispatch a partial round after this long; '
                             '0 = lockstep')
    parser.add_argument('--pcm_int16', action='store_true',
                        help='keep PCM int16 through the round buffers and '
                             'the host→device copy')
    flags = parse_flags(parser, sys.argv[1:] if argv is None else argv)
    set_numerics()
    server = build_server(build_decoder(flags), flags.serve_host, flags.port,
                          flags.round_timeout_ms, flags.pcm_int16)

    async def run():
        await server.start()
        print(f'serving {server.dec.n} stream slots on '
              f'{server.host}:{server.port} '
              f'(chunk {server.dec.hop_size / 16000 * 1e3:.0f} ms)',
              flush=True)
        async with server._server:
            await server._server.serve_forever()

    asyncio.run(run())


if __name__ == '__main__':
    main()
