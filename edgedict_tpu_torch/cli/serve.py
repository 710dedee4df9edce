"""Serving CLI of the port (counterpart of cli/serve.py, one device): N
concurrent PCM streams over TCP through serving.StreamServer, one chunk
step of the port's MultiStreamDecoder per round, or with --beam_width > 1
of its MultiStreamBeamDecoder (with --lm_path, shallow fusion), whose
rounds send each stream's current best hypothesis as '=' replace messages.

  python -m edgedict_tpu_torch.cli.serve --flagfile flagfiles/E6D2.txt \
      --port 8765 --n_streams 64 [--pt_path reference.pt | --model_name \
      <step>.ckpt] [--quantize int8] [--enc_type GRU] [--beam_width 4 \
      [--lm_path logs/<lm run>/lm.ckpt]]

Clients speak the protocol of serving.py (the JAX package's, unchanged); a
minimal client is edgedict_tpu_torch.serving.stream_client.
--serve_dp_size N > 1 splits the stream slots over the local GPUs cuda:0
... cuda:N-1, one replica of the model each (fewer visible cards stop the
parse); under --device cpu it makes N CPU replicas.  The weights are
loaded as cli/stream.py loads them: --pt_path, else the run's checkpoint.
"""

import asyncio
import sys

import torch

from edgedict_tpu_torch.cli.stream import build_parser as stream_parser
from edgedict_tpu_torch.cli.stream import make_decoder, set_numerics
from edgedict_tpu_torch.config import parse_flags
from edgedict_tpu_torch.serving import StreamServer
from edgedict_tpu_torch.stream import (
    MultiStreamBeamDecoder, MultiStreamDecoder, resolve_device)


def serve_devices(flags):
    """The replicas' devices of --serve_dp_size N > 1: cuda:0 ...
    cuda:N-1, or N times the CPU; None for one device."""
    n = flags.serve_dp_size
    if n <= 1:
        return None
    device = resolve_device(flags.device)
    if device.type == 'cuda':
        return [torch.device('cuda', i) for i in range(n)]
    return [device] * n


def build_decoder(flags):
    return make_decoder(flags, MultiStreamDecoder, MultiStreamBeamDecoder,
                        n_streams=flags.n_streams,
                        devices=serve_devices(flags))


def build_server(decoder, host='127.0.0.1', port=0, round_timeout_ms=75,
                 pcm_int16=False):
    """StreamServer over `decoder`; round_timeout_ms 0 = lockstep rounds.
    A beam decoder's rounds replace each client's transcript with its
    stream's current best hypothesis ('=' messages)."""
    timeout = round_timeout_ms / 1e3 if round_timeout_ms > 0 else None
    return StreamServer(
        decoder, host=host, port=port, round_timeout=timeout,
        full_hypothesis=isinstance(decoder, MultiStreamBeamDecoder),
        pcm='int16' if pcm_int16 else 'float32')


def build_parser():
    """cli/stream.py's parser plus the server's own flags."""
    parser = stream_parser('multi-stream decode server')
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
    return parser


def main(argv=None):
    flags = parse_flags(build_parser(), sys.argv[1:] if argv is None
                        else argv)
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
