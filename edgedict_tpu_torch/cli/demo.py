"""Live demo over the EXPORTED artifacts (counterpart of cli/demo.py; the
reference demo.py role, its OpenVINO live decoder, on the port's
torch.export artifacts).

  python -m edgedict_tpu_torch.cli.demo --flagfile logs/<name>/flagfile.txt \
      --path x.wav [--device cuda|cpu] [--export_dir DIR]
  python -m edgedict_tpu_torch.cli.demo --flagfile ... --mic \
      [--demo_reset_step 200]                         (needs sounddevice)

Run `python -m edgedict_tpu_torch.cli.export` first: it writes
<logdir_root>/<name>/export (or --export_dir).  --device must be the one
the artifacts were exported for (cuda by default).  --mic resets the
decoder every --demo_reset_step decoded chunks.
"""

import sys

import numpy as np

from edgedict_tpu_torch.cli.export import build_parser
from edgedict_tpu_torch.cli.stream import listen, print_now, set_numerics
from edgedict_tpu_torch.config import parse_bool, parse_flags


def mic_callback(decoder, reset_step, emit=print_now):
    """The sounddevice callback of --mic (cli/demo.py:47-60 of the JAX
    package): samples join a buffer, every win_size of them are decoded
    (the buffer moves on by hop_size) and the new text printed; every
    `reset_step` decoded chunks the decoder is reset (0: never)."""
    buf = np.zeros(0, np.float32)
    chunks = 0

    def callback(indata, frames, t, status):
        nonlocal buf, chunks
        buf = np.concatenate([buf, indata[:, 0].astype(np.float32)])
        while len(buf) >= decoder.win_size:
            text = decoder.decode(buf[:decoder.win_size])
            buf = buf[decoder.hop_size:]
            chunks += 1
            if text:
                emit(text)
            if reset_step and chunks % reset_step == 0:
                decoder.reset()

    return callback


def main(argv=None):
    from edgedict_tpu_torch.data.audio_io import load_audio
    from edgedict_tpu_torch.export import build_exported_decoder

    parser = build_parser('streaming decode through the exported '
                          'artifacts')
    parser.add_argument('--path', default=None,
                        help='decode a wav file and exit')
    parser.add_argument('--mic', type=parse_bool, default=False,
                        help='stream from the microphone (sounddevice)')
    parser.add_argument('--demo_reset_step', type=int, default=200,
                        help='--mic: reset the state every N chunks')
    flags = parse_flags(parser, sys.argv[1:] if argv is None else argv)
    if not flags.path and not flags.mic:
        parser.error('pass --path <wav> or --mic')
    set_numerics()
    decoder = build_exported_decoder(flags)
    win, hop = decoder.win_size, decoder.hop_size
    if flags.path:
        audio, sr = load_audio(flags.path)
        if sr != 16000:
            raise SystemExit(f'expected 16 kHz audio, got {sr}')
        n = max((len(audio) - win) // hop + 1, 0)
        print(''.join(decoder.decode(audio[i * hop:i * hop + win])
                      for i in range(n)))
        return
    listen(mic_callback(decoder, flags.demo_reset_step))


if __name__ == '__main__':
    main()
