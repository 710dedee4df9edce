"""Live-stream captioning CLI of the port (counterpart of
cli/youtube_live.py; the reference youtube_live.py): resolve a YouTube
live URL, demux / decode / resample its audio, and decode it through the
streaming transducer with the silence-reset policy.

  python -m edgedict_tpu_torch.cli.youtube_live \
      --flagfile logs/<name>/flagfile.txt --url <youtube url>
  python -m edgedict_tpu_torch.cli.youtube_live --flagfile ... --wav x.wav

The live path needs yt-dlp (or youtube-dl) and PyAV, imported only there.
--wav is the offline A/B of the reference (youtube_live.py:45-62): the
live decoder's decode_wav, then, when <logdir_root>/<name>/export holds
artifacts (cli.export), the exported decoder over the same chunks.  The
decoder flags are cli.stream's (--device cuda by default).
"""

import os
import sys

import numpy as np

from edgedict_tpu_torch.cli import stream
from edgedict_tpu_torch.config import parse_flags


def resolve_stream_url(url):
    try:
        import yt_dlp as youtube_dl
    except ImportError:
        import youtube_dl
    with youtube_dl.YoutubeDL({'format': 'bestaudio/best',
                               'quiet': True}) as ydl:
        info = ydl.extract_info(url, download=False)
    return info['url']


def pcm_frames(container, audio_stream, resampler):
    """Demux / decode / resample a PyAV container into mono float32 16 kHz
    pcm arrays (reference youtube_live.py:103-109)."""
    for frame in container.decode(audio_stream):
        for r in resampler.resample(frame) or []:
            yield r.to_ndarray().reshape(-1).astype(np.float32) / 32768.0


def caption_stream(decoder, pcm_iter, reset_step=200, reset_after=35,
                   emit=None):
    """Rolling-buffer chunking + caption emission + reset policies over an
    iterator of pcm arrays (cli/youtube_live.py:47-108 of the JAX package;
    the runtime core of reference youtube_live.py:88-131).

    Incoming pcm accumulates in a buffer; every time >= win_size samples
    are buffered the decoder consumes buf[:win_size] and the buffer moves
    on by hop_size.  Chunks holding non-finite samples are skipped, not
    decoded (NaN guard, youtube_live.py:111-121).  Silence policy:
    `reset_after` consecutive chunks without progress reset the decoder
    ('[Background]'); a periodic reset fires every `reset_step` decoded
    chunks (youtube_live.py:21, 125-128).  A beam decoder (one with a
    `beam`) returns the full hypothesis: progress is a changed one, and
    the line is re-rendered.

    → {'chunks_done', 'nan_skipped', 'silence_resets',
    'periodic_resets'}."""
    if emit is None:
        emit = stream.print_now
    buf = np.zeros(0, np.float32)
    blank_count = 0
    chunks_done = 0
    nan_skipped = 0
    silence_resets = 0
    periodic_resets = 0
    is_beam = hasattr(decoder, 'beam')
    last = ''
    for pcm in pcm_iter:
        buf = np.concatenate([buf, np.asarray(pcm, np.float32)])
        while len(buf) >= decoder.win_size:
            chunk = buf[:decoder.win_size]
            buf = buf[decoder.hop_size:]
            if not np.isfinite(chunk).all():
                nan_skipped += 1
                emit('[NAN]')
                continue
            text = decoder.decode(chunk)
            chunks_done += 1
            progressed = text != last if is_beam else bool(text)
            if is_beam and progressed:
                emit('\r' + text + ' ' * max(len(last) - len(text), 0))
            elif progressed:
                emit(text)
            last = text
            if progressed:
                blank_count = 0
            else:
                blank_count += 1
                if blank_count >= reset_after:
                    emit('\n[Background]')
                    decoder.reset()
                    silence_resets += 1
                    blank_count = 0
                    last = ''
            if reset_step and chunks_done % reset_step == 0:
                decoder.reset()
                periodic_resets += 1
    return {'chunks_done': chunks_done, 'nan_skipped': nan_skipped,
            'silence_resets': silence_resets,
            'periodic_resets': periodic_resets}


def wav_ab(flags, decoder, path):
    """The --wav A/B: prints '[jit] <text>' of the live decoder and, when
    the run has exported artifacts, '[exported] <text>'."""
    from edgedict_tpu_torch.data.audio_io import load_audio
    from edgedict_tpu_torch.export import build_exported_decoder
    audio, sr = load_audio(path)
    if sr != 16000:
        raise SystemExit(f'expected 16 kHz audio, got {sr}')
    print('[jit]', decoder.decode_wav(audio))
    export_dir = os.path.join(flags.logdir_root, flags.name, 'export')
    if os.path.isdir(export_dir):
        exp = build_exported_decoder(flags, export_dir)
        n = max((len(audio) - exp.win_size) // exp.hop_size + 1, 0)
        print('[exported]', ''.join(
            exp.decode(audio[i * exp.hop_size:
                             i * exp.hop_size + exp.win_size])
            for i in range(n)))


def main(argv=None):
    parser = stream.build_parser('caption a live stream')
    parser.add_argument('--url', default=None, help='youtube live stream url')
    parser.add_argument('--wav', default=None,
                        help='offline A/B decode of a wav file')
    parser.add_argument('--yt_reset_step', type=int, default=200,
                        help='periodic state reset, in chunks (reference '
                             'youtube_live.py:21)')
    parser.add_argument('--yt_reset_after', type=int, default=35,
                        help='reset after N consecutive blank chunks')
    flags = parse_flags(parser, sys.argv[1:] if argv is None else argv)
    if not flags.wav and not flags.url:
        parser.error('pass --url or --wav')
    stream.set_numerics()
    decoder = stream.build_stream_decoder(flags)
    if flags.wav:
        wav_ab(flags, decoder, flags.wav)
        return
    import av
    container = av.open(resolve_stream_url(flags.url))
    audio_stream = next(s for s in container.streams if s.type == 'audio')
    resampler = av.AudioResampler(format='s16', layout='mono', rate=16000)
    caption_stream(decoder, pcm_frames(container, audio_stream, resampler),
                   reset_step=flags.yt_reset_step,
                   reset_after=flags.yt_reset_after)


if __name__ == '__main__':
    main()
