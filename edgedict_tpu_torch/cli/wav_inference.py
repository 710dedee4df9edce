"""Streaming inference benchmark harness of the port (counterpart of
cli/wav_inference.py; the reference cli/openvino_wav_inference.py:94-147):
streams LibriSpeech test-clean (or any directory in its layout) through
the live and / or exported stream decoders and prints, per backend, the
WER, the throughput (audio seconds per wall second) and the mean chunk ms.

  python -m edgedict_tpu_torch.cli.wav_inference \
      --flagfile logs/<name>/flagfile.txt [--n_samples 50] \
      [--backends jit,exported,int8] [--wav_dir DIR] [--per_stage] \
      [--device cuda|cpu]

Backends, the JAX package's names: jit = the live StreamingDecoder (its
flags as in cli.stream), int8 = the same with --quantize int8, exported =
the ExportedStreamDecoder over <logdir_root>/<name>/export (cli.export
writes it).  --per_stage adds the live decoder's per-component ms
(StreamingDecoder.profile_components: featurize / encoder / joint /
decoder as separate calls, the reference README latency table).
"""

import os
import sys
import time

import numpy as np

from edgedict_tpu_torch.cli import stream
from edgedict_tpu_torch.config import TRAIN_FLAGS, parse_bool, parse_flags

BACKENDS = ('jit', 'exported', 'int8')


def run_backend(name, decoder, utts):
    """Stream every (audio, text) of `utts` through `decoder` chunk by
    chunk (reset before each) and print the report line → (WER,
    throughput, hypotheses)."""
    from edgedict_tpu_torch.metrics import wer
    refs, hyps = [], []
    total_audio = 0.0
    total_time = 0.0
    # greedy decode() gives the NEW text per chunk (concatenated), beam
    # decode() the current FULL hypothesis (the last is kept)
    is_beam = hasattr(decoder, 'beam')
    for audio, text in utts:
        decoder.reset()
        start = time.perf_counter()
        hyp = []
        n = (len(audio) - decoder.win_size) // decoder.hop_size + 1
        for i in range(max(n, 0)):
            hyp.append(decoder.decode(
                audio[i * decoder.hop_size:
                      i * decoder.hop_size + decoder.win_size]))
        total_time += time.perf_counter() - start
        total_audio += len(audio) / 16000.0
        refs.append(text.lower())
        hyps.append((hyp[-1] if hyp and is_beam else ''.join(hyp)).strip())
    pairs = [(r, h) for r, h in zip(refs, hyps) if r.strip()]
    mean_wer = wer([r for r, _ in pairs], [h for _, h in pairs]) \
        if pairs else 1.0
    rtf = total_audio / total_time if total_time else 0.0
    mean_ms = float(np.mean(decoder.elapsed)) * 1000 \
        if getattr(decoder, 'elapsed', None) else 0.0
    print(f'[{name}] WER {mean_wer:.4f}  throughput {rtf:.3f} sec/sec  '
          f'mean chunk {mean_ms:.2f} ms  ({len(pairs)} utts, '
          f'{total_audio:.1f}s audio)', flush=True)
    return mean_wer, rtf, hyps


def load_utterances(flags, tokenizer):
    """The first --n_samples (audio, text) of --wav_dir, else
    --LibriSpeech_test."""
    from edgedict_tpu_torch.data import Librispeech, load_audio
    ds = Librispeech(flags.wav_dir or flags.LibriSpeech_test, tokenizer,
                     audio_max_length=999)
    utts = []
    for rec in ds.data[:flags.n_samples]:
        audio, sr = load_audio(os.path.join(ds.root, rec['path']))
        if sr != 16000:
            raise SystemExit(f'{rec["path"]}: expected 16 kHz, got {sr}')
        utts.append((audio.astype(np.float32), rec['text']))
    return utts


def main(argv=None):
    from edgedict_tpu_torch.export import build_exported_decoder
    from edgedict_tpu_torch.trainer import build_tokenizer

    parser = stream.build_parser('streaming inference benchmark')
    parser.add_argument('--n_samples', type=int, default=50,
                        help='utterances to benchmark')
    parser.add_argument('--backends', default='jit',
                        help='comma list of jit, exported, int8')
    parser.add_argument('--wav_dir', default=None,
                        help='a directory in the LibriSpeech layout '
                             '(default --LibriSpeech_test)')
    test_root = next(d for n, _, d in TRAIN_FLAGS if n == 'LibriSpeech_test')
    parser.add_argument('--LibriSpeech_test', default=test_root)
    parser.add_argument('--per_stage', type=parse_bool, default=False,
                        help='also print the per-component ms of the live '
                             'decoder')
    flags = parse_flags(parser, sys.argv[1:] if argv is None else argv)
    backends = flags.backends.split(',')
    unknown = sorted(set(backends) - set(BACKENDS))
    if unknown:
        parser.error(f'--backends: unknown {unknown}; expected {BACKENDS}')
    stream.set_numerics()
    utts = load_utterances(flags, build_tokenizer(flags))
    print(f'benchmarking {len(utts)} utterances', flush=True)

    results = {}
    if 'jit' in backends:
        dec = stream.build_stream_decoder(flags)
        results['jit'] = run_backend('jit', dec, utts)
        if flags.per_stage and hasattr(dec, 'profile_components'):
            stages = dec.profile_components(utts[0][0])
            print('[jit per-stage ms] ' + '  '.join(
                f'{k} {v:.3f}' for k, v in stages.items()), flush=True)
    if 'int8' in backends:
        old, flags.quantize = flags.quantize, 'int8'
        try:
            dec = stream.build_stream_decoder(flags)
        finally:
            flags.quantize = old
        results['int8'] = run_backend('int8', dec, utts)
    if 'exported' in backends:
        results['exported'] = run_backend(
            'exported', build_exported_decoder(flags), utts)
    return results


if __name__ == '__main__':
    main()
