"""Streaming decode CLI of the port (counterpart of cli/stream.py): decode
a wav file chunk by chunk and print the transcript and the throughput
line, or stream from the microphone.

  python -m edgedict_tpu_torch.cli.stream --flagfile flagfiles/E6D2.txt \
      --path x.wav [--pt_path reference.pt | --model_name <step>.ckpt] \
      [--device cuda|cpu] [--quantize int8] [--enc_type GRU] \
      [--beam_width 4 [--lm_path logs/<lm run>/lm.ckpt --lm_weight 0.2]]
  python -m edgedict_tpu_torch.cli.stream --flagfile ... --mic \
      [--reset_after 35]                          (needs sounddevice)

--device defaults to cuda and fails without a card; the CPU runs only when
asked with --device cpu.  --infer_dtype auto is bf16 on CUDA (bf16 encoder,
fp32 joint and prediction net) and fp32 on the CPU.  --quantize int8 serves
an int8 weight-only encoder (ops/quant.py); --enc_type GRU a GRU encoder.
Without --pt_path the weights are the run's checkpoint, as in the JAX
package's CLI: logs/<name>/models/<--model_name>, else the latest step's
<step>.ckpt, else random (seed 0).  --beam_width > 1 switches to the
streaming beam search (StreamingBeamDecoder: --max_sym_per_frame label
expansions a frame, --merge_prefixes Graves prefix merging), and
--lm_path adds shallow fusion with an LM that the port's cli.train_lm wrote
(weight --lm_weight).  --mic: after --reset_after consecutive chunks
without progress the decoder state is reset and "[Background]" printed
(reference stream.py:92-98); a beam decoder re-renders its full
hypothesis, and an unchanged hypothesis counts as no progress.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from edgedict_tpu_torch.config import (
    TRAIN_FLAGS, add_model_flags, add_serve_flags,
    feature_config_from_flags, parse_bool, parse_flags,
    transducer_config_from_flags)
from edgedict_tpu_torch.stream import resolve_device


def set_numerics():
    """True fp32 matmuls and fp32 reductions in bf16 matmuls on CUDA: the
    fp32 token loop must not run in TF32 (greedy tokens would stop being
    exact)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def build_parser(description):
    parser = argparse.ArgumentParser(description=description)
    add_model_flags(parser)
    add_serve_flags(parser)
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default) or 'cpu'")
    parser.add_argument('--pt_path', default=None,
                        help='a reference PyTorch .pt (plain or lightning), '
                             "the port's .ckpt or the JAX package's; unset "
                             "= the run's checkpoint")
    run_name = next(d for n, _, d in TRAIN_FLAGS if n == 'name')
    parser.add_argument('--name', default=run_name,
                        help="the training run's name (the trainer's --name)")
    parser.add_argument('--model_name', default=None,
                        help='checkpoint file under <logdir_root>/<name>/'
                             'models; unset = the latest step')
    parser.add_argument('--infer_dtype', default='auto',
                        choices=('auto', 'bf16', 'bfloat16', 'fp32',
                                 'float32'),
                        help='encoder compute dtype: auto = bf16 on CUDA, '
                             'fp32 on the CPU')
    parser.add_argument('--step_n_frame', type=int, default=2,
                        help='encoder input frames per chunk')
    parser.add_argument('--quantize', default=None, choices=('int8',),
                        help="'int8' = weight-only int8 encoder "
                             '(per-channel symmetric scales; ops/quant.py); '
                             'unset = serve at --infer_dtype precision')
    parser.add_argument('--beam_width', type=int, default=1,
                        help='>1 switches to streaming beam search')
    parser.add_argument('--merge_prefixes', type=parse_bool, default=True,
                        help='Graves prefix-probability summation in beam '
                             'search')
    parser.add_argument('--max_sym_per_frame', type=int, default=3,
                        help='beam search label expansions per encoder '
                             'frame')
    parser.add_argument('--lm_path', default=None,
                        help="an LM checkpoint of the port's cli.train_lm "
                             '(logs/<name>/lm.ckpt): shallow fusion when '
                             'beam_width > 1')
    parser.add_argument('--lm_weight', type=float, default=0.2,
                        help='shallow-fusion LM weight')
    return parser


def resolve_infer_dtype(name, device):
    if name == 'auto':
        return torch.bfloat16 if device.type == 'cuda' else None
    return {'bf16': torch.bfloat16, 'bfloat16': torch.bfloat16,
            'fp32': None, 'float32': None}[name]


def build_tokenizer(flags):
    """Tokenizer per flags, with the reference cache layout (char →
    <logdir_root>/char, bpe → BPE-<size>)."""
    from edgedict_tpu_torch.tokenizer import (
        CharTokenizer, HuggingFaceTokenizer)
    if flags.tokenizer == 'bpe':
        return HuggingFaceTokenizer(cache_dir='BPE-%d' % flags.bpe_size,
                                    vocab_size=flags.bpe_size)
    tok = CharTokenizer(cache_dir=os.path.join(flags.logdir_root, 'char'))
    try:
        tok.load()
    except FileNotFoundError:
        pass
    return tok


def run_checkpoint(flags):
    """logs/<name>/models/<--model_name>, else the latest step's
    checkpoint; None when that file does not exist (cli/stream.py:83-97 of
    the JAX package)."""
    from edgedict_tpu_torch.checkpoint import checkpoint_path, latest_step
    logdir = os.path.join(flags.logdir_root, flags.name)
    if flags.model_name:
        path = os.path.join(logdir, 'models', flags.model_name)
    else:
        step = latest_step(logdir)
        path = None if step is None else checkpoint_path(logdir, step)
    return path if path and os.path.exists(path) else None


def load_model(flags):
    """(model on the CPU, cfg, feature_cfg, tokenizer, device) from parsed
    flags: the weights of --pt_path, else the run's checkpoint, else
    random (seed 0) — shared by the stream, serve and export CLIs."""
    from edgedict_tpu_torch.compat import load_reference_checkpoint
    from edgedict_tpu_torch.models.transducer import Transducer

    device = resolve_device(flags.device)
    tokenizer = build_tokenizer(flags)
    if getattr(tokenizer, 'tokenizer', None) is None and \
            getattr(tokenizer, 'token2id', None) is None:
        raise SystemExit('tokenizer cache not found — point --logdir_root '
                         '(char) or the working directory (BPE-<size>) at '
                         'one')
    feature_cfg = feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = transducer_config_from_flags(flags, tokenizer.vocab_size,
                                       feature_cfg.input_size)
    path = flags.pt_path or run_checkpoint(flags)
    if path:
        model = load_reference_checkpoint(path, cfg, 'cpu')
        print(f'loaded {path}')
    else:
        print('WARNING: no checkpoint found — using random weights')
        model = Transducer(cfg, device='cpu', seed=0)
    return model, cfg, feature_cfg, tokenizer, device


def load_inference_bundle(flags):
    """load_model's (model, cfg, feature_cfg, tokenizer, compute dtype,
    device): the dtype of --infer_dtype on that device."""
    model, cfg, feature_cfg, tokenizer, device = load_model(flags)
    dtype = resolve_infer_dtype(flags.infer_dtype, device)
    return model, cfg, feature_cfg, tokenizer, dtype, device


def load_lm_fusion(flags):
    """--lm_path / --lm_weight → the (LMModel, LMConfig, weight) triple the
    beam decoders take for shallow fusion, or None."""
    if not flags.lm_path:
        return None
    from edgedict_tpu_torch.models.lm import load_lm_checkpoint
    lm, lm_cfg = load_lm_checkpoint(flags.lm_path)
    print(f'LM fusion: {flags.lm_path} (lambda={flags.lm_weight})')
    return lm, lm_cfg, float(flags.lm_weight)


def make_decoder(flags, greedy_cls, beam_cls, **kw):
    """greedy_cls, or beam_cls when --beam_width > 1 (with the LM of
    --lm_path), over load_inference_bundle's model; kw go to either (the
    stream and serve CLIs)."""
    model, cfg, feature_cfg, tokenizer, dtype, device = \
        load_inference_bundle(flags)
    kw.update(device=device, step_n_frame=flags.step_n_frame,
              compute_dtype=dtype, quantize=flags.quantize)
    if flags.beam_width > 1:
        return beam_cls(
            model, cfg, feature_cfg, tokenizer, beam_width=flags.beam_width,
            max_sym_per_frame=flags.max_sym_per_frame,
            merge_prefixes=flags.merge_prefixes, lm=load_lm_fusion(flags),
            **kw)
    return greedy_cls(model, cfg, feature_cfg, tokenizer, **kw)


def build_stream_decoder(flags):
    """StreamingBeamDecoder when --beam_width > 1 (with the LM of
    --lm_path), else StreamingDecoder."""
    from edgedict_tpu_torch.stream import (
        StreamingBeamDecoder, StreamingDecoder)
    return make_decoder(flags, StreamingDecoder, StreamingBeamDecoder,
                        block_chunks=getattr(flags, 'block_chunks', 1))


def print_now(text, end=''):
    print(text, end=end, flush=True)


def mic_callback(decoder, reset_after, emit=print_now):
    """The sounddevice callback of --mic (cli/stream.py:167-207 of the JAX
    package): incoming samples join a buffer; every win_size of them are
    decoded and the buffer moves on by hop_size.  Greedy decode() gives
    the NEW text (printed as it comes), beam decode() the current FULL
    hypothesis (the line re-rendered); a chunk with no new text, or an
    unchanged hypothesis, counts as silence, and `reset_after` of them in a
    row reset the decoder and print '[Background]'."""
    buf = np.zeros(0, np.float32)
    blank_count = 0
    is_beam = hasattr(decoder, 'beam')
    last = ''

    def callback(indata, frames, t, status):
        nonlocal buf, blank_count, last
        buf = np.concatenate([buf, indata[:, 0].astype(np.float32)])
        while len(buf) >= decoder.win_size:
            text = decoder.decode(buf[:decoder.win_size])
            buf = buf[decoder.hop_size:]
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
                    emit('\n[Background]', end='\n')
                    decoder.reset()
                    blank_count = 0
                    last = ''

    return callback


def listen(callback):
    """Feed the microphone (16 kHz mono, sounddevice) to `callback` until
    interrupted (ctrl-c)."""
    import sounddevice as sd
    with sd.InputStream(samplerate=16000, channels=1, callback=callback):
        print('listening (ctrl-c to stop)', flush=True)
        while True:
            time.sleep(0.1)


def main(argv=None):
    from edgedict_tpu_torch.data.audio_io import load_audio

    parser = build_parser('streaming decode of a wav file or the '
                          'microphone')
    parser.add_argument('--path', default=None, help='wav file to decode')
    parser.add_argument('--mic', type=parse_bool, default=False,
                        help='stream from the microphone (sounddevice)')
    parser.add_argument('--reset_after', type=int, default=35,
                        help='--mic: reset the state after N consecutive '
                             'chunks without new text')
    parser.add_argument('--block_chunks', type=int, default=1,
                        help='>1 decodes N chunks per layer-major group '
                             'step (same output)')
    flags = parse_flags(parser, sys.argv[1:] if argv is None else argv)
    if not flags.path and not flags.mic:
        parser.error('pass --path <wav> or --mic')
    if flags.serve_dp_size > 1:
        parser.error('--serve_dp_size splits the streams of cli.serve over '
                     'devices; cli.stream decodes one stream')
    set_numerics()
    decoder = build_stream_decoder(flags)
    if not flags.path:
        listen(mic_callback(decoder, flags.reset_after))
        return
    audio, sr = load_audio(flags.path)
    if sr != 16000:
        raise SystemExit(f'expected 16 kHz audio, got {sr}')
    text = decoder.decode_wav(audio)
    print(text)
    if decoder.elapsed:
        mean_ms = float(np.mean(decoder.elapsed)) * 1000
        total = sum(decoder.elapsed)
        print(f'[chunks {len(decoder.elapsed)}  mean {mean_ms:.2f} ms  '
              f'throughput {len(audio) / sr / total:.2f} sec/sec]')


if __name__ == '__main__':
    main()
