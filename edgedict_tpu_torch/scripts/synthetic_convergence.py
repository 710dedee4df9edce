"""Synthetic-language convergence run of the port (counterpart of
scripts/synthetic_convergence.py): train a small transducer on a
tone-word language and measure its held-out WER.

Each "word" is a fixed 2-tone audio pattern; utterances are 3–6 random
words.  A model that learns the ASR mapping (not the utterances: the
held-out ones are unseen word sequences) drives held-out WER toward 0.
The corpus code is a copy of the JAX script's, so the audio and texts are
the same bit for bit; the model, trainer, decoders and LM are the port's
(K1-K13 on CUDA, their plain versions on the CPU).

  python -m edgedict_tpu_torch.scripts.synthetic_convergence [--steps 400] \
      [--enc_type LSTM|GRU] [--quant_ab] [--beam 4 --lm_fusion 0.8] \
      [--language easy|confusable|hard] [--snr_sweep inf,20,10,5,0] \
      [--device cuda|cpu]

--device defaults to cuda and fails without a card.  The exit code is 0
when the held-out greedy WER is under 0.3.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

SR = 16000
WORDS = {
    'ba': (300, 500), 'ko': (400, 700), 'mi': (550, 900),
    'ta': (650, 1100), 'zu': (800, 1300), 'pe': (950, 1500),
    'ra': (1100, 1800), 'no': (1300, 2100), 'si': (1500, 2400),
    'du': (1700, 2800),
}
TONE_SEC = 0.08

# ---------------------------------------------------------------------------
# "confusable" language: 6 pairs of words whose two tones differ by only
# 3-4% in the second tone (under one mel bin at 40 bins), plus a bigram
# grammar whose successor sets hold exactly ONE member of each confusable
# pair, so that an acoustic confusion within a pair is (almost) always a
# grammar violation: beam search and LM shallow fusion have real headroom
# over greedy decode.
# ---------------------------------------------------------------------------

CONF_WORDS = {
    'ba': (350, 2000), 'pa': (350, 2070),
    'ko': (500, 2400), 'go': (500, 2480),
    'mi': (650, 2800), 'ni': (650, 2890),
    'ta': (800, 3300), 'da': (800, 3410),
    'zu': (950, 3900), 'su': (950, 4030),
    're': (1100, 4600), 'le': (1100, 4750),
}
_CONF_NAMES = list(CONF_WORDS)


def conf_successors(i):
    """Allowed successors of word i: 3 words from 3 DISTINCT confusable
    pairs (offsets 1, 2, 4 mod 6), fixed parity pattern — so a successor
    set never contains both members of a pair."""
    p = i // 2
    return [2 * ((p + 1) % 6), 2 * ((p + 2) % 6) + 1, 2 * ((p + 4) % 6)]


def sample_conf_sentence(rng, n_words):
    idx = [rng.randint(len(_CONF_NAMES))]
    while len(idx) < n_words:
        succ = conf_successors(idx[-1])
        idx.append(succ[rng.randint(len(succ))])
    return [_CONF_NAMES[i] for i in idx]


def synth(words, rng, noise=0.02, word_table=None):
    table = word_table or WORDS
    audio = []
    for w in words:
        for f in table[w]:
            t = np.arange(int(SR * TONE_SEC)) / SR
            amp = 0.3 + 0.1 * rng.rand()
            audio.append(amp * np.sin(2 * np.pi * f * t))
        audio.append(np.zeros(int(SR * 0.02)))
    x = np.concatenate(audio)
    return (x + noise * rng.randn(len(x))).astype(np.float32)


def synth_hard(words, rng, snr_db=20.0, word_table=None,
               gap=(0.01, 0.04)):
    """Noise-and-variability tier: the easy corpus's near-uniform
    utterance statistics barely stress alignment, so this variant adds,
    per utterance: a speaker-like pitch scale (0.88–1.14×), per-word
    tone-duration jitter (0.06–0.11 s), random inter-word gaps (10–50 ms),
    amplitude wander, a 50% chance of a distractor tone (low 50–120 Hz hum
    or high 3.5–5 kHz whistle, outside the 300–2800 Hz word-tone band),
    and additive white noise calibrated to `snr_db` against the utterance
    RMS (None/inf = clean)."""
    table = word_table or WORDS
    pitch = 0.88 + 0.26 * rng.rand()
    audio = []
    for w in words:
        dur = 0.06 + 0.05 * rng.rand()
        for f in table[w]:
            t = np.arange(int(SR * dur)) / SR
            amp = 0.2 + 0.2 * rng.rand()
            audio.append(amp * np.sin(2 * np.pi * f * pitch * t))
        audio.append(np.zeros(int(SR * (gap[0]
                                        + (gap[1] - gap[0]) * rng.rand()))))
    x = np.concatenate(audio)
    if rng.rand() < 0.5:
        f_d = (50 + 70 * rng.rand()) if rng.rand() < 0.5 \
            else (3500 + 1500 * rng.rand())
        t = np.arange(len(x)) / SR
        x = x + (0.05 + 0.1 * rng.rand()) * np.sin(2 * np.pi * f_d * t)
    if snr_db is not None and np.isfinite(snr_db):
        rms = np.sqrt(np.mean(x ** 2))
        sigma = rms / (10.0 ** (snr_db / 20.0))
        x = x + sigma * rng.randn(len(x))
    return x.astype(np.float32)


class ToyCorpus:
    tokenizer = None

    def __init__(self, tokenizer, n, seed, language='easy', noise=0.02,
                 snr_db=20.0):
        """language='hard' uses synth_hard; snr_db may be a scalar or a
        list (sampled per utterance — a mixed-SNR training diet)."""
        rng = np.random.RandomState(seed)
        names = list(WORDS)
        self.samples = []
        self.data = []
        self.tokenizer = tokenizer
        snrs = snr_db if isinstance(snr_db, (list, tuple)) else [snr_db]
        for _ in range(n):
            n_words = rng.randint(3, 7)
            if language == 'confusable':
                words = sample_conf_sentence(rng, n_words)
                audio = synth(words, rng, noise, CONF_WORDS)
            elif language == 'hard':
                words = [names[rng.randint(len(names))]
                         for _ in range(n_words)]
                audio = synth_hard(words, rng,
                                   snr_db=snrs[rng.randint(len(snrs))])
            else:
                words = [names[rng.randint(len(names))]
                         for _ in range(n_words)]
                audio = synth(words, rng, noise)
            text = ' '.join(words)
            self.samples.append((audio, text))
            self.data.append({'audio_length': len(audio) / SR,
                              'text': text})

    def texts(self):
        return [t for _, t in self.samples]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        audio, text = self.samples[i]
        toks = np.asarray(self.tokenizer.encode(text), np.int32)
        return audio, toks


def _parse_snrs(spec):
    """'20,10,5,inf' → [20.0, 10.0, 5.0, inf]."""
    out = []
    for part in str(spec).split(','):
        part = part.strip()
        if part:
            out.append(float('inf') if part in ('inf', 'clean')
                       else float(part))
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

DEFAULTS = dict(steps=400, enc_type='LSTM',
                logdir=os.path.join(tempfile.gettempdir(), 'edgedict_synth'),
                tokenizer='char', beam=0, lm_fusion=0.0, language='easy',
                noise=0.02, train_n=256, eval_n=48, lr=3e-3, beam_msf=4,
                quant_ab=False, snr_train='20,10,5', snr_sweep='',
                device='cuda')
BPE_SIZE = 64
# the LM of shallow fusion: LMConfig(V, 32, 64, 1), Adam 3e-3 (optax's
# defaults, no clip), LM_STEPS rows of LM_BATCH x (LM_SEQ + 1) ids drawn by
# RandomState(0) from the BOS-prefixed training transcripts
LM_EMBED, LM_HIDDEN, LM_LAYERS = 32, 64, 1
LM_LR, LM_STEPS, LM_SEQ, LM_BATCH = 3e-3, 600, 32, 8
LM_SEED = 3
BEAM_MAX_TOKENS = 64
# serving precision A/B: (encoder dtype, quantize) of each leg
SERVING_LEGS = {'fp32': (None, None), 'bf16': (torch.bfloat16, None),
                'int8': (torch.bfloat16, 'int8')}


def flag_argv(args):
    """The trainer flags of the run (cli.baseline's parser): the JAX run's
    values; the rest (bf16 on, SpecAugment 50 x 2 / 5 x 1, Adam, the plateau
    scheduler) are the flags' defaults, as there."""
    argv = ['--name', 'synth', '--logdir_root', args.logdir,
            '--tokenizer', args.tokenizer, '--batch_size', '16',
            '--sub_batch_size', '16', '--eval_batch_size', '8',
            '--lr', str(args.lr), '--warmup_step', '40', '--gradclip', '5.0',
            '--enc_type', args.enc_type, '--enc_hidden_size', '128',
            '--enc_layers', '3', '--enc_proj_size', '128',
            '--dec_hidden_size', '64', '--dec_layers', '1',
            '--dec_proj_size', '64', '--joint_size', '128',
            '--vocab_embed_size', '16', '--feature', 'logfbank',
            '--feature_size', '40', '--n_fft', '400', '--win_length', '400',
            '--hop_length', '160', '--downsample', '2',
            '--audio_bucket_frames', '32', '--loss_step', '20',
            '--save_step', str(10 ** 9), '--eval_step', str(10 ** 9),
            '--dp_size', '1', '--tp_size', '1', '--device', args.device]
    if args.tokenizer == 'bpe':
        argv += ['--bpe_size', str(BPE_SIZE)]
    return argv


def build_flags(args):
    from edgedict_tpu_torch.cli.baseline import build_parser
    from edgedict_tpu_torch.config import parse_flags
    return parse_flags(build_parser(), flag_argv(args))


def build_tokenizer(args):
    """CharTokenizer under <logdir>/char, or a 64-id BPE under
    <logdir>/BPE-64; built on the training texts by the caller."""
    from edgedict_tpu_torch.tokenizer import (
        CharTokenizer, HuggingFaceTokenizer)
    if args.tokenizer == 'bpe':
        return HuggingFaceTokenizer(
            cache_dir=os.path.join(args.logdir, f'BPE-{BPE_SIZE}'),
            vocab_size=BPE_SIZE)
    os.makedirs(os.path.join(args.logdir, 'char'), exist_ok=True)
    return CharTokenizer(cache_dir=os.path.join(args.logdir, 'char'))


def build_run(args):
    """→ (trainer, tokenizer, train set, held-out set) of the run: the
    corpora (seeds 0 and 1), the tokenizer built on the training texts and
    the port's Trainer over them."""
    from edgedict_tpu_torch.trainer import Trainer
    flags = build_flags(args)
    tok = build_tokenizer(args)
    snr_train = _parse_snrs(args.snr_train)
    train_set = ToyCorpus(tok, args.train_n, seed=0, language=args.language,
                          noise=args.noise, snr_db=snr_train)
    eval_set = ToyCorpus(tok, args.eval_n, seed=1, language=args.language,
                         noise=args.noise, snr_db=snr_train)
    tok.build(train_set.texts())
    trainer = Trainer(flags, train_datasets=[train_set],
                      eval_dataset=eval_set)
    return trainer, tok, train_set, eval_set


def train_loop(trainer, steps, log_fn=print):
    """run_step over the loader's batches, epoch after epoch, until the
    step counter reaches `steps`; the loss every 50 steps."""
    while trainer.state.step < steps:
        for batch in trainer.loader:
            metrics = trainer.run_step(batch)
            step = trainer.state.step
            if step % 50 == 0:
                log_fn(f'step {step} loss {float(metrics["loss"]):.3f}')
            if step >= steps:
                break


def snr_sweep(trainer, tok, eval_n, snrs, log_fn=print):
    """Held-out greedy WER at each SNR (the same unseen word sequences,
    seed 1, of the hard language at that noise level) → {'snr_inf' |
    'snr_<x>': WER}.  The trainer's held-out set and loader are restored
    afterwards, so later decodes score the corpus the greedy WER scored."""
    from edgedict_tpu_torch.data import DataLoader
    out = {}
    held_out = trainer.eval_dataset, trainer.eval_loader
    try:
        for snr in snrs:
            sweep_set = ToyCorpus(tok, eval_n, seed=1, language='hard',
                                  snr_db=snr)
            trainer.eval_dataset = sweep_set
            trainer.eval_loader = DataLoader(
                sweep_set, trainer.flags.eval_batch_size, shuffle=False,
                bucket=trainer.bucket, drop_last=True, prefetch=0)
            _, swer = trainer.evaluate()
            key = 'snr_inf' if np.isinf(snr) else f'snr_{snr:g}'
            out[key] = swer
            log_fn(f'SNR sweep held-out greedy WER [{key}]: {swer:.4f}')
    finally:
        trainer.eval_dataset, trainer.eval_loader = held_out
    return out


def lm_ids(tok, texts):
    """The LM's token stream: every text BOS-prefixed."""
    from edgedict_tpu_torch.tokenizer import BOS
    ids = []
    for t in texts:
        ids.extend([BOS] + list(tok.encode(t)))
    return np.asarray(ids, np.int32)


def lm_batches(ids, steps):
    """`steps` (LM_BATCH, LM_SEQ + 1) rows of ids at RandomState(0)'s
    starts."""
    n = (len(ids) - 1) // LM_SEQ
    rng = np.random.RandomState(0)
    for _ in range(steps):
        starts = rng.randint(0, n, LM_BATCH) * LM_SEQ
        yield np.stack([ids[s:s + LM_SEQ + 1] for s in starts])


def lm_config(vocab_size):
    from edgedict_tpu_torch.models.lm import LMConfig
    return LMConfig(vocab_size=vocab_size, embed_size=LM_EMBED,
                    hidden_size=LM_HIDDEN, num_layers=LM_LAYERS)


def train_lm(model, cfg, ids, steps=LM_STEPS, log_fn=print):
    """Adam (optax's defaults, no clip) at LM_LR over lm_batches: the
    model trained in place; → the loss of each step."""
    from edgedict_tpu_torch import optim
    from edgedict_tpu_torch.cli.train_lm import make_lm_train_step
    optimizer = optim.build_optimizer('adam')
    opt_state = optimizer.init(dict(model.named_parameters()))
    step = make_lm_train_step(cfg, optimizer)
    device = next(model.parameters()).device
    losses = []
    for ys in lm_batches(ids, steps):
        opt_state, loss = step(model, opt_state,
                               torch.from_numpy(ys).to(device), LM_LR)
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    log_fn(f'LM trained: loss {losses[-1]:.3f}')
    return losses


def _features(trainer, batch):
    return trainer.pipeline(torch.as_tensor(batch['audio']).to(trainer.device),
                            torch.as_tensor(batch['alen']).to(trainer.device))


def _refs(tok, batch):
    return [tok.decode([int(t) for t in y[:n]]) for y, n in
            zip(np.asarray(batch['ys']), np.asarray(batch['ylen']))]


def beam_hyps(trainer, tok, beam_width, max_sym_per_frame, lm=None):
    """(references, hypotheses) of transducer_beam_search (max_tokens 64)
    over the trainer's held-out loader; lm: (LMModel, LMConfig, weight) or
    None."""
    from edgedict_tpu_torch.models.beam_search import transducer_beam_search
    refs, hyps = [], []
    model = trainer.eval_model()
    for batch in trainer.eval_loader:
        xs, xlen = _features(trainer, batch)
        toks, n_tok, _ = transducer_beam_search(
            model, trainer.cfg, xs, xlen, beam_width=beam_width,
            max_sym_per_frame=max_sym_per_frame,
            max_tokens=BEAM_MAX_TOKENS, lm=lm)
        toks, n_tok = toks.cpu().numpy(), n_tok.cpu().numpy()
        hyps.extend(tok.decode([int(t) for t in toks[b][:int(n_tok[b])]])
                    for b in range(toks.shape[0]))
        refs.extend(_refs(tok, batch))
    return refs, hyps


@torch.no_grad()
def serving_hyps(trainer, tok, dtype, quantize):
    """(references, hypotheses) of the offline greedy decode over
    prepare_inference_params(trained model, dtype, quantize) on the
    held-out loader: the features cast to the encoder's dtype, the token
    loop in fp32."""
    from edgedict_tpu_torch.models.decoding import transducer_greedy_decode
    from edgedict_tpu_torch.stream import prepare_inference_params
    from edgedict_tpu_torch.trainer import truncate_and_strip
    prepared = prepare_inference_params(trainer.eval_model(), dtype,
                                        quantize=quantize)
    refs, hyps = [], []
    for batch in trainer.eval_loader:
        xs, xlen = _features(trainer, batch)
        if dtype is not None:
            xs = xs.to(dtype)
        y_seq, out_len, _ = transducer_greedy_decode(
            prepared, trainer.cfg, xs, xlen, cache=prepared.decode_cache)
        seqs = truncate_and_strip(y_seq.cpu(), out_len.cpu(),
                                  blank=trainer.cfg.blank)
        hyps.extend(tok.decode([int(t) for t in s]) for s in seqs)
        refs.extend(_refs(tok, batch))
    return refs, hyps


def run(log_fn=print, **kwargs):
    """Train on the toy language; → {'greedy': held-out WER} plus 'beam'
    (beam > 0), 'beam_lm' (and lm_fusion > 0), 'serve_fp32', 'serve_bf16',
    'serve_int8' (quant_ab) and 'snr_<x>' (snr_sweep, e.g.
    'inf,20,10,5'); kwargs are main()'s flags (DEFAULTS)."""
    unknown = set(kwargs) - set(DEFAULTS)
    if unknown:
        raise TypeError(f'unknown arguments {sorted(unknown)}')
    args = argparse.Namespace(**{**DEFAULTS, **kwargs})
    from edgedict_tpu_torch.cli.baseline import set_numerics
    from edgedict_tpu_torch.metrics import wer
    from edgedict_tpu_torch.stream import resolve_device
    resolve_device(args.device)          # no card: fail before any work
    set_numerics()
    trainer, tok, train_set, _ = build_run(args)

    train_loop(trainer, args.steps, log_fn)
    trainer.save()                  # reusable for decode-setting sweeps
    loss, greedy = trainer.evaluate()
    log_fn(f'FINAL held-out (greedy): loss {loss:.3f} WER {greedy:.4f}')
    result = {'greedy': greedy}

    if args.snr_sweep:
        result.update(snr_sweep(trainer, tok, args.eval_n,
                                _parse_snrs(args.snr_sweep), log_fn))

    if args.beam:
        lm = None
        if args.lm_fusion > 0:
            from edgedict_tpu_torch.models.lm import LMModel
            cfg = lm_config(tok.vocab_size)
            model = LMModel(cfg, trainer.device, seed=LM_SEED)
            train_lm(model, cfg, lm_ids(tok, train_set.texts()),
                     log_fn=log_fn)
            lm = (model, cfg, args.lm_fusion)
        result['beam'] = wer(*beam_hyps(trainer, tok, args.beam,
                                        args.beam_msf))
        log_fn(f'FINAL held-out (beam W={args.beam}): '
               f'WER {result["beam"]:.4f}')
        if lm is not None:
            result['beam_lm'] = wer(*beam_hyps(trainer, tok, args.beam,
                                               args.beam_msf, lm))
            log_fn(f'FINAL held-out (beam W={args.beam} + LM fusion '
                   f'{args.lm_fusion}): WER {result["beam_lm"]:.4f}')

    if args.quant_ab:
        for name, (dtype, quantize) in SERVING_LEGS.items():
            result[f'serve_{name}'] = wer(*serving_hyps(trainer, tok, dtype,
                                                        quantize))
            log_fn(f'SERVING A/B held-out greedy WER [{name}]: '
                   f'{result[f"serve_{name}"]:.4f}')
    return result


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    d = DEFAULTS
    ap.add_argument('--steps', type=int, default=d['steps'])
    ap.add_argument('--enc_type', default=d['enc_type'],
                    choices=['LSTM', 'GRU'])
    ap.add_argument('--logdir', default=d['logdir'])
    ap.add_argument('--tokenizer', default=d['tokenizer'],
                    choices=['char', 'bpe'])
    ap.add_argument('--beam', type=int, default=d['beam'],
                    help='also evaluate with beam search of this width')
    ap.add_argument('--lm_fusion', type=float, default=d['lm_fusion'],
                    help='train an LM on the corpus and fuse at this weight')
    ap.add_argument('--language', default=d['language'],
                    choices=['easy', 'confusable', 'hard'],
                    help='confusable = near-identical word pairs + bigram '
                         'grammar (beam/LM headroom); hard = pitch scaling '
                         '+ duration jitter + distractor tones + SNR noise')
    ap.add_argument('--snr_train', default=d['snr_train'],
                    help="language=hard: per-utterance training SNRs (dB), "
                         "comma list; 'inf' = clean")
    ap.add_argument('--snr_sweep', default=d['snr_sweep'],
                    help="after training, held-out WER at each SNR, e.g. "
                         "'inf,20,10,5,0'")
    ap.add_argument('--noise', type=float, default=d['noise'])
    ap.add_argument('--train_n', type=int, default=d['train_n'])
    ap.add_argument('--eval_n', type=int, default=d['eval_n'])
    ap.add_argument('--lr', type=float, default=d['lr'])
    ap.add_argument('--quant_ab', action='store_true',
                    help='after training, A/B held-out greedy WER across '
                         'fp32 / bf16 / int8 weight-only serving')
    ap.add_argument('--beam_msf', type=int, default=d['beam_msf'],
                    help='beam label-expansion budget per frame (must '
                         'cover the model alignment burst length)')
    ap.add_argument('--device', default=d['device'],
                    help="torch device: 'cuda' (default) or 'cpu'")
    return ap


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    result = run(**vars(args))
    return 0 if result['greedy'] < 0.3 else 1


if __name__ == '__main__':
    sys.exit(main())
