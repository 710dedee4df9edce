"""Training orchestration on one device (counterpart of
edgedict_tpu/trainer.py).

Flags → tokenizer → datasets (edgedict_tpu.data: LibriSpeech / TEDLIUM /
CommonVoice / YouTube layouts, host loader with length bucketing) → seeded
Transducer + optimizer + plateau scheduler → step loop with linear warmup,
the grad-accumulated train step (train.py), periodic eval (loss + greedy
WER), step-numbered checkpoints and a best-WER copy.  A resumed run replays
the batch order of an uninterrupted one: the checkpoint holds the
augmentation generator's state, and the loader's epoch counter and
in-epoch position are restored (trainer.py:463-494).
"""

import os
import shutil
import time

import numpy as np
import torch

from edgedict_tpu.data import (
    BucketSpec, CommonVoice, DataLoader, Librispeech, MergedDataset,
    TEDLIUM, YoutubeCaption)
from edgedict_tpu.metrics import wer as wer_fn
from edgedict_tpu.tokenizer import CharTokenizer, HuggingFaceTokenizer
from edgedict_tpu_torch import optim
from edgedict_tpu_torch.checkpoint import (
    checkpoint_path, latest_step, load_checkpoint, prune_checkpoints,
    save_checkpoint, snapshot_flags)
from edgedict_tpu_torch.config import (
    feature_config_from_flags, transducer_config_from_flags)
from edgedict_tpu_torch.features import FeaturePipeline
from edgedict_tpu_torch.stream import resolve_device
from edgedict_tpu_torch.train import (
    device_batch, make_eval_step, make_train_state, make_train_step)

AUGMENT_SEED = 1234


def build_tokenizer(flags):
    """Tokenizer per flags, with the reference cache layout (char →
    <logdir_root>/char, bpe → BPE-<size> in the working directory)."""
    if flags.tokenizer == 'bpe':
        return HuggingFaceTokenizer(cache_dir='BPE-%d' % flags.bpe_size,
                                    vocab_size=flags.bpe_size)
    tok = CharTokenizer(cache_dir=os.path.join(flags.logdir_root, 'char'))
    try:
        tok.load()
    except FileNotFoundError:
        pass
    return tok


def build_datasets(flags, tokenizer):
    """Train/eval datasets from the corpus roots; a corpus whose root is
    missing is skipped (trainer.py:53-77)."""
    kwargs = dict(audio_max_length=flags.audio_max_length,
                  cache_audio=flags.cache_audio)
    train = []
    for root in (flags.LibriSpeech_train_500, flags.LibriSpeech_train_360,
                 flags.LibriSpeech_train_100):
        if os.path.isdir(root):
            train.append(Librispeech(root, tokenizer, **kwargs))
    if os.path.isdir(os.path.join(flags.TEDLIUM_train, 'wav')):
        train.append(TEDLIUM(flags.TEDLIUM_train, tokenizer, **kwargs))
    if os.path.isfile(os.path.join(flags.CommonVoice, 'train.tsv')):
        train.append(CommonVoice(flags.CommonVoice, 'train.tsv', tokenizer,
                                 **kwargs))
    for root, csv_name in ((flags.YT_bloomberg2, 'bloomberg2_meta.csv'),
                           (flags.YT_life, 'life_meta.csv')):
        if os.path.isfile(os.path.join(root, csv_name)):
            train.append(YoutubeCaption(root, csv_name, tokenizer, **kwargs))
    eval_ds = None
    if os.path.isdir(flags.LibriSpeech_test):
        eval_ds = Librispeech(flags.LibriSpeech_test, tokenizer,
                              audio_max_length=999)
    return train, eval_ds


def pick_accum_steps(batch_size, sub_batch_size):
    """Accumulation steps: the fewest that make the micro-batch (an equal
    split of the batch) at most sub_batch_size (trainer.py:80-109, one
    device)."""
    for accum in range(1, batch_size + 1):
        if batch_size % accum == 0 and batch_size // accum <= sub_batch_size:
            return accum
    raise ValueError(f'no micro-batch <= sub_batch_size={sub_batch_size} '
                     f'divides batch_size={batch_size}')


def truncate_and_strip(y_seq, out_len, blank=0):
    """Per sample: frames < out_len, blanks dropped (decoding.py:88-99)."""
    y_seq, out_len = np.asarray(y_seq), np.asarray(out_len)
    return [seq[:int(n)][seq[:int(n)] != blank]
            for seq, n in zip(y_seq, out_len)]


class Trainer:
    def __init__(self, flags):
        self.flags = flags
        self.logdir = os.path.join(flags.logdir_root, flags.name)
        os.makedirs(self.logdir, exist_ok=True)
        self.device = resolve_device(flags.device)

        self.tokenizer = build_tokenizer(flags)
        train_datasets, eval_dataset = build_datasets(flags, self.tokenizer)
        self.train_dataset = MergedDataset(train_datasets)
        self.eval_dataset = eval_dataset
        if getattr(self.tokenizer, 'token2id', True) is None or \
                getattr(self.tokenizer, 'tokenizer', True) is None:
            self.tokenizer.build(self.train_dataset.texts())

        self.accum_steps = pick_accum_steps(flags.batch_size,
                                            flags.sub_batch_size)
        self.optimizer = optim.build_optimizer(flags.optim,
                                               gradclip=flags.gradclip)
        self.feature_cfg = feature_config_from_flags(flags)
        self.pipeline = FeaturePipeline(self.feature_cfg, self.device)
        self.cfg = transducer_config_from_flags(
            flags, self.tokenizer.vocab_size, self.feature_cfg.input_size)
        self.state = make_train_state(self.cfg, self.optimizer, self.device)
        self.train_step = make_train_step(self.cfg, self.optimizer,
                                          bf16=flags.bf16,
                                          feature_pipeline=self.pipeline)
        self.eval_step = make_eval_step(self.cfg, self.pipeline)
        self.sched = optim.ReduceLROnPlateau(
            base_lr=flags.lr, factor=flags.sched_factor,
            patience=flags.sched_patience, min_lr=flags.sched_min_lr) \
            if flags.sched else None

        hop = flags.hop_length * max(1, flags.downsample)
        self.bucket = BucketSpec(
            t_multiple=flags.audio_bucket_frames * hop,
            u_multiple=flags.label_bucket,
            t_max=int(flags.audio_max_length * 16000 + hop))
        self.loader = DataLoader(
            self.train_dataset, flags.batch_size, shuffle=True,
            bucket=self.bucket, drop_last=True,
            workers=max(1, flags.num_workers))
        self.eval_loader = DataLoader(
            self.eval_dataset, flags.eval_batch_size, shuffle=False,
            bucket=self.bucket, drop_last=True,
            prefetch=0) if self.eval_dataset is not None else None
        snapshot_flags(flags, self.logdir)
        self.generator = torch.Generator(device=self.device).manual_seed(
            AUGMENT_SEED)
        self._skip_batches = 0
        self._best_wer = float('inf')

    # ------------------------------------------------------------------
    def _lr(self, step):
        lr = self.flags.lr * optim.warmup_scale(step, self.flags.warmup_step)
        if self.sched is not None:
            lr = max(lr * self.sched.scale, self.flags.sched_min_lr)
        return lr

    def run_step(self, batch):
        """One optimizer step on a host batch dict (audio/alen/ys/ylen)."""
        dev = device_batch(batch, self.accum_steps, self.device)
        self.state, metrics = self.train_step(
            self.state, dev, self._lr(self.state.step), self.generator)
        return metrics

    def train(self, total_steps=None, log_fn=print):
        f = self.flags
        total = total_steps or f.epochs * max(len(self.loader), 1)
        t0 = time.time()
        while self.state.step < total:
            for batch in self.loader:
                if self._skip_batches:
                    self._skip_batches -= 1     # resume: fast-forward to
                    continue                    # the checkpointed position
                metrics = self.run_step(batch)
                step = self.state.step
                if step % f.loss_step == 0:
                    log_fn(f'step {step}/{total} loss '
                           f'{float(metrics["loss"]):.4f} lr '
                           f'{self._lr(step):.2e} ({time.time() - t0:.1f}s)')
                if step % f.save_step == 0:
                    self.save()
                    prune_checkpoints(self.logdir, f.keep_checkpoints)
                if step % f.eval_step == 0 and self.eval_loader:
                    val_loss, val_wer = self.evaluate()
                    if self.sched is not None:
                        self.sched.step(val_loss)
                    log_fn(f'eval @ {step}: loss {val_loss:.4f} '
                           f'WER {val_wer:.4f}')
                    if val_wer < self._best_wer:
                        self._best_wer = val_wer
                        shutil.copy(self.save(),
                                    os.path.join(self.logdir, 'best.ckpt'))
                if step >= total:
                    break
        self.save()

    # ------------------------------------------------------------------
    def evaluate(self, max_batches=None):
        """→ (mean loss, corpus WER of the greedy decode)."""
        losses, refs, hyps = [], [], []
        model = self.state.model
        for i, batch in enumerate(self.eval_loader):
            if max_batches is not None and i >= max_batches:
                break
            dev = {k: torch.as_tensor(v).to(self.device)
                   for k, v in batch.items()}
            loss, y_seq, out_len = self.eval_step(model, dev)
            losses.append(float(loss))
            seqs = truncate_and_strip(y_seq.cpu(), out_len.cpu(),
                                      blank=self.cfg.blank)
            hyps.extend(self.tokenizer.decode_plus(seqs))
            refs.extend(self.tokenizer.decode_plus(
                [y[:n] for y, n in zip(np.asarray(batch['ys']),
                                       np.asarray(batch['ylen']))]))
        pairs = [(r, h) for r, h in zip(refs, hyps) if r.strip()]
        val_wer = wer_fn([r for r, _ in pairs], [h for _, h in pairs]) \
            if pairs else 1.0
        return float(np.mean(losses) if losses else np.nan), val_wer

    # ------------------------------------------------------------------
    def save(self):
        return save_checkpoint(
            self.logdir, self.state.step, self.state.model.state_dict(),
            self.state.opt_state,
            self.sched.state_dict() if self.sched else None,
            extra={'generator': self.generator.get_state(),
                   'best_wer': self._best_wer})

    def load(self, step=None):
        step = step if step is not None else latest_step(self.logdir)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {self.logdir}')
        payload = load_checkpoint(checkpoint_path(self.logdir, step))
        model = self.state.model
        model.load_state_dict(payload['model'])
        params = dict(model.named_parameters())
        opt_state = payload['optim']
        if opt_state is None:                   # model-only checkpoint
            opt_state = self.optimizer.init(params)
        opt_state = _to_device(opt_state, self.device)
        self.state = type(self.state)(model, opt_state, int(payload['step']))
        if self.sched is not None and payload['sched'] is not None:
            self.sched.load_state_dict(payload['sched'])
        extra = payload.get('extra') or {}
        if 'generator' in extra:
            self.generator.set_state(extra['generator'])
        if extra.get('best_wer') is not None:
            self._best_wer = float(extra['best_wer'])
        # replay the batch sequence an uninterrupted run would have seen
        n = max(len(self.loader), 1)
        self.loader.epoch = step // n
        self._skip_batches = step % n
        return step


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
