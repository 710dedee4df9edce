"""Training orchestration on one device (counterpart of
edgedict_tpu/trainer.py).

Flags → tokenizer → datasets (data/: LibriSpeech / TEDLIUM /
CommonVoice / YouTube layouts, host loader with length bucketing) → seeded
Transducer + optimizer + plateau scheduler → step loop with linear warmup,
the grad-accumulated train step (train.py), periodic eval (loss + greedy
WER, and the beam search's WER with --eval_beam_width > 0), step-numbered
checkpoints (the periodic ones written on a background thread) and a
best-WER copy.  A resumed run replays the batch order of an uninterrupted
one: the checkpoint holds the augmentation generator's state, and the
loader's epoch counter and in-epoch position are restored
(trainer.py:463-494).  `load` also reads the JAX package's checkpoints:
model, optax state (compat.optim_state_from_jax), step, plateau state and
best WER.

One-card extras of the JAX trainer: --device_corpus (the whole corpus
padded to one (L_max, U_max) on the device once, batches gathered there
by index in the host loader's order, :112-137, :249-311), --profile_dir
(a torch.profiler chrome trace of steps 11-13, :347-360), tensorboard
scalars and samples when tensorboardX imports (:199-205), and on CUDA
page-locked loader batches copied one step ahead (train.prefetch_batches).

Data parallelism (cli/distributed.py; trainer.py:160, :199, :453 of the
JAX package): under a torch.distributed process group each rank is handed
its shard of the corpora and loads --batch_size rows from it; the shared
train step averages the gradients across the ranks.  The ranks start from
rank 0's parameters, agree on the steps of an epoch (the fewest batches
any rank's loader has, so no rank waits alone in an all-reduce), draw
augmentation from generators seeded by rank, and sum their evaluation
counts (loss, word errors and reference words of the greedy and the beam
decode) before the WER, the plateau scheduler and the best checkpoint read
them.  Only rank 0 writes the flag snapshot, tensorboard, the step log and
checkpoints; every rank waits at a barrier after a save and before a load.
--device_corpus is one process only.

Tensor and pipeline parallelism (parallel/; trainer.py:156-160, :228-237
of the JAX package): --tp_size / --pp_size build the process's grid of
devices from --device (parallel/__init__.py:grid_devices, make_layout).
The model is placed over it, the train step is make_train_step_pp with pp
> 1 (the accumulation micro-batches as its microbatches, a multiple of pp
where one divides the batch), evaluation and the greedy decode run on a
gathered one-device copy on the home device, checkpoints hold the
one-device layout (the slices gathered on save, scattered on load), and
batches and the device corpus stay on the home device.
"""

import itertools
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from edgedict_tpu_torch import optim, parallel
from edgedict_tpu_torch.checkpoint import (
    checkpoint_path, latest_step, load_checkpoint, prune_checkpoints,
    save_checkpoint, snapshot_flags, wait_for_checkpoints)
from edgedict_tpu_torch.compat import (
    optim_state_from_jax, state_dict_from_jax_params)
from edgedict_tpu_torch.config import (
    feature_config_from_flags, transducer_config_from_flags)
from edgedict_tpu_torch.data import (
    BucketSpec, CommonVoice, DataLoader, Librispeech, MergedDataset,
    TEDLIUM, YoutubeCaption)
from edgedict_tpu_torch.features import FeaturePipeline
from edgedict_tpu_torch.jax_checkpoint import (
    is_jax_checkpoint, load_jax_checkpoint)
from edgedict_tpu_torch.models.transducer import build_optimizer
from edgedict_tpu_torch.metrics import compute_measures
from edgedict_tpu_torch.stream import resolve_device
from edgedict_tpu_torch.tokenizer import (
    PAD, CharTokenizer, HuggingFaceTokenizer)
from edgedict_tpu_torch.train import (
    broadcast_module, device_batch, make_beam_eval_step, make_eval_step,
    make_train_state, make_train_step, prefetch_batches, world)

AUGMENT_SEED = 1234
PROFILE_STEPS = (10, 13)     # the trace covers the steps after 10, to 13


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


def tokenizer_built(tokenizer):
    """False for a tokenizer that found no cache and awaits build()."""
    return getattr(tokenizer, 'token2id', True) is not None and \
        getattr(tokenizer, 'tokenizer', True) is not None


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


def pick_accum_steps(batch_size, sub_batch_size, pp=1):
    """Accumulation steps: the fewest that make the micro-batch (an equal
    split of the batch) at most sub_batch_size; with pp > 1 the fewest
    such that are a multiple of pp where one exists, as the accumulation
    micro-batches stream through the pipeline stages (trainer.py:80-108,
    one process of the dp axis)."""
    def search(fits):
        for accum in range(1, batch_size + 1):
            if batch_size % accum == 0 and fits(accum) \
                    and batch_size // accum <= sub_batch_size:
                return accum
        return None

    found = search(lambda a: a % pp == 0) if pp > 1 else None
    if found is None:
        found = search(lambda a: True)
    if found is None:
        raise ValueError(f'no micro-batch <= sub_batch_size={sub_batch_size} '
                         f'divides batch_size={batch_size}')
    return found


def truncate_and_strip(y_seq, out_len, blank=0):
    """Per sample: frames < out_len, blanks dropped (decoding.py:88-99)."""
    y_seq, out_len = np.asarray(y_seq), np.asarray(out_len)
    return [seq[:int(n)][seq[:int(n)] != blank]
            for seq, n in zip(y_seq, out_len)]


class IndexBatches:
    """The --device_corpus loader: {'idx': (B,) int32} batches in the order
    the wrapped DataLoader yields its host batches (its shuffle, pools and
    epoch counter), so resume replay is unchanged (trainer.py:112-137)."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    @property
    def epoch(self):
        return self.loader.epoch

    @epoch.setter
    def epoch(self, value):
        self.loader.epoch = value

    def __iter__(self):
        batches = self.loader._batches_indices()
        self.loader.epoch += 1
        for idxs in batches:
            yield {'idx': np.asarray(idxs, np.int32)}


def summary_writer(logdir):
    """A tensorboardX SummaryWriter on logdir, or None when tensorboardX
    does not import (trainer.py:199-205)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


def error_counts(refs, hyps):
    """(word errors, reference words, pairs) of the pairs whose reference
    is not blank: the sums a corpus WER is made of, which ranks add up."""
    pairs = [(r, h) for r, h in zip(refs, hyps) if r.strip()]
    if not pairs:
        return 0, 0, 0
    m = compute_measures([r for r, _ in pairs], [h for _, h in pairs])
    return (m['substitutions'] + m['deletions'] + m['insertions'],
            m['hits'] + m['substitutions'] + m['deletions'], len(pairs))


def corpus_wer(errors, words, pairs, empty):
    """WER of summed error counts (metrics.wer's value); `empty` when no
    pair had a reference."""
    return errors / max(words, 1) if pairs else empty


class Trainer:
    def __init__(self, flags, train_datasets=None, eval_dataset=None):
        """train_datasets / eval_dataset: the corpora (cli/distributed.py
        hands each rank its shards); None = build_datasets of the flags."""
        self.flags = flags
        self.logdir = os.path.join(flags.logdir_root, flags.name)
        tp, pp = flags.tp_size, flags.pp_size
        self.layout = parallel.make_layout(tp, pp, parallel.grid_devices(
            resolve_device(flags.device), tp * pp))
        self.device = self.layout.home
        self.rank, self.world = world()
        if self.world > 1 and flags.device_corpus:
            raise ValueError('--device_corpus is one process: shard the '
                             'corpora over the ranks with the host loader '
                             'instead')
        os.makedirs(self.logdir, exist_ok=True)

        given = train_datasets is not None
        if not given:
            self.tokenizer = build_tokenizer(flags)
            train_datasets, eval_dataset = build_datasets(flags,
                                                          self.tokenizer)
        self.train_dataset = MergedDataset(train_datasets)
        if given:             # the tokenizer that encodes their labels
            self.tokenizer = self.train_dataset.tokenizer or \
                build_tokenizer(flags)
        self.eval_dataset = eval_dataset
        if not tokenizer_built(self.tokenizer):
            self.tokenizer.build(self.train_dataset.texts())

        self.accum_steps = pick_accum_steps(flags.batch_size,
                                            flags.sub_batch_size,
                                            pp=self.layout.pp)
        self._build_model_and_steps()
        broadcast_module(self.state.model)
        self.last_beam_wer = None
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
            workers=max(1, flags.num_workers),
            pin_memory=self.device.type == 'cuda')
        self.eval_loader = DataLoader(
            self.eval_dataset, flags.eval_batch_size, shuffle=False,
            bucket=self.bucket, drop_last=True,
            prefetch=0) if self.eval_dataset is not None else None
        # the batches of an epoch: the fewest of any rank's loader
        self.epoch_steps = len(self.loader)
        if self.world > 1:
            self.epoch_steps = int(self._all_reduce([self.epoch_steps],
                                                    dist.ReduceOp.MIN)[0])
        self.device_corpus = None
        if flags.device_corpus:
            self._build_device_corpus()
        self.writer = None
        if self.rank == 0:
            self.writer = summary_writer(self.logdir)
            snapshot_flags(flags, self.logdir)
        self.generator = torch.Generator(device=self.device).manual_seed(
            AUGMENT_SEED + self.rank)
        self._skip_batches = 0
        self._best_wer = float('inf')

    def _build_model_and_steps(self):
        """Featurizer, model config, train state and the train / eval /
        beam-eval steps (raw_trainer.py overrides this)."""
        flags = self.flags
        self.feature_cfg = feature_config_from_flags(flags)
        self.pipeline = FeaturePipeline(self.feature_cfg, self.device)
        self.cfg = transducer_config_from_flags(
            flags, self.tokenizer.vocab_size, self.feature_cfg.input_size)
        self.optimizer = build_optimizer(
            self.cfg, flags.optim, gradclip=flags.gradclip,
            shards=parallel.vocab_shards(self.cfg, self.layout))
        self.state = make_train_state(self.cfg, self.optimizer, self.device,
                                      layout=self.layout)
        if self.layout.pp > 1:
            from edgedict_tpu_torch.parallel.pipeline import (
                make_train_step_pp)
            # the accumulation micro-batches are the pipeline's microbatches
            self.train_step = make_train_step_pp(
                self.cfg, self.optimizer, self.layout, bf16=flags.bf16,
                feature_pipeline=self.pipeline)
        else:
            self.train_step = make_train_step(self.cfg, self.optimizer,
                                              bf16=flags.bf16,
                                              feature_pipeline=self.pipeline)
        self.eval_step = make_eval_step(self.cfg, self.pipeline)
        self.beam_eval_step = make_beam_eval_step(
            self.cfg, flags.eval_beam_width, self.pipeline) \
            if flags.eval_beam_width > 0 else None

    def _build_device_corpus(self):
        """Every training sample padded to one (L_max, U_max) (the bucket's
        rounding; ys PAD-filled as seq_collate does, so a gathered batch
        equals the host loader's where the lengths are uniform) and put on
        the device once; the loader then yields index batches."""
        ds = self.train_dataset
        n = len(ds)
        pool, fetch = self.loader._fetcher()
        try:
            items = fetch(list(range(n)))
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
        l_max = self.bucket.round_t(max(len(a) for a, _ in items))
        u_max = self.bucket.round_u(max(len(t) for _, t in items))
        a_dtype = np.int16 if items[0][0].dtype == np.int16 else np.float32
        audio = np.zeros((n, l_max), a_dtype)
        alen = np.zeros((n,), np.int32)
        ys = np.full((n, u_max), PAD, np.int32)
        ylen = np.zeros((n,), np.int32)
        for i, (a, t) in enumerate(items):
            audio[i, :len(a)] = a
            alen[i] = len(a)
            ys[i, :len(t)] = t
            ylen[i] = len(t)
        print(f'device_corpus: {n} utts padded to L={l_max} U={u_max} '
              f'({audio.nbytes / 1e9:.2f} GB audio on device)')
        self.device_corpus = {
            k: torch.from_numpy(v).to(self.device)
            for k, v in (('audio', audio), ('alen', alen), ('ys', ys),
                         ('ylen', ylen))}
        self.loader = IndexBatches(self.loader)

    def gather(self, idx):
        """An index batch → the (accum, micro, ...) device batch, gathered
        from the device corpus."""
        idx = torch.as_tensor(np.asarray(idx).reshape(self.accum_steps, -1)
                              ).to(self.device)
        return {k: v[idx] for k, v in self.device_corpus.items()}

    def device_batches(self, batches):
        """Loader batches → device batches: gathered on the device
        (--device_corpus), else copied one ahead (prefetch_batches)."""
        if self.device_corpus is not None:
            return (self.gather(b['idx']) for b in batches)
        return prefetch_batches(batches, self.accum_steps, self.device)

    # ------------------------------------------------------------------
    def _lr(self, step):
        lr = self.flags.lr * optim.warmup_scale(step, self.flags.warmup_step)
        if self.sched is not None:
            lr = max(lr * self.sched.scale, self.flags.sched_min_lr)
        return lr

    def run_step(self, batch):
        """One optimizer step on a host batch dict (audio/alen/ys/ylen) or,
        with --device_corpus, an index batch {'idx': (B,)}."""
        if self.device_corpus is not None and 'idx' in batch:
            dev = self.gather(batch['idx'])
        else:
            dev = device_batch(batch, self.accum_steps, self.device)
        return self.run_device_step(dev)

    def run_device_step(self, dev):
        """One optimizer step on an (accum, micro, ...) device batch."""
        self.state, metrics = self.train_step(
            self.state, dev, self._lr(self.state.step), self.generator)
        return metrics

    def _all_reduce(self, values, op=dist.ReduceOp.SUM):
        """Reduce a list of numbers across the ranks (float64 on this
        device) → the list."""
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op)
        return t.tolist()

    def _barrier(self):
        if self.world > 1:
            dist.barrier()

    def _loader_batches(self):
        """The loader's batches of an epoch (epoch_steps of them) after the
        resume's fast-forward."""
        for batch in itertools.islice(self.loader, self.epoch_steps):
            if self._skip_batches:
                self._skip_batches -= 1     # resume: skip to the
                continue                    # checkpointed position
            yield batch

    def _profiler(self):
        """A torch.profiler of the card (and the host) writing a chrome
        trace under --profile_dir when it stops."""
        from torch.profiler import ProfilerActivity, profile
        out = self.flags.profile_dir
        os.makedirs(out, exist_ok=True)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == 'cuda' else [])
        first, last = PROFILE_STEPS
        return profile(activities=acts, on_trace_ready=lambda p:
                       p.export_chrome_trace(os.path.join(
                           out, f'trace_steps_{first + 1}-{last}.json')))

    def train(self, total_steps=None, log_fn=print):
        f = self.flags
        total = total_steps or f.epochs * max(self.epoch_steps, 1)
        t0 = time.time()
        prof, profiled = None, not f.profile_dir
        try:
            while self.state.step < total:
                batches = self.device_batches(self._loader_batches())
                for dev in batches:
                    # a torch.profiler trace of steps 11-13
                    if not profiled and self.state.step == PROFILE_STEPS[0]:
                        prof, profiled = self._profiler(), True
                        prof.start()
                    metrics = self.run_device_step(dev)
                    step = self.state.step
                    if prof is not None and step == PROFILE_STEPS[1]:
                        self._stop_profiler(prof)
                        prof = None
                    if step % f.loss_step == 0 and self.rank == 0:
                        loss = float(metrics['loss'])
                        if self.writer:
                            self.writer.add_scalar('train_loss', loss, step)
                            self.writer.add_scalar('lr', self._lr(step),
                                                   step)
                        log_fn(f'step {step}/{total} loss {loss:.4f} lr '
                               f'{self._lr(step):.2e} '
                               f'({time.time() - t0:.1f}s)')
                    if step % f.save_step == 0:
                        # the snapshot is taken here, the write runs on
                        # the writer thread
                        self.save(background=True)
                        if self.rank == 0:
                            prune_checkpoints(self.logdir, f.keep_checkpoints)
                    if step % f.eval_step == 0 and self.eval_loader:
                        self._eval_and_keep_best(step, log_fn)
                    if step >= total:
                        break
                batches.close()
        finally:
            if prof is not None:       # the run ended inside the window
                self._stop_profiler(prof)
        self.save()
        wait_for_checkpoints()
        self._barrier()

    def _stop_profiler(self, prof):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        prof.stop()

    def _eval_and_keep_best(self, step, log_fn):
        val_loss, val_wer = self.evaluate()
        if self.sched is not None:
            self.sched.step(val_loss)
        if self.writer:
            self.writer.add_scalar('val_loss', val_loss, step)
            self.writer.add_scalar('WER', val_wer, step)
        rank = f'[rank {self.rank}/{self.world}] ' if self.world > 1 else ''
        log_fn(f'{rank}eval @ {step}: loss {val_loss:.4f} '
               f'WER {val_wer:.4f}{self.beam_wer_text()}')
        if val_wer < self._best_wer:
            # the best-WER copy is written synchronously, as in JAX
            self._best_wer = val_wer
            path = self.save()
            if self.rank == 0:
                shutil.copy(path, os.path.join(self.logdir, 'best.ckpt'))

    # ------------------------------------------------------------------
    def beam_wer_text(self):
        """' beam_WER x' after an evaluate() that decoded with beam, else
        '' (the JAX package's eval log format)."""
        return (f' beam_WER {self.last_beam_wer:.4f}'
                if self.last_beam_wer is not None else '')

    def evaluate(self, max_batches=None):
        """→ (mean loss, corpus WER of the greedy decode); with
        --eval_beam_width > 0 the beam decode's WER goes to
        last_beam_wer.  Under a process group each rank decodes its shard
        and the sums behind these numbers are added across the ranks, so
        every rank returns the same values."""
        losses, refs, hyps, beam_hyps = [], [], [], []
        model = self.eval_model()
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
            if self.beam_eval_step is not None:
                toks, n_tok = self.beam_eval_step(model, dev)
                beam_hyps.extend(self.tokenizer.decode_plus(
                    [t[:n] for t, n in zip(toks.cpu().numpy(),
                                           n_tok.cpu().numpy())]))
        sums = [float(np.sum(losses)), len(losses),
                *error_counts(refs, hyps), *error_counts(refs, beam_hyps)]
        if self.world > 1:
            sums = self._all_reduce(sums)
        loss_sum, n_losses = sums[:2]
        val_wer = corpus_wer(*sums[2:5], empty=1.0)
        self.last_beam_wer = corpus_wer(*sums[5:], empty=None)
        if self.writer and self.last_beam_wer is not None:
            self.writer.add_scalar('beam_WER', self.last_beam_wer,
                                   self.state.step)
        pairs = [(r, h) for r, h in zip(refs, hyps) if r.strip()]
        if self.writer and pairs:
            sample = '\n\n'.join(f'REF: {r}\nHYP: {h}' for r, h in
                                  pairs[:self.flags.sample_size])
            self.writer.add_text('samples', sample, self.state.step)
        return (loss_sum / n_losses if n_losses else float('nan'),
                val_wer)

    def eval_model(self):
        """The model that evaluation runs: the train state's, or on a grid
        of several devices a gathered one-device copy on the home device
        (the greedy decode's K3 takes the whole joint)."""
        model = self.state.model
        if len(self.layout.devices) == 1:
            return model
        return parallel.gathered_model(model, self.device)

    # ------------------------------------------------------------------
    def save(self, background=False):
        """Rank 0 writes the checkpoint (with every rank's augmentation
        generator state); → its path on every rank."""
        extra = {'generator': self.generator.get_state(),
                 'best_wer': self._best_wer}
        if self.world > 1:
            states = [None] * self.world
            dist.all_gather_object(states, extra['generator'])
            extra['generators'] = states
        if self.rank == 0:
            path = save_checkpoint(
                self.logdir, self.state.step, self.state.model.state_dict(),
                optim.join_shards(self.state.opt_state,
                                  self.optimizer.shards),
                self.sched.state_dict() if self.sched else None,
                extra=extra, background=background)
        else:
            path = checkpoint_path(self.logdir, self.state.step)
        self._barrier()
        return path

    def load(self, step=None, log_fn=print):
        wait_for_checkpoints()        # a resume in this process sees them
        self._barrier()               # and the other ranks see rank 0's
        step = step if step is not None else latest_step(self.logdir)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {self.logdir}')
        path = checkpoint_path(self.logdir, step)
        model = self.state.model
        if is_jax_checkpoint(path):
            payload = load_jax_checkpoint(path)
            model.load_state_dict(state_dict_from_jax_params(
                payload['model']))
            opt_state = None if payload['optim'] is None else \
                optim_state_from_jax(payload['optim'], self.optimizer,
                                     model.state_dict())
            log_fn('JAX checkpoint: its augmentation rng cannot seed a '
                   f'torch.Generator; augmentation restarts from seed '
                   f'{AUGMENT_SEED}')
        else:
            payload = load_checkpoint(path)
            model.load_state_dict(payload['model'])
            opt_state = payload['optim']
        params = dict(model.named_parameters())
        if opt_state is None:                   # model-only checkpoint
            opt_state = self.optimizer.init(params)
        else:                                   # the one-device layout
            opt_state = optim.place_state(optim.split_shards(
                opt_state, self.optimizer.shards), params)
        self.state = type(self.state)(model, opt_state, int(payload['step']))
        if self.sched is not None and payload['sched'] is not None:
            self.sched.load_state_dict(payload['sched'])
        extra = payload.get('extra') or {}
        if len(extra.get('generators') or ()) == self.world:
            self.generator.set_state(extra['generators'][self.rank])
        elif 'generator' in extra:
            self.generator.set_state(extra['generator'])
        if extra.get('best_wer') is not None:
            self._best_wer = float(extra['best_wer'])
        broadcast_module(model)
        # replay the batch sequence an uninterrupted run would have seen
        n = max(self.epoch_steps, 1)
        self.loader.epoch = step // n
        self._skip_batches = step % n
        return step

