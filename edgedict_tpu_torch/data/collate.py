"""Batch collation with static-shape bucketing (counterpart of
edgedict_tpu/data/collate.py).

`seq_collate` keeps the reference contract (rnnt/dataset.py:202-240):
zero-pad audio to the batch max T (rounded up to a `BucketSpec` bucket),
PAD-fill token ids to max U, emit audio/alen/ys/ylen.  `DataLoader` is a
host-side loader: shuffling, length-sorted batching from pools, threaded
sample fetch and prefetch; with pin_memory=True (a CUDA trainer) its worker
hands over each batch as page-locked torch tensors, ready for an
asynchronous copy to the card.
"""

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from edgedict_tpu_torch.tokenizer import PAD


class BucketSpec:
    """Rounds (T, U) up to a fixed menu of shapes."""

    def __init__(self, t_multiple=16000, u_multiple=16,
                 t_max=None, u_max=None):
        self.t_multiple = t_multiple
        self.u_multiple = u_multiple
        self.t_max = t_max
        self.u_max = u_max

    def round_t(self, t):
        t = -(-t // self.t_multiple) * self.t_multiple
        return min(t, self.t_max) if self.t_max else t

    def round_u(self, u):
        u = -(-u // self.u_multiple) * self.u_multiple
        return min(u, self.u_max) if self.u_max else u


def pin_batch(batch):
    """A batch dict of arrays → page-locked CPU tensors."""
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in batch.items()}


def seq_collate(samples, bucket: BucketSpec = None, pad_id=PAD,
                audio_key='audio'):
    """samples: list of (audio (L,), tokens (U,)) → batch dict with
    '<audio_key>', '<audio_key[0]>len', 'ys', 'ylen' (reference seq_collate,
    rnnt/dataset.py:225-240, generalized to raw audio or features)."""
    audios, tokens = zip(*samples)
    b = len(samples)
    t_max = max(a.shape[0] for a in audios)
    u_max = max(len(t) for t in tokens) or 1
    if bucket is not None:
        t_max = bucket.round_t(t_max)
        u_max = bucket.round_u(u_max)

    feat_shape = audios[0].shape[1:]
    # int16 samples (decoded-PCM cache) stay int16 through collate and H2D;
    # the train step scales them to float on the device (features.pcm_to_float)
    dtype = np.int16 if audios[0].dtype == np.int16 else np.float32
    xs = np.zeros((b, t_max) + feat_shape, dtype)
    ys = np.full((b, u_max), pad_id, np.int32)
    xlen = np.zeros((b,), np.int32)
    ylen = np.zeros((b,), np.int32)
    for i, (a, t) in enumerate(zip(audios, tokens)):
        n = min(a.shape[0], t_max)
        u = min(len(t), u_max)
        xs[i, :n] = a[:n]
        ys[i, :u] = t[:u]
        xlen[i] = n
        ylen[i] = u
    key_len = 'alen' if audio_key == 'audio' else 'xlen'
    return {audio_key: xs, key_len: xlen, 'ys': ys, 'ylen': ylen}


class DataLoader:
    """Shuffled batching with threaded prefetch.

    sort_pool: batches are drawn from length-sorted pools of
    `sort_pool * batch_size` samples, so same-batch utterances have similar
    lengths (the token-budget intent of the reference's batch_by_size,
    rnnt/data_utils_fast.pyx:28-83) while retaining global shuffle.
    """

    def __init__(self, dataset, batch_size, shuffle=True, bucket=None,
                 seed=0, drop_last=True, sort_pool=8, prefetch=2,
                 collate_fn=None, audio_key='audio', workers=None,
                 pin_memory=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.bucket = bucket
        self.seed = seed
        self.drop_last = drop_last
        self.sort_pool = max(1, sort_pool)
        self.prefetch = prefetch
        self.audio_key = audio_key
        # parallel sample fetch: audio decode is the loader's hot path and
        # the native FLAC decoder (~1040 audio-s/s/thread) cannot feed the
        # ~8100 audio-s/s train step single-threaded; the ctypes decode
        # releases the GIL so a thread pool scales it (reference: torch
        # DataLoader num_workers processes, rnnt/dataset.py via
        # cli/baseline.py DataLoader(num_workers=...))
        self.workers = (workers if workers is not None
                        else min(8, os.cpu_count() or 1))
        self.collate_fn = collate_fn or (
            lambda s: seq_collate(s, bucket=self.bucket,
                                  audio_key=self.audio_key))
        self.pin_memory = pin_memory
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _batches_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        pool_size = self.sort_pool * self.batch_size
        batches = []
        for start in range(0, n, pool_size):
            pool = order[start:start + pool_size]
            # sort pool by cached audio length when available
            data = getattr(self.dataset, 'data', None)
            if data is not None:
                pool = sorted(pool,
                              key=lambda i: data[i]['audio_length'])
            for i in range(0, len(pool), self.batch_size):
                b = pool[i:i + self.batch_size]
                if len(b) == self.batch_size or not self.drop_last:
                    batches.append(list(b))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch + 12345)
            rng.shuffle(batches)
        return batches

    def _fetcher(self):
        """(pool, fetch) — fetch(idxs) loads a batch's samples, in order,
        decoding on `workers` threads when workers > 1."""
        if self.workers > 1:
            pool = ThreadPoolExecutor(self.workers)
            return pool, lambda idxs: list(
                pool.map(self.dataset.__getitem__, idxs))
        return None, lambda idxs: [self.dataset[i] for i in idxs]

    def _load(self, fetch, idxs):
        batch = self.collate_fn(fetch(idxs))
        return pin_batch(batch) if self.pin_memory else batch

    def __iter__(self):
        batches = self._batches_indices()
        self.epoch += 1
        pool, fetch = self._fetcher()
        if self.prefetch <= 0:
            try:
                for idxs in batches:
                    yield self._load(fetch, idxs)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)
            return

        q = queue.Queue(maxsize=self.prefetch)
        stop = object()
        error = []

        def worker():
            try:
                for idxs in batches:
                    q.put(self._load(fetch, idxs))
            except BaseException as e:     # surface in the consumer
                error.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
