"""Utility namespace (counterpart of edgedict_tpu/utils/__init__.py): the
metrics, text normalization and native bindings, re-exported from their
modules, and a scoped numpy seed."""

import contextlib

import numpy as _np

from edgedict_tpu_torch import _native as native  # noqa: F401
from edgedict_tpu_torch.metrics import cer, compute_measures, wer  # noqa: F401
from edgedict_tpu_torch.text import (  # noqa: F401
    collapse_whitespace, english_cleaners, normalize_numbers,
    number_to_words, ordinal_to_words)


@contextlib.contextmanager
def numpy_seed(seed, *extra):
    """Scoped numpy RNG seeding (the fairseq helper the reference carries
    at rnnt/data_utils.py:113-128): host-side data randomness made
    reproducible without clobbering the global state."""
    if seed is None:
        yield
        return
    for e in extra:
        seed = (seed * 16777619) ^ int(e)
    state = _np.random.get_state()
    _np.random.seed(seed & 0x7fffffff)
    try:
        yield
    finally:
        _np.random.set_state(state)
