"""Datasets, collation and audio I/O of the trainer and the CLIs
(counterpart of edgedict_tpu/data/, the parts the port uses)."""

from edgedict_tpu_torch.data.audio_io import load_audio, save_wav  # noqa: F401
from edgedict_tpu_torch.data.collate import (  # noqa: F401
    BucketSpec, DataLoader)
from edgedict_tpu_torch.data.dataset import (  # noqa: F401
    CommonVoice, Librispeech, MergedDataset, TEDLIUM, YoutubeCaption)
