"""Corpus datasets: LibriSpeech / TEDLIUM / CommonVoice / YouTubeCaption
(counterpart of edgedict_tpu/data/dataset.py).

The corpus layouts and index-cache behaviour of the reference
(rnnt/dataset.py:31-199): each dataset scans its corpus once via `build()`,
checks that files load at the expected sample rate, caches
`{path, text, audio_length}` records to a JSON index in the corpus root
(`index_v1_<session>.json`, the file the JAX package writes), then filters
by min/max audio seconds.  `__getitem__` returns the raw waveform and the
token ids: featurisation runs on the device inside the train step.

`cache_audio=True` also builds a decoded-PCM cache next to the index (one
contiguous int16 blob + an offsets array, built once by a thread pool,
memory-mapped thereafter): `__getitem__` then returns an int16 view, and
the int16 → float scaling happens on the device (features.pcm_to_float),
which halves the host→device bytes.
"""

import csv
import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from edgedict_tpu_torch.data.audio_io import load_audio

PCM_SCALE = 32768.0   # int16 cache quantization: x_int = round(x * 32768)
# (16-bit PCM WAV sources round-trip EXACTLY: load divides by 32768)


class AudioDataset:
    def __init__(self, root, tokenizer, session='', desc='AudioDataset',
                 transform=None, audio_min_length=0, audio_max_length=999,
                 sampling_rate=16000, reverse_sorted_by_length=False,
                 cache_audio=False):
        self.root = root
        self.sampling_rate = sampling_rate
        index_path = os.path.join(root, f'index_v1_{session}.json')

        if os.path.exists(index_path):
            with open(index_path) as f:
                data = json.load(f)
        else:
            data = []
            paths, texts = self.build()
            for path, text in zip(paths, texts):
                full_path = os.path.join(root, path)
                if not os.path.exists(full_path):
                    continue
                try:
                    audio, sr = load_audio(full_path)
                except Exception as e:
                    print(f'Fail to load {full_path}: {e}')
                    continue
                if sr != sampling_rate:
                    continue
                data.append({'path': path, 'text': text,
                             'audio_length': len(audio) // sr})
            with open(index_path, 'w') as f:
                json.dump(data, f)

        total_secs = filtered_secs = 0
        self.data = []
        for i, x in enumerate(data):
            x['cache_i'] = i      # position in the (unfiltered) index —
            if audio_min_length <= x['audio_length'] <= audio_max_length:
                self.data.append(x)
                total_secs += x['audio_length']
            else:
                filtered_secs += x['audio_length']
        print(f'Dataset : {desc}\n'
              f'size    : {len(self.data)}\n'
              f'Time    : {total_secs / 3600:.2f} hours\n'
              f'Filtered: {filtered_secs / 3600:.2f} hours\n' + '=' * 40)

        if reverse_sorted_by_length:
            self.data.sort(key=lambda x: x['audio_length'], reverse=True)
        self.transform = transform
        self.tokenizer = tokenizer

        self._pcm = self._pcm_off = None
        if cache_audio and data:
            self._open_pcm_cache(data, session)

    # -- decoded-PCM cache -------------------------------------------------
    def _open_pcm_cache(self, index_data, session):
        """Build (once) and mmap the decoded int16 PCM cache covering every
        index record, in index order.  Files: `pcm_v1_<session>.bin`
        (contiguous '<i2' samples) and `pcm_v1_<session>.off.npy`
        (int64 offsets, len N+1)."""
        bin_path = os.path.join(self.root, f'pcm_v1_{session}.bin')
        off_path = os.path.join(self.root, f'pcm_v1_{session}.off.npy')
        if not (os.path.exists(bin_path) and os.path.exists(off_path)):
            print(f'Building PCM cache for {len(index_data)} files '
                  f'-> {bin_path}')

            def decode(rec):
                audio, _ = load_audio(os.path.join(self.root, rec['path']))
                q = np.round(np.clip(audio, -1.0, 1.0) * PCM_SCALE)
                return np.clip(q, -32768, 32767).astype('<i2')

            offsets = np.zeros(len(index_data) + 1, np.int64)
            tmp = bin_path + '.tmp'
            with open(tmp, 'wb') as f, ThreadPoolExecutor(
                    min(8, os.cpu_count() or 1)) as pool:
                for i, pcm in enumerate(pool.map(decode, index_data)):
                    f.write(pcm.tobytes())
                    offsets[i + 1] = offsets[i] + len(pcm)
            np.save(off_path, offsets)
            os.replace(tmp, bin_path)      # offsets land before the blob
        self._pcm_off = np.load(off_path)
        if len(self._pcm_off) != len(index_data) + 1:
            raise RuntimeError(
                f'PCM cache {off_path} does not match the index '
                f'({len(self._pcm_off) - 1} vs {len(index_data)} records); '
                f'delete pcm_v1_{session}.* to rebuild')
        self._pcm = np.memmap(bin_path, '<i2', mode='r')

    def texts(self):
        return [x['text'] for x in self.data]

    def build(self):
        """Return (paths, texts); paths relative to self.root."""
        raise NotImplementedError

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        rec = self.data[idx]
        if self._pcm is not None:
            i = rec['cache_i']
            audio = self._pcm[self._pcm_off[i]:self._pcm_off[i + 1]]
            if self.transform is None:
                # int16 view straight off the mmap: the train step scales
                # to float on DEVICE (features.pcm_to_float)
                tokens = np.asarray(self.tokenizer.encode(rec['text']),
                                    np.int32)
                return audio, tokens
            audio = audio.astype(np.float32) / PCM_SCALE
        else:
            audio, _ = load_audio(os.path.join(self.root, rec['path']))
        if self.transform is not None:
            audio = self.transform(audio)
        tokens = np.asarray(self.tokenizer.encode(rec['text']), np.int32)
        return audio.astype(np.float32), tokens


class Librispeech(AudioDataset):
    """<root>/<spk>/<chap>/<spk>-<chap>.trans.txt + .flac utterances
    (reference rnnt/dataset.py:157-178)."""

    def __init__(self, root, tokenizer, *args, **kwargs):
        super().__init__(root, tokenizer, 'label', 'Librispeech',
                         *args, **kwargs)

    def build(self):
        paths, texts = [], []
        for trans_file in glob.glob(os.path.join(self.root, '*/*/*.txt')):
            dir2 = os.path.dirname(trans_file)
            dir1 = os.path.dirname(dir2)
            rel = os.path.join(os.path.basename(dir1),
                               os.path.basename(dir2))
            with open(trans_file) as f:
                for line in f:
                    filename, text = line.split(maxsplit=1)
                    # prefer .wav (preprocessed) over .flac
                    for ext in ('.wav', '.flac'):
                        p = os.path.join(rel, filename + ext)
                        if os.path.exists(os.path.join(self.root, p)):
                            paths.append(p)
                            texts.append(text.strip())
                            break
        return paths, texts


class TEDLIUM(AudioDataset):
    """<root>/wav/labels.txt lines '<file> <text>' (reference
    rnnt/dataset.py:181-199)."""

    def __init__(self, root, tokenizer, *args, **kwargs):
        super().__init__(root, tokenizer, 'label', 'TEDLIUM',
                         *args, **kwargs)

    def build(self):
        paths, texts = [], []
        with open(os.path.join(self.root, 'wav', 'labels.txt')) as f:
            for line in f:
                filename, text = line.split(maxsplit=1)
                paths.append(os.path.join('wav', filename))
                texts.append(text.strip())
        return paths, texts


class CommonVoice(AudioDataset):
    """<root>/<labels>.tsv with 'path'/'sentence' columns; clips under
    clips/, .mp3 → .wav (reference rnnt/dataset.py:134-154)."""

    def __init__(self, root, labels, tokenizer, *args, **kwargs):
        self.labels = labels
        super().__init__(root, tokenizer, labels.replace('.tsv', ''),
                         'CommonVoice', *args, **kwargs)

    def build(self):
        paths, texts = [], []
        with open(os.path.join(self.root, self.labels)) as f:
            for row in csv.DictReader(f, delimiter='\t'):
                filename = row['path'].replace('.mp3', '.wav')
                paths.append(os.path.join('clips', filename))
                texts.append(row['sentence'])
        return paths, texts


class YoutubeCaption(AudioDataset):
    """<root>/<labels>.csv with 'ID'/'Transcription' columns; wavs in the
    directory named by the csv prefix (reference rnnt/dataset.py:113-131)."""

    def __init__(self, root, labels, tokenizer, *args, **kwargs):
        self.labels = labels
        super().__init__(root, tokenizer, labels.replace('.csv', ''),
                         'YoutubeCaption', *args, **kwargs)

    def build(self):
        paths, texts = [], []
        wav_dir = self.labels.split('_')[0]
        with open(os.path.join(self.root, self.labels)) as f:
            for row in csv.DictReader(f):
                text = str(row['Transcription'])
                if ' ' in text:
                    paths.append(os.path.join(wav_dir, row['ID']))
                    texts.append(text)
        return paths, texts


class MergedDataset:
    """Concatenation of datasets + pooled texts for tokenizer training
    (reference rnnt/dataset.py:15-28)."""

    def __init__(self, datasets):
        self.datasets = [d for d in datasets if len(d) > 0]
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        self.tokenizer = self.datasets[0].tokenizer if self.datasets else None

    def texts(self):
        out = []
        for d in self.datasets:
            out.extend(d.texts())
        return out

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        k = int(np.searchsorted(self.offsets, idx, side='right')) - 1
        return self.datasets[k][idx - int(self.offsets[k])]
