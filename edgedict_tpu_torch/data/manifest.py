"""JSON manifest reader (counterpart of edgedict_tpu/data/manifest.py, a
copy: the reference parts/manifest.py:23-141 surface):
one JSON object per line with audio filepath(s), duration and transcript;
filters by min/max duration and optionally sorts by duration.
"""

import json

from edgedict_tpu_torch.text import english_cleaners


class Manifest:
    def __init__(self, manifest_paths, max_duration=None, min_duration=None,
                 sort_by_duration=False, max_utts=0, normalize=True):
        self.items = []
        duration = 0.0
        filtered = 0.0
        for path in manifest_paths:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    item = json.loads(line)
                    files = item.get('files')
                    if files is None:
                        files = [{'fname': item.get(
                            'audio_filepath', item.get('audio_filename')),
                            'duration': item.get('duration', 0)}]
                    dur = item.get('duration', 0.0)
                    if (min_duration is not None and dur < min_duration) or \
                            (max_duration is not None and dur > max_duration):
                        filtered += dur
                        continue
                    text = item.get('text',
                                    item.get('transcript', '')) or ''
                    self.items.append({
                        'files': files,
                        'duration': dur,
                        'text': english_cleaners(text) if normalize
                        else text,
                    })
                    duration += dur
                    if max_utts and len(self.items) >= max_utts:
                        break
        if sort_by_duration:
            self.items.sort(key=lambda x: x['duration'])
        self.duration = duration
        self.filtered_duration = filtered

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def __getitem__(self, i):
        return self.items[i]
