"""Audio perturbations (counterpart of edgedict_tpu/data/perturb.py, a
copy: the reference parts/perturb.py:21-111 surface):
speed, gain and time-shift perturbations composed by an AudioAugmentor
that applies each with a probability.
"""

import numpy as np

from edgedict_tpu_torch.data.segment import AudioSegment, resample


class SpeedPerturbation:
    """Speed perturbation via resample-then-play-back (sox `speed`
    semantics: duration AND pitch both scale by the rate).

    DELIBERATE DEVIATION from the reference, which uses
    librosa.effects.time_stretch — a phase-vocoder stretch that changes
    duration while PRESERVING pitch (reference parts/perturb.py:42).
    Rationale: (1) the resample formulation is the one the ASR
    augmentation literature standardized on (Ko et al. 2015, "Audio
    augmentation for speech recognition", the Kaldi/sox recipe) because
    the correlated pitch shift adds speaker variability that
    pitch-preserving stretching suppresses; (2) a phase vocoder
    (STFT→phase-accumulate→iSTFT) adds transient smearing artifacts that
    the model would learn as channel characteristics; (3) it needs no
    librosa dependency — one polyphase resample (data/segment.py) does the
    job.  Same knobs, same default range, same probability gating as the
    reference; only the stretch algorithm differs.
    """

    def __init__(self, min_speed_rate=0.85, max_speed_rate=1.15, rng=None):
        self.min_rate = min_speed_rate
        self.max_rate = max_speed_rate
        self.rng = rng or np.random.RandomState()

    def perturb(self, segment: AudioSegment):
        rate = self.rng.uniform(self.min_rate, self.max_rate)
        if abs(rate - 1.0) < 1e-3:
            return
        sr = segment.sample_rate
        # speed change = resample to sr/rate then play back at sr
        segment._samples = resample(segment.samples, int(sr * rate), sr)


class GainPerturbation:
    def __init__(self, min_gain_dbfs=-10, max_gain_dbfs=10, rng=None):
        self.min_gain = min_gain_dbfs
        self.max_gain = max_gain_dbfs
        self.rng = rng or np.random.RandomState()

    def perturb(self, segment: AudioSegment):
        gain = self.rng.uniform(self.min_gain, self.max_gain)
        segment._samples = segment.samples * (10.0 ** (gain / 20.0))


class ShiftPerturbation:
    def __init__(self, min_shift_ms=-5.0, max_shift_ms=5.0, rng=None):
        self.min_shift = min_shift_ms
        self.max_shift = max_shift_ms
        self.rng = rng or np.random.RandomState()

    def perturb(self, segment: AudioSegment):
        ms = self.rng.uniform(self.min_shift, self.max_shift)
        shift = int(segment.sample_rate * ms / 1000.0)
        if abs(shift) >= len(segment.samples):
            return
        s = segment.samples
        out = np.zeros_like(s)
        if shift > 0:
            out[shift:] = s[:-shift]
        elif shift < 0:
            out[:shift] = s[-shift:]
        else:
            out = s
        segment._samples = out


_PERTURBATIONS = {
    'speed': SpeedPerturbation,
    'gain': GainPerturbation,
    'shift': ShiftPerturbation,
}


class AudioAugmentor:
    """Applies each registered perturbation with its probability
    (reference parts/perturb.py AudioAugmentor)."""

    def __init__(self, perturbations=None, rng=None):
        self.rng = rng or np.random.RandomState()
        self._pipeline = perturbations or []   # [(prob, perturbation)]

    @classmethod
    def from_config(cls, config, rng=None):
        rng = rng or np.random.RandomState()
        pipeline = []
        for name, spec in (config or {}).items():
            spec = dict(spec)
            prob = spec.pop('prob', 1.0)
            pipeline.append((prob, _PERTURBATIONS[name](rng=rng, **spec)))
        return cls(pipeline, rng)

    def perturb(self, segment: AudioSegment):
        for prob, p in self._pipeline:
            if self.rng.rand() <= prob:
                p.perturb(segment)
