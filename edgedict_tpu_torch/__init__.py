"""edgedict_tpu_torch — the PyTorch + CUDA port of edgedict_tpu.

The JAX package `edgedict_tpu/` stays the reference; every module here has
a counterpart of the same name there (`features.py` ↔ `features.py`,
`ops/rnn.py` ↔ `ops/rnn.py`, ...).  The port runs the streaming greedy
serving path and the training step of the reference presets on an NVIDIA
H100: the Pallas kernels on those paths are hand-written CUDA kernels for
`sm_90a` (`csrc/*.cu`), built with nvcc at first use (`_build.py`) and
bound with ctypes.  Each kernel wrapper runs its plain PyTorch version for CPU tensors
(the CPU tests hold that against JAX) and launches the kernel for CUDA
tensors.

This package imports torch and numpy, and from the JAX package only its
JAX-free modules (`edgedict_tpu.tokenizer`, `edgedict_tpu.serving`,
`edgedict_tpu.data`, `edgedict_tpu.metrics`).
"""

__version__ = '0.1.0'
