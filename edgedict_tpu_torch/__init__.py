"""edgedict_tpu_torch — the PyTorch + CUDA port of edgedict_tpu.

The JAX package `edgedict_tpu/` stays the reference; every module here has
a counterpart of the same name there (`features.py` ↔ `features.py`,
`ops/rnn.py` ↔ `ops/rnn.py`, ...).  The port runs the streaming greedy
serving path, beam search with RNN-LM shallow fusion, the training step of
the reference presets, wav2vec 2.0 pretraining and the raw-waveform
fine-tune on an NVIDIA H100 (LSTM or GRU encoder, fp32, bf16 or int8
weight-only), data-parallel training over processes (cli/distributed.py),
tensor and pipeline parallelism over each process's devices (parallel/)
and serving sharded over devices: the Pallas
kernels on those paths are hand-written CUDA kernels for `sm_90a`
(`csrc/*.cu`), built with nvcc at first use (`_build.py`) and bound with
ctypes.  Each kernel wrapper runs its plain PyTorch version for CPU tensors
(the CPU tests hold that against JAX) and launches the kernel for CUDA
tensors.

This package imports torch and numpy and nothing of the JAX package: what
it needs of the JAX package's JAX-free modules it keeps as its own copies
(`tokenizer.py`, `serving.py`, `metrics.py`, `text.py`, `data/`,
`utils/`, `_native.py`).
"""

__version__ = '0.1.0'
