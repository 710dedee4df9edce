"""Build and load the port's CUDA kernels.

All `csrc/*.cu` sources compile with nvcc into ONE shared library with a
plain C interface, loaded with ctypes (no PyTorch headers: the build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o libedgedict_kernels-<hash>.so csrc/*.cu

The library is built at first use into `edgedict_tpu_torch/_build/`
(gitignored), keyed by a hash of the sources and flags, so an edit to any
kernel rebuilds and an unchanged tree reuses the build.  A missing nvcc
or a failed compile raises; nothing is downloaded.

Every C entry returns `cudaGetLastError()` after its launches; `check`
raises when it is not 0.  Pointers and the stream go in as
`ctypes.c_void_p` (a plain int argument would be cut to 32 bits).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, '_build')
SOURCES = ('lstm_fwd.cu', 'mel_power.cu', 'greedy_decode.cu')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xp, w_hh, h0, c0, ys, cs, hbuf, T, B, H, bf16, stream
    'edd_lstm_fwd': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # audio_p, Lp, wcos, wsin, mel_t, out, B, T, n_fft, hop, n_freq,
    # n_mels, stream
    'edd_mel_power': (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # f, T, B, J, w_dec_t, b_joint, w_out_t, b_out, V, table, E,
    # L, w_ih_t[L], w_hh_t[L], bias[L], H, w_proj_t, b_proj, D,
    # h_dec0, hs0, cs0, tokens, logp, h_dec, hs, cs, blank, unk, stream
    'edd_greedy_decode': (
        _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I,
        _I, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_P),
        _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
# {'seconds': float, 'path': str, 'log': str, 'cached': bool}
build_info = {}


def nvcc_path():
    """nvcc from PATH, else from CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.isfile(cand):
        return cand
    raise RuntimeError('nvcc not found (PATH, CUDA_HOME): the CUDA kernels '
                       'of edgedict_tpu_torch cannot be built')


def source_hash():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), 'rb') as f:
            h.update(name.encode() + b'\0' + f.read())
    return h.hexdigest()[:16]


def _compile(out_path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out_path}.{os.getpid()}.tmp'
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp,
           *[os.path.join(CSRC, s) for s in SOURCES]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f'nvcc failed ({r.returncode}):\n{log[-8000:]}')
    # the log first: a concurrent process that finds the library reads it
    with open(f'{out_path}.log.{os.getpid()}', 'w') as f:
        f.write(log)
    os.replace(f'{out_path}.log.{os.getpid()}', out_path + '.log')
    os.replace(tmp, out_path)
    return seconds, log


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = os.path.join(BUILD_DIR,
                                f'libedgedict_kernels-{source_hash()}.so')
            cached = os.path.isfile(path)
            if cached:
                seconds = 0.0
                with open(path + '.log') as f:
                    log = f.read()
            else:
                seconds, log = _compile(path)
            lib = ctypes.CDLL(path)
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            build_info.update(seconds=seconds, path=path, log=log,
                              cached=cached)
            _lib = lib
    return _lib


def check(err, name):
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')


def ptr(t):
    """Device pointer of a tensor (None → NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(t, name, dtypes):
    """Validate one kernel argument: CUDA, contiguous, allowed dtype."""
    if t.device.type != 'cuda':
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')
    if t.dtype not in dtypes:
        raise ValueError(f'{name}: dtype {t.dtype} not in {dtypes}')
