"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles with its own nvcc process, all started
together, into an object; one more nvcc links them into ONE shared library
with a plain C interface, loaded with ctypes (no PyTorch headers: the build
takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o
         libedgedict_kernels-<hash>.so *.o

The library is built at first use into `edgedict_tpu_torch/_build/`
(gitignored), keyed by a hash of the sources, the headers they include
(`HEADERS`) and the flags, so an edit to any kernel or header rebuilds and
an unchanged tree reuses the build.  A missing nvcc or a failed compile
raises; nothing is downloaded.

Every C entry returns `cudaGetLastError()` after its launches; `check`
raises when it is not 0.  The entries launch on the CUDA runtime's
current device, so every wrapper that calls one runs under
`on_tensor_device` (its tensors' card made current, as a replica on
cuda:1 needs).  Pointers and the stream go in as
`ctypes.c_void_p` (a plain int argument would be cut to 32 bits).
"""

import contextlib
import ctypes
import functools
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
SOURCES = ('rnn_fwd.cu', 'rnn_bwd.cu', 'mel_power.cu', 'greedy_decode.cu',
           'joint_lse.cu', 'rnnt_loss.cu', 'quant_matmul.cu')
HEADERS = ('rnn_common.cuh', 'mma_tile.cuh')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                           '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xp, w_hh, h0e, c0, ys, cs, hT, T, B, H, bf16, grid, smem, stream
    'edd_lstm_fwd': (_P,) * 7 + (_I,) * 6 + (_P,),
    # xp, w_q, w_scale, h0e, c0, ys, cs, hT, T, B, H, bf16, grid, smem,
    # stream
    'edd_lstm_fwd_q': (_P,) * 8 + (_I,) * 6 + (_P,),
    # xp, w_hh, b_hh, h0e, h0, ys, T, B, H, bf16, grid, smem, stream
    'edd_gru_fwd': (_P,) * 6 + (_I,) * 6 + (_P,),
    # xp, w_q, w_scale, b_hh, h0e, h0, ys, T, B, H, bf16, grid, smem,
    # stream
    'edd_gru_fwd_q': (_P,) * 7 + (_I,) * 6 + (_P,),
    # cell (0 LSTM, 1 GRU, 2 int8 LSTM, 3 int8 GRU), bf16, smem, out (int*)
    'edd_rnn_fwd_blocks_per_sm': (_I, _I, _I, _P),
    # x, wq, scale, bias, out, R, K, N, bf16, tiled, stream
    'edd_quant_matmul': (_P,) * 5 + (_I,) * 5 + (_P,),
    # xp, w_hh, h0e, c0, ys, cs, dys, dcs, dhT, hproj, dgates, dh0, dc0,
    # T, B, H, bf16, grid, smem, stream
    'edd_lstm_bwd': (_P,) * 13 + (_I,) * 6 + (_P,),
    # xp, w_hh, b_hh, h0e, ys, dys, dhT, hproj, dgx, dgh, dh0,
    # T, B, H, bf16, grid, smem, stream
    'edd_gru_bwd': (_P,) * 11 + (_I,) * 6 + (_P,),
    # gru, bf16, smem, out (int*)
    'edd_rnn_bwd_blocks_per_sm': (_I, _I, _I, _P),
    # f, g, wt, bias, labels, blank_lp, label_lp, lse, hs, B, T, U1, J, V,
    # blank, r_t, r_u, ldh, slab_tiles, bf16, stream
    'edd_joint_lse_fwd': (_P,) * 9 + (_I,) * 11 + (_P,),
    # f, g, wt, w, bias, labels, lse, d_blank, d_label, df, dg, dw, dbias,
    # hs, dls, dw_part, dbias_part, dfdg_part, B, T, U1, J, V, blank, r_t,
    # r_u, slab_tiles, dw_split, bf16, stream
    'edd_joint_lse_bwd': (_P,) * 18 + (_I,) * 11 + (_P,),
    # blank, label, xlen, ylen, alpha, logz, B, T, U1, warps, items, stream
    'edd_lattice_alpha': (_P,) * 6 + (_I,) * 5 + (_P,),
    # blank, label, alpha, logz, xlen, ylen, gb, gl, B, T, U1, warps,
    # items, stream
    'edd_lattice_beta_grad': (_P,) * 8 + (_I,) * 5 + (_P,),
    # audio, dft, mel_t, band, out, part, count, L, T, n_fft, hop, M, nbp,
    # rg, cg, S, passes, slices, kc, tiles_per_row, span, blocks, smem,
    # stream
    'edd_mel_power': (_P,) * 7 + (_I,) * 16 + (_P,),
    # f, T, B, J, w_dec_t, b_joint, w_out_t, b_out, V, table, E,
    # L, w_ih_t[L], w_hh_t[L], bias[L], H, w_proj_t, b_proj, D,
    # h_dec0, hs0, cs0, tokens, logp, h_dec, hs, cs, blank, unk,
    # scratch, scratch_floats, grid, bc, pc, smem, stream
    'edd_greedy_decode': (
        _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I,
        _I, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_P),
        _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _P, ctypes.c_longlong, _I, _I, _I, _I, _P),
    # unused, unused, smem, out (int*)
    'edd_greedy_decode_blocks_per_sm': (_I, _I, _I, _P),
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
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), 'rb') as f:
            h.update(name.encode() + b'\0' + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands concurrently; → [(returncode, output)]."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    return [(p.returncode, out) for p, out in
            ((p, p.communicate()[0]) for p in procs)]


def _compile(out_path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f'{out_path}.{os.getpid()}'
    nvcc = nvcc_path()
    objs = [f'{tag}.{name}.o' for name in SOURCES]
    t0 = time.perf_counter()
    try:
        results = _run_all([[nvcc, *NVCC_FLAGS, '-c', os.path.join(CSRC, name),
                             '-o', obj] for name, obj in zip(SOURCES, objs)])
        log = ''.join(out for _, out in results)
        failed = [f'{name}:\n{out[-4000:]}' for name, (rc, out)
                  in zip(SOURCES, results) if rc != 0]
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
        tmp = f'{tag}.tmp'
        (rc, out), = _run_all([[nvcc, *ARCH_FLAGS, '-shared', '-o', tmp,
                                *objs]])
        log += out
        if rc != 0:
            raise RuntimeError(f'nvcc link failed ({rc}):\n{out[-8000:]}')
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
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
            lib.edd_error_string.argtypes = [_I]
            lib.edd_error_string.restype = ctypes.c_char_p
            build_info.update(seconds=seconds, path=path, log=log,
                              cached=cached)
            _lib = lib
    return _lib


def check(err, name):
    if err != 0:
        what = _lib.edd_error_string(err).decode() if _lib else ''
        raise RuntimeError(f'{name}: CUDA error {err} at launch ({what})')


def ptr(t):
    """Device pointer of a tensor (None → NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def on_device(device):
    """A context that makes `device` the current CUDA device (a null
    context for a CPU device)."""
    device = torch.device(device)
    if device.type != 'cuda':
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def on_tensor_device(fn):
    """Decorator of a kernel wrapper: run it with the device of its first
    tensor argument current, so its launches, plan queries and the stream
    of stream_ptr all belong to that card."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        for a in args:
            if isinstance(a, torch.Tensor):
                if a.device.type != 'cuda':
                    break
                with torch.cuda.device(a.device):
                    return fn(*args, **kwargs)
        return fn(*args, **kwargs)
    return wrapper


def stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """The SM count of a CUDA device (cached: a launch plan reads it on
    every call)."""
    return _sm_count(torch.cuda.current_device() if device.index is None
                     else device.index)


def require_cuda(t, name, dtypes):
    """Validate one kernel argument: CUDA, contiguous, allowed dtype."""
    if t.device.type != 'cuda':
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')
    if t.dtype not in dtypes:
        raise ValueError(f'{name}: dtype {t.dtype} not in {dtypes}')
