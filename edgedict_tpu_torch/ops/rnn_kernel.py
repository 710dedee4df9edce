"""K1 — the LSTM recurrence, forward (counterpart of the forward half of
edgedict_tpu/ops/rnn_pallas.py; kernel in csrc/lstm_fwd.cu).

`lstm_recurrence` takes the hoisted input projection (bias included) and
runs the time recurrence: the plain PyTorch loop below for CPU tensors, the
CUDA kernel for CUDA tensors.  The device of the tensors decides; there is
no fallback from one to the other.
"""

import torch

from edgedict_tpu_torch import _build


def lstm_recurrence_plain(x_proj, w_hh, h0, c0):
    """x_proj (T, B, 4H) fp32/bf16 incl. bias, w_hh (4H, H) in the same
    dtype, h0/c0 (B, H) fp32 → (ys (T, B, H) in x_proj's dtype, cs (T, B, H)
    fp32, hT (B, H) fp32).  Gate order i,f,g,o; h enters the recurrent
    product in w_hh's dtype and the product accumulates in fp32 (what the
    TPU kernel and the CUDA kernel compute)."""
    w = w_hh.float().t()
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(x_proj.shape[0]):
        gates = x_proj[t].float() + h.to(w_hh.dtype).float() @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h.to(x_proj.dtype))
        cs.append(c)
    return torch.stack(ys), torch.stack(cs), h


def lstm_recurrence(x_proj, w_hh, h0, c0):
    """See lstm_recurrence_plain; CUDA tensors launch csrc/lstm_fwd.cu (one
    step kernel per timestep, h ping-ponged between two buffers)."""
    if x_proj.device.type == 'cpu':
        return lstm_recurrence_plain(x_proj, w_hh, h0, c0)
    dtypes = (torch.float32, torch.bfloat16)
    _build.require_cuda(x_proj, 'x_proj', dtypes)
    _build.require_cuda(w_hh, 'w_hh', (x_proj.dtype,))
    _build.require_cuda(h0, 'h0', (torch.float32,))
    _build.require_cuda(c0, 'c0', (torch.float32,))
    t, b, h4 = x_proj.shape
    hid = h4 // 4
    if t < 1 or b < 1 or h4 != 4 * hid or w_hh.shape != (h4, hid) \
            or h0.shape != (b, hid) or c0.shape != (b, hid):
        raise ValueError('lstm_recurrence: shapes x_proj '
                         f'{tuple(x_proj.shape)}'
                         f' w_hh {tuple(w_hh.shape)} h0 {tuple(h0.shape)}'
                         f' c0 {tuple(c0.shape)}')
    dev = x_proj.device
    ys = torch.empty((t, b, hid), dtype=x_proj.dtype, device=dev)
    cs = torch.empty((t, b, hid), dtype=torch.float32, device=dev)
    hbuf = torch.empty((2, b, hid), dtype=torch.float32, device=dev)
    lib = _build.library()
    p = _build.ptr
    _build.check(lib.edd_lstm_fwd(
        p(x_proj), p(w_hh), p(h0), p(c0), p(ys), p(cs), p(hbuf), t, b, hid,
        int(x_proj.dtype == torch.bfloat16), _build.stream_ptr(dev)),
        'lstm_fwd')
    lstm_recurrence.launches += 1
    return ys, cs, hbuf[(t - 1) % 2]


lstm_recurrence.launches = 0
