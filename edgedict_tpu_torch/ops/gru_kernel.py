"""K5 — the GRU recurrence, forward (counterpart of
edgedict_tpu/ops/rnn_pallas.py:gru_recurrence_tm; kernel in
csrc/gru_fwd.cu).

`gru_recurrence` takes the hoisted input projection (b_ih included) and
runs the time recurrence with torch's gates r, z, n, b_hh applied inside
the reset gate.  CPU tensors run the plain loop below, which autograd
differentiates (GRU training on the CPU); CUDA tensors launch K5 inside a
`torch.autograd.Function` whose backward raises: the GRU backward kernel
(K6) is not ported yet.
"""

import torch

from edgedict_tpu_torch import _build


def gru_recurrence_plain(x_proj, w_hh, b_hh, h0):
    """x_proj (T, B, 3H) fp32/bf16 incl. b_ih, w_hh (3H, H) in the same
    dtype, b_hh (3H,) fp32, h0 (B, H) fp32 → ys (T, B, H) in x_proj's
    dtype.  h enters the recurrent product in w_hh's dtype, the product
    accumulates in fp32 and b_hh joins it in fp32 (what the TPU kernel and
    the CUDA kernel compute); the carried h is fp32, so ys[-1] is hT
    rounded to x_proj's dtype."""
    w = w_hh.float().t()
    b = b_hh.float()
    hid = h0.shape[-1]
    h = h0.float()
    ys = []
    for t in range(x_proj.shape[0]):
        h_proj = h.to(w_hh.dtype).float() @ w + b
        xp = x_proj[t].float()
        r = torch.sigmoid(xp[:, :hid] + h_proj[:, :hid])
        z = torch.sigmoid(xp[:, hid:2 * hid] + h_proj[:, hid:2 * hid])
        n = torch.tanh(xp[:, 2 * hid:] + r * h_proj[:, 2 * hid:])
        h = (1.0 - z) * n + z * h
        ys.append(h.to(x_proj.dtype))
    return torch.stack(ys)


def check_gru_args(x_proj, w_hh, b_hh, h0, w_dtypes):
    """Validate K5/K13 arguments on the card → (T, B, H)."""
    _build.require_cuda(x_proj, 'x_proj', (torch.float32, torch.bfloat16))
    _build.require_cuda(w_hh, 'w_hh', w_dtypes)
    _build.require_cuda(b_hh, 'b_hh', (torch.float32,))
    _build.require_cuda(h0, 'h0', (torch.float32,))
    t, b, h3 = x_proj.shape
    hid = h3 // 3
    if t < 1 or b < 1 or h3 != 3 * hid or w_hh.shape != (h3, hid) \
            or b_hh.shape != (h3,) or h0.shape != (b, hid):
        raise ValueError(f'gru_recurrence: shapes x_proj {tuple(x_proj.shape)}'
                         f' w_hh {tuple(w_hh.shape)} b_hh '
                         f'{tuple(b_hh.shape)} h0 {tuple(h0.shape)}')
    return t, b, hid


def _gru_fwd_kernel(x_proj, w_hh, b_hh, h0):
    """K5: one step kernel per timestep, h ping-ponged between two fp32
    buffers."""
    t, b, hid = check_gru_args(x_proj, w_hh, b_hh, h0, (x_proj.dtype,))
    dev = x_proj.device
    ys = torch.empty((t, b, hid), dtype=x_proj.dtype, device=dev)
    hbuf = torch.empty((2, b, hid), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.check(_build.library().edd_gru_fwd(
        p(x_proj), p(w_hh), p(b_hh), p(h0), p(ys), p(hbuf), t, b, hid,
        int(x_proj.dtype == torch.bfloat16), _build.stream_ptr(dev)),
        'gru_fwd')
    gru_recurrence.launches += 1
    return ys


class _GRURecurrence(torch.autograd.Function):
    """Forward K5; no backward on the card yet."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, h0):
        return _gru_fwd_kernel(x_proj, w_hh, b_hh, h0)

    @staticmethod
    def backward(ctx, dys):
        raise NotImplementedError(
            'the GRU backward on CUDA needs kernel K6 '
            '(edgedict_tpu/ops/rnn_pallas.py:_gru_bwd_kernel), which is not '
            'ported yet (ROADMAP.md, Queue 2); GRU training runs on the CPU '
            'only')


def gru_recurrence(x_proj, w_hh, b_hh, h0):
    """See gru_recurrence_plain; CUDA tensors launch csrc/gru_fwd.cu (K5).
    Differentiable on the CPU only."""
    if x_proj.device.type == 'cpu':
        return gru_recurrence_plain(x_proj, w_hh, b_hh, h0)
    return _GRURecurrence.apply(x_proj, w_hh, b_hh, h0)


gru_recurrence.launches = 0
