"""K1 + K4 — the LSTM recurrence, forward and backward (counterpart of
edgedict_tpu/ops/rnn_pallas.py:lstm_recurrence_tm; kernels in
csrc/lstm_fwd.cu and csrc/lstm_bwd.cu).

`lstm_recurrence` takes the hoisted input projection (bias included) and
runs the time recurrence as a `torch.autograd.Function`: the forward is K1,
the backward K4 (the dh/dc chain, gates rematerialised from the saved ys),
and dW_hh is one matmul over all steps outside the kernel.  The plain
PyTorch loops below run for CPU tensors, the kernels for CUDA tensors.  The
device of the tensors decides; there is no fallback from one to the other.
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


def _lstm_fwd_kernel(x_proj, w_hh, h0, c0):
    """K1: one step kernel per timestep, h ping-ponged between two
    buffers."""
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


def lstm_recurrence_bwd_plain(x_proj, w_hh, h0, c0, ys, cs, dys, dcs, dhT):
    """The analytic reverse loop of rnn_pallas.py:_bwd_step.  Inputs as the
    forward's plus its outputs; the cotangents dys (T, B, H) in ys's dtype,
    dcs (T, B, H) fp32 and dhT (B, H) fp32 may each be None (zero).  The
    gates are rematerialised from ys as the forward formed them (h_{t-1} =
    ys[t-1], or h0 rounded to x_proj's dtype).  → (dgates (T, B, 4H) in
    x_proj's dtype, dh0 (B, H) fp32, dc0 (B, H) fp32)."""
    t_len, b, h4 = x_proj.shape
    hid = h4 // 4
    dtype = x_proj.dtype
    w = w_hh.float()
    h_prev = torch.cat([h0.to(dtype)[None], ys[:-1]]).float()
    gates = x_proj.float() + h_prev @ w.t()
    i = torch.sigmoid(gates[..., :hid])
    f = torch.sigmoid(gates[..., hid:2 * hid])
    g = torch.tanh(gates[..., 2 * hid:3 * hid])
    o = torch.sigmoid(gates[..., 3 * hid:])
    c_prev = torch.cat([c0.float()[None], cs[:-1]])
    dh = torch.zeros(b, hid, dtype=torch.float32, device=x_proj.device)
    dc = torch.zeros_like(dh)
    if dhT is not None:
        dh = dh + dhT.float()
    out = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        if dys is not None:
            dh = dh + dys[t].float()
        if dcs is not None:
            dc = dc + dcs[t]
        tc = torch.tanh(cs[t])
        d_o = dh * tc
        dc = dh * o[t] * (1.0 - tc * tc) + dc
        dg = torch.cat([dc * g[t] * i[t] * (1.0 - i[t]),
                        dc * c_prev[t] * f[t] * (1.0 - f[t]),
                        dc * i[t] * (1.0 - g[t] * g[t]),
                        d_o * o[t] * (1.0 - o[t])], dim=-1).to(dtype)
        out[t] = dg
        dh = dg.float() @ w
        dc = dc * f[t]
    return torch.stack(out), dh, dc


def _lstm_bwd_kernel(x_proj, w_hh, h0, c0, ys, cs, dys, dcs, dhT):
    """K4: one step kernel per timestep in reverse, then one for dh0."""
    dtype = x_proj.dtype
    for name, t, dts in (('ys', ys, (dtype,)), ('cs', cs, (torch.float32,)),
                         ('dys', dys, (dtype,)),
                         ('dcs', dcs, (torch.float32,)),
                         ('dhT', dhT, (torch.float32,))):
        if t is not None:
            _build.require_cuda(t, name, dts)
    t_len, b, h4 = x_proj.shape
    hid = h4 // 4
    if ys.shape != (t_len, b, hid) or cs.shape != ys.shape:
        raise ValueError(f'lstm_recurrence_bwd: ys {tuple(ys.shape)} cs '
                         f'{tuple(cs.shape)} for x_proj {tuple(x_proj.shape)}')
    dev = x_proj.device
    w_hh_t = w_hh.t().contiguous()
    h0e = h0.to(dtype).contiguous()
    dgates = torch.empty_like(x_proj)
    dh0 = torch.empty((b, hid), dtype=torch.float32, device=dev)
    dc = torch.zeros((b, hid), dtype=torch.float32, device=dev)
    lib = _build.library()
    p = _build.ptr
    _build.check(lib.edd_lstm_bwd(
        p(x_proj), p(w_hh), p(w_hh_t), p(h0e), p(c0), p(ys), p(cs), p(dys),
        p(dcs), p(dhT), p(dgates), p(dh0), p(dc), t_len, b, hid,
        int(dtype == torch.bfloat16), _build.stream_ptr(dev)), 'lstm_bwd')
    lstm_recurrence_bwd.launches += 1
    return dgates, dh0, dc


def lstm_recurrence_bwd(x_proj, w_hh, h0, c0, ys, cs, dys, dcs, dhT):
    """See lstm_recurrence_bwd_plain; CUDA tensors launch csrc/lstm_bwd.cu
    (K4)."""
    if x_proj.device.type == 'cpu':
        return lstm_recurrence_bwd_plain(x_proj, w_hh, h0, c0, ys, cs, dys,
                                         dcs, dhT)
    return _lstm_bwd_kernel(x_proj, w_hh, h0, c0, ys, cs, dys, dcs, dhT)


lstm_recurrence_bwd.launches = 0


class _LSTMRecurrence(torch.autograd.Function):
    """Forward K1 (plain on CPU), backward K4 + one matmul for dW_hh."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0):
        if x_proj.device.type == 'cpu':
            ys, cs, h = lstm_recurrence_plain(x_proj, w_hh, h0, c0)
        else:
            ys, cs, h = _lstm_fwd_kernel(x_proj, w_hh, h0, c0)
        ctx.save_for_backward(x_proj, w_hh, h0, c0, ys, cs)
        ctx.set_materialize_grads(False)
        return ys, cs, h

    @staticmethod
    def backward(ctx, dys, dcs, dhT):
        x_proj, w_hh, h0, c0, ys, cs = ctx.saved_tensors
        if dys is None and dcs is None and dhT is None:
            return None, None, None, None
        dgates, dh0, dc0 = lstm_recurrence_bwd(
            x_proj, w_hh, h0, c0, ys, cs,
            None if dys is None else dys.contiguous(),
            None if dcs is None else dcs.contiguous(),
            None if dhT is None else dhT.contiguous())
        dw = None
        if ctx.needs_input_grad[1]:
            # dW_hh = sum_t dgates_t^T h_{t-1}: the h0 rank-B term plus one
            # contiguous-slice product (rnn_pallas.py:358-367)
            t_len, b, h4 = dgates.shape
            hid = h4 // 4
            dw = dgates[0].t() @ h0.to(dgates.dtype)
            if t_len > 1:
                dw = dw + dgates[1:].reshape(-1, h4).t() @ \
                    ys[:-1].reshape(-1, hid)
            dw = dw.to(w_hh.dtype)
        return dgates, dw, dh0, dc0


def lstm_recurrence(x_proj, w_hh, h0, c0):
    """See lstm_recurrence_plain; CUDA tensors launch csrc/lstm_fwd.cu (K1),
    and their backward csrc/lstm_bwd.cu (K4).  Differentiable in all four
    inputs."""
    return _LSTMRecurrence.apply(x_proj, w_hh, h0, c0)


lstm_recurrence.launches = 0
