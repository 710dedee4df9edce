"""K5 + K6 — the GRU recurrence, forward and backward (counterpart of
edgedict_tpu/ops/rnn_pallas.py:gru_recurrence_tm; kernels in
csrc/rnn_fwd.cu and csrc/rnn_bwd.cu).

`gru_recurrence` takes the hoisted input projection (b_ih included) and
runs the time recurrence with torch's gates r, z, n, b_hh applied inside
the reset gate, as a `torch.autograd.Function` returning (ys, hT) like the
JAX custom VJP: the forward is K5 (one persistent launch for all steps),
the backward K6 (the gates rematerialised from the saved ys in one product,
then the dh chain), and dW_hh / db_hh are one matmul and one sum over all
steps outside the kernel (rnn_pallas.py:651-659).  The plain PyTorch loops below run for CPU
tensors, the kernels for CUDA tensors.  The device of the tensors decides;
there is no fallback from one to the other.
"""

import torch

from edgedict_tpu_torch import _build
from edgedict_tpu_torch.ops import rnn_bwd, rnn_fwd


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


@_build.on_tensor_device
def _gru_fwd_kernel(x_proj, w_hh, b_hh, h0):
    """K5: one persistent cooperative launch for all T steps
    (ops/rnn_fwd.py plans its grid); the fp32 h is carried in the kernel,
    the recurrent product reads h0 rounded to x_proj's dtype at t = 0, then
    ys[t-1]."""
    t, b, hid = check_gru_args(x_proj, w_hh, b_hh, h0, (x_proj.dtype,))
    plan = rnn_fwd.card_plan(x_proj, 3)
    dev = x_proj.device
    h0e = h0.to(x_proj.dtype).contiguous()
    ys = torch.empty((t, b, hid), dtype=x_proj.dtype, device=dev)
    p = _build.ptr
    _build.check(_build.library().edd_gru_fwd(
        p(x_proj), p(w_hh), p(b_hh), p(h0e), p(h0), p(ys), t, b, hid,
        int(x_proj.dtype == torch.bfloat16), plan.blocks, plan.smem,
        _build.stream_ptr(dev)), 'gru_fwd')
    gru_recurrence.launches += 1
    return ys


def _h_prev(h0, ys):
    """h_{t-1} for every step as the forward fed its dot: h0 rounded to
    ys's dtype at t = 0, else ys[t-1] (rnn_pallas.py:529-535)."""
    return torch.cat([h0.to(ys.dtype)[None], ys[:-1]])


def gru_recurrence_bwd_plain(x_proj, w_hh, b_hh, h0, ys, dys, dhT):
    """The analytic reverse loop of rnn_pallas.py:_gru_bwd_kernel.  Inputs
    as the forward's plus its ys; the cotangents dys (T, B, H) in ys's
    dtype and dhT (B, H) fp32 may each be None (zero).  The gates are
    rematerialised from ys as the forward formed them; dh carried to t-1
    is dh·z + dgh W_hh, dgh in W's dtype, the product accumulated in fp32.
    → (dgx = d(r, z, n) pre-activations, dgh = (da_r, da_z, da_n·r) (both
    (T, B, 3H) in x_proj's dtype), dh0 (B, H) fp32)."""
    t_len, b, h3 = x_proj.shape
    hid = h3 // 3
    dtype = x_proj.dtype
    w = w_hh.float()
    h_prev = _h_prev(h0, ys)
    h_proj = h_prev.to(w_hh.dtype).float() @ w.t() + b_hh.float()
    xp = x_proj.float()
    r = torch.sigmoid(xp[..., :hid] + h_proj[..., :hid])
    z = torch.sigmoid(xp[..., hid:2 * hid] + h_proj[..., hid:2 * hid])
    hn = h_proj[..., 2 * hid:]
    n = torch.tanh(xp[..., 2 * hid:] + r * hn)
    h_prev = h_prev.float()
    dh = torch.zeros(b, hid, dtype=torch.float32, device=x_proj.device)
    if dhT is not None:
        dh = dh + dhT.float()
    dgx, dgh = [None] * t_len, [None] * t_len
    for t in range(t_len - 1, -1, -1):
        if dys is not None:
            dh = dh + dys[t].float()
        da_n = dh * (1.0 - z[t]) * (1.0 - n[t] * n[t])
        da_r = da_n * hn[t] * r[t] * (1.0 - r[t])
        da_z = dh * (h_prev[t] - n[t]) * z[t] * (1.0 - z[t])
        dgx[t] = torch.cat([da_r, da_z, da_n], dim=-1).to(dtype)
        dgh[t] = torch.cat([da_r, da_z, da_n * r[t]], dim=-1).to(dtype)
        dh = dh * z[t] + dgh[t].to(w_hh.dtype).float() @ w
    return torch.stack(dgx), torch.stack(dgh), dh


@_build.on_tensor_device
def _gru_bwd_kernel(x_proj, w_hh, b_hh, h0, ys, dys, dhT):
    """K6: the gate remat over all steps into an fp32 scratch, then the
    persistent chain kernel (ops/rnn_bwd.py plans its grid)."""
    t_len, b, hid = check_gru_args(x_proj, w_hh, b_hh, h0, (x_proj.dtype,))
    dtype = x_proj.dtype
    for name, t, dts in (('ys', ys, (dtype,)), ('dys', dys, (dtype,))):
        if t is not None:
            _build.require_cuda(t, name, dts)
    if ys.shape != (t_len, b, hid) or (dys is not None
                                       and dys.shape != ys.shape):
        raise ValueError(f'gru_recurrence_bwd: ys {tuple(ys.shape)} for '
                         f'x_proj {tuple(x_proj.shape)}')
    if dhT is not None:
        dhT = dhT.float().contiguous()
        _build.require_cuda(dhT, 'dhT', (torch.float32,))
        if dhT.shape != (b, hid):
            raise ValueError(f'gru_recurrence_bwd: dhT {tuple(dhT.shape)}')
    plan = rnn_bwd.card_plan(x_proj, 3)
    dev = x_proj.device
    h0e = h0.to(dtype).contiguous()
    hproj = torch.empty(x_proj.shape, dtype=torch.float32, device=dev)
    dgx = torch.empty_like(x_proj)
    dgh = torch.empty_like(x_proj)
    dh0 = torch.empty((b, hid), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.check(_build.library().edd_gru_bwd(
        p(x_proj), p(w_hh), p(b_hh), p(h0e), p(ys), p(dys), p(dhT),
        p(hproj), p(dgx), p(dgh), p(dh0), t_len, b, hid,
        int(dtype == torch.bfloat16), plan.blocks, plan.smem,
        _build.stream_ptr(dev)), 'gru_bwd')
    gru_recurrence_bwd.launches += 1
    return dgx, dgh, dh0


def gru_recurrence_bwd(x_proj, w_hh, b_hh, h0, ys, dys, dhT):
    """See gru_recurrence_bwd_plain; CUDA tensors launch csrc/rnn_bwd.cu
    (K6)."""
    if x_proj.device.type == 'cpu':
        return gru_recurrence_bwd_plain(x_proj, w_hh, b_hh, h0, ys, dys, dhT)
    return _gru_bwd_kernel(x_proj, w_hh, b_hh, h0, ys, dys, dhT)


gru_recurrence_bwd.launches = 0


class _GRURecurrence(torch.autograd.Function):
    """Forward K5 (plain on CPU), backward K6 + one matmul for dW_hh and
    one sum for db_hh."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, h0):
        if x_proj.device.type == 'cpu':
            ys = gru_recurrence_plain(x_proj, w_hh, b_hh, h0)
        else:
            ys = _gru_fwd_kernel(x_proj, w_hh, b_hh, h0)
        ctx.save_for_backward(x_proj, w_hh, b_hh, h0, ys)
        ctx.set_materialize_grads(False)
        return ys, ys[-1].clone()

    @staticmethod
    def backward(ctx, dys, dhT):
        x_proj, w_hh, b_hh, h0, ys = ctx.saved_tensors
        if dys is None and dhT is None:
            return None, None, None, None
        dgx, dgh, dh0 = gru_recurrence_bwd(
            x_proj, w_hh, b_hh, h0, ys,
            None if dys is None else dys.contiguous(),
            None if dhT is None else dhT.contiguous())
        dw = db = None
        if ctx.needs_input_grad[1]:
            # dW_hh = sum_t dgh_t^T h_{t-1}: one product over all steps,
            # accumulated in fp32, rounded once (rnn_pallas.py:653-658)
            h3 = dgh.shape[-1]
            dw = (dgh.reshape(-1, h3).t()
                  @ _h_prev(h0, ys).to(dgh.dtype).reshape(-1, h3 // 3))
            dw = dw.to(w_hh.dtype)
        if ctx.needs_input_grad[2]:
            db = dgh.sum(dim=(0, 1), dtype=torch.float32).to(b_hh.dtype)
        return dgx, dw, db, dh0


def gru_recurrence(x_proj, w_hh, b_hh, h0):
    """→ (ys, hT = ys[T-1]); see gru_recurrence_plain.  CUDA tensors launch
    csrc/rnn_fwd.cu (K5), and their backward csrc/rnn_bwd.cu (K6).
    Differentiable in all four inputs."""
    return _GRURecurrence.apply(x_proj, w_hh, b_hh, h0)


gru_recurrence.launches = 0
