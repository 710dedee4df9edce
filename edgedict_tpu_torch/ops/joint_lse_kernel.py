"""K7 + K8 — fused joint + logsumexp + blank/label gather, and its backward
(counterpart of edgedict_tpu/ops/joint_lse_pallas.py; kernels in
csrc/joint_lse.cu).

`fused_joint_lse(f, g, w_t, bias, labels, blank)` → (blank_lp (B,T,U+1),
label_lp (B,T,U)) without ever materialising the whole (B,T,U+1,V) logits:
for CUDA tensors an autograd.Function whose forward is K7 (saving only the
per-cell logsumexp) and whose backward is K8 (dlogits, dW, dbias, df, dg;
the bf16 launch plans of both in ops/joint_lse_plan.py); for CPU tensors
`fused_joint_lse_plain`, the same math in plain PyTorch, differentiated by
autograd.  Products run in f's dtype (bf16 in
training) with fp32 accumulation; W and the bias gradients come back fp32.
There is no U envelope: any U+1 runs.
"""

import torch
import torch.nn.functional as F

from edgedict_tpu_torch import _build
from edgedict_tpu_torch.ops import joint_lse_plan


def joint_lse_fwd_plain(f, g, w_t, bias, labels, blank, dtype=None):
    """K7's plain version: f (B,T,J), g (B,U+1,J), w_t (J,V), bias (V,),
    labels (B,U) → (blank_lp (B,T,U+1), label_lp (B,T,U), lse (B,T,U+1))
    fp32: h = tanh(f + g) in fp32, rounded to the product dtype (`dtype`,
    else f's) for the product h·W^T (fp32 accumulation) + bias, then the
    two entries normalised by one logsumexp (joint_lse_pallas.py's
    _xla_reference)."""
    dtype = dtype or f.dtype
    h = torch.tanh(f.float()[:, :, None, :] + g.float()[:, None, :, :])
    logits = h.to(dtype).float() @ w_t.to(dtype).float() + bias.float()
    lse = torch.logsumexp(logits, -1)
    u = labels.shape[1]
    blank_lp = logits[..., blank] - lse
    idx = labels.long()[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
    label_lp = torch.gather(logits[:, :, :u], -1, idx)[..., 0] \
        - lse[:, :, :u]
    return blank_lp, label_lp, lse


def fused_joint_lse_plain(f, g, w_t, bias, labels, blank):
    """→ (blank_lp (B,T,U+1), label_lp (B,T,U)) of joint_lse_fwd_plain,
    differentiable by autograd."""
    return joint_lse_fwd_plain(f, g, w_t, bias, labels, blank)[:2]


def joint_lse_bwd_plain(f, g, w_t, bias, labels, blank, lse, d_blank,
                        d_label):
    """K8's plain version: from the saved lse (B,T,U+1) and the cotangents
    of blank_lp and label_lp, dlogits = onehot(blank)·d_blank +
    onehot(label)·d_label − softmax·(d_blank + d_label) with softmax =
    exp(logits − lse), then → (df (B,T,J), dg (B,U+1,J), dw_t (J,V),
    dbias (V,)), fp32.  The lse is taken as given, so a slice of the
    vocabulary handed the whole vocabulary's lse gets its slice of the
    whole dlogits."""
    dtype = f.dtype
    h = torch.tanh(f.float()[:, :, None, :] + g.float()[:, None, :, :])
    hq = h.to(dtype).float()
    w = w_t.to(dtype).float()
    logits = hq @ w + bias.float()
    d_lab = torch.cat([d_label.float(), torch.zeros_like(d_blank[..., :1])],
                      -1)
    dl = -torch.exp(logits - lse[..., None]) * (d_blank.float()
                                                 + d_lab)[..., None]
    dl[..., blank] += d_blank.float()
    u = labels.shape[1]
    idx = labels.long()[:, None, :, None].expand(-1, f.shape[1], -1, 1)
    dl[:, :, :u].scatter_add_(-1, idx, d_label.float()[..., None])
    dw_t = torch.einsum('btuj,btuv->jv', hq, dl)
    dbias = dl.sum((0, 1, 2))
    da = (dl @ w.t()) * (1 - h * h)
    return da.sum(2), da.sum(1), dw_t, dbias


def _dims(f, g, w_t, bias, labels):
    dtypes = (torch.float32, torch.bfloat16)
    _build.require_cuda(f, 'f', dtypes)
    _build.require_cuda(g, 'g', (f.dtype,))
    _build.require_cuda(w_t, 'w_t', (f.dtype,))
    _build.require_cuda(bias, 'bias', (torch.float32,))
    _build.require_cuda(labels, 'labels', (torch.int32,))
    b, t, j = f.shape
    u1 = g.shape[1]
    v = w_t.shape[1]
    if g.shape != (b, u1, j) or w_t.shape != (j, v) or bias.shape != (v,) \
            or labels.shape != (b, u1 - 1) or min(b, t, u1, j, v) < 1:
        raise ValueError(f'fused_joint_lse: f {tuple(f.shape)} g '
                         f'{tuple(g.shape)} w_t {tuple(w_t.shape)} bias '
                         f'{tuple(bias.shape)} labels {tuple(labels.shape)}')
    return b, t, u1, j, v


@_build.on_tensor_device
def joint_lse_fwd(f, g, w_t, bias, labels, blank, staged=False):
    """K7: → (blank_lp (B,T,U+1), label_lp (B,T,U), lse (B,T,U+1)), fp32;
    f, g, w_t in one dtype (fp32 or bf16), all contiguous CUDA tensors.
    bf16 runs the tensor-core lattice tiles (ops/joint_lse_plan.py
    fwd_plan) on the problem padded by pad16, with h in shared memory where
    it fits (`staged` forces the slab scratch, for measurement); fp32 the
    CUDA-core kernel.  One launch is counted per call."""
    b, t, u1, j, v = _dims(f, g, w_t, bias, labels)
    dev = f.device
    blank_lp = torch.empty((b, t, u1), dtype=torch.float32, device=dev)
    label_lp = torch.empty((b, t, u1 - 1), dtype=torch.float32, device=dev)
    lse = torch.empty((b, t, u1), dtype=torch.float32, device=dev)
    p = _build.ptr
    if f.dtype == torch.bfloat16:
        f, g, w_t, bias = (x if x.data_ptr() % 16 == 0 else x.clone()
                           for x in pad16(f, g, w_t, bias))
        j, v = w_t.shape
        plan = joint_lse_plan.fwd_plan(b, t, u1, j, v, _build.sm_count(dev),
                                       staged)
        hs = None if plan.resident else torch.empty(
            (plan.slab_tiles * joint_lse_plan.TILE_CELLS, j),
            dtype=torch.bfloat16, device=dev)
        _build.check(_build.library().edd_joint_lse_fwd_mma(
            p(f), p(g), p(w_t), p(bias), p(labels), p(blank_lp), p(label_lp),
            p(lse), p(hs), b, t, u1, j, v, int(blank), plan.r_t, plan.r_u,
            plan.ldh, plan.slab_tiles, _build.stream_ptr(dev)),
            'joint_lse_fwd')
    else:
        _build.check(_build.library().edd_joint_lse_fwd(
            p(f), p(g), p(w_t), p(bias), p(labels), p(blank_lp), p(label_lp),
            p(lse), b, t, u1, j, v, int(blank), _build.stream_ptr(dev)),
            'joint_lse_fwd')
    joint_lse_fwd.launches += 1
    return blank_lp, label_lp, lse


joint_lse_fwd.launches = 0


def joint_lse_bwd(f, g, w_t, bias, labels, blank, lse, d_blank, d_label):
    """K8: → (df (B,T,J), dg (B,U+1,J), dw_t (J,V), dbias (V,)), all fp32;
    w (V, J) is made here from w_t.  bf16 runs the tensor-core kernels slab
    by slab over a scratch of the plan's size (ops/joint_lse_plan.py), fp32
    the CUDA-core kernels.  One launch is counted per call."""
    b, t, u1, j, v = _dims(f, g, w_t, bias, labels)
    _build.require_cuda(lse, 'lse', (torch.float32,))
    _build.require_cuda(d_blank, 'd_blank', (torch.float32,))
    _build.require_cuda(d_label, 'd_label', (torch.float32,))
    if lse.shape != (b, t, u1) or d_blank.shape != (b, t, u1) \
            or d_label.shape != (b, t, u1 - 1):
        raise ValueError(f'joint_lse_bwd: lse {tuple(lse.shape)} d_blank '
                         f'{tuple(d_blank.shape)} d_label '
                         f'{tuple(d_label.shape)}')
    grads = (_bwd_mma if f.dtype == torch.bfloat16 else _bwd_cuda_cores)(
        f, g, w_t, bias, labels, blank, lse, d_blank, d_label)
    joint_lse_bwd.launches += 1
    return grads


def pad16(f, g, w_t, bias):
    """(f, g, w_t, bias) with J and V padded to multiples of 16, as the
    tensor-core kernels take them: zero columns of f and g (h = 0 there)
    and zero rows of W^T add nothing to the products, and a padded vocab
    column's bias of -inf gives it a softmax of 0: it adds 0 to the sum of
    exp of the forward and dlogits 0 to the backward.  The outputs of the
    padded problem, cut back to J and V, are the original's."""
    j0, v0 = w_t.shape
    j, v = -(-j0 // 16) * 16, -(-v0 // 16) * 16
    if (j, v) == (j0, v0):
        return f, g, w_t, bias
    return (F.pad(f, (0, j - j0)), F.pad(g, (0, j - j0)),
            F.pad(w_t, (0, v - v0, 0, j - j0)),
            F.pad(bias, (0, v - v0), value=float('-inf')))


@_build.on_tensor_device
def _bwd_mma(f, g, w_t, bias, labels, blank, lse, d_blank, d_label):
    """The tensor-core kernels, slab by slab (ops/joint_lse_plan.py), on
    the problem padded by pad16."""
    j0, v0 = w_t.shape
    f, g, w_t, bias = pad16(f, g, w_t, bias)
    (b, t, j), u1, v = f.shape, g.shape[1], w_t.shape[1]
    dev = f.device
    plan = joint_lse_plan.bwd_plan(b, t, u1, j, v, _build.sm_count(dev))
    if w_t.data_ptr() % 16:            # the products copy 16-byte rows
        w_t = w_t.clone()
    w = w_t.t().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    df, dg = torch.zeros((b, t, j), **f32), torch.zeros((b, u1, j), **f32)
    dw_t, dbias = torch.empty((j, v), **f32), torch.empty((v,), **f32)
    hs = torch.empty((plan.slab_rows, j), dtype=torch.bfloat16, device=dev)
    dls = torch.empty((plan.slab_rows, v), dtype=torch.bfloat16, device=dev)
    dw_part = torch.zeros((plan.dw_split, j, v), **f32)
    dbias_part = torch.zeros((plan.slab_tiles // 2, v), **f32)
    p = _build.ptr
    _build.check(_build.library().edd_joint_lse_bwd_mma(
        p(f), p(g), p(w_t), p(w), p(bias), p(labels), p(lse), p(d_blank),
        p(d_label), p(df), p(dg), p(dw_t), p(dbias), p(hs), p(dls),
        p(dw_part), p(dbias_part), b, t, u1, j, v, int(blank), plan.r_t,
        plan.r_u, plan.slab_tiles, plan.dw_split, _build.stream_ptr(dev)),
        'joint_lse_bwd')
    return df[..., :j0], dg[..., :j0], dw_t[:j0, :v0], dbias[:v0]


@_build.on_tensor_device
def _bwd_cuda_cores(f, g, w_t, bias, labels, blank, lse, d_blank, d_label):
    """fp32: the row-tiled kernels with fp32 atomics."""
    (b, t, j), u1, v = f.shape, g.shape[1], w_t.shape[1]
    dev = f.device
    w = w_t.t().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    df, dg = torch.zeros((b, t, j), **f32), torch.zeros((b, u1, j), **f32)
    dw_t, dbias = torch.zeros((j, v), **f32), torch.zeros((v,), **f32)
    # row shares of the dW kernel: at most two blocks per SM in all, one wave
    strips = -(-v // 32)
    n_split = max(1, min(2 * _build.sm_count(dev) // strips,
                         -(-b * t * u1 // 32)))
    p = _build.ptr
    _build.check(_build.library().edd_joint_lse_bwd(
        p(f), p(g), p(w_t), p(w), p(bias), p(labels), p(lse), p(d_blank),
        p(d_label), p(df), p(dg), p(dw_t), p(dbias), b, t, u1, j, v,
        int(blank), n_split, _build.stream_ptr(dev)), 'joint_lse_bwd')
    return df, dg, dw_t, dbias


joint_lse_bwd.launches = 0


class _FusedJointLSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g, w_t, bias, labels, blank):
        dtype = f.dtype
        args = (f.contiguous(), g.contiguous(),
                w_t.to(dtype).contiguous(), bias.float().contiguous(),
                labels.to(torch.int32).contiguous())
        blank_lp, label_lp, lse = joint_lse_fwd(*args, blank)
        ctx.save_for_backward(*args, lse)
        ctx.blank = blank
        ctx.dtypes = (f.dtype, g.dtype, w_t.dtype, bias.dtype)
        return blank_lp, label_lp

    @staticmethod
    def backward(ctx, d_blank, d_label):
        f, g, w_t, bias, labels, lse = ctx.saved_tensors
        if d_blank is None:
            d_blank = torch.zeros_like(lse)
        if d_label is None:
            d_label = torch.zeros(labels.shape[0], lse.shape[1],
                                  labels.shape[1], device=lse.device)
        df, dg, dw_t, dbias = joint_lse_bwd(
            f, g, w_t, bias, labels, ctx.blank, lse,
            d_blank.float().contiguous(), d_label.float().contiguous())
        f_dt, g_dt, w_dt, b_dt = ctx.dtypes
        return (df.to(f_dt), dg.to(g_dt), dw_t.to(w_dt), dbias.to(b_dt),
                None, None)


def fused_joint_lse(f, g, w_t, bias, labels, blank):
    """See fused_joint_lse_plain; CUDA tensors go through K7 (forward) and
    K8 (backward)."""
    if f.device.type == 'cpu':
        return fused_joint_lse_plain(f, g, w_t, bias, labels, blank)
    return _FusedJointLSE.apply(f, g, w_t, bias, labels, blank)
