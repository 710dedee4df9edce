"""Basic layers as plain functions on tensors (counterpart of
edgedict_tpu/ops/layers.py).

Torch-layout weights (Linear stores (out, in)) so reference checkpoints map
1:1.  LayerNorm statistics are always fp32; `linear` accumulates in fp32 and
casts back to the input dtype (on CUDA the numerics flags set by the entry
points keep bf16 reductions in fp32, see README).
"""

import torch
import torch.nn.functional as F


def linear_init(in_size, out_size, generator):
    """PyTorch nn.Linear default init U(-1/sqrt(in), 1/sqrt(in)) → (w, b),
    on the CPU (callers move the module to its device)."""
    k = 1.0 / in_size ** 0.5
    w = torch.empty(out_size, in_size).uniform_(-k, k, generator=generator)
    b = torch.empty(out_size).uniform_(-k, k, generator=generator)
    return w, b


def linear(x, w, b):
    """x @ w.T + b in x's dtype, fp32 accumulation."""
    return F.linear(x, w.to(x.dtype), b.to(x.dtype))


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis with fp32 statistics; output in x's
    dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def group_norm(x, scale, bias, num_groups, eps=1e-5):
    """GroupNorm over (B, C, T) computed in fp32 (layers.py:70-80): the
    population variance (ddof 0) of each group of C / num_groups channels
    over time, per-channel scale and bias; output in x's dtype."""
    b, c, t = x.shape
    x32 = x.float().reshape(b, num_groups, c // num_groups, t)
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = x32.var(dim=(2, 3), unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, c, t)
    y = y * scale.float()[None, :, None] + bias.float()[None, :, None]
    return y.to(x.dtype)


def embedding(table, ids, padding_idx=None):
    """Row lookup; the `padding_idx` row reads as zero on every call, also
    for a table whose stored row is not zero (torch's nn.Embedding only
    zeroes it at init)."""
    out = F.embedding(ids, table)
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out


def dropout(x, rate, deterministic, generator=None):
    """Inverted dropout (layers.py:83-87): keep with probability 1 - rate,
    scale kept values by 1 / (1 - rate).  The mask is drawn from
    `generator`, on x's device."""
    if deterministic or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)
