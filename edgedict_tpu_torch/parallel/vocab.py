"""The vocabulary-parallel joint (counterpart of the 'tp' rule of
edgedict_tpu/parallel/train.py:param_sharding, :71-80, and of the joint's
vocab product that GSPMD partitions there, ops/rnnt_loss.py:310-340).

The joint's output layer Linear(J, V) is cut into tp row slices, slice k
(rows v0 .. v0 + V/tp) on the grid's vocabulary device k
(`VocabParallelLinear`).  Where tp does not divide V the vocabulary stays
whole, as param_sharding leaves it replicated (`vocab_slices`).

`vocab_parallel_joint_lse(f, g, w_t_slices, bias_slices, labels, blank)`
is fused_joint_lse (ops/joint_lse_kernel.py) over the slices, f and g on
the home device:

  * each slice gets one extra column, the sentinel: zero weight and a bias
    of -inf (pad16's convention for its padded columns).  The labels and
    the blank go into the slice's coordinates, v - v0, and an id the slice
    does not own onto the sentinel, whose gathered logit is then -inf and
    adds exp(-inf) = 0 to the slice's sum;
  * forward: K7 once a slice → (blank_lp_k, label_lp_k, lse_k) on its
    device; on the home device lse = logsumexp_k(lse_k), and the owner's
    log-prob is blank_lp_k + (lse_k - lse), the owner picked by
    torch.where;
  * backward, one autograd.Function around the whole: K8 once a slice with
    the whole vocabulary's lse, the full cotangents and the slice's
    labels.  K8's dlogits = onehot·d − softmax·(d_blank + d_label) is then
    the slice's part of the whole dlogits; the sentinel's onehot term
    meets its zero row of W, so it adds nothing to df / dg.  df and dg are
    summed on the home device; dW and dbias stay on the slice, the
    sentinel's column cut off.

For CPU tensors `vocab_parallel_joint_lse_plain` computes the same through
the plain K7 (joint_lse_fwd_plain) of each slice and autograd.
`make_vocab_parallel(fwd, bwd)` builds the Function over any pair of slice
functions: the card's is K7 / K8, and the CPU tests run it over the plain
K7 / K8 (joint_lse_fwd_plain / joint_lse_bwd_plain) against the plain
version.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
from edgedict_tpu_torch.optim import on, shard_key


def vocab_slices(vocab_size, tp):
    """The vocabulary's slice count: tp where it divides vocab_size, else 1
    (the vocabulary stays whole, param_sharding:73-76)."""
    return tp if tp > 1 and vocab_size % tp == 0 else 1


def shard_vocab(weight, bias, devices):
    """A Linear(J, V)'s weight (V, J) and bias (V,) → ([weight rows of
    slice k on devices[k]], [bias of slice k]), V cut into len(devices)
    equal slices."""
    n = len(devices)
    return ([w.to(d) for w, d in zip(weight.chunk(n), devices)],
            [b.to(d) for b, d in zip(bias.chunk(n), devices)])


def gather_vocab(slices, device):
    """The slices of shard_vocab → the whole tensor on `device`."""
    return torch.cat([s.detach().to(device) for s in slices])


class VocabParallelLinear(nn.Module):
    """The joint's output Linear(J, V) held as row slices, slice k on
    devices[k]: parameters weight_k (V/n, J) and bias_k (V/n,)
    (optim.shard_key).  Its state dict holds the whole Linear's keys,
    `weight` and `bias`, gathered on the first device, and loading one
    scatters it, so checkpoints keep the one-device layout."""

    def __init__(self, linear, devices):
        super().__init__()
        self.n = len(devices)
        for name, parts in zip(('weight', 'bias'), shard_vocab(
                linear.weight.detach(), linear.bias.detach(), devices)):
            for k, part in enumerate(parts):
                self.register_parameter(shard_key(name, k),
                                        nn.Parameter(part.clone()))

    def slices(self, name):
        return [getattr(self, shard_key(name, k)) for k in range(self.n)]

    def gathered(self, device):
        """The whole Linear on `device` (a copy)."""
        from edgedict_tpu_torch.models.transducer import Linear
        return Linear.of(gather_vocab(self.slices('weight'), device),
                         gather_vocab(self.slices('bias'), device))

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name in ('weight', 'bias'):
            parts = self.slices(name)
            destination[prefix + name] = gather_vocab(parts, parts[0].device)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        for name in ('weight', 'bias'):
            parts, key = self.slices(name), prefix + name
            if key not in state_dict:
                missing_keys.append(key)
                continue
            whole = state_dict[key]
            shape = (sum(p.shape[0] for p in parts),) + parts[0].shape[1:]
            if tuple(whole.shape) != shape:
                error_msgs.append(f'size mismatch for {key}: copying a param '
                                  f'with shape {tuple(whole.shape)}, the '
                                  f'slices hold {shape}')
                continue
            with torch.no_grad():
                for p, piece in zip(parts, whole.chunk(self.n)):
                    p.copy_(piece)
        if strict:
            unexpected_keys.extend(
                k for k in state_dict if k.startswith(prefix)
                and k[len(prefix):] not in ('weight', 'bias'))


def slice_problem(w_t, bias, labels, blank, v0):
    """Slice k's problem: (J, Vk) w_t and (Vk,) bias with the sentinel
    column appended (weight 0, bias -inf, fp32), labels (int32, on the
    slice's device) and blank in the slice's coordinates v - v0, an id
    the slice does not own (outside v0 .. v0 + Vk) mapped to the sentinel
    Vk."""
    vk = w_t.shape[1]
    w_t = F.pad(w_t, (0, 1))
    bias = F.pad(bias.float(), (0, 1), value=float('-inf'))
    lab = on(labels, w_t).long()
    lab = torch.where((lab >= v0) & (lab < v0 + vk), lab - v0, vk)
    blank_k = blank - v0 if v0 <= blank < v0 + vk else vk
    return w_t, bias, lab.to(torch.int32), blank_k


def _bounds(w_ts):
    out, v0 = [], 0
    for w_t in w_ts:
        out.append(v0)
        v0 += w_t.shape[1]
    return out


def _combine(parts, labels, blank, starts, sizes):
    """Each slice's (blank_lp_k, label_lp_k, lse_k) → (blank_lp, label_lp,
    lse) of the whole vocabulary on labels' (the home) device."""
    lses = [on(p[2], labels) for p in parts]
    lse = torch.logsumexp(torch.stack(lses), 0)
    u = labels.shape[1]
    blank_lp = label_lp = None
    for (b_lp, l_lp, _), lse_k, v0, vk in zip(parts, lses, starts, sizes):
        if v0 <= blank < v0 + vk:
            blank_lp = on(b_lp, labels) + (lse_k - lse)
        lp = on(l_lp, labels) + (lse_k[..., :u] - lse[..., :u])
        own = ((labels >= v0) & (labels < v0 + vk))[:, None, :]
        label_lp = lp if label_lp is None else torch.where(own, lp, label_lp)
    return blank_lp, label_lp, lse


def vocab_parallel_joint_lse_plain(f, g, w_t_slices, bias_slices, labels,
                                   blank):
    """The plain version: f (B,T,J), g (B,U+1,J), labels (B,U) on the home
    device, w_t_slices [(J, Vk) on device k], bias_slices [(Vk,)] →
    (blank_lp (B,T,U+1), label_lp (B,T,U)) fp32 on the home device, each
    slice through joint_lse_fwd_plain, differentiable by autograd."""
    starts = _bounds(w_t_slices)
    f32, g32 = f.float(), g.float()      # df, dg summed over slices in fp32
    parts = []
    for w_t, bias, v0 in zip(w_t_slices, bias_slices, starts):
        w_p, b_p, lab, blank_k = slice_problem(w_t, bias, labels, blank, v0)
        parts.append(KJ.joint_lse_fwd_plain(on(f32, w_p), on(g32, w_p), w_p,
                                            b_p, lab, blank_k, f.dtype))
    return _combine(parts, labels, blank, starts,
                    [w.shape[1] for w in w_t_slices])[:2]


def make_vocab_parallel(fwd, bwd):
    """The vocabulary-parallel joint as an autograd.Function over a slice's
    forward fwd(f, g, w_t, bias, labels, blank) → (blank_lp, label_lp,
    lse) and backward bwd(f, g, w_t, bias, labels, blank, lse, d_blank,
    d_label) → (df, dg, dw_t, dbias): → apply(f, g, labels, blank,
    *w_t_slices, *bias_slices)."""

    class VocabParallelJointLSE(torch.autograd.Function):
        @staticmethod
        def forward(ctx, f, g, labels, blank, *slices):
            n = len(slices) // 2
            w_ts, biases = slices[:n], slices[n:]
            starts = _bounds(w_ts)
            labels = labels.to(torch.int32).contiguous()
            parts, saved, blanks = [], [], []
            for w_t, bias, v0 in zip(w_ts, biases, starts):
                w_p, b_p, lab, blank_k = slice_problem(
                    w_t.to(f.dtype), bias, labels, blank, v0)
                args = (on(f, w_p).contiguous(), on(g, w_p).contiguous(),
                        w_p.contiguous(), b_p.contiguous(), lab.contiguous())
                parts.append(fwd(*args, blank_k))
                saved.extend(args)
                blanks.append(blank_k)
            blank_lp, label_lp, lse = _combine(
                parts, labels, blank, starts, [w.shape[1] for w in w_ts])
            ctx.save_for_backward(lse, *saved)
            ctx.blanks = blanks
            ctx.dtypes = (f.dtype, g.dtype, [w.dtype for w in w_ts],
                          [b.dtype for b in biases])
            return blank_lp, label_lp

        @staticmethod
        def backward(ctx, d_blank, d_label):
            lse, *saved = ctx.saved_tensors
            f_dt, g_dt, w_dts, b_dts = ctx.dtypes
            if d_blank is None:
                d_blank = torch.zeros_like(lse)
            if d_label is None:
                u = saved[4].shape[1]
                d_label = torch.zeros_like(lse[..., :u])
            df = dg = None
            dws, dbs = [], []
            for k, blank_k in enumerate(ctx.blanks):
                args = saved[5 * k:5 * k + 5]
                ref = args[0]
                df_k, dg_k, dw_k, db_k = bwd(
                    *args, blank_k, on(lse, ref).contiguous(),
                    on(d_blank.float(), ref).contiguous(),
                    on(d_label.float(), ref).contiguous())
                df = on(df_k, lse) if df is None else df + on(df_k, lse)
                dg = on(dg_k, lse) if dg is None else dg + on(dg_k, lse)
                dws.append(dw_k[:, :-1].to(w_dts[k]))
                dbs.append(db_k[:-1].to(b_dts[k]))
            return (df.to(f_dt), dg.to(g_dt), None, None, *dws, *dbs)

    return VocabParallelJointLSE.apply


_kernels = make_vocab_parallel(KJ.joint_lse_fwd, KJ.joint_lse_bwd)


def vocab_parallel_joint_lse(f, g, w_t_slices, bias_slices, labels, blank):
    """See vocab_parallel_joint_lse_plain; CUDA tensors go through K7
    (forward) and K8 (backward) once a slice."""
    if f.device.type == 'cpu':
        return vocab_parallel_joint_lse_plain(f, g, w_t_slices, bias_slices,
                                              labels, blank)
    return _kernels(f, g, labels, blank, *w_t_slices, *bias_slices)
