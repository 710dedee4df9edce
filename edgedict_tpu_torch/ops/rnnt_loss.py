"""RNN-Transducer lattice loss (counterpart of edgedict_tpu/ops/rnnt_loss.py).

Semiring convention as in the JAX package: the lattice lives on states
(t, u), t in [0, T], u in [0, U].  A blank transition (t,u)→(t+1,u) has
log-prob blank_lp[t,u] (valid t < xlen, u <= ylen); a label transition
(t,u)→(t,u+1) has label_lp[t,u] = log P(labels[u] | t, u) (valid t < xlen,
u < ylen), and there is none at t = T.  The path ends at (xlen, ylen);
loss = −logZ.  Invalid transitions carry the finite NEG, never −inf.

  * `rnnt_loss_core_plain` — the lattice core as an autograd.Function with
    the analytic α/β occupancy gradient (rnnt_loss.py:172-203); the rows
    over t run in a loop and the within-row recurrence over u is solved by
    log-semiring doubling (rnnt_loss_pallas.py:58-75).
  * `rnnt_loss` — from full-lattice logits (B, T, U+1, V).
  * `rnnt_loss_from_joint` — from encoder/decoder activations: for CUDA
    tensors the fused joint kernels (K7/K8, ops/joint_lse_kernel.py) and the
    lattice kernels (K9/K10, ops/rnnt_loss_kernel.py), so the (B, T, U+1, V)
    logits never exist; for CPU tensors the time-chunked, checkpointed plain
    joint (rnnt_loss.py:310-339).
  * `rnnt_loss_reference` — the cell-by-cell DP, differentiable by
    autograd: the test oracle (tiny sizes only).
"""

import torch
from torch.utils.checkpoint import checkpoint

from edgedict_tpu_torch.ops.joint_lse_kernel import fused_joint_lse

NEG = -1e30  # effectively log(0), finite to avoid inf−inf NaNs


def masked_transitions(blank_lp, label_lp, xlen, ylen):
    """Validity masks: blank_lp (B,T,U+1), label_lp (B,T,U) → fp32 copies
    (fp64 for fp64 inputs) with NEG at invalid transitions
    (rnnt_loss.py:92-104)."""
    _, t_len, u1 = blank_lp.shape
    dev = blank_lp.device
    dt = torch.promote_types(blank_lp.dtype, torch.float32)
    t_ids = torch.arange(t_len, device=dev)[None, :, None]
    u_ids = torch.arange(u1, device=dev)[None, None, :]
    xl = xlen.to(dev).long()[:, None, None]
    yl = ylen.to(dev).long()[:, None, None]
    blank_m = torch.where((t_ids < xl) & (u_ids <= yl), blank_lp.to(dt),
                          NEG)
    label_m = torch.where((t_ids < xl) & (u_ids[..., :u1 - 1] < yl),
                          label_lp.to(dt), NEG)
    return blank_m, label_m


def _shift_right(x, s):
    """x[..., u] ← x[..., u − s], NEG entering."""
    return torch.cat([torch.full_like(x[..., :s], NEG), x[..., :-s]], -1)


def _shift_left(x, s):
    return torch.cat([x[..., s:], torch.full_like(x[..., :s], NEG)], -1)


def _row_scan_fwd(b, c):
    """Solve a[u] = b[u] ⊕ (c[u] + a[u−1]), a[−1] = NEG, by doubling."""
    s, u1 = 1, b.shape[-1]
    while s < u1:
        b = torch.logaddexp(b, c + _shift_right(b, s))
        c = c + _shift_right(c, s)
        s *= 2
    return b


def _row_scan_rev(b, c):
    """Solve a[u] = b[u] ⊕ (c[u] + a[u+1]), a[U+1] = NEG (reverse)."""
    s, u1 = 1, b.shape[-1]
    while s < u1:
        b = torch.logaddexp(b, c + _shift_left(b, s))
        c = c + _shift_left(c, s)
        s *= 2
    return b


def lattice_alpha_plain(blank_lp, label_lp, xlen, ylen):
    """Forward lattice: (blank (B,T,U+1), label (B,T,U) log-probs, xlen,
    ylen) → (alpha (B, T+1, U+1), logz (B,)), masking included (the
    plain version of K9, rnnt_loss_pallas.py:_alpha_kernel), in fp32, or
    in fp64 throughout for fp64 inputs (the card tests' reference)."""
    blank_m, label_m = masked_transitions(blank_lp, label_lp, xlen, ylen)
    b, t_len, u1 = blank_m.shape
    # labsh[t, u] = label[t, u−1]: NEG at u = 0, and no row at t = T
    labsh = torch.cat([torch.full_like(blank_m[..., :1], NEG), label_m], -1)
    first = torch.full((b, u1), NEG, dtype=blank_m.dtype,
                       device=blank_m.device)
    first[:, 0] = 0.0
    row = _row_scan_fwd(first, labsh[:, 0])
    rows = [row]
    neg_row = torch.full_like(row, NEG)
    for t in range(1, t_len + 1):
        c = labsh[:, t] if t < t_len else neg_row
        row = _row_scan_fwd(row + blank_m[:, t - 1], c)
        rows.append(row)
    alpha = torch.stack(rows, 1)
    idx = torch.arange(b, device=alpha.device)
    logz = alpha[idx, xlen.to(alpha.device).long(),
                 ylen.to(alpha.device).long()]
    return alpha, logz


def lattice_beta_grad_plain(blank_lp, label_lp, alpha, logz, xlen, ylen):
    """Backward lattice fused with the occupancies: → (gb (B,T,U+1),
    gl (B,T,U)) = ∂logZ-occupancy of each transition, i.e. ∂(−logZ)/∂lp
    up to the sign the caller applies (the plain version of K10,
    rnnt_loss_pallas.py:_beta_grad_kernel)."""
    blank_m, label_m = masked_transitions(blank_lp, label_lp, xlen, ylen)
    b, t_len, u1 = blank_m.shape
    dev = blank_m.device
    label_full = torch.cat([label_m, torch.full_like(blank_m[..., :1], NEG)],
                           -1)
    lane = torch.arange(u1, device=dev)[None, :]
    xl = xlen.to(dev).long()[:, None]
    yl = ylen.to(dev).long()[:, None]
    z = logz[:, None]

    def term(t):
        return torch.where((xl == t) & (lane == yl), 0.0, NEG)

    beta_next = term(t_len)
    gbs, gls = [None] * t_len, [None] * t_len
    for t in range(t_len - 1, -1, -1):
        bt = torch.logaddexp(blank_m[:, t] + beta_next, term(t))
        beta_row = _row_scan_rev(bt, label_full[:, t])
        gbs[t] = torch.exp(alpha[:, t] + blank_m[:, t] + beta_next - z)
        gls[t] = torch.exp(alpha[:, t] + label_full[:, t]
                           + _shift_left(beta_row, 1) - z)[:, :u1 - 1]
        beta_next = beta_row
    return torch.stack(gbs, 1), torch.stack(gls, 1)


def make_core(alpha_fn, beta_grad_fn):
    """The lattice core (B,) = −logZ as an autograd.Function over a pair of
    (alpha, beta+grad) implementations; the gradient is −g·occupancy."""

    class Core(torch.autograd.Function):
        @staticmethod
        def forward(ctx, blank_lp, label_lp, xlen, ylen):
            alpha, logz = alpha_fn(blank_lp, label_lp, xlen, ylen)
            ctx.save_for_backward(blank_lp, label_lp, alpha, logz, xlen,
                                  ylen)
            return -logz

        @staticmethod
        def backward(ctx, g):
            blank_lp, label_lp, alpha, logz, xlen, ylen = ctx.saved_tensors
            gb, gl = beta_grad_fn(blank_lp, label_lp, alpha, logz, xlen,
                                  ylen)
            scale = -g.float()[:, None, None]
            return (gb * scale).to(blank_lp.dtype), \
                (gl * scale).to(label_lp.dtype), None, None

    return Core.apply


rnnt_loss_core_plain = make_core(lattice_alpha_plain, lattice_beta_grad_plain)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def gather_normalized_lp(logits, labels, blank):
    """blank (B,T,U+1) / label (B,T,U) log-probs from raw logits
    (B,T,U+1,V): one logsumexp, only the two gathered entries normalized."""
    u = labels.shape[1]
    lse = torch.logsumexp(logits.float(), -1)
    blank_lp = logits[..., blank].float() - lse
    idx = labels.long()[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
    label_lp = torch.gather(logits[:, :, :u], -1, idx)[..., 0].float() \
        - lse[:, :, :u]
    return blank_lp, label_lp


def _core():
    from edgedict_tpu_torch.ops.rnnt_loss_kernel import rnnt_loss_core
    return rnnt_loss_core


def rnnt_loss(logits, labels, xlen, ylen, blank=0):
    """Per-sample RNN-T loss (B,) from full-lattice logits (B,T,U+1,V):
    the contract of warprnnt_pytorch.RNNTLoss with reduction='none'."""
    blank_lp, label_lp = gather_normalized_lp(logits, labels, blank)
    return _core()(blank_lp, label_lp, xlen.to(torch.int32),
                   ylen.to(torch.int32))


def rnnt_loss_from_joint(joint, h_enc, h_dec, labels, xlen, ylen, blank=0,
                         time_chunk=24):
    """Per-sample RNN-T loss (B,) fusing the joint network.

    h_enc (B, T, E) encoder output, h_dec (B, U+1, D) prediction-net output
    (BOS-prepended), labels (B, U).  CUDA tensors go through the fused joint
    (K7/K8) and the lattice kernels (K9/K10); CPU tensors through the plain
    joint `time_chunk` frames at a time, each chunk rematerialised in the
    backward (torch.utils.checkpoint), so the (B, T, U+1, V) logits never
    exist whole.  A joint whose output layer is in vocabulary slices (tp,
    parallel/vocab.py) runs vocab_parallel_joint_lse in place of
    fused_joint_lse; the lattice runs on f's (the home) device."""
    from edgedict_tpu_torch.models.transducer import joint_project
    from edgedict_tpu_torch.parallel.vocab import (
        VocabParallelLinear, vocab_parallel_joint_lse)
    f, g = joint_project(joint, h_enc, h_dec)          # (B,T,J), (B,U1,J)
    if isinstance(joint.out, VocabParallelLinear):     # V in slices (tp)
        w_t = [w.t() for w in joint.out.slices('weight')]
        bias = joint.out.slices('bias')
        joint_lse = vocab_parallel_joint_lse
    else:
        w_t = joint.out.weight.t()                     # (J, V)
        bias = joint.out.bias
        joint_lse = fused_joint_lse
    labels = labels.to(torch.int32)
    if f.device.type == 'cuda':
        blank_lp, label_lp = joint_lse(f, g, w_t, bias, labels, blank)
    else:
        def chunk_lp(f_c, g_):
            return joint_lse(f_c, g_, w_t, bias, labels, blank)

        parts = [checkpoint(chunk_lp, f[:, s:s + time_chunk], g,
                            use_reentrant=False)
                 for s in range(0, f.shape[1], time_chunk)]
        blank_lp = torch.cat([p[0] for p in parts], 1)
        label_lp = torch.cat([p[1] for p in parts], 1)
    return _core()(blank_lp, label_lp, xlen.to(torch.int32),
                   ylen.to(torch.int32))


def rnnt_loss_reference(logits, labels, xlen, ylen, blank=0):
    """Cell-by-cell log-space DP (rnnt_loss.py:347-373), differentiable by
    autograd; label transitions exist only at t < T."""
    log_probs = torch.log_softmax(logits.float(), -1)
    u = labels.shape[1]
    blank_lp = log_probs[..., blank]
    idx = labels.long()[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
    label_lp = torch.gather(log_probs[:, :, :u], -1, idx)[..., 0]
    blank_m, label_m = masked_transitions(blank_lp, label_lp, xlen, ylen)
    b, t_len, u1 = blank_m.shape
    neg = torch.full((b,), NEG)
    alpha = [[None] * u1 for _ in range(t_len + 1)]
    for t in range(t_len + 1):
        for uu in range(u1):
            if t == 0 and uu == 0:
                alpha[t][uu] = torch.zeros(b)
                continue
            prev = neg
            if t > 0:
                prev = torch.logaddexp(prev, alpha[t - 1][uu]
                                       + blank_m[:, t - 1, uu])
            if uu > 0 and t < t_len:
                prev = torch.logaddexp(prev, alpha[t][uu - 1]
                                       + label_m[:, t, uu - 1])
            alpha[t][uu] = prev
    table = torch.stack([torch.stack(row, 1) for row in alpha], 1)
    return -table[torch.arange(b), xlen.long(), ylen.long()]
