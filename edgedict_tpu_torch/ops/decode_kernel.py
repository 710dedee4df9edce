"""K3 — the fused greedy frame loop (counterpart of
edgedict_tpu/ops/decode_pallas.py; kernel in csrc/greedy_decode.cu).

`greedy_frame_loop(cache, f, h_dec, hs, cs, blank, unk)` runs the frame-
synchronous greedy loop over precomputed joint encoder projections f
(T, B, J): per frame the joint, the logits, a first-max argmax with <unk>
re-argmax, and — on non-blank frames — the prediction net advances.  CPU
tensors run the plain loop below (the `lax.scan` body of
edgedict_tpu/stream.py:173-196, written against the cache); CUDA tensors
launch the kernel once for all T frames, spread over the whole card (plan
ops/decode_plan.py).

The cache (`build_decode_cache`) holds every weight in right-multiply
layout, fp32, built once per decoder: the frame loop always runs in fp32
(the serving policy keeps the joint and prediction net fp32).
"""

import ctypes
import functools

import torch

from edgedict_tpu_torch import _build
from edgedict_tpu_torch.ops import decode_plan, rnn_bwd
from edgedict_tpu_torch.tokenizer import PAD


def build_decode_cache(model):
    """Kernel-layout fp32 views of the joint + prediction-net weights
    (decode_pallas.py:build_decode_cache): matrices transposed to x @ W,
    the LSTM bias pre-summed (b_ih + b_hh in the param dtype, then fp32),
    the embedding PAD row zeroed."""
    joint, dec = model.joint, model.decoder

    def t32(w):
        return w.detach().t().float().contiguous()

    def f32(b):
        return b.detach().float().contiguous()

    table = dec.embed.weight.detach().float().clone()
    table[PAD] = 0.0
    layers = [{'w_ih_t': t32(p['w_ih']), 'w_hh_t': t32(p['w_hh']),
               'bias': f32(p['b_ih'].detach() + p['b_hh'].detach())}
              for p in dec.lstm.layers()]
    return {
        'w_dec_t': t32(joint.w_dec), 'b_joint': f32(joint.b),
        'w_out_t': t32(joint.out.weight), 'b_out': f32(joint.out.bias),
        'table': table.contiguous(), 'layers': layers,
        'w_proj_t': t32(dec.proj.weight), 'b_proj': f32(dec.proj.bias),
    }


def first_argmax(x):
    """(B, V) → (B,) int64 index of the FIRST maximum; a row holding NaN
    gives its first NaN (jnp.argmax semantics, decode_pallas.py:108-128).
    Compared in fp32."""
    x = x.float()
    v = x.shape[-1]
    col = torch.arange(v, device=x.device).expand_as(x)
    nan = torch.isnan(x)
    m = x.max(dim=-1, keepdim=True).values
    idx_max = torch.where(x == m, col, v).min(dim=-1).values
    idx_nan = torch.where(nan, col, v).min(dim=-1).values
    return torch.where(nan.any(dim=-1), idx_nan, idx_max)


def greedy_frame_loop_plain(cache, f, h_dec, hs, cs, blank, unk,
                            emit_logp=False):
    """f (T, B, J); h_dec (B, D); hs/cs (L, B, H) → (tokens (T, B) int32,
    logp (T, B) fp32 or None, h_dec, hs, cs)."""
    tokens, probs = [], []
    hs, cs = list(hs.unbind(0)), list(cs.unbind(0))
    for t in range(f.shape[0]):
        g = h_dec @ cache['w_dec_t'] + cache['b_joint']
        h = torch.tanh(f[t] + g)
        logits = h @ cache['w_out_t'] + cache['b_out']
        pred = first_argmax(logits)
        if emit_logp:
            m = logits.max(dim=-1, keepdim=True).values
            probs.append(-torch.log(torch.exp(logits - m).sum(dim=-1)))
        if unk is not None:
            masked = logits.clone()
            masked[:, unk] = float('-inf')
            pred = torch.where(pred == unk, first_argmax(masked), pred)
        xs = cache['table'][pred]
        new_h, new_c = [], []
        for li, lp in enumerate(cache['layers']):
            gates = xs @ lp['w_ih_t'] + lp['bias'] + hs[li] @ lp['w_hh_t']
            i, fg, gg, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(fg) * cs[li] + torch.sigmoid(i) * torch.tanh(gg)
            xs = torch.sigmoid(o) * torch.tanh(c)
            new_h.append(xs)
            new_c.append(c)
        h_dec_new = xs @ cache['w_proj_t'] + cache['b_proj']
        adv = (pred != blank)[:, None]
        h_dec = torch.where(adv, h_dec_new, h_dec)
        hs = [torch.where(adv, n, o) for n, o in zip(new_h, hs)]
        cs = [torch.where(adv, n, o) for n, o in zip(new_c, cs)]
        tokens.append(pred.to(torch.int32))
    b = h_dec.shape[0]
    tokens = torch.stack(tokens) if tokens else \
        torch.zeros((0, b), dtype=torch.int32, device=f.device)
    logp = None
    if emit_logp:
        logp = torch.stack(probs) if probs else \
            torch.zeros((0, b), device=f.device)
    return tokens, logp, h_dec, torch.stack(hs), torch.stack(cs)


def card_plan(cache, f, hs):
    """K3's launch plan for f (T, B, J) and hs (L, B, H) on their card."""
    dev = f.device
    return _card_plan(
        torch.cuda.current_device() if dev.index is None else dev.index,
        f.shape[1], f.shape[2], *cache['table'].shape, hs.shape[0],
        hs.shape[2], cache['w_proj_t'].shape[1])


@functools.lru_cache(maxsize=None)
def _card_plan(index, b, j, v, e, n_layers, hid, d):
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    smem, _ = decode_plan.layout_floats(
        b, j, v, e, n_layers, hid, d, decode_plan.BLOCKS_PER_SM * sms,
        min(b, decode_plan.STREAM_CHUNK))
    n = 0
    if 4 * smem <= decode_plan.SMEM_PER_BLOCK:
        n = rnn_bwd.card_blocks_per_sm('edd_greedy_decode_blocks_per_sm',
                                       index, 0, False, 4 * smem)
    return decode_plan.decode_plan(b, j, v, e, n_layers, hid, d, sms, n)


def greedy_frame_loop(cache, f, h_dec, hs, cs, blank, unk, emit_logp=False):
    """See greedy_frame_loop_plain; CUDA tensors launch
    csrc/greedy_decode.cu once for all T frames (one count per launch)."""
    if f.device.type == 'cpu':
        return greedy_frame_loop_plain(cache, f, h_dec, hs, cs, blank, unk,
                                       emit_logp)
    f32 = (torch.float32,)
    layers = cache['layers']
    for name, x in (('f', f), ('h_dec', h_dec), ('hs', hs), ('cs', cs)):
        _build.require_cuda(x, name, f32)
    for name in ('w_dec_t', 'b_joint', 'w_out_t', 'b_out', 'table',
                 'w_proj_t', 'b_proj'):
        _build.require_cuda(cache[name], name, f32)
    for lp in layers:
        for name in ('w_ih_t', 'w_hh_t', 'bias'):
            _build.require_cuda(lp[name], name, f32)
    t, b, j = f.shape
    n_layers, _, hid = hs.shape
    d = cache['w_proj_t'].shape[1]
    v, e = cache['table'].shape
    if not 1 <= n_layers <= decode_plan.MAX_LAYERS \
            or len(layers) != n_layers \
            or h_dec.shape != (b, d) or cs.shape != hs.shape \
            or hs.shape[1] != b or cache['w_out_t'].shape != (j, v) \
            or cache['w_dec_t'].shape != (d, j):
        raise ValueError(f'greedy_frame_loop: shapes f {tuple(f.shape)} '
                         f'h_dec {tuple(h_dec.shape)} hs {tuple(hs.shape)} '
                         f'layers {len(layers)}')
    plan = card_plan(cache, f, hs)
    dev = f.device
    tokens = torch.empty((t, b), dtype=torch.int32, device=dev)
    logp = torch.empty((t, b), dtype=torch.float32, device=dev) \
        if emit_logp else None
    h_out = torch.empty_like(h_dec)
    hs_out = torch.empty_like(hs)
    cs_out = torch.empty_like(cs)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=dev)
    p = _build.ptr
    arr = ctypes.c_void_p * n_layers
    w_ih = arr(*[lp['w_ih_t'].data_ptr() for lp in layers])
    w_hh = arr(*[lp['w_hh_t'].data_ptr() for lp in layers])
    bias = arr(*[lp['bias'].data_ptr() for lp in layers])
    _build.check(_build.library().edd_greedy_decode(
        p(f), t, b, j, p(cache['w_dec_t']), p(cache['b_joint']),
        p(cache['w_out_t']), p(cache['b_out']), v, p(cache['table']), e,
        n_layers, w_ih, w_hh, bias, hid, p(cache['w_proj_t']),
        p(cache['b_proj']), d, p(h_dec), p(hs), p(cs), p(tokens), p(logp),
        p(h_out), p(hs_out), p(cs_out), int(blank),
        -1 if unk is None else int(unk), p(scratch), plan.scratch_floats,
        plan.blocks, plan.stream_chunk, plan.smem, _build.stream_ptr(dev)),
        'greedy_decode')
    greedy_frame_loop.launches += 1
    return tokens, logp, h_out, hs_out, cs_out


greedy_frame_loop.launches = 0
