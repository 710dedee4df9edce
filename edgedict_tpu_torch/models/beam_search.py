"""Transducer beam search with optional RNN-LM shallow fusion (counterpart
of edgedict_tpu/models/beam_search.py).

A static (B, W) beam advanced frame by frame, at most `max_sym_per_frame`
label expansions per frame (always all of them: the shapes never depend
on the data), pruned by `top_k`.  Every hypothesis lives in fixed-shape
tensors (tokens, lengths, log-probs, prediction-net and LM state), so a
frame step makes no host sync and a later CUDA graph can capture it.

Scoring follows Graves: a hypothesis is a label prefix whose score sums
the probability of every alignment of it that survives in the beam;
identical prefixes are logsumexp-merged into the lowest-index copy at
every pool operation, before the prune (merge_prefixes=False scores
single alignments).  Dead hypotheses sit at NEG = -1e30, not -inf, and
stay there exactly (NEG plus a log-prob rounds back to NEG in fp32).

Shallow fusion: lm = (LMModel, LMConfig, weight) adds weight ·
log P_lm(v | prefix) to every label expansion, the LM state threaded per
hypothesis beside the prediction net's.

On a CUDA tensor every prediction-net and LM step is one K1 launch per
LSTM layer (ops/rnn_kernel.py) at B·W rows and T = 1; the joint, the
log-softmax, the prune, the gathers and the merge are plain PyTorch, as
the JAX package computes them outside any Pallas kernel.
"""

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.models.lm import lm_apply, lm_zero_state
from edgedict_tpu_torch.tokenizer import BOS

NEG = -1e30


class BeamState(NamedTuple):
    tokens: torch.Tensor     # (B, W, U_cap) int32
    n_tok: torch.Tensor      # (B, W) int32
    logp: torch.Tensor       # (B, W) fp32
    dec_out: torch.Tensor    # (B, W, D)
    dec_state: tuple         # (h, c) each (L, B, W, H)
    lm_state: Optional[tuple]              # (h, c) each (L, B, W, Hlm)
    lm_next: Optional[torch.Tensor]        # (B, W, V) LM log-probs


def top_k(x, k):
    """(values, indices) of the k largest entries along the last axis, ties
    lowest index first as jax.lax.top_k gives them (torch.topk orders
    ties arbitrarily)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _map_opt(fn, *xs):
    return None if xs[0] is None else fn(*xs)


def _map_state(fn, *states):
    """fn over the (h, c) pair of an LSTM state (None stays None)."""
    if states[0] is None:
        return None
    return tuple(fn(*parts) for parts in zip(*states))


def _gather_beam(state: BeamState, idx):
    """Select hypotheses: idx (B, W') indexes the W axis."""
    def g2(x):                       # (B, W, ...) → (B, W', ...)
        return torch.take_along_dim(
            x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), dim=1)

    def gstate(s):                   # (L, B, W, H)
        return torch.take_along_dim(s, idx[None, :, :, None], dim=2)

    return BeamState(
        tokens=g2(state.tokens), n_tok=g2(state.n_tok), logp=g2(state.logp),
        dec_out=g2(state.dec_out),
        dec_state=_map_state(gstate, state.dec_state),
        lm_state=_map_state(gstate, state.lm_state),
        lm_next=_map_opt(g2, state.lm_next))


def _concat_beams(a: BeamState, b: BeamState):
    """Two pools along the W axis (axis 1 of (B, W, ...), axis 2 of the
    (L, B, W, H) network states)."""
    def c1(x, y):
        return torch.cat([x, y], dim=1)

    def c2(x, y):
        return torch.cat([x, y], dim=2)

    return BeamState(
        tokens=c1(a.tokens, b.tokens), n_tok=c1(a.n_tok, b.n_tok),
        logp=c1(a.logp, b.logp), dec_out=c1(a.dec_out, b.dec_out),
        dec_state=_map_state(c2, a.dec_state, b.dec_state),
        lm_state=_map_state(c2, a.lm_state, b.lm_state),
        lm_next=_map_opt(c1, a.lm_next, b.lm_next))


def _merge_top_w(a: BeamState, b: BeamState, w, merge=False):
    """Top-w of the concatenated pools; with merge=True identical prefixes
    in the 2w pool are probability-summed before the prune."""
    cat = _concat_beams(a, b)
    if merge:
        cat = merge_duplicate_prefixes(cat)
    logp, idx = top_k(cat.logp, w)
    return _gather_beam(cat, idx)._replace(logp=logp)


def merge_duplicate_prefixes(beam: BeamState):
    """Graves prefix merging: live hypotheses with identical label prefixes
    (reached through different alignments) sum their probabilities into
    the lowest-index copy; the other copies drop to NEG."""
    tokens, n_tok, logp = beam.tokens, beam.n_tok, beam.logp
    _, w, u = tokens.shape
    dev = tokens.device
    valid = torch.arange(u, device=dev) < n_tok[..., None]
    tok_masked = torch.where(valid, tokens, -1)
    same_len = n_tok[:, :, None] == n_tok[:, None, :]            # (B,W,W)
    same_tok = (tok_masked[:, :, None, :]
                == tok_masked[:, None, :, :]).all(dim=-1)
    live = logp > NEG / 2
    eq = same_len & same_tok & live[:, :, None] & live[:, None, :]
    ids = torch.arange(w, device=dev)
    # canonical representative: the lowest index of each class
    canon = torch.where(eq, ids[None, :, None], w).amin(dim=1)    # (B, W)
    contrib = canon[:, None, :] == ids[None, :, None]            # (B,W,W)
    merged = torch.logsumexp(
        torch.where(contrib, logp[:, None, :], NEG), dim=2)
    is_canon = canon == ids[None, :]
    return beam._replace(logp=torch.where(is_canon & live, merged, NEG))


def make_beam_machinery(model, cfg, batch, beam_width=8, max_sym_per_frame=3,
                        max_tokens=200, lm=None, merge_prefixes=True,
                        device=None):
    """(init_beam_fn, frame_step) for a (batch, beam_width) search on
    `device` (default: the model's).  The initial beam (the BOS-primed
    prediction net of an empty prefix, the LM primed with BOS) is computed
    here, once; init_beam_fn() returns it and launches nothing.
    frame_step(beam, h_enc_t (B, E), valid (B,) bool or None = all) →
    the beam after the frame."""
    b_, w_ = batch, beam_width
    v_ = cfg.vocab_size
    blank = int(cfg.blank)
    u_cap = max_tokens
    if device is None:
        device = next(model.parameters()).device

    def tile_w(x):                    # (B, ...) → (B, W, ...)
        return x[:, None].expand((b_, w_) + x.shape[1:]).contiguous()

    def tile_state(s):                # (L, B, H) → (L, B, W, H)
        return s[:, :, None].expand(s.shape[:2] + (w_,)
                                    + s.shape[2:]).contiguous()

    with torch.no_grad():
        empty = torch.zeros((b_, 0), dtype=torch.long, device=device)
        h_dec0, dstate0 = T.decoder_apply(model.decoder, cfg, empty)
        if lm is not None:
            lm_model, lm_cfg, lm_weight = lm
            lmlp0, lmstate0 = lm_apply(
                lm_model, lm_cfg,
                torch.full((b_, 1), BOS, dtype=torch.long, device=device),
                lm_zero_state(lm_cfg, b_, device))
            lm_state0 = _map_state(tile_state, lmstate0)
            lm_next0 = tile_w(lmlp0[:, 0])
        else:
            lm_weight, lm_state0, lm_next0 = 0.0, None, None
        logp0 = torch.full((b_, w_), NEG, dtype=torch.float32, device=device)
        logp0[:, 0] = 0.0
        init = BeamState(
            tokens=torch.zeros((b_, w_, u_cap), dtype=torch.int32,
                               device=device),
            n_tok=torch.zeros((b_, w_), dtype=torch.int32, device=device),
            logp=logp0, dec_out=tile_w(h_dec0[:, 0]),
            dec_state=_map_state(tile_state, dstate0),
            lm_state=lm_state0, lm_next=lm_next0)
    positions = torch.arange(u_cap, device=device)

    def flat(s):                      # (L, B, W, H) → (L, B·W, H)
        return s.reshape(s.shape[0], b_ * w_, s.shape[-1])

    def unflat(s):
        return s.reshape(s.shape[0], b_, w_, s.shape[-1])

    def advance(state: BeamState, v):
        """Append token v (B, W) to every hypothesis and step the networks
        (K1 per LSTM layer at B·W rows, T = 1)."""
        toks = v.reshape(b_ * w_, 1)
        d_out, dstate = T.decoder_apply(
            model.decoder, cfg, toks, _map_state(flat, state.dec_state))
        # at n_tok == u_cap no position matches and nothing is written
        write = positions == state.n_tok[..., None]
        tokens = torch.where(write, v[..., None], state.tokens)
        n_tok = torch.clamp(state.n_tok + 1, max=u_cap)
        lm_state, lm_next = None, None
        if state.lm_state is not None:
            lmlp, lstate = lm_apply(lm_model, lm_cfg, toks,
                                    _map_state(flat, state.lm_state))
            lm_next = lmlp[:, 0].reshape(b_, w_, v_)
            lm_state = _map_state(unflat, lstate)
        return state._replace(
            tokens=tokens, n_tok=n_tok, dec_out=d_out[:, 0].reshape(
                b_, w_, -1),
            dec_state=_map_state(unflat, dstate), lm_state=lm_state,
            lm_next=lm_next)

    def beam_joint_logp(h_enc_t, dec_out):
        """Pointwise joint per hypothesis: (B, E) × (B, W, D) → (B, W, V)
        fp32 log-probs; the frames enter in the encoder's dtype."""
        enc = h_enc_t[:, None, :].expand(b_, w_, h_enc_t.shape[-1])
        logits = T.joint_apply(model.joint, enc.reshape(b_ * w_, -1),
                               dec_out.reshape(b_ * w_, -1))
        return F.log_softmax(logits.float(), dim=-1).reshape(b_, w_, v_)

    def frame_step(beam: BeamState, h_enc_t, valid=None):
        stay = beam._replace(logp=torch.full_like(beam.logp, NEG))
        active = beam
        for _ in range(max_sym_per_frame):
            lp = beam_joint_logp(h_enc_t, active.dec_out)
            # blank: the hypothesis consumes the frame → the stay pool
            stay = _merge_top_w(
                stay, active._replace(logp=active.logp + lp[..., blank]),
                w_, merge=merge_prefixes)
            # labels: expand within the frame
            total = active.logp[..., None] + lp
            if active.lm_next is not None:
                total = total + lm_weight * active.lm_next
            total[..., blank] = NEG
            total = torch.where((active.n_tok >= u_cap)[..., None], NEG,
                                total)
            flat_logp, flat_idx = top_k(total.reshape(b_, w_ * v_), w_)
            active = _gather_beam(active, flat_idx // v_)._replace(
                logp=flat_logp)
            active = advance(active, (flat_idx % v_).to(torch.int32))
            if merge_prefixes:
                # identical prefixes from different in-frame emission
                # orders: sum before the next expansion
                active = merge_duplicate_prefixes(active)
        # expansions that never emitted blank still consume the frame
        lp = beam_joint_logp(h_enc_t, active.dec_out)
        stay = _merge_top_w(
            stay, active._replace(logp=active.logp + lp[..., blank]), w_,
            merge=merge_prefixes)
        if valid is None:
            return stay

        # frames past xlen leave the beam as it was
        def g1(new, old):
            return torch.where(valid.reshape((b_,) + (1,) * (new.ndim - 1)),
                               new, old)

        def g2(new, old):
            return torch.where(
                valid.reshape((1, b_) + (1,) * (new.ndim - 2)), new, old)

        return BeamState(
            tokens=g1(stay.tokens, beam.tokens),
            n_tok=g1(stay.n_tok, beam.n_tok),
            logp=g1(stay.logp, beam.logp),
            dec_out=g1(stay.dec_out, beam.dec_out),
            dec_state=_map_state(g2, stay.dec_state, beam.dec_state),
            lm_state=_map_state(g2, stay.lm_state, beam.lm_state),
            lm_next=_map_opt(g1, stay.lm_next, beam.lm_next))

    def init_beam_fn():
        return init

    return init_beam_fn, frame_step


def best_hypothesis(final: BeamState):
    """(tokens (B, U_cap), n_tok (B,), logp (B,)) of the best beam entry
    (the first of equal scores, as argmax gives it)."""
    best = torch.argmax(final.logp, dim=1)            # (B,)

    def take(x):
        return torch.take_along_dim(
            x, best.reshape((-1,) + (1,) * (x.ndim - 1)), dim=1)[:, 0]

    return take(final.tokens), take(final.n_tok), take(final.logp)


@torch.no_grad()
def beam_search_from_encoder(model, cfg, h_enc, xlen=None, beam_width=8,
                             max_sym_per_frame=3, max_tokens=200, lm=None,
                             merge_prefixes=True):
    """h_enc (B, T', E) → (tokens (B, U_cap) int32, n_tok (B,), logp (B,)).

    lm: optional (LMModel, LMConfig, weight) for shallow fusion; xlen (B,)
    valid frames (None: all)."""
    b, t_len, _ = h_enc.shape
    init_fn, frame_step = make_beam_machinery(
        model, cfg, b, beam_width=beam_width,
        max_sym_per_frame=max_sym_per_frame, max_tokens=max_tokens, lm=lm,
        merge_prefixes=merge_prefixes, device=h_enc.device)
    beam = init_fn()
    valid = None if xlen is None else (
        torch.arange(t_len, device=h_enc.device)[None, :]
        < xlen.to(h_enc.device)[:, None])
    for t in range(t_len):
        beam = frame_step(beam, h_enc[:, t],
                          None if valid is None else valid[:, t])
    return best_hypothesis(beam)


@torch.no_grad()
def transducer_beam_search(model, cfg, xs, xlen, beam_width=8,
                           max_sym_per_frame=3, max_tokens=200, lm=None):
    """Features (B, T, F) → beam-search decode (the reference
    Transducer.beam_search entry, models.py:121-202)."""
    h_enc, _ = T.encoder_apply(model.encoder, cfg, xs)
    out_len = T.scale_length(cfg, xlen, xs.shape[1], h_enc.shape[1])
    return beam_search_from_encoder(
        model, cfg, h_enc, out_len, beam_width=beam_width,
        max_sym_per_frame=max_sym_per_frame, max_tokens=max_tokens, lm=lm)
