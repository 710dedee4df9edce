"""Batched greedy transducer decode (counterpart of
edgedict_tpu/models/decoding.py, greedy part), and the host-side CTC
collapse of the CTC and legacy models.

The frame loop is K3 (ops/decode_kernel.py: plain loop on CPU, the CUDA
kernel on CUDA) with per-frame max log-probs.  Emitted sequences keep
blanks in place, one slot per frame, like the reference
(rnnt/models.py:243-269).
"""

import numpy as np
import torch

from edgedict_tpu_torch.models import transducer as T
from edgedict_tpu_torch.ops.decode_kernel import (
    build_decode_cache, greedy_frame_loop)


def transducer_greedy_decode(model, cfg, xs, xlen, cache=None):
    """xs (B, T, input_size) features, xlen (B,) valid frames →
    (y_seq (B, T') int32 with blanks, out_len (B,), neg_logp (B,))."""
    h_enc, _ = T.encoder_apply(model.encoder, cfg, xs)
    out_len = T.scale_length(cfg, xlen, xs.shape[1], h_enc.shape[1])
    y_seq, neg_logp = greedy_decode_from_encoder(model, cfg, h_enc, cache)
    return y_seq, out_len, neg_logp


def greedy_decode_from_encoder(model, cfg, h_enc, cache=None):
    """h_enc (B, T', E) → (y_seq (B, T') int32, neg_logp (B,) fp32).

    The token loop runs in fp32 (bf16 encoder frames are upcast, exactly),
    with the prediction net primed on BOS as the reference does."""
    if cache is None:
        cache = build_decode_cache(model)
    h_enc = h_enc.float()
    b = h_enc.shape[0]
    empty = torch.zeros((b, 0), dtype=torch.long, device=h_enc.device)
    h_dec0, (hs, cs) = T.decoder_apply(model.decoder, cfg, empty)
    f = torch.matmul(h_enc, model.joint.w_enc.float().t())
    tokens, logp, _, _, _ = greedy_frame_loop(
        cache, f.transpose(0, 1).contiguous(),
        h_dec0[:, 0].float().contiguous(), hs, cs, int(cfg.blank), None,
        emit_logp=True)
    return tokens.t(), -logp.sum(dim=0)


def ctc_greedy_decode_postprocess(y_seq, logprob, xlen, blank=0):
    """Host-side CTC collapse (decoding.py:101 of the JAX package;
    reference CTCEncoder.greedy_decode, rnnt/models.py:294-310): per
    sample, keep frames < xlen, drop consecutive repeats, then blanks.
    y_seq / logprob (B, T) (tensors or arrays), xlen (B,) → (list of 1-D
    int arrays, neg_logp (B,) = -sum of the kept frames' log-probs)."""
    y_seq, logprob, xlen = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                            for x in (y_seq, logprob, xlen))
    seqs, neg_logp = [], []
    for seq, lp, n in zip(y_seq, logprob, xlen):
        seq, lp = seq[:int(n)], lp[:int(n)]
        unique = np.ones(len(seq), dtype=bool)
        unique[1:] = seq[1:] != seq[:-1]
        mask = unique & (seq != blank)
        seqs.append(seq[mask])
        neg_logp.append(-lp[mask].sum())
    return seqs, np.asarray(neg_logp)
