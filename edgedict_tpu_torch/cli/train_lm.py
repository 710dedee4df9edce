"""RNN language-model trainer of the port (counterpart of cli/train_lm.py;
reference cli/train_lm.py:20-109): trains the LSTM LM of models/lm.py on
the corpus transcripts and keeps the best checkpoint at
logs/<name>/lm.ckpt for beam-search shallow fusion (cli.stream / cli.serve
--lm_path).

  python -m edgedict_tpu_torch.cli.train_lm --flagfile flagfiles/E6D2.txt \
      --LibriSpeech_train_100 <dir> --name <lm run> [--device cuda|cpu] \
      [--lm_embed_size 256 --lm_hidden_size 512 --lm_layers 2 \
       --lm_seq_len 64 --lm_tie_weights false]

The corpora, tokenizer, --lr, --epochs, --batch_size, --loss_step and
--save_step are the trainer's flags.  Adam with a global-norm clip of 5.0,
fp32.  Every --save_step iterations whose loss beats the best so far
writes logs/<name>/models/<it>.ckpt and copies it to lm.ckpt; the last
iteration is saved too.  On CUDA each LSTM layer's forward is one K1
launch and its backward one K4 launch.  --device defaults to cuda and
fails without a card.
"""

import argparse
import dataclasses
import os
import shutil
import sys

import numpy as np
import torch

from edgedict_tpu_torch.config import (
    add_model_flags, add_train_flags, parse_bool, parse_flags)


def build_parser():
    parser = argparse.ArgumentParser(description='RNN language-model '
                                                 'trainer')
    add_model_flags(parser)
    add_train_flags(parser)
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default) or 'cpu'")
    parser.add_argument('--lm_embed_size', type=int, default=256)
    parser.add_argument('--lm_hidden_size', type=int, default=512)
    parser.add_argument('--lm_layers', type=int, default=2)
    parser.add_argument('--lm_seq_len', type=int, default=64,
                        help='BPTT length of a training row')
    parser.add_argument('--lm_tie_weights', type=parse_bool, default=False,
                        help='tie the embedding and the output weight')
    return parser


def batch_texts(texts, tokenizer, seq_len, batch_size, rng):
    """Token stream → (B, seq_len + 1) int32 rows (next-token LM): every
    text BOS-prefixed, the stream cut at rng-permuted multiples of
    seq_len."""
    from edgedict_tpu_torch.tokenizer import BOS
    ids = []
    for t in texts:
        ids.extend([BOS] + list(tokenizer.encode(t)))
    ids = np.asarray(ids, np.int32)
    n = (len(ids) - 1) // seq_len
    starts = rng.permutation(n) * seq_len
    for i in range(0, len(starts) - batch_size + 1, batch_size):
        yield np.stack([ids[s:s + seq_len + 1]
                        for s in starts[i:i + batch_size]])


def make_lm_train_step(cfg, optimizer):
    """step(model, opt_state, ys (B, U) on the model's device, lr) →
    (new opt_state, loss): lm_loss over whole rows, its gradients, the
    optimizer's update added to the parameters in place."""
    from edgedict_tpu_torch.models.lm import lm_loss

    def step(model, opt_state, ys, lr):
        params = dict(model.named_parameters())
        ylen = torch.full((ys.shape[0],), ys.shape[1], dtype=torch.int32,
                          device=ys.device)
        loss = lm_loss(model, cfg, ys, ylen)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                dict(zip(params, grads)), opt_state, params, lr)
            for k, p in params.items():
                p.add_(updates[k])
        return opt_state, loss.detach()

    return step


def main(argv=None, log_fn=print):
    from edgedict_tpu_torch import optim
    from edgedict_tpu_torch.checkpoint import save_checkpoint
    from edgedict_tpu_torch.cli.baseline import set_numerics
    from edgedict_tpu_torch.models.lm import LMConfig, LMModel
    from edgedict_tpu_torch.stream import resolve_device
    from edgedict_tpu_torch.trainer import build_datasets, build_tokenizer

    flags = parse_flags(build_parser(),
                        sys.argv[1:] if argv is None else argv)
    set_numerics()
    device = resolve_device(flags.device)
    tokenizer = build_tokenizer(flags)
    train_sets, _ = build_datasets(flags, tokenizer)
    if not train_sets:
        raise SystemExit('no corpora found')
    texts = [t for d in train_sets for t in d.texts()]
    if getattr(tokenizer, 'tokenizer', True) is None or \
            getattr(tokenizer, 'token2id', True) is None:
        tokenizer.build(texts)

    cfg = LMConfig(vocab_size=tokenizer.vocab_size,
                   embed_size=flags.lm_embed_size,
                   hidden_size=flags.lm_hidden_size,
                   num_layers=flags.lm_layers,
                   tie_weights=flags.lm_tie_weights)
    model = LMModel(cfg, device, seed=0)
    optimizer = optim.build_optimizer('adam', gradclip=5.0)
    opt_state = optimizer.init(dict(model.named_parameters()))
    step = make_lm_train_step(cfg, optimizer)
    extra = {'lm_cfg': dataclasses.asdict(cfg)}

    logdir = os.path.join(flags.logdir_root, flags.name)
    rng = np.random.RandomState(0)
    best = float('inf')
    it = 0
    for epoch in range(flags.epochs):
        for ys in batch_texts(texts, tokenizer, flags.lm_seq_len,
                              flags.batch_size, rng):
            opt_state, loss = step(model, opt_state,
                                   torch.from_numpy(ys).to(device), flags.lr)
            it += 1
            if it % flags.loss_step == 0:
                ppl = float(np.exp(min(float(loss), 20.0)))
                log_fn(f'epoch {epoch} it {it} loss {float(loss):.4f} '
                       f'ppl {ppl:.1f}')
            if it % flags.save_step == 0 and float(loss) < best:
                best = float(loss)
                path = save_checkpoint(logdir, it, model.state_dict(),
                                       extra=extra)
                shutil.copy(path, os.path.join(logdir, 'lm.ckpt'))
    save_checkpoint(logdir, it or 1, model.state_dict(), extra=extra)
    return model, cfg


if __name__ == '__main__':
    main()
