"""Data-parallel training launcher of the port (counterpart of
cli/distributed.py; the reference cli/lightning.py's DDP role): one
process a GPU, the ordinary Trainer in each, the gradients averaged by the
shared train step's all-reduce (train.py).

Under torchrun (the environment gives the rank, the world size and the
rendezvous):

  torchrun --nproc_per_node 8 -m edgedict_tpu_torch.cli.distributed \
      --flagfile flagfiles/E6D2.txt <trainer flags>

or with the JAX launcher's flags, the same command in every process:

  python -m edgedict_tpu_torch.cli.distributed --flagfile ... \
      --coordinator_address host:port --num_processes N --process_id i

(a `tcp://host:port` rendezvous; --coordinator_address may also be
`file:///path`).  Each process takes the grid of n = tp_size × pp_size
GPUs cuda:<local rank · n> .. cuda:<local rank · n + n - 1> (LOCAL_RANK
under torchrun, else --process_id; a request for more cards than are
visible exits 2 naming the count) and the NCCL backend; --device cpu
takes gloo, for tests (the grid is then the CPU n times).  There is no
fallback from NCCL to gloo or from CUDA to the CPU.  Each rank trains on
every num_processes-th utterance of each corpus (and evaluates its share
of the eval set); rank 0 builds a missing tokenizer cache while the
others wait.
--dp_size must be -1 or the world size.
"""

import argparse
import os
import sys

import torch
import torch.distributed as dist

from edgedict_tpu_torch.config import expand_argv, parse_flags


class _ShardedDataset:
    """View of a dataset holding every num_shards-th sample."""

    def __init__(self, dataset, shard, num_shards):
        self.dataset = dataset
        self.idx = list(range(shard, len(dataset), num_shards))
        self.data = [dataset.data[i] for i in self.idx] \
            if hasattr(dataset, 'data') else None
        self.tokenizer = getattr(dataset, 'tokenizer', None)

    def texts(self):
        return self.dataset.texts()

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.dataset[self.idx[i]]


def add_launcher_flags(parser):
    parser.add_argument('--coordinator_address', default=None,
                        help='host:port of process 0 (or file:///path); '
                             "unset = torchrun's environment")
    parser.add_argument('--num_processes', type=int, default=None,
                        help='total processes')
    parser.add_argument('--process_id', type=int, default=None,
                        help='this process index')
    return parser


def build_parser():
    from edgedict_tpu_torch.cli.baseline import build_parser as trainer
    return add_launcher_flags(trainer())


def init_process_group(argv):
    """Join the process group the launcher flags or torchrun's environment
    name → (rank, world size, the first device of this rank's grid)."""
    pre = add_launcher_flags(argparse.ArgumentParser(add_help=False))
    pre.add_argument('--device', default='cuda')
    pre.add_argument('--tp_size', type=int, default=1)
    pre.add_argument('--pp_size', type=int, default=1)
    known, _ = pre.parse_known_args(expand_argv(list(argv)))
    if known.coordinator_address:
        if known.num_processes is None or known.process_id is None:
            pre.error('--coordinator_address needs --num_processes and '
                      '--process_id')
        addr = known.coordinator_address
        kw = dict(init_method=addr if '://' in addr else f'tcp://{addr}',
                  world_size=known.num_processes, rank=known.process_id)
        local = int(os.environ.get('LOCAL_RANK', known.process_id))
    elif 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
        kw = dict(init_method='env://')
        local = int(os.environ.get('LOCAL_RANK', 0))
    else:
        pre.error('run under torchrun (python -m torch.distributed.run '
                  '--nproc_per_node N -m edgedict_tpu_torch.cli.distributed '
                  '...) or pass --coordinator_address, --num_processes and '
                  '--process_id')
    if known.device == 'cpu':
        device, backend = torch.device('cpu'), 'gloo'
    else:
        n = max(1, known.tp_size * known.pp_size)
        visible = torch.cuda.device_count()
        if visible == 0:
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               'is visible')
        if (local + 1) * n > visible:
            pre.error(f'local rank {local} needs the {n} cards cuda:'
                      f'{local * n}..cuda:{local * n + n - 1} (tp_size × '
                      f'pp_size) but {visible} are visible')
        device, backend = torch.device('cuda', local * n), 'nccl'
        torch.cuda.set_device(device)
    dist.init_process_group(backend, **kw)
    return dist.get_rank(), dist.get_world_size(), device


def sharded_datasets(flags, rank, world):
    """(this rank's train shards, its eval shard): rank 0 builds a missing
    tokenizer cache from the whole training text first."""
    from edgedict_tpu_torch.data import MergedDataset
    from edgedict_tpu_torch.trainer import (
        build_datasets, build_tokenizer, tokenizer_built)
    tokenizer = build_tokenizer(flags)
    if not tokenizer_built(tokenizer):
        if rank == 0:
            train_sets, _ = build_datasets(flags, tokenizer)
            tokenizer.build(MergedDataset(train_sets).texts())
        dist.barrier()
        tokenizer = build_tokenizer(flags)
    train_sets, eval_set = build_datasets(flags, tokenizer)
    train_sets = [_ShardedDataset(d, rank, world) for d in train_sets]
    if eval_set is not None:
        eval_set = _ShardedDataset(eval_set, rank, world)
    return train_sets, eval_set


def main(argv=None, log_fn=print):
    from edgedict_tpu_torch.cli.baseline import set_numerics
    from edgedict_tpu_torch.trainer import Trainer
    argv = sys.argv[1:] if argv is None else list(argv)
    rank, world, device = init_process_group(argv)
    try:
        parser = build_parser()
        flags = parse_flags(parser, argv)
        if flags.mode == 'device_rate':
            parser.error('--mode device_rate measures one process: run it '
                         'with cli.baseline')
        flags.device = str(device)
        set_numerics()
        log_fn(f'process {rank}/{world} on {device} '
               f'({dist.get_backend()})')
        train_sets, eval_set = sharded_datasets(flags, rank, world)
        trainer = Trainer(flags, train_datasets=train_sets,
                          eval_dataset=eval_set)
        if flags.mode == 'resume':
            log_fn(f'resumed from step '
                   f'{trainer.load(flags.resume_step, log_fn=log_fn)}')
        if flags.mode == 'eval':
            trainer.load(flags.resume_step, log_fn=log_fn)
            loss, wer = trainer.evaluate()
            log_fn(f'[rank {rank}/{world}] val_loss {loss:.4f} WER '
                   f'{wer:.4f}{trainer.beam_wer_text()}')
            return trainer
        trainer.train(log_fn=log_fn)
        return trainer
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
