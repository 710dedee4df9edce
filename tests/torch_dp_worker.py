"""One rank of tests/test_torch_port_distributed.py's data-parallel runs: a
gloo process group on the CPU (file:// rendezvous) running the port's
shared train step on this rank's rows of the batches the test wrote.

  python tests/torch_dp_worker.py <rendezvous file> <rank> <world> \
      <spec.pt> <out.pt>

spec.pt: {'cfg': TransducerConfig kwargs, 'gradclip', 'lrs': [lr a step],
'batches': {key: (steps, rows, ...) tensor}, 'state_dict'}.  Rank 0 loads
the state dict, every other rank starts from its own seed and takes rank
0's parameters by broadcast_module.  out.pt: {'states': [state dict after
each step], 'metrics': [{name: float} a step], 'count': Adam's count}.
"""

import sys

import torch
import torch.distributed as dist

from edgedict_tpu_torch import optim as popt
from edgedict_tpu_torch import train as ptrain
from edgedict_tpu_torch.models import transducer as PT


def main(rendezvous, rank, world, spec_path, out_path):
    dist.init_process_group('gloo', init_method=f'file://{rendezvous}',
                            rank=rank, world_size=world)
    try:
        spec = torch.load(spec_path)
        cfg = PT.TransducerConfig(**spec['cfg'])
        opt = popt.build_optimizer('adam', gradclip=spec['gradclip'])
        state = ptrain.make_train_state(cfg, opt, 'cpu', seed=100 + rank)
        if rank == 0:
            state.model.load_state_dict(spec['state_dict'])
        ptrain.broadcast_module(state.model)
        state.opt_state = opt.init(dict(state.model.named_parameters()))
        step = ptrain.make_train_step(cfg, opt, bf16=False)
        rows = {k: v.shape[1] // world for k, v in spec['batches'].items()}
        states, metrics = [], []
        for i, lr in enumerate(spec['lrs']):
            batch = {k: v[i, rank * rows[k]:(rank + 1) * rows[k]][None]
                     for k, v in spec['batches'].items()}
            state, m = step(state, batch, lr)
            metrics.append({k: float(v) for k, v in m.items()})
            states.append({k: v.clone() for k, v in
                           state.model.state_dict().items()})
        torch.save({'states': states, 'metrics': metrics,
                    'count': int(state.opt_state['count'])}, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
