"""Tensor and pipeline parallelism inside one process (counterpart of
edgedict_tpu/parallel/: the 'tp' and 'pp' axes of make_mesh,
parallel/train.py:38-87).

Data parallelism is one process a GPU (train.py, cli/distributed.py).
Each process also owns a grid of tp × pp devices (`make_layout`) and runs
its model split across them: stages and vocabulary slices are device
placements, and autograd runs the backward across them.  Slot (k, s) of
the grid is devices[k·pp + s], as make_mesh lays out its ('tp', 'pp') axes
for one dp index:

  * the home device (slot 0) holds the featurizer, the encoder's input
    LayerNorm, its preamble layers (parallel/pipeline.py:pipeline_split)
    and its projection, the prediction net and the joint's first layer,
    and runs the loss;
  * pipeline stage s (slot (0, s)) holds its tail layers of the encoder;
  * vocabulary slice k (slot (k, 0)) holds its V/tp rows of the joint's
    output layer (parallel/vocab.py:VocabParallelLinear).

Each optimizer state entry sits beside its parameter (optim.py).  A
model's state dict keeps the one-device key layout: saving gathers the
slices, loading scatters them, so a run saved at tp = 2 or pp = 2 resumes
on one device and the other way round.  The device list may repeat a
device: the CPU tests use [cpu] * n, the one-card smoke [cuda:0] * n.
"""

import copy
import dataclasses

import torch

from edgedict_tpu_torch.parallel.vocab import (
    VocabParallelLinear, vocab_slices)

JOINT_OUT = 'joint.joint.2'      # the joint's output Linear(J, V)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A process's grid: tp vocabulary slices × pp pipeline stages over
    `devices` (tp·pp of them, slot (k, s) = devices[k·pp + s])."""
    tp: int
    pp: int
    devices: tuple

    @property
    def home(self):
        return self.devices[0]

    def vocab_devices(self):
        return [self.devices[k * self.pp] for k in range(self.tp)]

    def stage_devices(self):
        return list(self.devices[:self.pp])


def make_layout(tp=1, pp=1, devices=None):
    """The grid of tp × pp slots over the first tp·pp of `devices` (torch
    devices or their names; repeats allowed).  ValueError for tp or pp
    below 1 and for more slots than devices, as make_mesh refuses."""
    if tp < 1 or pp < 1:
        raise ValueError(f'make_layout(tp={tp}, pp={pp}): tp and pp must be '
                         '>= 1')
    devices = [torch.device(d) for d in (devices or [])]
    if tp * pp > len(devices):
        raise ValueError(f'make_layout(tp={tp}, pp={pp}) needs tp*pp='
                         f'{tp * pp} devices but was given {len(devices)} '
                         f'({[str(d) for d in devices[:4]]})')
    return Layout(tp, pp, tuple(devices[:tp * pp]))


def grid_devices(device, n):
    """A process's n grid devices from its first, `device`: cuda:i ..
    cuda:i+n-1 (ValueError naming the count when fewer cards are visible;
    no wrap), or the CPU n times."""
    device = torch.device(device)
    if device.type != 'cuda':
        return [device] * n
    first = device.index or 0
    visible = torch.cuda.device_count()
    if first + n > visible:
        raise ValueError(f'{n} cards needed from cuda:{first} (tp_size × '
                         f'pp_size) but {visible} visible')
    return [torch.device('cuda', first + i) for i in range(n)]


def vocab_shards(cfg, layout):
    """The optimizer's shards ({name: slices}, optim.Optimizer) of a model
    of `cfg` placed by `layout`."""
    n = vocab_slices(cfg.vocab_size, layout.tp)
    return {f'{JOINT_OUT}.{k}': n for k in ('weight', 'bias')} \
        if n > 1 else {}


def place_model(model, layout):
    """Put a Transducer's parameters where `layout` says, in place: all on
    the home device; with pp > 1 the encoder's tail layers of stage s on
    stage device s; with tp > 1 dividing the vocabulary the joint's output
    layer as a VocabParallelLinear over the vocabulary devices.
    → model."""
    model.to(layout.home)
    if layout.pp > 1:
        from edgedict_tpu_torch.parallel.pipeline import stage_layers
        enc = model.encoder.lstm
        for layers, dev in zip(stage_layers(model.cfg, layout.pp),
                               layout.stage_devices()):
            for i in layers:
                enc.lstms[i].to(dev)
                enc.projs[i].to(dev)
    if vocab_slices(model.cfg.vocab_size, layout.tp) > 1:
        model.joint.joint[2] = VocabParallelLinear(model.joint.joint[2],
                                                   layout.vocab_devices())
    return model


def gathered_model(model, device):
    """A one-device copy of a placed model on `device` (the vocabulary
    slices joined back into one Linear): what eval and the greedy decode
    run on."""
    out = copy.deepcopy(model)
    for name, mod in list(out.named_modules()):
        if isinstance(mod, VocabParallelLinear):
            parent, leaf = name.rsplit('.', 1)
            setattr(out.get_submodule(parent), leaf, mod.gathered(device))
    return out.to(device)
