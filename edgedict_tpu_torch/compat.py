"""Reference checkpoints and JAX params → the port's Transducer (counterpart
of edgedict_tpu/compat/torch_import.py).

The port's module tree already has the reference state_dict key layout
(models/transducer.py), so a reference `.pt` loads with
`load_state_dict`.  `state_dict_from_jax_params` is the inverse of the JAX
package's `transducer_from_state_dict`: it lets the tests hand both
packages the same weights.
"""

import numpy as np
import torch

from edgedict_tpu_torch.models.transducer import Transducer, TransducerConfig


def convert_lightning2normal(checkpoint):
    """Lightning checkpoint → plain {'model': state_dict} (strips the
    `model.` prefix, reference rnnt/models.py:368-380)."""
    if 'state_dict' in checkpoint:
        sd = {}
        for k, v in checkpoint['state_dict'].items():
            sd[k.split('model.', 1)[1] if k.startswith('model.') else k] = v
        return {'model': sd}
    if 'model' not in checkpoint:
        return {'model': checkpoint}
    return checkpoint


def state_dict_from_jax_params(params):
    """edgedict_tpu params pytree (numpy or array-likes) → reference
    state_dict of fp32 CPU tensors.  The joint's w_enc / w_dec are
    concatenated back into the single (J, E + D) first weight.  An LSTM
    encoder layer carries 4H gate rows, a GRU one 3H, under the same
    `encoder.lstm.lstms.{i}.*` keys (compat/torch_import.py:58)."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {}
    enc = params['encoder']
    sd['encoder.norm.weight'] = t(enc['norm']['scale'])
    sd['encoder.norm.bias'] = t(enc['norm']['bias'])
    for i, layer in enumerate(enc['layers']):
        p = f'encoder.lstm.lstms.{i}.'
        rnn = layer['rnn']
        sd[p + 'weight_ih_l0'] = t(rnn['w_ih'])
        sd[p + 'weight_hh_l0'] = t(rnn['w_hh'])
        sd[p + 'bias_ih_l0'] = t(rnn['b_ih'])
        sd[p + 'bias_hh_l0'] = t(rnn['b_hh'])
        sd[f'encoder.lstm.projs.{i}.0.weight'] = t(layer['ln']['scale'])
        sd[f'encoder.lstm.projs.{i}.0.bias'] = t(layer['ln']['bias'])
    sd['encoder.proj.weight'] = t(enc['proj']['w'])
    sd['encoder.proj.bias'] = t(enc['proj']['b'])

    dec = params['decoder']
    sd['decoder.embed.weight'] = t(dec['embed']['table'])
    for k, layer in enumerate(dec['lstm']['layers']):
        sd[f'decoder.lstm.weight_ih_l{k}'] = t(layer['w_ih'])
        sd[f'decoder.lstm.weight_hh_l{k}'] = t(layer['w_hh'])
        sd[f'decoder.lstm.bias_ih_l{k}'] = t(layer['b_ih'])
        sd[f'decoder.lstm.bias_hh_l{k}'] = t(layer['b_hh'])
    sd['decoder.proj.weight'] = t(dec['proj']['w'])
    sd['decoder.proj.bias'] = t(dec['proj']['b'])

    joint = params['joint']
    sd['joint.joint.0.weight'] = torch.cat(
        [t(joint['w_enc']), t(joint['w_dec'])], dim=1)
    sd['joint.joint.0.bias'] = t(joint['b'])
    sd['joint.joint.2.weight'] = t(joint['out']['w'])
    sd['joint.joint.2.bias'] = t(joint['out']['b'])
    return sd


def lm_state_dict_from_jax_params(params):
    """edgedict_tpu LM params (models/lm.py:lm_init; numpy or array-likes)
    → the state dict of the port's LMModel, fp32 CPU tensors: untied
    (`out`) or tied (`out_b`, the table as the output weight)."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {'embed.weight': t(params['embed']['table'])}
    for k, layer in enumerate(params['lstm']['layers']):
        sd[f'lstm.weight_ih_l{k}'] = t(layer['w_ih'])
        sd[f'lstm.weight_hh_l{k}'] = t(layer['w_hh'])
        sd[f'lstm.bias_ih_l{k}'] = t(layer['b_ih'])
        sd[f'lstm.bias_hh_l{k}'] = t(layer['b_hh'])
    if 'out_b' in params:
        sd['out_b'] = t(params['out_b'])
    else:
        sd['out.weight'] = t(params['out']['w'])
        sd['out.bias'] = t(params['out']['b'])
    return sd


def transducer_from_state_dict(state_dict, cfg: TransducerConfig, device):
    """Reference state_dict → the port's Transducer on `device` (strict:
    a missing or unexpected key raises)."""
    model = Transducer(cfg, device=device)
    model.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32)
                           for k, v in state_dict.items()})
    return model


def load_reference_checkpoint(path, cfg: TransducerConfig, device):
    """torch.load a reference .pt (plain or lightning) → Transducer."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    sd = convert_lightning2normal(ckpt)['model']
    return transducer_from_state_dict(sd, cfg, device)
