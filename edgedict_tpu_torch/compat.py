"""Reference checkpoints and JAX params → the port's Transducer (counterpart
of edgedict_tpu/compat/torch_import.py).

The port's module tree already has the reference state_dict key layout
(models/transducer.py), so a reference `.pt` loads with
`load_state_dict`.  `state_dict_from_jax_params` is the inverse of the JAX
package's `transducer_from_state_dict`: it lets the tests hand both
packages the same weights, and it reads the JAX package's checkpoints
(jax_checkpoint.py) into the port; `optim_state_from_jax` carries their
optax state over to the port's optimizer.  The other models' converters
(wav2vec, LM, CTC, the legacy v1 family) map their JAX params trees the
same way.
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


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear_sd(p, prefix):
    return {prefix + 'weight': _t(p['w']), prefix + 'bias': _t(p['b'])}


def _norm_sd(p, prefix):
    return {prefix + 'weight': _t(p['scale']), prefix + 'bias': _t(p['bias'])}


def _lstm_sd(layers, prefix):
    """A JAX recurrent stack's layers (ops/rnn.py lstm_init / gru_init
    dicts) → torch nn.LSTM / nn.GRU keys `{prefix}{weight_ih, weight_hh,
    bias_ih, bias_hh}_l{k}`."""
    sd = {}
    for k, layer in enumerate(layers):
        for name, leaf in (('weight_ih', 'w_ih'), ('weight_hh', 'w_hh'),
                           ('bias_ih', 'b_ih'), ('bias_hh', 'b_hh')):
            sd[f'{prefix}{name}_l{k}'] = _t(layer[leaf])
    return sd


def _encoder_sd(enc):
    """The encoder's keys (`encoder.*`) of a JAX encoder params dict."""
    sd = _norm_sd(enc['norm'], 'encoder.norm.')
    for i, layer in enumerate(enc['layers']):
        sd.update(_lstm_sd([layer['rnn']], f'encoder.lstm.lstms.{i}.'))
        sd.update(_norm_sd(layer['ln'], f'encoder.lstm.projs.{i}.0.'))
    sd.update(_linear_sd(enc['proj'], 'encoder.proj.'))
    return sd


def _frontend_sd(fe, prefix='frontend.'):
    """A JAX FrontEnd / conv extractor params dict (models/wav2vec.py)
    → `frontend.layers.{i}.{weight, bias, gn.*, ln.*}` and
    `frontend.ln.*`."""
    sd = {}
    for i, layer in enumerate(fe['layers']):
        p = f'{prefix}layers.{i}.'
        sd[p + 'weight'] = _t(layer['w'])
        if 'b' in layer:
            sd[p + 'bias'] = _t(layer['b'])
        for norm in ('gn', 'ln'):
            if norm in layer:
                sd.update(_norm_sd(layer[norm], f'{p}{norm}.'))
    if 'ln' in fe:
        sd.update(_norm_sd(fe['ln'], prefix + 'ln.'))
    return sd


def state_dict_from_jax_params(params):
    """edgedict_tpu params pytree (numpy or array-likes) → reference
    state_dict of fp32 CPU tensors.  The joint's w_enc / w_dec are
    concatenated back into the single (J, E + D) first weight.  An LSTM
    encoder layer carries 4H gate rows, a GRU one 3H, under the same
    `encoder.lstm.lstms.{i}.*` keys (compat/torch_import.py:58).  The raw
    fine-tune's params (raw_trainer.py) add `frontend`, which maps to the
    RawTransducer's `frontend.*` keys."""
    t = _t
    sd = _encoder_sd(params['encoder'])
    if 'frontend' in params:
        sd.update(_frontend_sd(params['frontend']))

    dec = params['decoder']
    sd['decoder.embed.weight'] = t(dec['embed']['table'])
    sd.update(_lstm_sd(dec['lstm']['layers'], 'decoder.lstm.'))
    sd['decoder.proj.weight'] = t(dec['proj']['w'])
    sd['decoder.proj.bias'] = t(dec['proj']['b'])

    joint = params['joint']
    sd['joint.joint.0.weight'] = torch.cat(
        [t(joint['w_enc']), t(joint['w_dec'])], dim=1)
    sd['joint.joint.0.bias'] = t(joint['b'])
    sd['joint.joint.2.weight'] = t(joint['out']['w'])
    sd['joint.joint.2.bias'] = t(joint['out']['b'])
    return sd


def _gumbel_vq_sd(p, prefix):
    sd = {prefix + 'vars': _t(p['vars'])}
    sd.update(_linear_sd(p['weight_proj'], prefix + 'weight_proj.'))
    return sd


def wav2vec_state_dict_from_jax_params(params):
    """edgedict_tpu wav2vec params (models/wav2vec.py:wav2vec_init) → the
    state dict of the port's Wav2Vec, fp32 CPU tensors: `frontend.*`,
    `encoder.*` (the key layout of state_dict_from_jax_params),
    `mask_emb`, `final_proj.*`, `project_q.*` and, where present,
    `post_extract_proj.*`, `quantizer.{vars, weight_proj.*}`,
    `input_quantizer.*` and `project_inp.*`."""
    sd = _frontend_sd(params['frontend'])
    sd.update(_encoder_sd(params['encoder']))
    sd['mask_emb'] = _t(params['mask_emb'])
    for name in ('final_proj', 'project_q', 'post_extract_proj',
                 'project_inp'):
        if name in params:
            sd.update(_linear_sd(params[name], name + '.'))
    for name in ('quantizer', 'input_quantizer'):
        if name in params:
            sd.update(_gumbel_vq_sd(params[name], name + '.'))
    return sd


def lm_state_dict_from_jax_params(params):
    """edgedict_tpu LM params (models/lm.py:lm_init; numpy or array-likes)
    → the state dict of the port's LMModel, fp32 CPU tensors: untied
    (`out`) or tied (`out_b`, the table as the output weight)."""
    sd = {'embed.weight': _t(params['embed']['table'])}
    sd.update(_lstm_sd(params['lstm']['layers'], 'lstm.'))
    if 'out_b' in params:
        sd['out_b'] = _t(params['out_b'])
    else:
        sd.update(_linear_sd(params['out'], 'out.'))
    return sd


def ctc_state_dict_from_jax_params(params):
    """edgedict_tpu CTC params (models/ctc.py:ctc_init) → the state dict of
    the port's CTCModel, fp32 CPU tensors: `encoder.*` (the key layout of
    state_dict_from_jax_params) and `tovocab.{weight, bias}`."""
    sd = _encoder_sd(params['encoder'])
    sd.update(_linear_sd(params['tovocab'], 'tovocab.'))
    return sd


def _residual_rnn_sd(p, prefix=''):
    sd = _norm_sd(p['ln_in'], prefix + 'ln_in.')
    for i, layer in enumerate(p['layers']):
        sd.update(_lstm_sd([layer], f'{prefix}layers.{i}.'))
    for i, ln in enumerate(p['lns']):
        sd.update(_norm_sd(ln, f'{prefix}lns.{i}.'))
    if 'head' in p:
        sd.update(_linear_sd(p['head'], prefix + 'head.'))
    return sd


def legacy_state_dict_from_jax_params(params):
    """edgedict_tpu legacy params (models/legacy.py) → the state dict of
    the port's module, fp32 CPU tensors, by the tree's kind:
    residual_rnn_init → ResidualRNN, residual_proj_init → ResidualProj,
    rnn_model_init → RNNModel (`norm.{weight, bias, running_mean,
    running_var}` from gamma, beta, mean, var), legacy_transducer_init →
    LegacyTransducer (`encoder.*`, `embed.weight`, `decoder.*`, `fc1.*`,
    `fc2.*`)."""
    if 'fc1' in params:
        sd = _residual_rnn_sd(params['encoder'], 'encoder.')
        sd['embed.weight'] = _t(params['embed']['table'])
        sd.update(_lstm_sd(params['decoder']['layers'], 'decoder.'))
        sd.update(_linear_sd(params['fc1'], 'fc1.'))
        sd.update(_linear_sd(params['fc2'], 'fc2.'))
        return sd
    if 'blocks' in params:
        sd = {}
        for i, blk in enumerate(params['blocks']):
            p = f'blocks.{i}.'
            sd.update(_lstm_sd([blk['rnn']], p + 'rnn.'))
            sd.update(_linear_sd(blk['proj_out'], p + 'proj_out.'))
            if 'proj_in' in blk:
                sd.update(_linear_sd(blk['proj_in'], p + 'proj_in.'))
        return sd
    if 'norm' in params:
        norm = params['norm']
        sd = {'norm.weight': _t(norm['gamma']), 'norm.bias': _t(norm['beta']),
              'norm.running_mean': _t(norm['mean']),
              'norm.running_var': _t(norm['var'])}
        sd.update(_lstm_sd(params['lstm']['layers'], 'lstm.'))
        sd.update(_linear_sd(params['head'], 'head.'))
        return sd
    return _residual_rnn_sd(params)


def transducer_from_state_dict(state_dict, cfg: TransducerConfig, device):
    """Reference state_dict → the port's Transducer on `device` (strict:
    a missing or unexpected key raises)."""
    model = Transducer(cfg, device=device)
    model.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32)
                           for k, v in state_dict.items()})
    return model


def load_model_state(path):
    """The model state dict of a reference .pt (plain or lightning), the
    port's .ckpt or the JAX package's flax-msgpack .ckpt (its params
    through state_dict_from_jax_params)."""
    from edgedict_tpu_torch.jax_checkpoint import (
        is_jax_checkpoint, load_jax_checkpoint)
    if is_jax_checkpoint(path):
        return state_dict_from_jax_params(load_jax_checkpoint(path)['model'])
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    return convert_lightning2normal(ckpt)['model']


def load_reference_checkpoint(path, cfg: TransducerConfig, device):
    """A reference .pt, the port's .ckpt or a JAX .ckpt → Transducer."""
    return transducer_from_state_dict(load_model_state(path), cfg, device)


def _leaf_sources(params):
    """{port key: [JAX leaf paths]} of state_dict_from_jax_params on this
    params tree, in the order it concatenates them (the joint's first
    weight: w_enc, then w_dec): each leaf's index is passed through it."""
    paths = []

    def tag(tree, path):
        if isinstance(tree, dict):
            return {k: tag(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [tag(v, path + (i,)) for i, v in enumerate(tree)]
        paths.append(path)
        return np.array([[len(paths) - 1]], np.float32)

    sd = state_dict_from_jax_params(tag(params, ()))
    return {k: [paths[int(i)] for i in v.reshape(-1)] for k, v in sd.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _chain_entry(chain, keys):
    """The entry of an optax chain state holding `keys` (its index moves
    with clip_by_global_norm's empty entry)."""
    for entry in chain:
        if isinstance(entry, dict) and set(keys) <= set(entry):
            return entry
    raise ValueError(f'no entry with {sorted(keys)} in the optax chain '
                     f'state {[sorted(e) for e in chain]}')


def optim_state_from_jax(optax_state, optimizer, params):
    """The JAX package's optax state (inject_hyperparams → {count,
    hyperparams, inner_state: the chain of edgedict_tpu/optim.py:142-163},
    as a JAX checkpoint holds it, keyed '0', '1', ...) → the port's
    `optimizer.init` layout over `params` ({name: tensor}), CPU tensors.
    The moments take the params' key mapping (elementwise, so the joint's
    w_enc | w_dec concatenation holds for them); SM3's accumulators and
    Novograd's second moments go to the pieces of optimizer.segments.
    Raises ValueError when the state is not this optimizer's."""
    from edgedict_tpu_torch.jax_checkpoint import unstate
    from edgedict_tpu_torch.optim import split_segments
    state = unstate(optax_state)
    chain = state['inner_state']
    name = optimizer.name

    def moments(tree):
        return split_segments(state_dict_from_jax_params(tree),
                              optimizer.segments)

    def per_tensor(tree, fn):
        out = {}
        for key, paths in sources.items():
            leaves = [fn(_leaf(tree, p)) for p in paths]
            if len(leaves) == 1:
                out[key] = leaves[0]
            elif key in optimizer.segments:
                out.update({f'{key}[{i}]': v for i, v in enumerate(leaves)})
            else:
                raise ValueError(f'{key}: {len(leaves)} JAX tensors but no '
                                 'segments for it')
        return out

    out = {'count': torch.as_tensor(np.asarray(state['count']),
                                    dtype=torch.int32)}
    if name in ('adam', 'adamw'):
        entry = _chain_entry(chain, ('count', 'mu', 'nu'))
        out['count'] = torch.as_tensor(np.asarray(entry['count']),
                                       dtype=torch.int32)
        out['mu'], out['nu'] = moments(entry['mu']), moments(entry['nu'])
    elif name == 'sm3':
        entry = _chain_entry(chain, ('accs', 'momentum'))
        sources = _leaf_sources(entry['momentum'])
        out['accs'] = per_tensor(entry['accs'], lambda accs: {
            i: _t(a) for i, a in enumerate(accs)})
        out['momentum'] = moments(entry['momentum'])
    elif name == 'novograd':
        entry = _chain_entry(chain, ('m', 'v'))
        sources = _leaf_sources(entry['m'])
        out['m'] = moments(entry['m'])
        out['v'] = per_tensor(entry['v'], _t)
    elif optimizer.momentum:
        out['trace'] = moments(_chain_entry(chain, ('trace',))['trace'])
    _check_like(out, optimizer.init({k: p.detach().to('cpu')
                                     for k, p in params.items()}),
                'optimizer state')
    return out


def _check_like(got, want, path):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f'{path}: keys {sorted(got)} != '
                             f'{sorted(want)}')
        for k in want:
            _check_like(got[k], want[k], f'{path}.{k}')
    elif tuple(got.shape) != tuple(want.shape):
        raise ValueError(f'{path}: shape {tuple(got.shape)} != '
                         f'{tuple(want.shape)}')

