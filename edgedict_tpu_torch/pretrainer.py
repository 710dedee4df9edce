"""wav2vec 2.0 pretraining orchestration (counterpart of
edgedict_tpu/pretrainer.py).

Raw audio cropped to a fixed sample count per batch (crop_audio_batch),
span masks planned on the host with a count fixed by (B, T) (plan_masks),
then one train step (train.py with a custom loss: FrontEnd → mask → encoder
→ Gumbel VQ → negatives → InfoNCE, in fp32 whatever --bf16 says, as the
JAX loss takes no compute-dtype cast) under AdamW without decay of 1-D
params, a linear warmup + linear decay lr and a Gumbel temperature
annealed per update, both host scalars of the host step.  Held-out
contrastive accuracy (`evaluate`) picks the best checkpoint, copied to
logs/<name>/pretrained.ckpt for cli/train.py --use_pretrained.  The
forward's random draws come from a torch.Generator on the device (seed
77), eval's from a fresh one seeded 0 per batch, as the JAX pretrainer
uses PRNGKey(77) and PRNGKey(0); `run_step(batch, draws)` hands the
forward given draws instead (wav2vec.make_draws), so a test can feed two
devices the same ones.
"""

import os
import shutil

import numpy as np
import torch

from edgedict_tpu_torch import optim
from edgedict_tpu_torch.checkpoint import (
    checkpoint_path, save_checkpoint, snapshot_flags)
from edgedict_tpu_torch.models import wav2vec as W
from edgedict_tpu_torch.stream import resolve_device
from edgedict_tpu_torch.train import TrainState, device_batch, make_train_step


def wav2vec_config_from_flags(flags):
    """The pretrainer's Wav2VecConfig (pretrainer.py:73-87): the encoder's
    input is the FrontEnd's embed, so its weights splice into the
    fine-tune Transducer."""
    return W.Wav2VecConfig(
        input_size=W.DEFAULT_FRONTEND[-1][2],
        enc_hidden_size=flags.enc_hidden_size,
        enc_layers=flags.enc_layers,
        enc_dropout=flags.enc_dropout,
        enc_proj_size=flags.enc_proj_size,
        mask_prob=flags.mask_prob, mask_length=flags.mask_length,
        num_negatives=flags.num_negatives,
        latent_vars=flags.latent_vars,
        latent_groups=flags.latent_groups,
        final_dim=flags.final_dim,
        latent_temp=(flags.init_temp, flags.min_temp, flags.temp_decay))


def crop_audio_batch(samples, crop_len, rng):
    """List of (audio, tokens) → (B, crop_len) float32 with random crops
    (short clips zero-padded) + true lengths."""
    b = len(samples)
    out = np.zeros((b, crop_len), np.float32)
    lens = np.zeros((b,), np.int32)
    for i, (audio, _) in enumerate(samples):
        if len(audio) > crop_len:
            start = rng.randint(0, len(audio) - crop_len + 1)
            out[i] = audio[start:start + crop_len]
            lens[i] = crop_len
        else:
            out[i, :len(audio)] = audio
            lens[i] = len(audio)
    return {'audio': out, 'alen': lens}


def plan_masks(cfg, b, t_frames, rng):
    """(B, target) masked frames with a count fixed by (B, T): the
    planner's masks, subsampled or padded with random frames to `target`
    a row (pretrainer.py:150-167), drawn from the RandomState `rng`."""
    target = max(2, int(cfg.mask_prob * t_frames / cfg.mask_length))
    mask = W.compute_mask_indices(
        (b, t_frames), None, cfg.mask_prob, cfg.mask_length,
        cfg.mask_selection, min_masks=2, rng=rng)
    idx = W.mask_to_dense_indices(mask)
    m = idx.shape[1]
    if m >= target:
        sel = np.stack([rng.choice(m, target, replace=False)
                        for _ in range(b)])
        idx = np.take_along_axis(idx, np.sort(sel, axis=1), axis=1)
    else:
        pad = rng.randint(0, t_frames, (b, target - m))
        idx = np.concatenate([idx, pad.astype(np.int32)], axis=1)
    return idx


class Wav2VecPretrainer:
    def __init__(self, flags, train_dataset, eval_dataset=None):
        self.flags = flags
        if getattr(flags, 'pp_size', 1) > 1:
            raise NotImplementedError(
                'pipeline parallelism (--pp_size) is wired for the '
                'transducer trainer only; wav2vec pretraining uses dp/tp')
        # --tp_size splits nothing: the model has no joint output layer
        # (pretrainer.py:90-95 of the JAX package)
        self.logdir = os.path.join(flags.logdir_root, flags.name)
        os.makedirs(self.logdir, exist_ok=True)
        self.device = resolve_device(flags.device)
        self.cfg = cfg = wav2vec_config_from_flags(flags)
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.accum_steps = max(1, flags.batch_size // flags.sub_batch_size)
        self.optimizer = optim.adamw_no_ln_decay(
            flags.beta1, flags.beta2, flags.weight_decay, flags.gradclip)
        model = W.Wav2Vec(cfg, self.device, seed=0)
        self.state = TrainState(
            model, self.optimizer.init(dict(model.named_parameters())))
        self.host_step = 0

        def loss_fn(model, micro, generator, aux):
            res = W.wav2vec_forward(model, cfg, micro['audio'],
                                    micro['mask_idx'], temp=aux['temp'],
                                    draws=aux.get('draws'),
                                    generator=generator, training=True)
            loss, metrics = W.contrastive_loss(
                res, prob_ppl_weight=flags.prob_perplex,
                features_pen_weight=flags.features_pen)
            return loss, {k: metrics[k] for k in (
                'contrastive_loss', 'correct', 'count', 'prob_perplexity')
                if k in metrics}

        self.loss_fn = loss_fn
        self.train_step = make_train_step(cfg, self.optimizer,
                                          bf16=flags.bf16, loss_fn=loss_fn,
                                          loss_has_aux=True)
        self.generator = torch.Generator(device=self.device).manual_seed(77)
        self._np_rng = np.random.RandomState(0)
        self.best_accuracy = -1.0
        snapshot_flags(flags, self.logdir)

    # ------------------------------------------------------------------
    def make_batch(self, samples):
        n = self.flags.pretrain_audio_samples
        batch = crop_audio_batch(samples, n, self._np_rng)
        t_frames = W.frontend_output_length(self.cfg.frontend_params, n)
        batch['mask_idx'] = plan_masks(self.cfg, len(samples), t_frames,
                                       self._np_rng)
        return batch

    def temperature(self, step):
        f = self.flags
        return max(f.init_temp * f.temp_decay ** step, f.min_temp)

    def learning_rate(self, step):
        f = self.flags
        total = f.epochs * max(len(self.train_dataset) // f.batch_size, 1)
        return f.lr * optim.linear_warmup_decay(step, f.warmup_step, total)

    def run_step(self, batch, draws=None):
        """One update at the host step's lr and temperature; draws: the
        forward's random draws of each micro-batch (make_draws), else
        they come from self.generator."""
        step = self.host_step
        dev = device_batch(batch, self.accum_steps, self.device)
        aux = {'temp': self.temperature(step)}
        if draws is not None:
            aux['draws'] = draws
        self.state, metrics = self.train_step(
            self.state, dev, self.learning_rate(step), self.generator, aux)
        self.host_step += 1
        return metrics

    @torch.no_grad()
    def evaluate(self, max_batches=8):
        """Held-out contrastive accuracy and loss over at most max_batches
        full eval batches (pretrainer.py:193-225); None without an eval
        set."""
        if self.eval_dataset is None:
            return None
        f = self.flags
        correct = count = 0
        loss_sum = n = 0.0
        for start in range(0, min(len(self.eval_dataset),
                                  max_batches * f.eval_batch_size),
                           f.eval_batch_size):
            samples = [self.eval_dataset[i] for i in range(
                start, min(start + f.eval_batch_size,
                           len(self.eval_dataset)))]
            if len(samples) < f.eval_batch_size:
                break
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in self.make_batch(samples).items()}
            res = W.wav2vec_forward(
                self.state.model, self.cfg, batch['audio'],
                batch['mask_idx'], temp=self.temperature(self.host_step),
                generator=torch.Generator(device=self.device).manual_seed(0),
                training=False)
            _, m = W.contrastive_loss(
                res, prob_ppl_weight=f.prob_perplex,
                features_pen_weight=f.features_pen)
            correct += float(m['correct'])
            count += float(m['count'])
            loss_sum += float(m['loss'])
            n += 1
        if count == 0:
            return None
        return {'accuracy': correct / count, 'loss': loss_sum / max(n, 1)}

    def save_best(self, accuracy):
        """A new best accuracy writes logs/<name>/models/<step>.ckpt (the
        model alone) and copies it to logs/<name>/pretrained.ckpt."""
        if accuracy > self.best_accuracy:
            self.best_accuracy = accuracy
            step = self.state.step
            save_checkpoint(self.logdir, step, self.state.model.state_dict(),
                            extra={'accuracy': float(accuracy)})
            shutil.copy(checkpoint_path(self.logdir, step),
                        os.path.join(self.logdir, 'pretrained.ckpt'))
