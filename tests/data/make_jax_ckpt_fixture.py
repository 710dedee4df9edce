"""Write the JAX checkpoint fixture of the port's tests (tests/data/jax_ckpt/).

  JAX_PLATFORMS=cpu python tests/data/make_jax_ckpt_fixture.py [--out DIR]

Under the JAX package, on the CPU: a small Transducer (a char tokenizer
built from an 8-utterance seeded corpus) trained 2 Adam steps by
edgedict_tpu.trainer.Trainer, which saves logs/run/models/2.ckpt
(flax-msgpack, params and Adam state) and its flag snapshot.  The fixture
is that run directory as a logdir root:

  run/flagfile.txt  run/models/2.ckpt  char/token2id.pkl
  utt.wav           a seeded 1.5 s utterance
  expected.json     the JAX package's greedy streaming decode of utt.wav
                    (StreamingDecoder, fp32): every frame's token and the
                    text

Everything is seeded, so a rerun writes the same decode.  The flag
snapshot's paths are relative to the directory the run was made in.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, 'tests', 'data', 'jax_ckpt')
TEXTS = ['hello world', 'the cat sat', 'a b c d', 'speech test',
         'one two three', 'open the door', 'close the door', 'turn it off']
FLAGS_SET = dict(
    name='run', logdir_root='logs', tokenizer='char', batch_size=4,
    sub_batch_size=2, eval_batch_size=2, enc_hidden_size=16, enc_layers=2,
    enc_proj_size=16, dec_hidden_size=16, dec_layers=1, dec_proj_size=12,
    joint_size=16, vocab_embed_size=8, feature='logfbank', feature_size=8,
    n_fft=256, win_length=256, hop_length=128, downsample=3,
    audio_bucket_frames=16, label_bucket=16, audio_max_length=2.0,
    lr=3e-3, warmup_step=1, gradclip=5.0, epochs=1, dp_size=1, tp_size=1,
    optim='adam', LibriSpeech_train_100='libri', LibriSpeech_test='none',
    LibriSpeech_train_360='none', LibriSpeech_train_500='none',
    TEDLIUM_train='none', CommonVoice='none', YT_bloomberg2='none',
    YT_life='none', compilation_cache_dir='', profile_dir='')


def write_corpus(root, sr=16000, seconds=1.0):
    """LibriSpeech layout: root/1/2/1-2.trans.txt + one wav per text."""
    import numpy as np
    from edgedict_tpu.data.audio_io import save_wav
    rng = np.random.RandomState(0)
    d = os.path.join(root, '1', '2')
    os.makedirs(d, exist_ok=True)
    lines = []
    t = np.arange(int(sr * seconds)) / sr
    for i, text in enumerate(TEXTS):
        name = f'1-2-{i:04d}'
        audio = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t) \
            + 0.05 * rng.randn(len(t))
        save_wav(os.path.join(d, name + '.wav'), audio, sr)
        lines.append(f'{name} {text.upper()}')
    with open(os.path.join(d, '1-2.trans.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')


def make(out):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import numpy as np
    from edgedict_tpu.config import FLAGS, ensure_parsed
    from edgedict_tpu.data.audio_io import save_wav
    from edgedict_tpu.features import FeatureConfig
    from edgedict_tpu.stream import StreamingDecoder
    from edgedict_tpu.tokenizer import CharTokenizer
    from edgedict_tpu.trainer import Trainer

    ensure_parsed()
    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix='jax_ckpt_')
    saved = {k: getattr(FLAGS, k) for k in FLAGS_SET}
    try:
        os.chdir(work)
        write_corpus('libri')
        tok = CharTokenizer(cache_dir=os.path.join('logs', 'char'))
        tok.build([t.upper() for t in TEXTS])
        for k, v in FLAGS_SET.items():
            setattr(FLAGS, k, v)
        trainer = Trainer(FLAGS)
        batches = iter(trainer.loader)
        for _ in range(2):
            trainer.run_step(next(batches))
        trainer.save()

        feat = FeatureConfig.from_flags(FLAGS, pad_to_divisible=False)
        dec = StreamingDecoder(trainer.state.params, trainer.cfg, feat,
                               trainer.tokenizer,
                               compute_dtype=jax.numpy.float32)
        frames = []
        detok = dec._detok
        dec._detok = lambda tokens: (frames.extend(
            int(x) for x in np.asarray(tokens).reshape(-1)), detok(tokens))[1]
        rng = np.random.RandomState(7)
        t = np.arange(24000) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 330 * t)
                 + 0.05 * rng.randn(len(t))).astype(np.float32)
        save_wav('utt.wav', audio, 16000)
        # the decode of what the wav holds (16-bit PCM), as a reader sees it
        from edgedict_tpu.data.audio_io import load_audio
        pcm, _ = load_audio('utt.wav')
        text = dec.decode_wav(pcm)

        if os.path.isdir(out):
            shutil.rmtree(out)
        os.makedirs(out)
        shutil.copytree(os.path.join('logs', 'run', 'models'),
                        os.path.join(out, 'run', 'models'))
        shutil.copy(os.path.join('logs', 'run', 'flagfile.txt'),
                    os.path.join(out, 'run', 'flagfile.txt'))
        shutil.copytree(os.path.join('logs', 'char'),
                        os.path.join(out, 'char'))
        shutil.copy('utt.wav', os.path.join(out, 'utt.wav'))
        with open(os.path.join(out, 'expected.json'), 'w') as f:
            json.dump({'step': 2, 'optim': 'adam',
                       'vocab_size': trainer.tokenizer.vocab_size,
                       'frame_tokens': frames, 'text': text}, f, indent=1)
            f.write('\n')
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        for k, v in saved.items():
            setattr(FLAGS, k, v)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', default=OUT)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    print(make(args.out))


if __name__ == '__main__':
    main()
