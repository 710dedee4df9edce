"""Tokenizers: character and CharBPE with `</w>` word-end markers
(counterpart of edgedict_tpu/tokenizer.py; the same ids for the same vocab
files and texts).

  * token-id scheme NUL=0, PAD=1, BOS=2, UNK=3 (reference
    rnnt/tokenizer.py:7-20);
  * CharTokenizer: char → id table built from the corpus, pickled
    `token2id.pkl` (rnnt/tokenizer.py:24-66);
  * HuggingFaceTokenizer: CharBPE with lowercasing, whitespace split,
    `</w>` on the last char of each word, cache layout
    `<cache_dir>/<vocab_size>-<max_length>-{vocab.json,merges.txt}`
    (rnnt/tokenizer.py:69-123); decode drops ids <= 3.

The BPE engine is pure Python (greedy lowest merge rank, the results of
huggingface/tokenizers' CharBPE).  The merge engine and the trainer run
natively through `_native.py` when `make -C native` has built
`libchar_bpe.so` / `libbpe_trainer.so`, with identical results; without
them the pure-Python paths run.  Training prefers the HF rust trainer when
the `tokenizers` package is importable.  The legacy v1 id scheme
(<blank>=0, <bos>=1, <unk>=2) is detected on load; LegacyCharTokenizer is
the v1 character tokenizer of the legacy models (models/legacy.py).
"""

import json
import os
import pickle
import string
import unicodedata

NUL = 0   # blank
PAD = 1
BOS = 2
UNK = 3
NUL_token = '<nul>'
PAD_token = '<pad>'
BOS_token = '<bos>'
UNK_token = '<unk>'
DEFAULT_TOKEN2ID = {
    NUL_token: NUL,
    PAD_token: PAD,
    BOS_token: BOS,
    UNK_token: UNK,
}
DEFAULT_ID2TOKEN = {v: k for k, v in DEFAULT_TOKEN2ID.items()}

WORD_END = '</w>'


def _is_punctuation(ch):
    """Bert-style punctuation: ASCII symbol ranges + unicode P* category."""
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith('P')


class CharTokenizer:
    """Character-level tokenizer (reference rnnt/tokenizer.py:24-66)."""

    def __init__(self, cache_dir, max_length=None):
        self.cache_dir = cache_dir
        self.max_length = max_length
        self.token2id = None
        self.id2token = None
        self.vocab_size = 0

    def load(self):
        with open(os.path.join(self.cache_dir, 'token2id.pkl'), 'rb') as f:
            self.token2id = pickle.load(f)
        self._finalize()

    def build(self, texts):
        self.token2id = dict(DEFAULT_TOKEN2ID)
        chars = sorted(set(''.join(texts).lower()))
        for char in chars:
            self.token2id[char] = len(self.token2id)
        self._finalize()
        os.makedirs(self.cache_dir, exist_ok=True)
        with open(os.path.join(self.cache_dir, 'token2id.pkl'), 'wb') as f:
            pickle.dump(self.token2id, f)

    def _finalize(self):
        self.id2token = [None] * len(self.token2id)
        for token, idx in self.token2id.items():
            self.id2token[idx] = token
        self.vocab_size = len(self.token2id)

    def encode(self, text, max_length=None):
        text = str(text).lower()[:max_length or self.max_length]
        return [self.token2id.get(char, UNK) for char in text]

    def decode(self, tokens):
        text = ''.join(self.id2token[int(t)] for t in tokens)
        for token in DEFAULT_TOKEN2ID:
            text = text.replace(token, '')
        return text

    def decode_plus(self, token_batch):
        return [self.decode(tokens) for tokens in token_batch]

    @property
    def unk_id(self):
        return UNK

    def id_to_token(self, idx):
        return self.id2token[int(idx)]


class LegacyCharTokenizer:
    """v1 character tokenizer (tokenizer.py:108 of the JAX package;
    reference modules/tokenizer.py:33-74), the same ids.

    v1 id scheme: <blank>=0, <bos>=1, <unk>=2, characters from id 4 (id 3
    is never assigned).  encode() prepends BOS and maps out-of-vocab
    characters to BOS; decode() drops unknown ids and special tokens.  The
    charset is ASCII lowercase + punctuation + space + digits.

    Kept as the JAX class has it: `vocab_size` counts the 72 entries of
    token2id, but with id 3 unassigned the last character, '9', encodes to
    id 72 (encode('a9') == [1, 4, 72]).  A model sized by vocab_size has
    no row for '9'; legacy_vocab_size() (max id + 1 = 73) sizes one that
    has.
    """

    def __init__(self):
        valid = (string.ascii_lowercase + string.punctuation
                 + ' 0123456789')
        self.token2id = {'<blank>': 0, '<bos>': 1, '<unk>': 2}
        for idx, token in enumerate(valid):
            self.token2id[token] = idx + 4
        self.id2token = {i: t for t, i in self.token2id.items()}
        self.vocab_size = len(self.token2id)

    def __str__(self):
        return 'LegacyCharTokenizer'

    def encode(self, text, max_length=-1):
        text = str(text).lower()
        if max_length > 1:
            text = text[:max_length]
        return [1] + [self.token2id.get(ch, 1) for ch in text]

    def decode(self, tokens):
        text = ''.join(self.id2token.get(int(t), '') for t in tokens)
        for tok in ('<pad>', '<blank>', '<eos>', '<bos>', '<unk>'):
            text = text.replace(tok, '')
        return text

    def decode_plus(self, token_batch):
        return [self.decode(tokens) for tokens in token_batch]

    @property
    def unk_id(self):
        return 2

    def id_to_token(self, idx):
        return self.id2token.get(int(idx), '')

    def legacy_vocab_size(self):
        """Rows a legacy model needs for every id encode() can give: the
        largest id + 1 (73; vocab_size is 72, see the class note)."""
        return max(self.token2id.values()) + 1


class CharBPE:
    """Greedy merge-rank character BPE with `</w>` word-end suffix.

    Pure-Python engine compatible with vocab.json/merges.txt files produced by
    huggingface/tokenizers' CharBPETokenizer (the reference's BPE backend).
    """

    def __init__(self, vocab, merges, lowercase=True, unk_token=UNK_token):
        """vocab: dict token->id; merges: list of (left, right) pairs."""
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.merges = list(merges)
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.unk_id = self.vocab.get(unk_token)
        self._cache = {}

    # -- persistence (HF-compatible file formats) --

    @classmethod
    def from_files(cls, vocab_path, merges_path, lowercase=True,
                   unk_token=UNK_token):
        with open(vocab_path) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path) as f:
            for line in f:
                line = line.rstrip('\n')
                if line.startswith('#version') or not line:
                    continue
                a, b = line.split(' ')
                merges.append((a, b))
        if unk_token not in vocab and '<unk>' in vocab:
            unk_token = '<unk>'
        return cls(vocab, merges, lowercase=lowercase, unk_token=unk_token)

    def save(self, vocab_path, merges_path):
        with open(vocab_path, 'w') as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(merges_path, 'w') as f:
            f.write('#version: 0.2 - Trained by `edgedict_tpu`\n')
            for a, b in self.merges:
                f.write(f'{a} {b}\n')

    # -- core BPE --

    def _native_engine(self):
        """Lazily build the C++ merge engine (native/libchar_bpe.so) over
        vocab ids; None when the lib or any merge target is unavailable."""
        if getattr(self, '_native', False) is False:
            self._native = None
            try:
                from edgedict_tpu_torch._native import NativeBPE, available
                if available()['char_bpe']:
                    merges_ids = []
                    for a, b in self.merges:
                        ia, ib = self.vocab.get(a), self.vocab.get(b)
                        im = self.vocab.get(a + b)
                        if None in (ia, ib, im):
                            return self._native
                        merges_ids.append((ia, ib, im))
                    self._native = NativeBPE(merges_ids)
            except Exception:
                self._native = None
        return self._native

    def _bpe_word(self, word):
        """Split one word into BPE symbols (word excludes whitespace)."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        symbols = list(word)
        symbols[-1] = symbols[-1] + WORD_END
        engine = self._native_engine()
        if engine is not None:
            sym_ids = [self.vocab.get(s) for s in symbols]
            if None not in sym_ids:       # unknown chars → python fallback
                out = [self.inv_vocab[i]
                       for i in engine.encode_word(sym_ids)]
                if len(self._cache) < 1 << 20:
                    self._cache[word] = out
                return out
        while len(symbols) > 1:
            best_rank, best_i = None, None
            for i in range(len(symbols) - 1):
                r = self.ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            a, b = symbols[best_i], symbols[best_i + 1]
            # merge every occurrence of the best pair, left to right
            out, i = [], 0
            while i < len(symbols):
                if (i < len(symbols) - 1 and symbols[i] == a
                        and symbols[i + 1] == b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out
        if len(self._cache) < 1 << 20:
            self._cache[word] = symbols
        return symbols

    @staticmethod
    def pre_tokenize(text):
        """Bert-style pre-tokenization: split on whitespace; every
        punctuation character becomes its own word (matches the
        BertPreTokenizer inside huggingface CharBPETokenizer)."""
        words = []
        cur = []
        for ch in text:
            if ch.isspace():
                if cur:
                    words.append(''.join(cur))
                    cur = []
            elif _is_punctuation(ch):
                if cur:
                    words.append(''.join(cur))
                    cur = []
                words.append(ch)
            else:
                cur.append(ch)
        if cur:
            words.append(''.join(cur))
        return words

    def tokenize(self, text):
        if self.lowercase:
            text = text.lower()
        tokens = []
        for word in self.pre_tokenize(text):
            tokens.extend(self._bpe_word(word))
        return tokens

    def encode(self, text):
        """Encode text to ids.  A whole word whose symbols are not all in the
        vocab contributes <unk> per missing symbol (HF BPE unk behavior)."""
        ids = []
        for tok in self.tokenize(text):
            i = self.vocab.get(tok)
            if i is None:
                i = self.unk_id
            if i is not None:
                ids.append(i)
        return ids

    def id_to_token(self, idx):
        return self.inv_vocab.get(int(idx))

    def decode(self, ids):
        text = ''.join(self.inv_vocab.get(int(i), '') for i in ids)
        return text.replace(WORD_END, ' ').strip()

    # -- training (pure-Python fallback; HF rust trainer preferred) --

    @classmethod
    def train(cls, texts, vocab_size, special_tokens, lowercase=True,
              min_frequency=2):
        """Classic BPE training: repeatedly merge the most frequent pair.
        Runs on the native trainer (native/bpe_trainer.cpp — incremental
        pair counts + lazy heap) when built; the pure-Python loop below is
        the fallback and produces IDENTICAL merges (property-tested)."""
        word_freq = {}
        for text in texts:
            if lowercase:
                text = text.lower()
            for word in text.split():
                word_freq[word] = word_freq.get(word, 0) + 1
        # words as tuples of symbols
        words = []
        for word, freq in word_freq.items():
            symbols = list(word)
            symbols[-1] += WORD_END
            words.append([symbols, freq])

        vocab = {}
        for tok in special_tokens:
            vocab[tok] = len(vocab)
        alphabet = set()
        for symbols, _ in words:
            alphabet.update(symbols)
        for sym in sorted(alphabet):
            if sym not in vocab:
                vocab[sym] = len(vocab)

        try:
            from edgedict_tpu_torch._native import (
                available, train_bpe_merges)
            native_ok = available()['bpe_trainer']
        except Exception:
            native_ok = False
        if native_ok:
            merges = train_bpe_merges(
                [(tuple(s), f) for s, f in words], sorted(alphabet),
                max_merges=max(vocab_size - len(vocab), 0),
                min_frequency=min_frequency)
            for a, b in merges:
                vocab[a + b] = len(vocab)
            return cls(vocab, merges, lowercase=lowercase,
                       unk_token=special_tokens[-1] if special_tokens
                       else UNK_token)

        merges = []
        while len(vocab) < vocab_size:
            pair_counts = {}
            for symbols, freq in words:
                for i in range(len(symbols) - 1):
                    p = (symbols[i], symbols[i + 1])
                    pair_counts[p] = pair_counts.get(p, 0) + freq
            if not pair_counts:
                break
            best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
            (a, b), count = best
            if count < min_frequency:
                break
            merges.append((a, b))
            merged = a + b
            vocab[merged] = len(vocab)
            for entry in words:
                symbols = entry[0]
                if merged not in word_contains(symbols, a, b):
                    continue
                out, i = [], 0
                while i < len(symbols):
                    if (i < len(symbols) - 1 and symbols[i] == a
                            and symbols[i + 1] == b):
                        out.append(merged)
                        i += 2
                    else:
                        out.append(symbols[i])
                        i += 1
                entry[0] = out
        return cls(vocab, merges, lowercase=lowercase,
                   unk_token=special_tokens[-1] if special_tokens
                   else UNK_token)


def word_contains(symbols, a, b):
    """Return {a+b} if the pair (a, b) occurs in symbols, else {}."""
    for i in range(len(symbols) - 1):
        if symbols[i] == a and symbols[i + 1] == b:
            return {a + b}
    return {}


class HuggingFaceTokenizer:
    """CharBPE tokenizer with the reference's cache layout and id scheme.

    Drop-in for the reference class (rnnt/tokenizer.py:69-123): same
    `<cache_dir>/<vocab_size>-<max_length>-{vocab.json,merges.txt}` cache
    naming, same `decode` behavior (ids ≤ 3 dropped).  Backed by the
    pure-Python CharBPE engine; training uses the HF rust trainer when
    importable (exact reference behavior) with a pure-Python fallback.
    """

    def __init__(self, cache_dir, max_length=None, vocab_size=400):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.cache_dir = cache_dir
        self.name = '%d-%s' % (vocab_size, max_length)
        self.tokenizer = None
        self._special_ids_max = UNK  # ids ≤ this are dropped on decode

        vocab = os.path.join(cache_dir, self.name + '-vocab.json')
        merges = os.path.join(cache_dir, self.name + '-merges.txt')
        if not (os.path.exists(vocab) and os.path.exists(merges)):
            # legacy v1 cache layout: `<cache_dir>/-vocab.json` (BPE-1024)
            legacy_v = os.path.join(cache_dir, '-vocab.json')
            legacy_m = os.path.join(cache_dir, '-merges.txt')
            if os.path.exists(legacy_v) and os.path.exists(legacy_m):
                vocab, merges = legacy_v, legacy_m
        if os.path.exists(vocab) and os.path.exists(merges):
            self.tokenizer = CharBPE.from_files(vocab, merges)
            self.vocab_size = len(self.tokenizer.vocab)
            # v1 scheme has <unk>=2 and no <pad>; detect it so decode drops
            # the right special ids (SURVEY.md §"Two generations coexist")
            if self.tokenizer.vocab.get('<unk>') == 2:
                self._special_ids_max = 2

    def build(self, texts):
        if self.tokenizer is not None:
            return
        specials = [NUL_token, PAD_token, BOS_token, UNK_token]
        trained = None
        try:
            import tempfile
            from tokenizers import CharBPETokenizer
            with tempfile.NamedTemporaryFile('w', suffix='.txt') as f:
                f.write(' '.join(texts).lower())
                f.flush()
                hf = CharBPETokenizer(lowercase=True)
                hf.train([f.name], vocab_size=self.vocab_size,
                         special_tokens=specials)
            vocab = {tok: i for tok, i in hf.get_vocab().items()}
            merges = _extract_hf_merges(hf)
            trained = CharBPE(vocab, merges)
        except Exception:
            trained = CharBPE.train(texts, self.vocab_size, specials)
        self.tokenizer = trained
        self.vocab_size = len(trained.vocab)
        os.makedirs(self.cache_dir, exist_ok=True)
        trained.save(
            os.path.join(self.cache_dir, self.name + '-vocab.json'),
            os.path.join(self.cache_dir, self.name + '-merges.txt'))

    def encode(self, text):
        ids = self.tokenizer.encode(text.lower())
        return ids[:self.max_length]

    def decode(self, tokens, skip_special_tokens=True):
        keep = [int(t) for t in tokens if int(t) > self._special_ids_max]
        return self.tokenizer.decode(keep)

    def decode_plus(self, token_batch):
        return [self.decode(tokens) for tokens in token_batch]

    @property
    def unk_id(self):
        return self.tokenizer.unk_id

    def id_to_token(self, idx):
        return self.tokenizer.inv_vocab.get(int(idx), UNK_token)


def _extract_hf_merges(hf_tokenizer):
    """Pull the ordered merge list out of a trained HF tokenizer."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        hf_tokenizer._tokenizer.model.save(d, 'tmp')
        merges = []
        with open(os.path.join(d, 'tmp-merges.txt')) as f:
            for line in f:
                line = line.rstrip('\n')
                if line.startswith('#version') or not line:
                    continue
                a, b = line.split(' ')
                merges.append((a, b))
    return merges
