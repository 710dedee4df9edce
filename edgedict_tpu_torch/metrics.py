"""Evaluation metrics (counterpart of edgedict_tpu/metrics.py): word error
rate with the contract of `jiwer.wer` (reference cli/baseline.py:284):
total word-level edit distance over total reference words, corpus-wide
when given lists; `compute_measures`, its hit / substitution / deletion /
insertion breakdown (the counts a data-parallel eval sums across ranks);
and the character error rate `cer`.
"""


def _edit_distance(ref, hyp):
    """Levenshtein distance between two token sequences."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ri != hyp[j - 1])
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    return prev[m]


def wer(truth, hypothesis):
    """Corpus WER.  Accepts a string or a list of strings for each side."""
    if isinstance(truth, str):
        truth = [truth]
    if isinstance(hypothesis, str):
        hypothesis = [hypothesis]
    errors = 0
    words = 0
    for t, h in zip(truth, hypothesis):
        t_words = t.split()
        errors += _edit_distance(t_words, h.split())
        words += len(t_words)
    return errors / max(words, 1)


def compute_measures(truth, hypothesis):
    """jiwer.compute_measures-style breakdown (the reference logs it at
    cli/lightning.py:108-116): WER plus hit/substitution/deletion/insertion
    counts over word sequences."""
    if isinstance(truth, str):
        truth, hypothesis = [truth], [hypothesis]
    h = s = d = i_n = 0
    for t, hy in zip(truth, hypothesis):
        ref, hyp = t.split(), hy.split()
        n, m = len(ref), len(hyp)
        # Levenshtein with backtrace counts
        dp = [[(0, 0, 0, 0)] * (m + 1) for _ in range(n + 1)]
        for j in range(1, m + 1):
            dp[0][j] = (0, 0, 0, j)
        for i in range(1, n + 1):
            dp[i][0] = (0, 0, i, 0)
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                if ref[i - 1] == hyp[j - 1]:
                    hh, ss, dd, ii = dp[i - 1][j - 1]
                    dp[i][j] = (hh + 1, ss, dd, ii)
                else:
                    def add(c, delta):
                        return tuple(a + b for a, b in zip(c, delta))
                    cands = [add(dp[i - 1][j - 1], (0, 1, 0, 0)),
                             add(dp[i - 1][j], (0, 0, 1, 0)),
                             add(dp[i][j - 1], (0, 0, 0, 1))]
                    dp[i][j] = min(cands,
                                   key=lambda c: c[1] + c[2] + c[3])
        hh, ss, dd, ii = dp[n][m]
        h += hh
        s += ss
        d += dd
        i_n += ii
    total = max(h + s + d, 1)
    return {'wer': (s + d + i_n) / total, 'hits': h, 'substitutions': s,
            'deletions': d, 'insertions': i_n}


def cer(truth, hypothesis):
    """Corpus character error rate."""
    if isinstance(truth, str):
        truth = [truth]
    if isinstance(hypothesis, str):
        hypothesis = [hypothesis]
    errors = 0
    chars = 0
    for t, h in zip(truth, hypothesis):
        errors += _edit_distance(list(t), list(h))
        chars += len(t)
    return errors / max(chars, 1)
