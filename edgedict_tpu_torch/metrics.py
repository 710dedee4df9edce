"""Evaluation metrics (counterpart of edgedict_tpu/metrics.py, the part the
trainer uses): word error rate with the contract of `jiwer.wer` (reference
cli/baseline.py:284): total word-level edit distance over total reference
words, corpus-wide when given lists.
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
