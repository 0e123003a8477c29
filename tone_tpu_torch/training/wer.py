"""Word error rate — the project's quality metric.

Matches the aggregate WER semantics the reference gets from
``nemo...word_error_rate`` (dev/triton/client_wer.py:329): total edit
distance over total reference words across the corpus.  Includes the
reference evaluation's text normalization (ё -> е, lowercase;
client_wer.py:27-32).
"""

from __future__ import annotations


def normalize_text(text: str) -> str:
    """Normalization used in the reference WER evaluation."""
    return text.replace("ё", "е").replace("Ё", "Е").lower().strip()


def edit_distance(ref: list[str], hyp: list[str]) -> int:
    """Levenshtein distance between token sequences (two-row DP)."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, start=1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, start=1):
            cur[j] = min(
                prev[j] + 1,  # deletion
                cur[j - 1] + 1,  # insertion
                prev[j - 1] + (r != h),  # substitution
            )
        prev = cur
    return prev[-1]


def word_error_rate(hypotheses: list[str], references: list[str],
                    normalize: bool = True) -> float:
    """Corpus-level WER: sum(edit distances) / sum(reference word counts)."""
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses and references must have equal length")
    total_err = 0
    total_words = 0
    for hyp, ref in zip(hypotheses, references):
        if normalize:
            hyp, ref = normalize_text(hyp), normalize_text(ref)
        ref_words = ref.split()
        total_err += edit_distance(ref_words, hyp.split())
        total_words += len(ref_words)
    if total_words == 0:
        return 0.0 if total_err == 0 else float("inf")
    return total_err / total_words
