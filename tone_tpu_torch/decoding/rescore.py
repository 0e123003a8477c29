"""N-best LM rescoring for the on-TPU beam search.

The reference fuses the word n-gram LM into the beam search frame by frame
(shallow fusion, pyctcdecode semantics: α · log10→ln word probability plus
a β insertion bonus per completed word — tone/decoder.py:108).  That makes
LM lookups part of the per-frame inner loop, which is why the reference's
decode is host-sequential C++.

With the search itself running batched on the TPU
(``ops/beam_decode.py``), the LM moves to a per-hypothesis post-pass: the
device emits an n-best list with exact acoustic prefix scores, and the host
applies the *same* α/β word scoring once per hypothesis.  Cost drops from
O(frames × beams × LM) to O(n-best × words × LM) — three orders of
magnitude fewer LM lookups per phrase — at the cost of the LM not steering
the in-search pruning (mitigated by a wider device beam, which is nearly
free on the MXU/VPU).

When every word of the fused search's winning hypothesis also survives in
the n-best list, rescoring picks the same transcript; tests compare both
against the full-fusion host search on synthetic LMs.

A copy of ``tone_tpu/decoding/rescore.py``, kept in this package so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import math

from tone_tpu_torch.decoding.lm import LanguageModel

LOG10_TO_LN = math.log(10.0)


def lm_hypothesis_score(
    lm: LanguageModel, text: str, *, alpha: float = 0.4, beta: float = 0.9,
) -> float:
    """Σ over words of ``alpha · ln10 · log10 P(word | context) + beta`` —
    the shallow-fusion LM contribution of a completed hypothesis
    (the host search's ``_lm_word_score``, ``tone_tpu/decoding/beam.py``,
    applied per word)."""
    score = 0.0
    begin = getattr(lm, "begin_context", None)  # NativeLM lacks the method
    context = begin() if begin is not None else ("<s>",)
    for word in text.split():
        score += alpha * lm.score(context, word) * LOG10_TO_LN + beta
        context = context + (word,)
    return score


def rescore_nbest(
    hyps: list[tuple[str, float]],
    lm: LanguageModel | None,
    *,
    alpha: float = 0.4,
    beta: float = 0.9,
) -> list[tuple[str, float]]:
    """Re-rank (text, acoustic_logp) pairs by acoustic + LM score.

    Without an LM this is the identity ranking (β alone would only
    re-order hypotheses with different word counts, which the reference's
    no-LM greedy path doesn't do either).
    """
    if lm is None or not hyps:
        return list(hyps)
    scored = [
        (text, acoustic + lm_hypothesis_score(lm, text, alpha=alpha, beta=beta))
        for text, acoustic in hyps
    ]
    scored.sort(key=lambda p: -p[1])
    return scored
