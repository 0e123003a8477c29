"""CTC prefix beam search with optional word-level n-gram LM scoring.

A from-scratch implementation of the decoding capability the reference gets
from pyctcdecode + KenLM (tone/decoder.py:108-133): beam width 200, LM weight
``alpha`` applied to log10 word probabilities (converted to natural log),
word-insertion bonus ``beta`` per completed word — the same scoring scheme as
pyctcdecode's shallow-fusion defaults.

The search is exposed in two forms:

* :func:`ctc_beam_search` — decode a whole (T, V) logprob matrix (the
  reference's per-phrase usage, tone/decoder.py:133);
* :class:`StreamingBeamSearch` — the same search as carried state:
  ``advance(frames)`` consumes logprobs as they arrive and ``result()``
  reads the current best hypothesis without finalizing.  Prefix beam search
  is frame-sequential, so the incremental path is *exactly* the batch path
  (tests/test_torch_host_beam.py asserts equality) — this is what the
  serving layer uses for low-latency interim transcripts, a capability
  beyond the reference (which only decodes completed phrases).

This pure-Python implementation is the reference/fallback path; the C++
decoder in ``tone_tpu_torch/decoding/native`` implements the identical
algorithm (both forms) for production throughput (host-side, decoupled
from the device tick loop).

A copy of ``tone_tpu/decoding/beam.py``, kept in this package so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from tone_tpu_torch.decoding.hotwords import HotwordScorer
    from tone_tpu_torch.decoding.lm import LanguageModel

LOG10_TO_LN = math.log(10.0)
NEG_INF = -math.inf


@dataclass
class _Beam:
    """One beam hypothesis over collapsed text."""

    text: str  # full text including completed words
    partial: str  # chars of the in-progress word
    last_char: str  # last emitted (non-blank) char, for repeat-collapse
    p_b: float  # log prob of this prefix ending in blank
    p_nb: float  # log prob of this prefix ending in non-blank
    lm_score: float  # accumulated LM + hotword contribution (natural log)
    context: tuple[str, ...]  # word history for the LM
    hw: tuple = (0, 0.0)  # hotword automaton state (pure fn of text+partial)

    def total(self) -> float:
        return np.logaddexp(self.p_b, self.p_nb) + self.lm_score


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


class StreamingBeamSearch:
    """CTC prefix beam search over an unbounded frame stream.

    The carried state is the pruned beam set; feeding frames in any split
    produces the same beams as one batch pass (the algorithm is
    frame-sequential).  ``result()`` applies the final trailing-word LM
    scoring to a *copy* of the ranking, so it can be read every tick for
    interim transcripts and again after the last frame.
    """

    def __init__(
        self,
        labels: str,
        lm: "LanguageModel | None" = None,
        *,
        alpha: float = 0.4,
        beta: float = 0.9,
        beam_width: int = 200,
        token_min_logp: float = -5.0,
        blank_id: int | None = None,
        hotwords: "HotwordScorer | None" = None,
    ) -> None:
        self.labels = labels
        self.lm = lm
        self.alpha = alpha
        self.beta = beta
        self.beam_width = beam_width
        self.token_min_logp = token_min_logp
        self.blank_id = blank_id
        self.hotwords = hotwords
        self.reset()

    def reset(self) -> None:
        init_ctx = self.lm.begin_context() if self.lm is not None else ()
        self._beams: dict[tuple[str, str, str], _Beam] = {
            ("", "", ""): _Beam("", "", "", 0.0, NEG_INF, 0.0, init_ctx),
        }

    def _lm_word_score(self, context: tuple[str, ...], word: str) -> float:
        if self.lm is None or not word:
            return 0.0
        return self.alpha * self.lm.score(context, word) * LOG10_TO_LN + self.beta

    def advance(self, logprobs: np.ndarray) -> None:
        """Consume (T, V) natural-log probability frames."""
        logprobs = np.asarray(logprobs, dtype=np.float64)
        t_max, n_classes = logprobs.shape
        blank_id = self.blank_id if self.blank_id is not None else n_classes - 1
        labels = self.labels
        lm = self.lm
        beams = self._beams

        for t in range(t_max):
            frame = logprobs[t]
            best_tok = int(frame.argmax())
            tokens = np.flatnonzero(frame >= self.token_min_logp)
            if best_tok not in tokens:
                tokens = np.append(tokens, best_tok)

            next_beams: dict[tuple[str, str, str], _Beam] = {}

            def merge(key, text, partial, last_char, p_b, p_nb, lm_score, context,
                      hw=(0, 0.0)):
                b = next_beams.get(key)
                if b is None:
                    next_beams[key] = _Beam(text, partial, last_char, p_b, p_nb,
                                            lm_score, context, hw)
                else:
                    # hw/lm_score/context are pure functions of the key's
                    # (text, partial), so merged sources always agree on them.
                    b.p_b = _logsumexp2(b.p_b, p_b)
                    b.p_nb = _logsumexp2(b.p_nb, p_nb)

            hotwords = self.hotwords
            for beam in beams.values():
                p_total = _logsumexp2(beam.p_b, beam.p_nb)
                for tok in tokens:
                    p = float(frame[tok])
                    if tok == blank_id:
                        merge((beam.text, beam.partial, beam.last_char),
                              beam.text, beam.partial, beam.last_char,
                              p_total + p, NEG_INF, beam.lm_score, beam.context,
                              beam.hw)
                        continue
                    char = labels[tok]
                    if char == beam.last_char:
                        # Same char: extends the run (no new symbol) from p_nb...
                        merge((beam.text, beam.partial, beam.last_char),
                              beam.text, beam.partial, beam.last_char,
                              NEG_INF, beam.p_nb + p, beam.lm_score, beam.context,
                              beam.hw)
                        # ...or a new symbol after an explicit blank.
                        src = beam.p_b
                    else:
                        src = p_total
                    if src == NEG_INF:
                        continue
                    if char == " ":
                        # Word boundary: score the completed partial word.
                        # Consecutive spaces collapse (empty words are dropped).
                        word = beam.partial
                        new_text = beam.text + word + " " if word else beam.text
                        new_ctx = (beam.context + (word,)
                                   if (lm is not None and word) else beam.context)
                        hw, hw_delta = beam.hw, 0.0
                        if hotwords is not None and word:
                            # Collapsed (empty-word) spaces emit no text, so
                            # they don't step the automaton either.
                            hw, hw_delta = hotwords.step(beam.hw, " ")
                        merge((new_text, "", " "),
                              new_text, "", " ",
                              NEG_INF, src + p,
                              beam.lm_score + hw_delta
                              + self._lm_word_score(beam.context, word),
                              new_ctx, hw)
                    else:
                        hw, hw_delta = beam.hw, 0.0
                        if hotwords is not None:
                            hw, hw_delta = hotwords.step(beam.hw, char)
                        merge((beam.text, beam.partial + char, char),
                              beam.text, beam.partial + char, char,
                              NEG_INF, src + p, beam.lm_score + hw_delta,
                              beam.context, hw)

            # Deterministic prune: total desc, then prefix text asc as the tie
            # break (insertion-order-independent; matches the native decoder).
            pruned = sorted(next_beams.values(),
                            key=lambda b: (-b.total(), b.text + b.partial)
                            )[:self.beam_width]
            beams = {(b.text, b.partial, b.last_char): b for b in pruned}

        self._beams = beams

    def result(self) -> str:
        """Best hypothesis so far: trailing partial words get their final LM
        score for the ranking (non-destructive — advancing may still change
        the outcome)."""
        return self.nbest(1)[0][0]

    def nbest(self, n: int) -> list[tuple[str, float]]:
        """Up to ``n`` (text, score) hypotheses, best first — the
        pyctcdecode ``decode_beams`` capability.  Scores are natural-log
        acoustic + LM/hotword totals with the trailing partial word's
        provisional LM score applied, i.e. the same ranking ``result``
        uses.  Distinct beams can collapse to the same stripped text
        (trailing-space twins); only the best-scoring one is kept."""
        def final_key(b: _Beam):
            return (-(b.total() + self._lm_word_score(b.context, b.partial)),
                    b.text + b.partial)

        out: list[tuple[str, float]] = []
        seen: set[str] = set()
        for b in sorted(self._beams.values(), key=final_key):
            text = (b.text + b.partial).strip()
            if text in seen:
                continue
            seen.add(text)
            score = b.total() + self._lm_word_score(b.context, b.partial)
            if score == NEG_INF and out:
                break  # placeholder beams
            out.append((text, float(score)))
            if len(out) >= n:
                break
        return out


def ctc_beam_search(
    logprobs: np.ndarray,
    labels: str,
    lm: "LanguageModel | None" = None,
    *,
    alpha: float = 0.4,
    beta: float = 0.9,
    beam_width: int = 200,
    token_min_logp: float = -5.0,
    blank_id: int | None = None,
    hotwords: "HotwordScorer | None" = None,
) -> str:
    """Decode (T, V) logprobs into text.

    Args:
        logprobs: (T, vocab+1) natural-log probabilities; the blank is the
            last class unless ``blank_id`` is given.
        labels: string of characters for classes 0..len(labels)-1; the space
            character delimits words for LM scoring.
        lm: optional word LM scoring ``log10 P(word | context)``.
        alpha: LM weight (applied to ln-converted LM scores).
        beta: word-insertion bonus per completed word.
        beam_width: number of beams kept per frame.
        token_min_logp: per-frame tokens below this logprob are not expanded
            (except the best token of the frame).

    Returns:
        The decoded text (stripped).
    """
    search = StreamingBeamSearch(
        labels, lm, alpha=alpha, beta=beta, beam_width=beam_width,
        token_min_logp=token_min_logp, blank_id=blank_id, hotwords=hotwords)
    search.advance(logprobs)
    return search.result()
