"""Word-level timestamps and confidences via CTC forced alignment.

The reference emits phrase-level timestamps only (tone/pipeline.py:151-164).
Production telephony analytics (agent-script compliance, keyword spotting)
want word times and confidences, so this module aligns a decoded transcript
back to its phrase logprobs with the standard CTC Viterbi pass over the
blank-extended label sequence and reads word boundaries and path
probabilities off the best alignment.

Any decoded text is alignable: every decoder (greedy, beam, device beam,
fused) emits a transcript that corresponds to at least one CTC path through
the same logprobs.

Host-side numpy: phrases are short (the splitter force-splits at 2000
frames), and alignment is O(T·|text|) — microseconds per phrase, far off
the hot path.

A copy of ``tone_tpu/align.py``, kept in this package so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tone_tpu_torch.config import BLANK_ID, LABELS


@dataclass(frozen=True)
class WordTiming:
    """One word of a phrase: times in seconds (absolute, like TextPhrase),
    confidence = geometric mean of the aligned per-frame character
    probabilities (0..1]."""

    word: str
    start_time: float
    end_time: float
    confidence: float


def spans_to_word_timings(spans, start_frame: int, frame_size: float,
                          bias: float) -> tuple[WordTiming, ...]:
    """Word spans (from :func:`align_words` /
    ``ops.align_device.align_words_batch``) → absolute-time WordTimings.

    The one place the frame→seconds arithmetic lives (pipeline, bulk
    transcriber, and serving engine all call it).  Confidence is floored at
    1e-6 so it stays in (0, 1] after rounding."""
    return tuple(
        WordTiming(
            word=w,
            start_time=max(0.0, round(
                (start_frame + f0) * frame_size - bias, 2)),
            end_time=max(0.0, round(
                (start_frame + f1 + 1) * frame_size - bias, 2)),
            confidence=max(round(conf, 6), 1e-6),
        )
        for w, f0, f1, conf in spans)


def viterbi_align(logprobs: np.ndarray, label_ids,
                  blank_id: int = BLANK_ID) -> list[tuple[int, int, int]]:
    """Best CTC path for ``label_ids`` through (T, V) natural-log probs.

    Returns per-label (first_frame, last_frame, label_id) — the frames the
    best path spends emitting each label occurrence.  Empty labels align to
    nothing.  Raises ValueError if the sequence cannot fit in T frames
    (can't happen for text produced by a CTC decode of these logprobs).
    """
    lp = np.asarray(logprobs, np.float32)
    t_max = lp.shape[0]
    labels = list(label_ids)
    n = len(labels)
    if n == 0:
        return []
    # blank-extended sequence: [b, c1, b, c2, ..., b]
    ext = np.empty(2 * n + 1, np.int32)
    ext[0::2] = blank_id
    ext[1::2] = labels
    s_max = ext.size
    if t_max < n + np.sum(np.asarray(labels[1:]) == np.asarray(labels[:-1])):
        raise ValueError(f"{n} labels cannot align to {t_max} frames")

    emit = lp[:, ext]                                   # (T, S)
    # skip from s-2 allowed when ext[s] is a char differing from ext[s-2]
    can_skip = np.zeros(s_max, bool)
    can_skip[3::2] = ext[3::2] != ext[1:-2:2]
    can_skip[1] = False  # s=1 has no s-2
    NEG = np.float32(-1e30)

    alpha = np.full(s_max, NEG, np.float32)
    alpha[0] = emit[0, 0]
    if s_max > 1:
        alpha[1] = emit[0, 1]
    psi = np.zeros((t_max, s_max), np.int8)
    # preallocated scratch: the T-loop is the whole cost (a force-split
    # phrase is 2000 frames x ~4000 states), so avoid per-step allocation
    prev = np.empty(s_max, np.float32)
    skip = np.empty(s_max, np.float32)
    best = np.empty(s_max, np.float32)
    skip_base = np.where(can_skip, 0.0, NEG).astype(np.float32)
    for t in range(1, t_max):
        prev[0] = NEG
        prev[1:] = alpha[:-1]
        skip[:2] = NEG
        np.add(alpha[:-2], skip_base[2:], out=skip[2:])
        row = psi[t]
        np.greater(prev, alpha, out=row.view(bool))   # 1 where prev wins stay
        np.maximum(alpha, prev, out=best)
        np.copyto(row, 2, where=skip > best)
        np.maximum(best, skip, out=best)
        np.add(best, emit[t], out=alpha)

    s = int(np.argmax(alpha[s_max - 2:])) + s_max - 2 if s_max > 1 else 0
    if alpha[s] <= NEG:
        raise ValueError("no feasible CTC alignment")
    # backtrack: record the frame span spent in each odd (char) state
    first = np.full(s_max, -1, np.int64)
    last = np.full(s_max, -1, np.int64)
    for t in range(t_max - 1, -1, -1):
        if s % 2 == 1:
            first[s] = t
            if last[s] < 0:
                last[s] = t
        if t > 0:
            s -= int(psi[t, s])
    return [(int(first[2 * i + 1]), int(last[2 * i + 1]), labels[i])
            for i in range(n)]


def align_words(logprobs: np.ndarray, text: str,
                blank_id: int = BLANK_ID) -> list[tuple[str, int, int, float]]:
    """Word spans of ``text`` in (T, V) phrase logprobs.

    Returns per word (word, first_frame, last_frame, confidence); frames are
    relative to the phrase.  ``text`` must use the label alphabet.
    """
    lp = np.asarray(logprobs, np.float32)
    words = text.split()
    if not words:
        return []
    label_ids = [LABELS.index(c) for c in " ".join(words)]
    spans = viterbi_align(lp, label_ids, blank_id)
    out = []
    i = 0
    for word in words:
        chars = spans[i:i + len(word)]
        i += len(word) + 1  # skip the separating space
        logp = float(np.mean([lp[f, c[2]]
                              for c in chars for f in range(c[0], c[1] + 1)]))
        out.append((word, chars[0][0], chars[-1][1], float(np.exp(logp))))
    return out
