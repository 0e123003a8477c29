"""Plain reference of how T-one's logprobs become phrases and texts.

The reference splitter (``tone/logprob_splitter.py``), stated over a whole
stream at once: a frame is speech where P(blank) + P(space) <= 0.9; a
phrase ends at a silence of at least 20 frames (600 ms), the stream's
start and end counting as silence; a phrase of 2,000 frames or more is
cut into pieces of 2,000; each phrase is decoded from its frames with 3
more on each side.  Greedy CTC decoding takes the best class per frame,
merges repeats, drops the blank and strips spaces at the ends.

Numpy only; it imports nothing of the program it judges.
"""

from __future__ import annotations

import numpy as np

SILENCE_THRESHOLD = 0.9
MIN_SILENCE = 20
EXPAND = 3
MAX_PHRASE = 2000


def phrase_spans(logprobs: np.ndarray) -> list[tuple[int, int]]:
    """(start, end) frames of each phrase of a finished stream."""
    # float32, as the program decides it from its logprobs
    speech = np.exp(logprobs[..., -2:]).sum(axis=-1) <= SILENCE_THRESHOLD
    silent = [True] * MIN_SILENCE + [not s for s in speech] + [True] * MIN_SILENCE
    runs = []  # silence runs of MIN_SILENCE frames or more, in stream frames
    i = 0
    while i < len(silent):
        if silent[i]:
            j = i
            while j < len(silent) and silent[j]:
                j += 1
            if j - i >= MIN_SILENCE:
                runs.append((i - MIN_SILENCE, j - MIN_SILENCE))
            i = j
        else:
            i += 1
    spans = []
    for (_, start), (end, _) in zip(runs, runs[1:]):
        while end - start >= MAX_PHRASE:
            spans.append((start, start + MAX_PHRASE))
            start += MAX_PHRASE
        spans.append((start, end))
    return spans


def greedy_text(logprobs: np.ndarray, labels: str) -> str:
    text, prev = [], -1
    for t in logprobs.argmax(-1).tolist():
        if t != prev and t < len(labels):
            text.append(labels[t])
        prev = t
    return "".join(text).strip()


def phrase_texts(logprobs: np.ndarray, labels: str) -> list[str]:
    """The texts of a finished stream's phrases, in order."""
    return [greedy_text(logprobs[max(0, a - EXPAND):b + EXPAND], labels)
            for a, b in phrase_spans(logprobs)]
