"""Word-level n-gram language models for CTC beam-search decoding.

The reference scores beams with KenLM (C++) through pyctcdecode
(tone/decoder.py:108).  Neither is available here, so this module provides:

* :class:`ArpaLM` — a backoff n-gram LM loaded from ARPA text (optionally
  gzip-compressed), with standard Katz-backoff queries in log10 space
  (the same quantity KenLM returns).
* a loader that dispatches on file magic: ARPA text vs a KenLM binary
  (read in Python by ``kenlm_binary`` and ``kenlm_trie``; see ``load_lm``).

Queries are stateful-by-context: ``score(context, word)`` returns
``log10 P(word | context)`` with backoff, where ``context`` is a tuple of
previous words (most recent last).

A copy of ``tone_tpu/decoding/lm.py``, kept in this package so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import gzip
import math
from pathlib import Path

__all__ = ["ArpaLM", "load_lm", "LanguageModel"]


class LanguageModel:
    """Interface: log10 word probabilities with backoff."""

    order: int = 1

    def score(self, context: tuple[str, ...], word: str) -> float:
        raise NotImplementedError

    def begin_context(self) -> tuple[str, ...]:
        return ("<s>",)


class ArpaLM(LanguageModel):
    """Katz-backoff n-gram LM from an ARPA file.

    Probabilities and backoffs are stored in log10, as in the file format.
    Unknown words fall back to ``<unk>`` when present, else a floor score.
    """

    UNK_SCORE_FLOOR = -10.0

    def __init__(self, ngrams: list[dict[tuple[str, ...], tuple[float, float]]]):
        # ngrams[k] maps a (k+1)-tuple of words -> (log10 prob, log10 backoff).
        self._ngrams = ngrams
        self.order = len(ngrams)

    @classmethod
    def from_file(cls, path: str | Path) -> "ArpaLM":
        path = Path(path)
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            return cls._parse(f)

    @classmethod
    def _parse(cls, lines) -> "ArpaLM":
        ngrams: list[dict[tuple[str, ...], tuple[float, float]]] = []
        current: dict[tuple[str, ...], tuple[float, float]] | None = None
        section_n = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            if line.startswith("\\") and "-grams:" in line:
                section_n = int(line.strip("\\").split("-")[0])
                while len(ngrams) < section_n:
                    ngrams.append({})
                current = ngrams[section_n - 1]
                continue
            if line.startswith("\\end\\"):
                break
            if current is None:
                continue  # header / \data\ section
            parts = line.split("\t")
            if len(parts) < 2:
                parts = line.split()
                if len(parts) < section_n + 1:
                    continue
                prob = float(parts[0])
                words = tuple(parts[1:1 + section_n])
                backoff = float(parts[1 + section_n]) if len(parts) > 1 + section_n else 0.0
            else:
                prob = float(parts[0])
                words = tuple(parts[1].split())
                backoff = float(parts[2]) if len(parts) > 2 else 0.0
            current[words] = (prob, backoff)
        if not ngrams:
            raise ValueError("no n-gram sections found in ARPA file")
        return cls(ngrams)

    def score(self, context: tuple[str, ...], word: str) -> float:
        """log10 P(word | context) with Katz backoff."""
        context = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        if (word,) not in self._ngrams[0]:
            if ("<unk>",) in self._ngrams[0]:
                word = "<unk>"
            else:
                return self.UNK_SCORE_FLOOR

        # Try longest n-gram first; accumulate backoff weights on misses.
        backoff_sum = 0.0
        for start in range(len(context) + 1):
            ctx = context[start:]
            gram = (*ctx, word)
            entry = self._ngrams[len(gram) - 1].get(gram) if len(gram) <= self.order else None
            if entry is not None:
                return entry[0] + backoff_sum
            # No full n-gram: add the backoff weight of the context we drop.
            if ctx:
                ctx_entry = self._ngrams[len(ctx) - 1].get(ctx)
                if ctx_entry is not None:
                    backoff_sum += ctx_entry[1]
        return self._ngrams[0][(word,)][0] + backoff_sum


def load_lm(path: str | Path) -> LanguageModel:
    """Load an LM file: ARPA text (optionally .gz) or a KenLM binary —
    probing/rest-probing hash tables (the reference's published ``kenlm.bin``
    flavor) or trie/quant-trie, dispatched on the binary header."""
    path = Path(path)
    head = (gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")).read(9)
    if head.startswith(b"mmap lm "):  # KenLM binary magic
        from tone_tpu_torch.decoding.kenlm_binary import kenlm_model_type

        if kenlm_model_type(path) in (2, 3, 4, 5):
            from tone_tpu_torch.decoding.kenlm_trie import KenLMTrie

            return KenLMTrie(path)
        from tone_tpu_torch.decoding.kenlm_binary import KenLMBinary

        return KenLMBinary(path)
    return ArpaLM.from_file(path)
