"""First-party n-gram LM estimation: interpolated modified Kneser-Ney.

The reference's decode-time LM (``kenlm.bin``, tone/decoder.py:84-95) is
*built* with KenLM's external ``lmplz`` binary — a tool outside the
reference repo that a fine-tuning user must install to get a domain LM.
This module closes that loop in-framework: fine-tune the acoustic model
(``tone_tpu.training``), estimate a matching n-gram LM here from the
transcript corpus, write it as ARPA or any KenLM binary flavor
(``write_kenlm_binary`` / ``write_kenlm_trie``), and decode with it on
host or fused on TPU (``DeviceBeamSearchCTCDecoder``).

Algorithm: interpolated modified Kneser-Ney (Chen & Goodman 1998), the
same estimator ``lmplz`` implements (Heafield et al. 2013):

* lower-order tables use continuation ("adjusted") counts — the number
  of distinct left extensions — except n-grams starting with ``<s>``,
  which keep raw counts (nothing can precede ``<s>``);
* per-order discounts D1/D2/D3+ are closed-form from the adjusted
  count-of-counts;
* probabilities interpolate with the next-lower order all the way down
  to a uniform base distribution.

One deliberate deviation from lmplz: the uniform base excludes ``<s>``
(it is never a legal prediction; its unigram probability is the ARPA
conventional -99), so every conditional distribution the model encodes
sums to exactly 1 over the predictable vocabulary — an invariant
tests/test_estimate.py pins.  lmplz instead leaks a 1/|vocab| sliver of
mass onto ``<s>``.

Pure Python + dicts: estimation is an offline, host-side tool; the
decode-time hot paths live in the binary readers and the device LM.

A copy of ``tone_tpu/decoding/estimate.py``, kept in this package so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from collections import Counter
from pathlib import Path
from typing import Iterable, Sequence

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"

Ngrams = list[dict[tuple[str, ...], tuple[float, float]]]


def _count(sentences: Iterable[Sequence[str]], order: int):
    """Raw n-gram counts per order over ``<s> w1..wm </s>`` sentences."""
    raw = [Counter() for _ in range(order)]
    for sent in sentences:
        toks = [BOS, *sent, EOS]
        for n in range(1, order + 1):
            counts = raw[n - 1]
            for i in range(len(toks) - n + 1):
                counts[tuple(toks[i:i + n])] += 1
    return raw


def _adjust(raw, order: int):
    """Adjusted counts: continuation counts for orders < N (distinct left
    extensions), raw counts for the highest order and for ``<s>``-initial
    grams (KenLM adjust phase)."""
    adjusted = [Counter() for _ in range(order)]
    adjusted[order - 1] = raw[order - 1]
    for n in range(order - 1, 0, -1):  # fill order n from raw (n+1)-grams
        cont = adjusted[n - 1]
        for gram in raw[n]:
            cont[gram[1:]] += 1
        for gram, c in raw[n - 1].items():
            if gram[0] == BOS and gram not in cont:
                cont[gram] = c
    return adjusted


def _discounts(counts: Counter, n: int) -> tuple[float, float, float]:
    """Modified-KN discounts (D1, D2, D3+) from count-of-counts; clamped
    with conservative fallbacks where the closed form is undefined
    (lmplz hard-fails there; tiny corpora are a supported use here)."""
    t = Counter()
    for c in counts.values():
        if c <= 4:
            t[c] += 1
    fallback = (0.5, 1.0, 1.5)
    if not t[1] or not t[2]:
        return fallback
    y = t[1] / (t[1] + 2.0 * t[2])
    ds = []
    for k, default in zip((1, 2, 3), fallback):
        if not t[k] or not t[k + 1]:
            ds.append(default)
            continue
        d = k - (k + 1.0) * y * t[k + 1] / t[k]
        # A discount outside (0, k) would create negative pseudo-counts or
        # negative leftover mass; clamp into the open interval.
        ds.append(min(max(d, 1e-6), k - 1e-6))
    return tuple(ds)


def _prune(adjusted, order: int, prune: Sequence[int]):
    """Drop n-grams with adjusted count <= prune[n] (lmplz --prune
    semantics: a shorter threshold list extends its LAST value to the
    remaining higher orders, so ``--prune 0 1`` at order 3 means
    ``[0, 1, 1]``).

    Thresholds must be non-decreasing with order and 0 for unigrams.
    Closure is repaired afterwards: a kept gram's SUFFIX need not clear
    the same threshold (a gram seen after many distinct words can have a
    suffix seen after only one) yet the interpolated-ARPA normalization
    proof needs it stored, and a kept gram's CONTEXT PREFIX must be
    stored to carry the backoff weight the ARPA format routes through —
    both are force-kept.  Pruning happens before estimation, so every
    surviving context's distribution still sums to exactly 1 (pruned
    words route through backoff mass).
    """
    prune = list(prune)
    if not prune:
        return adjusted
    if len(prune) > order:
        raise ValueError(f"{len(prune)} prune thresholds for order {order}")
    prune = prune + [prune[-1]] * (order - len(prune))
    if prune[0] != 0:
        raise ValueError("unigrams cannot be pruned (threshold must be 0)")
    if any(a > b for a, b in zip(prune, prune[1:])):
        raise ValueError(f"prune thresholds must be non-decreasing: {prune}")

    forced: set = set()
    for n in range(order - 1, -1, -1):
        table = adjusted[n]
        kept = {g: c for g, c in table.items()
                if c > prune[n] or g in forced}
        adjusted[n] = Counter(kept)
        forced = {g[1:] for g in kept if len(g) > 1}
        forced |= {g[:-1] for g in kept if len(g) > 1}
    return adjusted


def estimate_ngram_lm(sentences: Iterable[Sequence[str]],
                      order: int = 3,
                      prune: Sequence[int] | None = None) -> Ngrams:
    """Estimate an interpolated modified-KN LM.

    Args:
        sentences: token sequences (no ``<s>``/``</s>`` — added here).
        order: highest n-gram order (≥1).
        prune: per-order count thresholds (lmplz ``--prune`` semantics:
            drop n-grams with adjusted count <= threshold; a shorter
            sequence extends its last value to the remaining higher
            orders; must be non-decreasing; unigrams unprunable).

    Returns:
        ARPA-style tables in the ``ArpaLM._ngrams`` layout — ``result[k]``
        maps (k+1)-word tuples to ``(log10 prob, log10 backoff)`` — directly
        consumable by ``ArpaLM``, ``write_kenlm_binary``, ``write_kenlm_trie``
        and ``DeviceLM.from_ngrams``.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    sentences = [[str(w) for w in s] for s in sentences]
    if not any(sentences):
        raise ValueError("empty corpus")
    for s in sentences:
        for w in s:
            if w in (BOS, EOS):
                raise ValueError(f"corpus contains reserved token {w!r}")

    raw = _count(sentences, order)
    adjusted = _adjust(raw, order)

    # <s> is never a legal prediction: keep it out of the unigram
    # distribution entirely (its ARPA probability is the conventional -99;
    # its crucial role is as a *context*, via gammas[1][("<s>",)]).
    bos_unigram = adjusted[0].pop((BOS,), None)
    # Discounts use pre-pruning count-of-counts (statistics of the corpus,
    # not of the pruned table).
    discounts = [_discounts(adjusted[n], n + 1) for n in range(order)]
    if prune is not None:
        adjusted = _prune(adjusted, order, prune)

    n_predictable = len(adjusted[0]) + 1  # observed types + <unk>

    # Bottom-up interpolated probabilities.  probs[gram] = P(w | context)
    # (linear), gammas[n][context] = leftover mass at order n+1 (linear).
    probs: dict[tuple[str, ...], float] = {}
    gammas: list[dict[tuple[str, ...], float]] = [dict() for _ in range(order)]

    for n in range(order):
        counts = adjusted[n]
        d1, d2, d3 = discounts[n]

        def discount(c: int) -> float:
            return 0.0 if c == 0 else d1 if c == 1 else d2 if c == 2 else d3

        denom: Counter = Counter()
        mass: Counter = Counter()
        for gram, c in counts.items():
            ctx = gram[:-1]
            denom[ctx] += c
            mass[ctx] += discount(c)

        for gram, c in counts.items():
            ctx = gram[:-1]
            u = (c - discount(c)) / denom[ctx]
            gamma = mass[ctx] / denom[ctx]
            if n == 0:
                lower = 1.0 / n_predictable
            else:
                # Every suffix of a counted gram is itself counted
                # (continuation counting guarantees it) — this lookup can
                # only miss if that invariant breaks.
                lower = probs[gram[1:]]
            probs[gram] = u + gamma * lower
        for ctx in denom:
            gammas[n][ctx] = mass[ctx] / denom[ctx]

    # <unk>: zero adjusted count => pure leftover mass at the unigram level.
    probs[(UNK,)] = gammas[0][()] * (1.0 / n_predictable)
    if bos_unigram is not None or order > 1:
        probs[(BOS,)] = 0.0  # emitted as the ARPA conventional -99

    tables: Ngrams = [dict() for _ in range(order)]
    for gram, p in probs.items():
        n = len(gram) - 1
        log_p = math.log10(p) if p > 0 else -99.0
        backoff = gammas[n + 1].get(gram) if n + 1 < order else None
        log_b = math.log10(backoff) if backoff else 0.0
        tables[n][gram] = (log_p, log_b)
    return tables


def write_arpa(ngrams: Ngrams, path: str | Path) -> None:
    """Write ARPA-style tables as a standard ARPA text file (.gz-aware)."""
    import gzip

    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wt", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for n, table in enumerate(ngrams, start=1):
            f.write(f"ngram {n}={len(table)}\n")
        for n, table in enumerate(ngrams, start=1):
            f.write(f"\n\\{n}-grams:\n")
            for gram in sorted(table):
                prob, backoff = table[gram]
                line = f"{prob:.7f}\t{' '.join(gram)}"
                if backoff:
                    line += f"\t{backoff:.7f}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")


def estimate_from_text(lines: Iterable[str], order: int = 3,
                       prune: Sequence[int] | None = None) -> Ngrams:
    """Estimate from raw text: one sentence per line, whitespace-tokenized,
    lowercased (the reference's label set is lowercase Cyrillic + space —
    tone/decoder.py:23)."""
    sentences = [line.split() for line in (l.strip().lower() for l in lines) if line]
    return estimate_ngram_lm(sentences, order, prune=prune)


def perplexity(lm, sentences: Iterable[Sequence[str]]) -> float:
    """Per-token perplexity of a ``LanguageModel`` over tokenized sentences.

    Tokens scored: each word plus the closing ``</s>``; OOV words back off
    to ``<unk>`` inside ``lm.score``.  10 ** (− mean log10 p).
    """
    total, n_tokens = 0.0, 0
    for sent in sentences:
        context: tuple[str, ...] = (BOS,)
        for w in [*[str(t) for t in sent], EOS]:
            total += lm.score(context, w)
            context = (*context, w)[-(max(lm.order - 1, 1)):]
            n_tokens += 1
    if not n_tokens:
        raise ValueError("empty evaluation corpus")
    return 10.0 ** (-total / n_tokens)
