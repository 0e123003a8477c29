"""Contextual biasing (hotwords) for the CTC beam search.

The reference decodes through pyctcdecode (tone/decoder.py:108-133), whose
``decode`` API supports hotword boosting even though the reference never
passes any.  Telephony deployments lean on it for exactly the reference's
weakest measured category — named entities (README.md:153) — so the
capability is first-class here: known words/phrases (client names, product
terms) get a per-character score boost while a hypothesis stays on a
matching path, with the boost retracted if the word completes as something
else.

Semantics (per emitted character, natural-log units):

* a match can only BEGIN at a word start — words merely *ending* with a
  hotword ("владимир" vs hotword "мир") are never boosted;
* while the current word (plus, for multi-word phrases, the matched tail
  of preceding words) is a prefix of some hotword, each matching character
  adds ``weight`` to the hypothesis score *tentatively*;
* a word boundary where the match is a complete hotword commits the
  tentative boost permanently — including when a longer phrase also
  continues through that boundary ("сан" commits even while "сан дата"
  keeps matching; only the continuation stays tentative);
* falling off the current path (mismatch, or a boundary with no direct
  continuation) RE-ENTERS at the longest word-aligned suffix of the match
  that is still a prefix of some hotword — an Aho–Corasick-style rematch,
  so overlapping phrases each get their full boost ("сан дата" then
  "дата центр" across "сан дата центр").  The hypothesis score is adjusted
  to the suffix's fresh value (its completed inner words committed, the
  in-progress tail tentative); with no viable suffix the tentative boost
  is retracted and the automaton parks until the next word boundary;
* at a boundary where the longer match dies, every word-aligned suffix
  that is itself a complete hotword ALSO commits its full value ("в"
  inside "аб в " with hotwords {"аб в", "в"}) — suffixes longer than the
  rematch target commit as a bonus; shorter ones are already inside the
  rematch's fresh value;
* an in-progress prefix keeps its tentative credit in interim/final
  ranking — biasing is active mid-word, which is what makes it effective
  for streaming partial transcripts.

Limit (single-path automaton): when a completed phrase has a direct
continuation AND a word-aligned suffix match, the continuation wins — the
automaton tracks one match at a time, preferring the longest.

The automaton state is a pure function of a hypothesis's emitted text, so
beams merged by (text, partial) always agree on it.  On any reachable
active node the tentative boost equals the precomputed per-node value
``_tent_at[node]`` — the invariant that lets the device twin
(ops/beam_decode.py) fold every transition into dense per-(node, char)
tables.

A copy of ``tone_tpu/decoding/hotwords.py``, kept in this package so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Iterable

# Automaton state carried on each beam: (node id, tentative boost).
# Node -1 = parked (mid-word after a mismatch) until the next word boundary.
START = (0, 0.0)


class HotwordScorer:
    """Character-trie hotword automaton with word-aligned failure links.

    Args:
        hotwords: words or multi-word phrases (matched across word
            boundaries); casing is normalized to lowercase to match the
            label set (tone/decoder.py:23).
        weight: natural-log score added per matching character.
    """

    def __init__(self, hotwords: Iterable[str], weight: float = 10.0) -> None:
        if isinstance(hotwords, str):
            # a lone string would silently iterate into per-CHARACTER
            # hotwords — an easy config type confusion
            raise TypeError("hotwords must be a list of phrases, not a string")
        self.weight = float(weight)
        self._children: list[dict[str, int]] = [{}]
        self._terminal: list[bool] = [False]
        self._path: list[str] = [""]
        phrases = sorted({" ".join(str(h).lower().split()) for h in hotwords} - {""})
        if not phrases:
            raise ValueError("no hotwords given")
        for phrase in phrases:
            node = 0
            for ch in phrase:
                nxt = self._children[node].get(ch)
                if nxt is None:
                    nxt = len(self._children)
                    self._children[node][ch] = nxt
                    self._children.append({})
                    self._terminal.append(False)
                    self._path.append(self._path[node] + ch)
                node = nxt
            self._terminal[node] = True
        self.phrases = phrases
        self._build_links()

    def _build_links(self) -> None:
        """Failure machinery, all per-node precomputed:

        * ``_fail[n]`` — longest proper suffix of path(n) that begins right
          after a space in path(n) and is itself a trie node (None if none):
          the only re-entry points consistent with matches-begin-at-word-
          starts;
        * ``_goto[n]`` — fail-chain-resolved transitions (nearest viable
          suffix wins), consulted when the direct child is missing;
        * ``_tent_at[n]`` — tentative boost outstanding at n on any path
          (weight × chars since the last committed boundary);
        * ``_full[n]`` — a fresh match's total value, weight × depth(n)
          (committed inner words + tentative tail);
        * ``_term_suf_lens[n]`` — lengths of the proper word-aligned
          suffixes of path(n) that are complete hotwords: each commits its
          full value at a boundary where the longer match dies.
        """
        w = self.weight
        node_of = {p: i for i, p in enumerate(self._path)}
        n_nodes = len(self._path)
        self._fail: list[int | None] = [None] * n_nodes
        self._tent_at = [0.0] * n_nodes
        self._full = [0.0] * n_nodes
        self._term_suf_lens: list[tuple[int, ...]] = [()] * n_nodes
        for n, s in enumerate(self._path):
            self._full[n] = w * len(s)
            suf_lens = []
            for k in range(1, len(s)):  # ascending k = longest suffix first
                if s[k - 1] == " " and s[k:] in node_of:
                    if self._fail[n] is None:
                        self._fail[n] = node_of[s[k:]]
                    if self._terminal[node_of[s[k:]]]:
                        suf_lens.append(len(s) - k)
            self._term_suf_lens[n] = tuple(suf_lens)
            last_commit = 0
            for j in range(len(s) - 1, 0, -1):  # deepest committed boundary
                if s[j] == " " and self._terminal[node_of[s[:j]]]:
                    last_commit = j
                    break
            self._tent_at[n] = w * (len(s) - last_commit)
        self._goto: list[dict[str, int]] = [{}] * n_nodes
        for n in sorted(range(n_nodes), key=lambda i: len(self._path[i])):
            f = self._fail[n]
            self._goto[n] = ({**self._goto[f], **self._children[f]}
                             if f is not None else {})

    def step(self, state: tuple[int, float], char: str) -> tuple[tuple[int, float], float]:
        """Advance on one emitted character.

        Returns (new_state, score_delta).  The caller adds ``score_delta``
        to the hypothesis score; tentative boost bookkeeping is inside the
        state.  A space character commits a completed hotword (the word
        boundary) and/or continues a phrase whose next character is a
        space; falling off rematches the longest word-aligned suffix, else
        retracts and parks until the next boundary.
        """
        node, tentative = state
        w = self.weight
        if node < 0:  # parked: matches only begin at word starts
            if char == " ":
                return START, 0.0
            return state, 0.0
        commit = char == " " and self._terminal[node]
        direct = self._children[node].get(char)
        if direct is not None:
            if commit:
                # Completed hotword with a continuing longer phrase: commit
                # what's accrued; only the continuation (this space) stays
                # tentative.
                return (direct, w), w
            return (direct, tentative + w), w
        rematch = self._goto[node].get(char)
        if rematch is not None:
            # Fell off this match: re-enter at the longest word-aligned
            # suffix still on a hotword path.  A commit keeps its accrued
            # boost; otherwise the old tentative is retracted against the
            # suffix's fresh value.  At a word boundary, terminal suffixes
            # longer than the rematch target also complete here — commit
            # them (shorter ones are inside the fresh value already).
            bonus = 0.0
            if char == " ":
                keep = len(self._path[rematch]) - 1
                bonus = w * sum(n for n in self._term_suf_lens[node]
                                if n > keep)
            delta = self._full[rematch] + bonus - (0.0 if commit else tentative)
            return (rematch, self._tent_at[rematch]), delta
        if char == " ":
            # The match dies at this boundary with no rematch: every
            # word-aligned suffix that is a complete hotword still
            # finished as words here — commit each one's full value.
            bonus = w * sum(self._term_suf_lens[node])
            return START, bonus + (0.0 if commit else -tentative)
        return (-1, 0.0), -tentative
