"""Silence-based phrase segmentation over the streaming CTC logprob stream.

Behavioral parity with the reference ``StreamingLogprobSplitter``
(tone/logprob_splitter.py): a frame is speech iff P(blank) + P(space) <= 0.9
(for a subword vocabulary, P(blank) <= 0.9: ``silence_classes``);
a phrase ends after >= 20 consecutive silence frames (600 ms); phrases longer
than 2000 frames (60 s) are force-split; emitted phrase logprobs are expanded
by 3 frames on each side; unconsumed logprobs plus a global frame offset are
carried in the state.

Pure numpy, host-side: the per-chunk workload is ~10 frames of 35 logprobs.
A copy of ``tone_tpu/splitter.py``, kept in this package so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from collections.abc import Iterator

    import numpy.typing as npt


@dataclass
class LogprobPhrase:
    """A finalized phrase: its logprobs and frame span.

    Attributes:
        logprobs: (L, vocab+1) float32 logprobs for the phrase (with the
            +-SPEECH_EXPAND_SIZE frame margin applied to ``logprobs`` only).
        start_frame: global start frame (not expanded).
        end_frame: global end frame (not expanded).
    """

    logprobs: "npt.NDArray[np.float32]"
    start_frame: int
    end_frame: int


@dataclass
class StreamingLogprobSplitterState:
    """Carried state: unconsumed logprobs + global frame offset."""

    past_logprobs: "npt.NDArray[np.float32]" = field(
        default_factory=lambda: np.zeros((0, 35), dtype=np.float32))
    offset: int = 0


class StreamingLogprobSplitter:
    """Splits the logprob stream into decodable phrases at silences."""

    InputType = "npt.NDArray[np.float32]"
    OutputType = "list[LogprobPhrase]"
    StateType = StreamingLogprobSplitterState

    SILENCE_THRESHOLD = 0.9  # probability
    MIN_SILENCE_DURATION = 20  # frames (600 ms)
    SPEECH_EXPAND_SIZE = 3  # frames
    MAX_PHRASE_DURATION = 2000  # frames (60 s)

    def __init__(self, n_classes: int = 35, silence_classes: int = 2) -> None:
        """``n_classes``: the logprobs' classes, the vocabulary and the blank
        (T-one's 35).  ``silence_classes``: how many of the last classes are
        silence: T-one's space and blank; for a subword vocabulary, whose
        pieces carry their own word-start mark, the blank alone."""
        self.n_classes = n_classes
        self.silence_classes = silence_classes

    def _phrase_spans(self, is_speech: "npt.NDArray[np.bool_]", *,
                      is_last: bool = False) -> "Iterator[tuple[int, int]]":
        """Yield (start, end) spans of completed phrases.

        A span is complete when it is followed by a silence run of at least
        ``MIN_SILENCE_DURATION`` frames (the end of the stream counts via the
        synthetic trailing silence when ``is_last``).  Overlong spans are
        force-split into ``MAX_PHRASE_DURATION`` pieces even mid-speech.
        """
        min_sil = self.MIN_SILENCE_DURATION
        n = len(is_speech)
        # Synthetic leading silence guarantees the stream starts at a phrase
        # boundary; trailing silence flushes the final phrase on is_last.
        # (Manual padding: np.pad costs ~40us/call, this path is per-slot-hot
        # in the batched serving splitter.)
        m = min_sil + n + (min_sil if is_last else 0)
        silence = np.empty(m + 2, np.int8)
        silence[0] = silence[-1] = 0
        silence[1:min_sil + 1] = 1
        np.logical_not(is_speech, out=silence[min_sil + 1:min_sil + 1 + n].view(bool))
        silence[min_sil + 1 + n:-1] = 1
        edges = np.diff(silence)
        starts = np.flatnonzero(edges == 1) - min_sil
        ends = np.flatnonzero(edges == -1) - min_sil
        long_enough = (ends - starts) >= min_sil
        starts, ends = starts[long_enough], ends[long_enough]

        # Speech span i runs from the end of qualifying silence i to the
        # start of qualifying silence i+1 (or the stream end for the last,
        # which is only emitted as force-split pieces).
        span_starts = ends.tolist()
        span_ends = starts.tolist()[1:] + [n]
        n_closed = len(ends) - 1
        for i, (start, end) in enumerate(zip(span_starts, span_ends)):
            while end - start >= self.MAX_PHRASE_DURATION:
                yield start, start + self.MAX_PHRASE_DURATION
                start += self.MAX_PHRASE_DURATION
            if i < n_closed:
                yield start, end

    def forward(
        self,
        logprobs: "npt.NDArray[np.float32]",
        state: StreamingLogprobSplitterState | None = None,
        *,
        is_last: bool = False,
    ) -> tuple[list[LogprobPhrase], StreamingLogprobSplitterState]:
        """Consume a chunk of logprobs; emit completed phrases + next state."""
        if not isinstance(logprobs, np.ndarray):
            raise TypeError(
                f"Incorrect 'logprobs' type: expected np.ndarray, but got {type(logprobs)}")
        if logprobs.shape[1:] != (self.n_classes,):
            raise ValueError(
                f"Shape of 'logprobs' must be (L, {self.n_classes}), but got {logprobs.shape}")
        if logprobs.dtype != np.float32:
            raise ValueError(
                f"Incorrect dtype of 'logprobs': expected np.float32, but got {logprobs.dtype}")
        if state is None:
            state = StreamingLogprobSplitterState(
                past_logprobs=np.zeros((0, logprobs.shape[-1]), np.float32))
        if not isinstance(state, StreamingLogprobSplitterState):
            raise TypeError(
                "Incorrect 'state' type: expected StreamingLogprobSplitterState "
                f"or None, but got {type(state)}")

        expand = self.SPEECH_EXPAND_SIZE
        logprobs = np.concatenate((state.past_logprobs, logprobs), axis=-2)
        # Silence = high combined probability of the last classes (T-one's
        # space and blank).
        is_speech = (np.exp(logprobs[..., -self.silence_classes:]).sum(axis=-1)
                     <= self.SILENCE_THRESHOLD)

        if not is_last and not is_speech.any():
            # Fast path for all-silence windows (the common telephony case —
            # exact same result as the full span machinery: no phrases, keep
            # the trailing ``expand``-frame margin).
            consumed = max(0, len(logprobs) - expand)
            return [], StreamingLogprobSplitterState(
                past_logprobs=logprobs[consumed:],
                offset=state.offset + consumed,
            )

        phrases: list[LogprobPhrase] = []
        consumed = 0
        for start, end in self._phrase_spans(is_speech, is_last=is_last):
            phrases.append(LogprobPhrase(
                logprobs=logprobs[max(0, start - expand):end + expand],
                start_frame=start + state.offset,
                end_frame=end + state.offset,
            ))
            consumed = end

        # Drop consumed frames; if nothing after is speech, also drop the
        # trailing silence except an ``expand``-frame margin.
        if not is_speech[consumed:].any():
            consumed = max(consumed, len(logprobs) - expand)
        return phrases, StreamingLogprobSplitterState(
            past_logprobs=logprobs[consumed:],
            offset=state.offset + consumed,
        )


class _SlotBuffer:
    """Per-slot carry (logprobs + speech mask) in ONE contiguous array with
    amortized-doubling growth.

    Equivalent to ``StreamingLogprobSplitterState.past_logprobs``, tuned for
    the serving worst case: when many slots close a phrase on the same tick
    (synchronized utterance ends), ``slice`` is a single contiguous copy and
    ``speech_window`` a view — the earlier chunk-list design spent the
    boundary tick in per-chunk Python loops (452 ms at 1024 slots x 1900
    frames; this layout does it in ~25 ms, dev/tick_bench.py
    --splitter-worst).
    """

    __slots__ = ("lp", "sp", "head", "tail")

    def __init__(self) -> None:
        self.lp = np.empty((128, 35), np.float32)
        self.sp = np.empty(128, bool)
        self.head = 0            # first unconsumed row
        self.tail = 0            # one past the last filled row

    @property
    def length(self) -> int:
        return self.tail - self.head

    def append(self, chunk: np.ndarray, sp: np.ndarray) -> None:
        n = len(chunk)
        if self.tail + n > len(self.lp):
            live = self.tail - self.head
            cap = len(self.lp)
            while cap < 2 * (live + n):
                cap *= 2
            lp = np.empty((cap, 35), np.float32)
            spb = np.empty(cap, bool)
            lp[:live] = self.lp[self.head:self.tail]
            spb[:live] = self.sp[self.head:self.tail]
            self.lp, self.sp = lp, spb
            self.head, self.tail = 0, live
        self.lp[self.tail:self.tail + n] = chunk
        self.sp[self.tail:self.tail + n] = sp
        self.tail += n

    def speech_window(self) -> np.ndarray:
        """The buffer's is_speech mask, (length,) bool — a view, valid
        until the next ``append``."""
        return self.sp[self.head:self.tail]

    def slice(self, a: int, b: int) -> np.ndarray:
        """Logprob frames [a, b) of the buffer (0 = first unconsumed).

        Returns a VIEW, like the single-stream splitter's phrase slices:
        buffer rows are written exactly once (appends only ever write past
        ``tail``; growth copies the live region into fresh storage and
        never touches the old array), so emitted phrases stay valid with
        zero copy on the boundary tick."""
        return self.lp[self.head + a:min(self.head + b, self.tail)]

    def drop_prefix(self, n: int) -> None:
        """Discard the first ``n`` unconsumed frames."""
        self.head += n


class BatchLogprobSplitter:
    """Vectorized multi-stream splitter over a fixed slot table.

    Behavioral parity with per-slot :class:`StreamingLogprobSplitter`
    instances fed the same chunks (asserted by tests/test_splitter.py), at
    serving scale.  Per tick: ONE batched speech-probability pass over all
    ticking slots, then three per-slot regimes:

    * all-silence window, not flushing — indexed fast path (keep the
      ``expand``-frame margin, advance offsets);
    * mid-phrase, no boundary event — O(1) append of the chunk to the
      slot's carry (the reference's per-call machinery provably emits
      nothing and consumes nothing on such windows);
    * boundary event — a silence run completes (detected by a vectorized
      frame-step over trailing-silence counters), the buffer crosses the
      force-split length, or ``is_last`` — run the EXACT span machinery
      (shared ``_phrase_spans``) on the assembled window.

    Phrase boundaries are rare (one per utterance per stream), so the exact
    machinery runs on a small fraction of slot-ticks and the steady-state
    host cost is a few vector ops plus O(1) python per slot.
    """

    def __init__(self, n_slots: int) -> None:
        self._span = StreamingLogprobSplitter()
        self.n_slots = n_slots
        self._buf = [_SlotBuffer() for _ in range(n_slots)]
        self._carry_speech = np.zeros(n_slots, bool)
        self._carry_len = np.zeros(n_slots, np.int64)
        self._offset = np.zeros(n_slots, np.int64)
        self._sil_run = np.zeros(n_slots, np.int64)  # trailing silence frames

    def reset(self, slot: int) -> None:
        self._buf[slot] = _SlotBuffer()
        self._carry_speech[slot] = False
        self._carry_len[slot] = 0
        self._offset[slot] = 0
        self._sil_run[slot] = 0

    def snapshot(self, slot: int) -> dict:
        """One slot's carry as host arrays/scalars — the splitter half of
        stream suspend/migrate (MultiStreamEngine.suspend_stream)."""
        buf = self._buf[slot]
        return {
            "splitter_logprobs": buf.lp[buf.head:buf.tail].copy(),
            "splitter_speech": buf.sp[buf.head:buf.tail].copy(),
            "splitter_carry_speech": bool(self._carry_speech[slot]),
            "splitter_carry_len": int(self._carry_len[slot]),
            "splitter_offset": int(self._offset[slot]),
            "splitter_sil_run": int(self._sil_run[slot]),
        }

    def restore(self, slot: int, snap: dict) -> None:
        """Restore a snapshot() into a (fresh) slot — possibly of a
        different BatchLogprobSplitter on a different host."""
        self.reset(slot)
        lp = np.asarray(snap["splitter_logprobs"], np.float32)
        if len(lp):
            self._buf[slot].append(lp, np.asarray(snap["splitter_speech"], bool))
        self._carry_speech[slot] = snap["splitter_carry_speech"]
        self._carry_len[slot] = snap["splitter_carry_len"]
        self._offset[slot] = snap["splitter_offset"]
        self._sil_run[slot] = snap["splitter_sil_run"]

    def forward_batch(
        self,
        logprobs: "npt.NDArray[np.float32]",
        slots: "npt.NDArray[np.int64]",
        is_last: "npt.NDArray[np.bool_]",
    ) -> dict[int, list[LogprobPhrase]]:
        """Consume one (K, T, 35) tick of logprobs for K slots.

        Returns {slot: [LogprobPhrase, ...]} for slots that completed
        phrases this tick.
        """
        span = self._span
        expand = span.SPEECH_EXPAND_SIZE
        t = logprobs.shape[1]
        sp_new = np.exp(logprobs[..., -2:]).sum(axis=-1) <= span.SILENCE_THRESHOLD

        # Vectorized boundary detection: step the per-slot trailing-silence
        # counters through the T new frames; a phrase can only close on the
        # frame where a run reaches MIN_SILENCE_DURATION with speech before
        # it in the buffered window.
        sil_run = self._sil_run[slots]
        speech_seen = self._carry_speech[slots]
        closes = np.zeros(len(slots), bool)
        for i in range(t):
            sp_i = sp_new[:, i]
            sil_run = np.where(sp_i, 0, sil_run + 1)
            closes |= (sil_run == span.MIN_SILENCE_DURATION) & speech_seen
            speech_seen |= sp_i
        self._sil_run[slots] = sil_run

        new_len = self._carry_len[slots] + t
        machinery = closes | is_last | (
            speech_seen & (new_len >= span.MAX_PHRASE_DURATION))
        silent = ~speech_seen & ~machinery

        # Fast path (all-silence window, not flushing): keep an
        # ``expand``-frame margin, advance the offset — fully indexed.
        # Copies detach the carry from the (K, T, 35) tick array (a view
        # would pin every tick's full batch in memory).
        fast = np.flatnonzero(silent)
        fast_slots = slots[fast]
        self._offset[fast_slots] += new_len[fast] - expand
        self._carry_len[fast_slots] = expand
        for k in fast:
            slot = int(slots[k])
            buf = _SlotBuffer()
            buf.append(logprobs[k, t - expand:], sp_new[k, t - expand:])
            self._buf[slot] = buf

        # Mid-phrase, no boundary: the reference machinery is a no-op on
        # this window (no qualifying silence run, below force-split length,
        # speech present so no margin trim) — append and move on.
        grow = np.flatnonzero(~silent & ~machinery)
        self._carry_len[slots[grow]] = new_len[grow]
        self._carry_speech[slots[grow]] = True
        for k in grow:
            self._buf[int(slots[k])].append(logprobs[k], sp_new[k])

        # Boundary events: run the exact per-window span machinery.
        out: dict[int, list[LogprobPhrase]] = {}
        for k in np.flatnonzero(machinery):
            slot = int(slots[k])
            buf = self._buf[slot]
            buf.append(logprobs[k], sp_new[k])
            wsp = buf.speech_window()
            phrases, consumed = self._split_buffer(
                buf, wsp, int(self._offset[slot]), bool(is_last[k]), expand)
            if phrases:
                out[slot] = phrases
            buf.drop_prefix(consumed)
            rest = wsp[consumed:]
            self._offset[slot] += consumed
            self._carry_len[slot] = buf.length
            self._carry_speech[slot] = bool(rest.any())
            # Recompute the trailing-silence counter from the kept carry; if
            # the carry is all silence the incremental counter (contiguous
            # run across the trimmed frames) is already exact — keep it.
            nz = np.flatnonzero(rest)
            if len(nz):
                self._sil_run[slot] = len(rest) - 1 - nz[-1]
        return out

    def _split_buffer(self, buf: _SlotBuffer, is_speech: np.ndarray,
                      offset: int, is_last: bool, expand: int):
        """The exact per-window splitting of StreamingLogprobSplitter.forward,
        over a chunked buffer instead of one array."""
        phrases: list[LogprobPhrase] = []
        consumed = 0
        for start, end in self._span._phrase_spans(is_speech, is_last=is_last):
            phrases.append(LogprobPhrase(
                logprobs=buf.slice(max(0, start - expand), end + expand),
                start_frame=start + offset,
                end_frame=end + offset,
            ))
            consumed = end
        if not is_speech[consumed:].any():
            consumed = max(consumed, buf.length - expand)
        return phrases, consumed
