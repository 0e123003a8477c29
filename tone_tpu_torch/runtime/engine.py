"""Multi-stream serving engine: stream table, tick loop, phrase decoding
(port of the host path of ``tone_tpu/runtime/engine.py`` with a greedy
decoder).

A stream table maps stream ids to arena slots; idle streams are evicted
after a timeout (Triton's ``max_sequence_idle_microseconds: 15000000``),
streams beyond the slot count wait as candidates, and each tick batches all
pending chunks into one arena step.  Phrase segmentation is one vectorized
pass over the ticking slots (``BatchLogprobSplitter``); final phrases decode
greedily on a small thread pool, interim text in the tick.

Options that need the device decoders, the beam decoders or the aligner
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.decoder import GreedyCTCDecoder
from tone_tpu_torch.pipeline import TextPhrase, phrase_times
from tone_tpu_torch.runtime.arena import StreamArena
from tone_tpu_torch.splitter import BatchLogprobSplitter


class UnknownStreamError(KeyError):
    """The stream id is gone — closed, finished, or evicted for idleness
    (the transport should tell the client its session ended)."""


@dataclass
class _Stream:
    slot: int | None            # None = candidate waiting for a slot
    pending: list = field(default_factory=list)  # queued (chunk, is_last)
    last_activity: float = field(default_factory=time.monotonic)
    # Interim (in-progress phrase) greedy-decode carry.
    interim_prev: int = -1          # last argmax token id (CTC collapse)
    interim_chars: list = field(default_factory=list)
    interim_sent: str = ""
    ticks: int = 0                  # completed ticks (suspend's torn-read guard)


@dataclass
class EngineStats:
    ticks: int = 0
    chunks_processed: int = 0
    phrases_decoded: int = 0
    active_streams: int = 0
    pending_streams: int = 0    # candidates queued for a slot
    last_tick_seconds: float = 0.0
    last_host_seconds: float = 0.0  # tick cost excluding the device step wait


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tone_tpu_torch yet "
                               f"(ROADMAP queue {item})")


class MultiStreamEngine:
    """Synchronous multi-stream engine over a device state arena.

    Usage:
        engine = MultiStreamEngine(variables, config, n_slots=256)
        sid = engine.open_stream()
        engine.feed(sid, chunk)                  # any number of times
        results = engine.tick()                  # {sid: [Future[TextPhrase], ...]}
        engine.close_stream(sid)                 # flushes with is_last

    Thread-safety: all public methods take the engine lock; ``tick`` may be
    driven by a dedicated loop (see server.py).
    """

    IDLE_EVICT_SECONDS = 15.0  # Triton parity: max_sequence_idle 15 s
    FORCE_EVICT_GRACE_SECONDS = 1.0  # never steal a slot active this recently

    def __init__(self, variables, config: ToneConfig, n_slots: int = 256,
                 decoder=None, device=None, decode_workers: int = 8,
                 interim_transcripts: bool = False,
                 interim_beam: bool = False,
                 interim_device_beam: bool = False,
                 idle_evict_seconds: float | None = None,
                 force_evict_grace: float | None = None,
                 word_timestamps: bool = False,
                 nbest: int = 0,
                 max_candidates: int = 0,
                 candidate_buffer_chunks: int = 200) -> None:
        """``interim_transcripts``: also decode each in-progress phrase
        greedily in the tick; ``tick`` then reports partial text per stream
        in ``last_interims``.

        ``idle_evict_seconds`` overrides the Triton-parity 15 s idle reap;
        ``force_evict_grace`` the 1 s quiet period below which a slot is
        never stolen under pressure.

        ``max_candidates``: streams accepted beyond the slot count; they
        buffer up to ``candidate_buffer_chunks`` chunks host-side and bind
        oldest-first as slots free (Triton's max_candidate_sequences).

        ``device``: ``cuda`` unless the caller asks for the CPU.

        Not ported yet (raise NotImplementedError): ``interim_beam`` (A11),
        ``interim_device_beam`` (A10), ``word_timestamps`` (the aligner,
        A10), ``nbest`` > 0 (A10/A11) and decoders other than greedy, such
        as device-decoder finals (A10) or hotword beams (A11)."""
        if interim_beam:
            raise _not_ported("interim_beam (carried host beam search)", "A11")
        if interim_device_beam:
            raise _not_ported("interim_device_beam (device beam arena)", "A10")
        if word_timestamps:
            raise _not_ported("word_timestamps (CTC forced alignment)", "A10")
        if nbest:
            raise _not_ported("nbest (beam-search alternatives)", "A10/A11")
        if decoder is not None and not isinstance(decoder, GreedyCTCDecoder):
            raise _not_ported(f"decoding with {type(decoder).__name__} "
                              "(device-decoder finals, beam and hotword decoders)",
                              "A10/A11")
        self.config = config
        self.arena = StreamArena(variables, config, n_slots, device=device)
        self.decoder = decoder or GreedyCTCDecoder()
        self.interim_transcripts = interim_transcripts
        if idle_evict_seconds is not None:
            self.IDLE_EVICT_SECONDS = idle_evict_seconds
        if force_evict_grace is not None:
            self.FORCE_EVICT_GRACE_SECONDS = force_evict_grace
        self._labels = config.labels
        self._splitter = BatchLogprobSplitter(n_slots)
        self._streams: dict[int, _Stream] = {}
        self.max_candidates = max(0, int(max_candidates))
        self.candidate_buffer_chunks = max(1, int(candidate_buffer_chunks))
        self._pending_bind: list[int] = []  # candidate sids, open order
        self._inflight: set[int] = set()    # sids mid-tick (popped, not done)
        self._free_slots = list(range(n_slots))
        self._slot_reset = np.zeros(n_slots, bool)
        self._next_id = 0
        self._lock = threading.Lock()
        self._device_lock = threading.Lock()   # serializes arena state swaps
        self._decode_pool = ThreadPoolExecutor(max_workers=decode_workers,
                                               thread_name_prefix="ctc-decode")
        self._finished_since_poll: list[int] = []
        self._evicted_since_poll: list[int] = []
        self.last_interims: dict[int, str] = {}
        self.stats = EngineStats()

    # -- stream lifecycle --------------------------------------------------

    def open_stream(self) -> int:
        """Acquire a slot for a new stream; returns the stream id.

        With every slot busy (and nothing evictable) the stream is accepted
        as a CANDIDATE when ``max_candidates`` allows.  Raises RuntimeError
        when candidates are exhausted too.
        """
        with self._lock:
            # Older waiting candidates bind first (Triton's oldest-first order).
            self._bind_candidates_locked()
            if not self._free_slots:
                # Reap idle streams; force-steal a quiet slot only when the
                # newcomer cannot queue as a candidate.
                queue_has_room = len(self._pending_bind) < self.max_candidates
                self._evict_idle_locked(force_one=not queue_has_room)
                self._bind_candidates_locked()
            if self._free_slots:  # implies no candidates left waiting
                slot = self._free_slots.pop()
                sid = self._next_id
                self._next_id += 1
                self._streams[sid] = _Stream(slot=slot)
                self._slot_reset[slot] = True
                self._splitter.reset(slot)
                return sid
            if len(self._pending_bind) >= self.max_candidates:
                raise RuntimeError("no free stream slots")
            sid = self._next_id
            self._next_id += 1
            self._streams[sid] = _Stream(slot=None)
            self._pending_bind.append(sid)
            return sid

    def _bind_candidates_locked(self) -> None:
        """Bind the oldest waiting candidates to freed slots (FIFO)."""
        while self._free_slots and self._pending_bind:
            sid = self._pending_bind.pop(0)
            stream = self._streams.get(sid)
            if stream is None:  # candidate closed while waiting
                continue
            slot = self._free_slots.pop()
            stream.slot = slot
            self._slot_reset[slot] = True
            self._splitter.reset(slot)

    def set_stream_hotwords(self, sid: int, hotwords, hotword_weight: float = 10.0) -> None:
        """Per-request hotword biasing needs a beam decoder, not ported yet:
        a non-empty list raises NotImplementedError; an empty one (the JAX
        engine's "clear the override") has nothing to clear."""
        if hotwords:
            raise _not_ported("per-request hotword biasing", "A11")
        with self._lock:
            if sid not in self._streams:
                raise UnknownStreamError(f"unknown stream {sid}")

    def set_stream_nbest(self, sid: int, n: int | None) -> None:
        """Per-request n-best: ``None``/0/1 keep top-1 (the only mode of the
        greedy decoder); more raises ValueError, as the JAX engine does for
        a greedy decoder."""
        n = int(n or 0)
        with self._lock:
            if sid not in self._streams:
                raise UnknownStreamError(f"unknown stream {sid}")
        if n > 1:
            raise ValueError(
                "the configured decoder has no n-best support "
                "(greedy decodes a single hypothesis; use a beam decoder)")

    def suspend_stream(self, sid: int) -> dict:
        """Serialize a drained live stream to a host-side snapshot (the flat
        fp16 acoustic blob plus the splitter carry) and release its slot —
        the suspend half of stream migration.  ``resume_stream`` restores it
        on this engine or another, of either package.

        Raises UnknownStreamError for dead streams, RuntimeError for
        undrained ones or slotless candidates.
        """
        with self._lock:
            stream = self._streams.get(sid)
            if stream is None:
                raise UnknownStreamError(f"unknown stream {sid}")
            if stream.pending or sid in self._inflight:
                raise RuntimeError(
                    f"stream {sid} has work in flight — "
                    "tick until drained before suspending")
            if stream.slot is None:
                raise RuntimeError(
                    f"stream {sid} is a waiting candidate with no device "
                    "state; close and reopen it instead")
            slot = stream.slot
            epoch = stream.ticks
        with self._device_lock:
            blob = self.arena.read_slot(slot)
        with self._lock:
            # Re-check: a concurrent close/evict or feed+tick may have moved
            # the stream on while the blob was read.
            if self._streams.get(sid) is not stream:
                raise UnknownStreamError(f"stream {sid} ended mid-suspend")
            if (stream.slot != slot or stream.pending
                    or sid in self._inflight or stream.ticks != epoch):
                raise RuntimeError(
                    f"stream {sid} advanced mid-suspend — quiesce its feed "
                    "and retry")
            snap = {"acoustic_state": blob, **self._splitter.snapshot(slot),
                    "nbest": 0, "hotwords": None}
            self._release_locked(sid)
            return snap

    def resume_stream(self, snapshot: dict) -> int:
        """Restore a ``suspend_stream`` snapshot into a fresh slot; returns
        the new stream id.  Raises RuntimeError when no slot is free."""
        if snapshot.get("hotwords"):
            raise _not_ported("resuming a stream with hotword biasing", "A11")
        if int(snapshot.get("nbest") or 0) > 1:
            raise _not_ported("resuming an n-best stream", "A10/A11")
        with self._lock:
            if not self._free_slots:
                self._evict_idle_locked(force_one=True)
            if not self._free_slots:
                raise RuntimeError("no free stream slots")
            slot = self._free_slots.pop()
            sid = self._next_id
            self._next_id += 1
            self._streams[sid] = _Stream(slot=slot)
            self._slot_reset[slot] = False  # the snapshot IS the state
            self._splitter.restore(slot, snapshot)
        with self._device_lock:
            self.arena.write_slot(slot, snapshot["acoustic_state"])
        return sid

    def feed(self, sid: int, chunk: np.ndarray, is_last: bool = False) -> None:
        """Queue one chunk (any length <= chunk_samples; zero-padded).

        Raises:
            UnknownStreamError: the stream finished, was closed, or was
                evicted — the client must open a new stream.
        """
        n = self.config.audio_chunk_samples
        chunk = np.asarray(chunk).astype(np.int16, copy=False)
        if len(chunk) < n:
            chunk = np.pad(chunk, (0, n - len(chunk)))
        with self._lock:
            stream = self._streams.get(sid)
            if stream is None:
                raise UnknownStreamError(
                    f"stream {sid} is not active (finished, closed, or "
                    f"evicted after {self.IDLE_EVICT_SECONDS:.0f}s idle)")
            if (stream.slot is None
                    and len(stream.pending) >= self.candidate_buffer_chunks):
                # Backpressure on a slotless candidate's host buffer.
                self._release_locked(sid)
                self._evicted_since_poll.append(sid)
                raise UnknownStreamError(
                    f"candidate stream {sid} exceeded its "
                    f"{self.candidate_buffer_chunks}-chunk buffer while "
                    "waiting for a slot")
            stream.pending.append((chunk, is_last))
            stream.last_activity = time.monotonic()

    def has_backlog(self) -> bool:
        """True if any slot-bound stream has chunks queued (the tick loop
        skips its sleep while draining a backlog)."""
        with self._lock:
            return any(s.pending and s.slot is not None
                       for s in self._streams.values())

    def close_stream(self, sid: int) -> None:
        """Mark end of stream: the final chunk is flagged is_last (a zero
        chunk is queued if nothing is pending, mirroring pipeline.finalize)."""
        with self._lock:
            stream = self._streams.get(sid)
            if stream is None:
                return
            if stream.pending:
                chunk, _ = stream.pending[-1]
                stream.pending[-1] = (chunk, True)
            else:
                zero = np.zeros(self.config.audio_chunk_samples, np.int16)
                stream.pending.append((zero, True))

    # -- the tick ----------------------------------------------------------

    def tick(self) -> dict[int, list[Future]]:
        """One batched step over all slots with pending chunks.

        Returns {sid: [phrase_future, ...]} for phrases completed this tick;
        futures resolve to ``TextPhrase`` (decoded on the thread pool),
        per-stream order is the list order.
        """
        t0 = time.monotonic()
        with self._lock:
            self._evict_idle_locked()
            self._bind_candidates_locked()
            n = self.arena.n_slots
            chunks = np.zeros((n, self.config.audio_chunk_samples), np.int16)
            active = np.zeros(n, bool)
            reset = np.zeros(n, bool)
            ticking: list[tuple[int, _Stream, bool]] = []
            for sid, stream in self._streams.items():
                if not stream.pending or stream.slot is None:
                    continue  # nothing queued, or a candidate awaiting a slot
                chunk, is_last = stream.pending.pop(0)
                slot = stream.slot
                chunks[slot] = chunk
                active[slot] = True
                # Consume a slot's reset flag only once it actually ticks.
                reset[slot] = self._slot_reset[slot]
                self._slot_reset[slot] = False
                ticking.append((sid, stream, is_last))
                self._inflight.add(sid)
            self.stats.pending_streams = len(self._pending_bind)
            self.stats.active_streams = len(self._streams) - self.stats.pending_streams

        if not ticking:
            return {}

        t_dev0 = time.monotonic()
        with self._device_lock:  # vs. resume_stream's state write
            logprobs = self.arena.tick(chunks, active, reset)
        t_device = time.monotonic() - t_dev0

        slot_ids = np.array([s.slot for _, s, _ in ticking], np.int64)
        lasts = np.array([last for _, _, last in ticking], bool)
        tick_logprobs = logprobs[slot_ids].astype(np.float32, copy=False)
        by_slot = self._splitter.forward_batch(tick_logprobs, slot_ids, lasts)
        argmax = tick_logprobs.argmax(axis=-1) if self.interim_transcripts else None

        results: dict[int, list[Future]] = {}
        interims: dict[int, str] = {}
        finished: list[int] = []
        blank = len(self._labels)
        with self._lock:
            for k, (sid, stream, is_last) in enumerate(ticking):
                stream.ticks += 1
                phrases = by_slot.get(stream.slot)
                if phrases:
                    results[sid] = [self._decode_pool.submit(self._decode, p)
                                    for p in phrases]
                if argmax is not None:
                    if phrases or is_last:
                        # Phrase boundary: restart the interim collapse.
                        stream.interim_prev = -1
                        stream.interim_chars = []
                        stream.interim_sent = ""
                    else:
                        prev, chars = stream.interim_prev, stream.interim_chars
                        for t in argmax[k]:
                            t = int(t)
                            if t != prev and t != blank:
                                chars.append(self._labels[t])
                            prev = t
                        stream.interim_prev = prev
                        text = "".join(chars).strip()
                        if text and text != stream.interim_sent:
                            stream.interim_sent = text
                            interims[sid] = text
                if is_last:
                    finished.append(sid)
            self.stats.chunks_processed += len(ticking)
            for sid in finished:
                self._release_locked(sid)
            self._finished_since_poll.extend(finished)
            self._inflight.difference_update(s for s, _, _ in ticking)
        self.last_interims = interims

        self.stats.ticks += 1
        elapsed = time.monotonic() - t0
        self.stats.last_tick_seconds = elapsed
        self.stats.last_host_seconds = elapsed - t_device
        return results

    def warmup(self) -> None:
        """Run the arena step once before serving traffic."""
        self.arena.warmup()

    def pop_finished(self) -> list[int]:
        """Stream ids whose final (is_last) chunk was processed since the
        last call — a transport delivers its end-of-stream marker after that
        stream's final phrases."""
        with self._lock:
            out = self._finished_since_poll
            self._finished_since_poll = []
            return out

    def pop_evicted(self) -> list[int]:
        """Stream ids evicted (idle timeout or slot pressure) since the last
        call — the transport should notify those clients."""
        with self._lock:
            out = self._evicted_since_poll
            self._evicted_since_poll = []
            return out

    def _decode(self, logprob_phrase) -> TextPhrase:
        text = self.decoder.forward(np.ascontiguousarray(logprob_phrase.logprobs))
        start, end = phrase_times(self.config, logprob_phrase.start_frame,
                                  logprob_phrase.end_frame)
        with self._lock:
            self.stats.phrases_decoded += 1
        return TextPhrase(text=text, start_time=start, end_time=end)

    # -- eviction ----------------------------------------------------------

    def _release_locked(self, sid: int) -> None:
        stream = self._streams.pop(sid, None)
        if stream is None:
            return
        if stream.slot is not None:
            self._free_slots.append(stream.slot)
            # Hand the slot straight to the oldest waiting candidate.
            self._bind_candidates_locked()
        else:
            try:
                self._pending_bind.remove(sid)
            except ValueError:
                pass

    def close(self, sid: int) -> None:
        """Drop a stream immediately (disconnect without flush)."""
        with self._lock:
            self._release_locked(sid)

    def _evict_idle_locked(self, force_one: bool = False) -> None:
        now = time.monotonic()
        # Candidates are reaped on inactivity even with chunks buffered:
        # they can never drain without a slot.
        idle = [sid for sid, s in self._streams.items()
                if (not s.pending or s.slot is None)
                and now - s.last_activity > self.IDLE_EVICT_SECONDS]
        if force_one and not idle:
            # Under slot pressure, reclaim the least-recently-active stream —
            # only a slot holder with nothing queued, quiet for the grace period.
            candidates = [
                sid for sid, s in self._streams.items()
                if not s.pending and s.slot is not None
                and now - s.last_activity > self.FORCE_EVICT_GRACE_SECONDS]
            if candidates:
                idle = [min(candidates, key=lambda s: self._streams[s].last_activity)]
        for sid in idle:
            self._release_locked(sid)
        self._evicted_since_poll.extend(idle)

    def shutdown(self) -> None:
        self._decode_pool.shutdown(wait=True)
