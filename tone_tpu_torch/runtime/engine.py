"""Multi-stream serving engine: stream table, tick loop, phrase decoding
(port of ``tone_tpu/runtime/engine.py``).

A stream table maps stream ids to arena slots; idle streams are evicted
after a timeout (Triton's ``max_sequence_idle_microseconds: 15000000``),
streams beyond the slot count wait as candidates, and each tick batches all
pending chunks into one arena step.  Phrase segmentation is one vectorized
pass over the ticking slots (``BatchLogprobSplitter``).  Final phrases
decode on a small thread pool: one by one with a host decoder (greedy, or
the host beam ``BeamSearchCTCDecoder``), or, with a
``DeviceBeamSearchCTCDecoder`` (LM-free, rescoring or fused), all phrases
of a tick in one batched device call (with per-stream n-best and hotwords).
Interim text comes from the greedy collapse in the tick, from a carried
host beam search per stream on the pool (``interim_beam``), or from a beam
arena on the device (``interim_device_beam``).

Traced (``profiling``), a tick records the span ``engine.tick`` over its
phases ``engine.bind`` (eviction, binding, assembling the chunks),
``engine.step`` (the arena's ``arena.upload``, ``arena.dispatch`` and
``arena.readback``), ``engine.split`` and ``engine.finish`` (the results,
the decode submissions, the interims), and each decode-pool task its wait
for a worker, ``engine.decode_wait``, and its work, ``engine.decode``: all
with the tick's count as their id.
"""

from __future__ import annotations

import copy
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from tone_tpu_torch import profiling
from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.decoder import (
    BeamSearchCTCDecoder,
    DeviceBeamSearchCTCDecoder,
    GreedyCTCDecoder,
)
from tone_tpu_torch.pipeline import TextPhrase, phrase_times, word_timings
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
    # Interim beam-decode carry (interim_beam): a carried-state host beam
    # search advanced on the decode pool, one task in flight per stream;
    # frames queue here between tasks, a phrase boundary folds into the next
    # task as a reset.
    beam: object = None
    beam_frames: list = field(default_factory=list)
    beam_task: Future | None = None
    beam_reset: bool = False
    beam_gen: int = 0               # bumped at boundaries; stale results drop
    # Per-request hotwords: on a device decoder the automaton tables ride
    # the batched finals call as one row of stacked tables (a list too big
    # to stack gets a per-stream device decoder instead); on a host decoder
    # the stream gets a host beam decoder of its own.
    decoder: object = None          # per-stream decoder override
    hotwords: tuple | None = None   # (words, weight) behind the biasing —
    # plain data so suspend/resume can carry it across engines
    hotword_tables: object = None   # ops.beam_decode.HotwordTables
    nbest: int = 0                  # >1: finals carry n-best alternatives
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

    MAX_NBEST = 32
    # Cap on the stacked per-row hotword tables a batched finals call may
    # upload (3 tables x final_decode_batch x nodes x chars); a request over
    # it gets a per-stream decoder (per-phrase decodes) instead.
    MAX_STACKED_HOTWORD_BYTES = 32 * 1024 * 1024

    def __init__(self, variables, config: ToneConfig, n_slots: int = 256,
                 decoder=None, device=None, sharding=None, decode_workers: int = 8,
                 interim_transcripts: bool = False,
                 interim_beam: bool = False,
                 interim_device_beam: bool = False,
                 interim_beam_width: int = 8,
                 interim_beam_max_len: int = 2048,
                 idle_evict_seconds: float | None = None,
                 force_evict_grace: float | None = None,
                 final_decode_batch: int = 64,
                 word_timestamps: bool = False,
                 nbest: int = 0,
                 max_candidates: int = 0,
                 candidate_buffer_chunks: int = 200,
                 hotword_warmup_buckets=(32,)) -> None:
        """``decoder``: ``GreedyCTCDecoder`` (the default), the host beam
        ``BeamSearchCTCDecoder``, or ``DeviceBeamSearchCTCDecoder`` (any
        object with ``forward``).  Host decoders decode each final phrase
        on the pool.  With the device decoder, final phrases of a tick
        decode in one batched call; the engine works on a shallow copy
        pinned to the engine's device and to ``final_decode_batch`` rows per
        call (batches pad up to and split at it, so ``warmup`` runs every
        shape a tick can ask for).

        ``interim_transcripts``: also decode each in-progress phrase in the
        tick; ``tick`` then reports partial text per stream in
        ``last_interims``.  ``interim_beam``: the partials come from a
        carried-state host beam search per stream (``decoder.streaming()``)
        advanced on the decode pool, at most one advance in flight per
        stream, its text reported on a later tick.  ``interim_device_beam``:
        the partials come from a beam arena on the device
        (``ops/beam_decode.py``), advanced for every ticking slot in one call
        per tick and reset at phrase boundaries, biased like the finals when
        the decoder has hotwords; ``interim_beam_width`` /
        ``interim_beam_max_len`` size it.

        ``word_timestamps``: final phrases carry per-word times and
        confidences (CTC forced alignment, ``align.py``), on the pool.

        ``nbest``: the default per-stream n-best (0, or 2..MAX_NBEST);
        ``set_stream_nbest`` overrides it per request.  Needs a beam
        decoder.

        ``hotword_warmup_buckets``: hotword-table node buckets whose
        stacked finals calls ``warmup`` runs once (device decoders only).

        ``idle_evict_seconds`` overrides the Triton-parity 15 s idle reap;
        ``force_evict_grace`` the 1 s quiet period below which a slot is
        never stolen under pressure.

        ``max_candidates``: streams accepted beyond the slot count; they
        buffer up to ``candidate_buffer_chunks`` chunks host-side and bind
        oldest-first as slots free (Triton's max_candidate_sequences).

        ``device``: ``cuda`` unless the caller asks for the CPU.
        ``sharding``: instead, the slots split over a mesh's data devices
        (``StreamArena``, ``parallel.mesh.arena_shardings``); the engine's
        device, on which the device decoder and the interim beam arena run,
        is then the first data device."""
        if decoder is not None and not callable(getattr(decoder, "forward", None)):
            raise TypeError(f"decoder {type(decoder).__name__} has no forward(logprobs)")
        if nbest and (nbest < 0 or nbest > self.MAX_NBEST):
            raise ValueError(f"nbest must be 0..{self.MAX_NBEST}, got {nbest}")
        if nbest == 1:
            raise ValueError("nbest=1 is ambiguous (finals always carry the "
                             "top hypothesis as .text): use 0 for no "
                             "alternatives or N >= 2")
        if nbest and not hasattr(decoder or (), "nbest"):
            raise ValueError("nbest > 1 needs a beam decoder (greedy has no "
                             "alternative hypotheses)")
        self.config = config
        self.arena = StreamArena(variables, config, n_slots, device=device, sharding=sharding)
        self.device_finals = isinstance(decoder, DeviceBeamSearchCTCDecoder)
        if self.device_finals:
            # A copy pinned to the engine's device and one batch bucket: the
            # caller's decoder may also serve a pipeline or another engine.
            decoder = copy.copy(decoder)
            decoder.device = self.arena.device
            decoder._cuda_stream = None
            decoder.batch_floor = decoder.max_batch = final_decode_batch
        self.decoder = decoder or GreedyCTCDecoder()
        self.interim_transcripts = (interim_transcripts or interim_beam
                                    or interim_device_beam)
        self.interim_device_beam = interim_device_beam
        self.interim_beam = (interim_beam and not interim_device_beam
                             and hasattr(self.decoder, "streaming"))
        self._interim_results: dict[int, tuple[int, str]] = {}
        self._device_beams = None       # lazy ops.beam_decode (Hot)BeamState
        self._device_beam_width = interim_beam_width
        self._device_beam_max_len = interim_beam_max_len
        self.word_timestamps = word_timestamps
        self.default_nbest = int(nbest) if nbest else 0
        # hotword-table node buckets whose stacked finals calls were run
        self._warmed_hotword_buckets: set[int] = set()
        self._hotword_warmup_buckets = tuple(
            int(b) for b in (hotword_warmup_buckets or ()) if int(b) > 0)
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
        # resumed slots keep their acoustic state (reset False) but restart
        # the interim device-beam arena
        self._beam_force_reset = np.zeros(n_slots, bool)
        self._next_id = 0
        self._lock = threading.Lock()
        self._interim_lock = threading.Lock()  # guards _interim_results only
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
                self._streams[sid] = _Stream(slot=slot, nbest=self.default_nbest)
                self._slot_reset[slot] = True
                self._splitter.reset(slot)
                return sid
            if len(self._pending_bind) >= self.max_candidates:
                raise RuntimeError("no free stream slots")
            sid = self._next_id
            self._next_id += 1
            self._streams[sid] = _Stream(slot=None, nbest=self.default_nbest)
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
        """Per-request contextual biasing: this stream's final phrases (and
        its interim beams) decode with the given hotwords.  With the device
        decoder the bias is data: the request's automaton tables become one
        row of the tick's batched finals call (stacked per-row tables,
        padded to power-of-two node counts).  A list so large that stacking
        it would pass MAX_STACKED_HOTWORD_BYTES gets a per-stream device
        decoder sharing the engine's LM and fusion (per-phrase decodes).
        With a host decoder (greedy or host beam) the stream gets a host
        beam decoder of its own, reusing the engine decoder's LM.  An empty
        list clears an earlier override."""
        override = None
        tables = None
        if hotwords:
            base = self.decoder
            if self.device_finals:
                from tone_tpu_torch.ops.beam_decode import make_hotword_tables

                tables = make_hotword_tables(hotwords, hotword_weight)
                if self._stacked_hotword_bytes(tables) > self.MAX_STACKED_HOTWORD_BYTES:
                    override = DeviceBeamSearchCTCDecoder(
                        base._lm, alpha=base.alpha, beta=base.beta,
                        beam_width=base.beam_width, nbest=base.nbest_hyps,
                        max_len=base.max_len, fusion=base.fusion, hotwords=hotwords,
                        hotword_weight=hotword_weight, device=base.device)
                    tables = None
            else:
                from tone_tpu_torch.decoding.lm import LanguageModel

                lm = getattr(base, "_lm", None)
                override = BeamSearchCTCDecoder(
                    lm if isinstance(lm, LanguageModel) else None,
                    native_lm=getattr(base, "_native_lm", None),
                    alpha=getattr(base, "alpha", BeamSearchCTCDecoder.ALPHA),
                    beta=getattr(base, "beta", BeamSearchCTCDecoder.BETA),
                    beam_width=getattr(base, "beam_width", None)
                    or BeamSearchCTCDecoder.BEAM_WIDTH,
                    hotwords=hotwords, hotword_weight=hotword_weight)
        with self._lock:
            stream = self._streams.get(sid)
            if stream is None:
                raise UnknownStreamError(f"unknown stream {sid}")
            stream.decoder = override  # None clears an earlier override
            stream.hotword_tables = tables
            stream.hotwords = ((tuple(hotwords), float(hotword_weight))
                               if hotwords else None)
            # the carried interim search rebuilds (biased or not); a new
            # generation drops an in-flight task's stale result
            stream.beam = None
            stream.beam_gen += 1
            stream.beam_reset = True
            stream.beam_frames.clear()
        if tables is not None:
            # One warm per effective node bucket, on the pool, overlapping
            # the stream's early audio.
            bucket = self._effective_hotword_bucket(tables)
            with self._lock:
                fresh = bucket not in self._warmed_hotword_buckets
                self._warmed_hotword_buckets.add(bucket)
            if fresh:
                self._decode_pool.submit(self._warm_hotword_bucket, bucket, tables)

    def set_stream_nbest(self, sid: int, n: int | None) -> None:
        """Per-request n-best: this stream's final phrases carry up to ``n``
        alternative ``(text, score)`` transcripts (``TextPhrase.nbest``);
        ``None``/0/1 clears.  With the device decoder the stream stays on
        the batched finals call.  The greedy decoder raises ValueError."""
        n = int(n or 0)
        if n < 0 or n > self.MAX_NBEST:
            raise ValueError(f"nbest must be 0..{self.MAX_NBEST}, got {n}")
        with self._lock:
            stream = self._streams.get(sid)
            if stream is None:
                raise UnknownStreamError(f"unknown stream {sid}")
            if n > 1 and not hasattr(stream.decoder or self.decoder, "nbest"):
                raise ValueError(
                    "the configured decoder has no n-best support "
                    "(greedy decodes a single hypothesis; use a beam decoder)")
            stream.nbest = 0 if n <= 1 else n

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
                    "nbest": stream.nbest, "hotwords": stream.hotwords}
            self._release_locked(sid)
            return snap

    def resume_stream(self, snapshot: dict) -> int:
        """Restore a ``suspend_stream`` snapshot into a fresh slot; returns
        the new stream id; its n-best and hotwords come along (the biasing
        is rebuilt for this engine's decoder family).  Raises RuntimeError
        when no slot is free."""
        nbest = int(snapshot.get("nbest") or 0)
        with self._lock:
            if not self._free_slots:
                self._evict_idle_locked(force_one=True)
            if not self._free_slots:
                raise RuntimeError("no free stream slots")
            slot = self._free_slots.pop()
            sid = self._next_id
            self._next_id += 1
            self._streams[sid] = _Stream(slot=slot, nbest=nbest)
            self._slot_reset[slot] = False  # the snapshot IS the state
            self._beam_force_reset[slot] = True
            self._splitter.restore(slot, snapshot)
        with self._device_lock:
            self.arena.write_slot(slot, snapshot["acoustic_state"])
        hw = snapshot.get("hotwords")
        if hw:
            self.set_stream_hotwords(sid, list(hw[0]), hw[1])
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
        with profiling.span("engine.tick", self.stats.ticks):
            return self._tick()

    def _tick(self) -> dict[int, list[Future]]:
        t0 = time.monotonic()
        with profiling.span("engine.bind"), self._lock:
            self._evict_idle_locked()
            self._bind_candidates_locked()
            n = self.arena.n_slots
            chunks = np.zeros((n, self.config.audio_chunk_samples), np.int16)
            active = np.zeros(n, bool)
            reset = np.zeros(n, bool)
            beam_reset = np.zeros(n, bool)
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
                beam_reset[slot] = reset[slot] or self._beam_force_reset[slot]
                self._slot_reset[slot] = False
                self._beam_force_reset[slot] = False
                ticking.append((sid, stream, is_last))
                self._inflight.add(sid)
            self.stats.pending_streams = len(self._pending_bind)
            self.stats.active_streams = len(self._streams) - self.stats.pending_streams

        if not ticking:
            return {}

        t_dev0 = time.monotonic()
        with profiling.span("engine.step"), self._device_lock:  # vs. resume_stream's write
            logprobs = self.arena.tick(chunks, active, reset)
        t_device = time.monotonic() - t_dev0

        with profiling.span("engine.split"):
            slot_ids = np.array([s.slot for _, s, _ in ticking], np.int64)
            lasts = np.array([last for _, _, last in ticking], bool)
            tick_logprobs = logprobs[slot_ids].astype(np.float32, copy=False)
            by_slot = self._splitter.forward_batch(tick_logprobs, slot_ids, lasts)
            argmax = (tick_logprobs.argmax(axis=-1)
                      if self.interim_transcripts and not self.interim_beam
                      and not self.interim_device_beam else None)
            device_texts = None
            if self.interim_device_beam:
                device_texts = self._tick_device_beams(logprobs, ticking, by_slot, beam_reset)

        with profiling.span("engine.finish"):
            results = self._finish_tick(ticking, by_slot, tick_logprobs, argmax, device_texts)

        self.stats.ticks += 1
        elapsed = time.monotonic() - t0
        self.stats.last_tick_seconds = elapsed
        self.stats.last_host_seconds = elapsed - t_device
        return results

    def _finish_tick(self, ticking, by_slot, tick_logprobs, argmax, device_texts,
                     ) -> dict[int, list[Future]]:
        """The tick's results: phrase futures (decodes submitted to the
        pool), interims, finished streams released."""
        results: dict[int, list[Future]] = {}
        interims: dict[int, str] = {}
        finished: list[int] = []
        batch_finals: list[tuple[Future, object, int, object]] = []
        blank = len(self._labels)
        with self._lock:
            for k, (sid, stream, is_last) in enumerate(ticking):
                stream.ticks += 1
                phrases = by_slot.get(stream.slot)
                if phrases and self.device_finals and stream.decoder is None:
                    # One batched device call per tick decodes these, with
                    # the stream's n-best and hotword tables as row data.
                    futs = [Future() for _ in phrases]
                    batch_finals.extend((f, p, stream.nbest, stream.hotword_tables)
                                        for f, p in zip(futs, phrases))
                    results[sid] = futs
                elif phrases:
                    # host decoders, and per-stream overrides: per phrase on
                    # the pool
                    results[sid] = [self._submit(self._decode, p, stream.decoder, stream.nbest)
                                    for p in phrases]
                if device_texts is not None:
                    if phrases or is_last:
                        stream.interim_sent = ""
                    else:
                        text = device_texts[stream.slot]
                        if text and text != stream.interim_sent:
                            stream.interim_sent = text
                            interims[sid] = text
                elif self.interim_beam:
                    if phrases or is_last:
                        # Phrase boundary: the real decoder finalizes the
                        # in-progress text; restart the carried search.
                        stream.beam_reset = True
                        stream.beam_gen += 1
                        stream.beam_frames.clear()
                        stream.interim_sent = ""
                    else:
                        stream.beam_frames.append(np.ascontiguousarray(tick_logprobs[k]))
                    if not is_last:
                        self._maybe_submit_interim_locked(sid, stream)
                elif argmax is not None:
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
        if batch_finals:
            # The pool task dispatches the device call and resolves the
            # futures; the tick thread never waits for the decode.
            self._submit(self._decode_batch, batch_finals)
        if self.interim_beam:
            # Surface beam-interim texts completed since the last tick.
            with self._interim_lock:
                done_interims = self._interim_results
                self._interim_results = {}
            if done_interims:
                with self._lock:
                    for sid, (gen, text) in done_interims.items():
                        stream = self._streams.get(sid)
                        if stream is None or stream.beam_gen != gen:
                            # a boundary finalized this phrase after the
                            # worker stored its text: drop the stale interim
                            continue
                        if text and text != stream.interim_sent:
                            stream.interim_sent = text
                            interims[sid] = text
        self.last_interims = interims
        return results

    def _submit(self, fn, *args) -> Future:
        """``fn(*args)`` on the decode pool; traced, with its wait for a
        worker and its work as spans of the running tick."""
        if not profiling.recording():
            return self._decode_pool.submit(fn, *args)
        tick, queued = self.stats.ticks, time.monotonic_ns()

        def traced():
            profiling.add_span("engine.decode_wait", queued, time.monotonic_ns(), tick)
            with profiling.span("engine.decode", tick):
                return fn(*args)
        return self._decode_pool.submit(traced)

    def warmup(self) -> None:
        """Run every per-tick device path once before serving traffic: the
        arena step and, when enabled, the batched finals call at every frame
        bucket (plain and for the hotword warmup buckets) and the interim
        beam arena's reset/advance/readout."""
        self.arena.warmup()
        if self.device_finals:
            self._warm_decode_buckets(self.decoder)
            from tone_tpu_torch.ops.beam_decode import make_hotword_tables

            for b in sorted(set(self._hotword_warmup_buckets)):
                eff = self._effective_hotword_bucket(
                    make_hotword_tables(("а",), pad_nodes=b))
                with self._lock:
                    if eff in self._warmed_hotword_buckets:
                        continue
                    self._warmed_hotword_buckets.add(eff)
                try:
                    self._warm_decode_buckets(
                        self.decoder, hotwords=make_hotword_tables(("а",), pad_nodes=eff))
                except Exception:
                    with self._lock:
                        self._warmed_hotword_buckets.discard(eff)
                    raise
        if self.interim_device_beam:
            init, reset, advance, top = self._interim_beam_ops()
            n = self.arena.n_slots
            if self._device_beams is None:
                self._device_beams = init(n, self._device_beam_width,
                                          self._device_beam_max_len, self.arena.device)
            state = reset(self._device_beams, np.zeros(n, bool))
            frames = self.config.encoder.chunk_size
            # zero active frames: the whole path runs, states unchanged
            state = advance(state, np.full((n, frames, len(self._labels) + 1), -3.5,
                                           np.float32), np.zeros(n, np.int64))
            top(state)[0].cpu()
            self._device_beams = state

    def _warm_decode_buckets(self, decoder, hotwords=None) -> None:
        """Run a decoder once at every frame bucket a serving phrase can
        fall in (the splitter force-splits phrases, so the set is closed);
        ``hotwords``: the stacked per-row-biased call at its node bucket."""
        from tone_tpu_torch.splitter import StreamingLogprobSplitter as _S

        max_frames = _S.MAX_PHRASE_DURATION + 2 * _S.SPEECH_EXPAND_SIZE
        v = len(self._labels) + 1
        t = 64
        while True:
            decoder.forward_batch(
                [np.full((min(t, max_frames), v), -3.5, np.float32)],
                hotword_rows=[hotwords] if hotwords is not None else None)
            if t >= max_frames:
                break
            t <<= 1

    def _stacked_hotword_bytes(self, tables) -> int:
        """Bytes a batched finals call would upload if this request's
        tables ride the stacked path (at the effective node bucket)."""
        batch = getattr(self.decoder, "max_batch", None) or 1
        n_nodes = self._effective_hotword_bucket(tables)
        return 3 * 4 * batch * n_nodes * int(tables.next_node.shape[1])

    def _effective_hotword_bucket(self, tables) -> int:
        """The node count a serving call stacks for these tables: the max of
        theirs and the engine decoder's own (unbiased rows inherit those)."""
        bucket = int(tables.next_node.shape[0])
        base = getattr(self.decoder, "hotword_tables", None)
        if base is not None:
            bucket = max(bucket, int(base.next_node.shape[0]))
        return bucket

    def _warm_hotword_bucket(self, bucket: int, tables) -> None:
        """Pool task: run the batched finals call for a request's node
        bucket once; a failed warm un-marks the bucket so a later request
        retries."""
        try:
            from tone_tpu_torch.ops.beam_decode import pad_hotword_tables

            self._warm_decode_buckets(self.decoder,
                                      hotwords=pad_hotword_tables(tables, bucket))
        except Exception:  # noqa: BLE001 — warm is best-effort; real decodes
            with self._lock:  # surface their own errors through futures
                self._warmed_hotword_buckets.discard(bucket)

    def _interim_beam_ops(self):
        """(init, reset, advance, top_tokens) for the interim device arena —
        the hotword-biased variants when the final decoder has hotword
        tables, so interim partials bias like finals."""
        from tone_tpu_torch.ops import beam_decode as bd

        hw = getattr(self.decoder, "hotword_tables", None)
        if isinstance(hw, bd.HotwordTables):
            return (bd.init_hot_beam_state, bd.hot_beam_reset,
                    lambda st, lp, fr: bd.hot_beam_advance(st, lp, fr, hotwords=hw),
                    bd.hot_beam_top_tokens)
        return (bd.init_beam_state, bd.beam_reset,
                lambda st, lp, fr: bd.beam_advance(st, lp, fr), bd.beam_top_tokens)

    def _tick_device_beams(self, logprobs, ticking, by_slot, reset):
        """Advance the device beam arena one tick and read back the best
        hypothesis per slot.  Slots reset when the acoustic slot resets (a
        new or resumed stream) or at a phrase boundary (the finalized
        phrase goes through the real decoder); other ticking slots advance
        over this tick's frames."""
        from tone_tpu_torch.ops.beam_decode import top_texts

        init, reset_fn, advance, top = self._interim_beam_ops()
        n = self.arena.n_slots
        if self._device_beams is None:
            self._device_beams = init(n, self._device_beam_width,
                                      self._device_beam_max_len, self.arena.device)
        reset_mask = np.asarray(reset, bool).copy()
        frames = np.zeros(n, np.int64)
        for _, stream, is_last in ticking:
            if by_slot.get(stream.slot) or is_last:
                reset_mask[stream.slot] = True
            else:
                frames[stream.slot] = logprobs.shape[1]
        state = reset_fn(self._device_beams, reset_mask)
        state = advance(state, np.asarray(logprobs, np.float32), frames)
        self._device_beams = state
        return top_texts(*top(state))

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

    def _maybe_submit_interim_locked(self, sid: int, stream: _Stream) -> None:
        """Kick the stream's carried host beam search on the decode pool (at
        most one in-flight advance per stream; frames queue between tasks,
        a boundary folds into the next task as a reset)."""
        if stream.beam_task is not None and not stream.beam_task.done():
            return
        if not stream.beam_frames and not stream.beam_reset:
            return
        if stream.beam is None:
            stream.beam = (stream.decoder or self.decoder).streaming()
        beam = stream.beam
        frames = stream.beam_frames
        stream.beam_frames = []
        do_reset, stream.beam_reset = stream.beam_reset, False
        gen = stream.beam_gen

        def work():
            if do_reset:
                beam.reset()
            if frames:
                beam.advance(np.concatenate(frames, axis=0))
            text = beam.result()
            # Stored on the worker (not a done-callback) so per-stream store
            # order is task order; the tick re-checks the generation when it
            # drains, as a boundary may land between this store and the next
            # tick.
            with self._interim_lock:
                if stream.beam_gen == gen:
                    self._interim_results[sid] = (gen, text)
            return text

        stream.beam_task = self._submit(work)

    def _word_times(self, logprob_phrase, text: str):
        if not self.word_timestamps:
            return None
        return word_timings(self.config, logprob_phrase, text)

    def _decode(self, logprob_phrase, decoder=None, nbest: int = 0) -> TextPhrase:
        decoder = decoder or self.decoder
        logprobs = np.ascontiguousarray(logprob_phrase.logprobs)
        alternatives = None
        if nbest > 1 and hasattr(decoder, "nbest"):
            ranked = decoder.nbest(logprobs, nbest)
            text = ranked[0][0] if ranked else ""
            alternatives = tuple(ranked)
        else:
            text = decoder.forward(logprobs)
        start, end = phrase_times(self.config, logprob_phrase.start_frame,
                                  logprob_phrase.end_frame)
        with self._lock:
            self.stats.phrases_decoded += 1
        return TextPhrase(text=text, start_time=start, end_time=end,
                          words=self._word_times(logprob_phrase, text),
                          nbest=alternatives)

    def _decode_batch(self, items: list[tuple[Future, object, int, object]]) -> None:
        """Decode a tick's completed phrases in one batched device call and
        resolve each phrase's future.  Mixed n-best rides the same call
        (``forward_batch_nbest`` at the largest n asked for), and so do
        per-request hotwords (each item's tables, or None, are a row of the
        stacked tables).  Word alignment, host work, runs on the pool."""
        max_n = max((n for _, _, n, _ in items), default=0)
        hotword_rows = [hw for _, _, _, hw in items]
        if not any(hw is not None for hw in hotword_rows):
            hotword_rows = None
        try:
            lps = [np.ascontiguousarray(p.logprobs) for _, p, _, _ in items]
            if max_n > 1:
                ranked_rows = self.decoder.forward_batch_nbest(lps, max_n, hotword_rows)
                texts = [r[0][0] if r else "" for r in ranked_rows]
            else:
                texts = self.decoder.forward_batch(lps, hotword_rows)
                ranked_rows = [None] * len(items)
        except Exception as e:  # noqa: BLE001 — futures must resolve
            for fut, _, _, _ in items:
                fut.set_exception(e)
            return
        for (fut, phrase, n, _), text, ranked in zip(items, texts, ranked_rows):
            start, end = phrase_times(self.config, phrase.start_frame, phrase.end_frame)
            with self._lock:
                self.stats.phrases_decoded += 1
            alternatives = tuple(ranked[:n]) if ranked and n > 1 else None
            if self.word_timestamps and text:
                def finish(fut=fut, phrase=phrase, text=text, start=start, end=end,
                           alternatives=alternatives):
                    try:
                        fut.set_result(TextPhrase(
                            text=text, start_time=start, end_time=end,
                            words=self._word_times(phrase, text), nbest=alternatives))
                    except Exception as e:  # noqa: BLE001
                        fut.set_exception(e)

                try:
                    self._decode_pool.submit(finish)
                except RuntimeError:
                    # pool already shut down: resolve inline so no caller
                    # blocked on fut.result() waits forever
                    finish()
            else:
                fut.set_result(TextPhrase(text=text, start_time=start, end_time=end,
                                          nbest=alternatives))

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
