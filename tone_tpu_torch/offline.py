"""Batched offline transcription: bulk throughput for batch jobs and corpus
evaluation (port of ``tone_tpu/offline.py``).

Whole utterances go through the acoustic model in batches, then each is
split into phrases and decoded.  Two forwards give the same function:

* the chunk scan (the default): ``core.model.apply_streaming`` over the
  300 ms chunk columns of the batch, from a zero state;
* ``use_offline_forward=True``: ``core.model.apply_offline``, the
  full-sequence forward whose chunk-simulating masks reproduce the scan.

A ``FastConformerConfig`` (an offline-only architecture) runs
``core.fastconformer.apply_fastconformer`` and needs
``use_offline_forward=True``: its rows carry no edge padding, are padded
with zeros to a bucketed multiple of one output frame's samples, and go to
the forward with their lengths, so that it computes each row as if alone;
its phrases are split at the blank alone and decoded with its vocabulary;
frames are 80 ms.  With a transducer (``fastconformer_tdt``) the forward
is the encoder and the greedy TDT loop on the device
(``core.transducer.greedy_tdt``; on a card its steps replay as a CUDA
graph, ``GraphedLoop``), and a batch comes back as the loop's record
instead of logprobs: a phrase ends where 20 or more frames pass with no
token and is cut at 2,000 frames (the splitter's frame counts), its pieces
joined with the word-start mark read as a space, its times from the token
frames.  With an attention decoder (``fastconformer_aed``) each call is
first cut into consecutive windows of at most ``config.aed.window_seconds``,
and the windows are the rows, sorted and batched as calls are; the forward
is the encoder and the greedy decoder with its cache (``core.aed.greedy_aed``;
replayed as a CUDA graph on a card, ``GraphedDecoder``), a batch comes back
as the loop's record beside its windows (``_Windows``: each row's call and
window, frames and cap, and the logits and cross-attention memory of the
windows named in ``keep_logits``, which a check such as the benchmark's
reads through ``_wait``), and each window with text gives one phrase,
timed at the window's bounds, in call order.  The mesh and word times are
T-one's only.

Utterances are sorted by length and padded to a bucketed number of chunks;
the zero chunks that pad a row are processed as audio, as the JAX
package's are, so they decide where the last phrase ends.

The batches run as a two-deep pipeline: batch ``i+1``'s forward is queued
on the device before the host splits and decodes batch ``i``.  Each
batch's logprobs are copied into pinned host memory without blocking, and
only that copy's event is waited on, so the wait does not include the next
batch's queued work.

With ``mesh`` (``parallel.mesh.make_mesh``, a ``data`` axis only) the
batch rows are split evenly over the mesh's data devices, as the JAX
package shards them: the batch size must be a multiple of the data axis,
checked at construction, and the last batch is padded with zero rows to
an even split (those rows are dropped).  Each device holds a replica of
the inference weights (one per distinct device) and runs its rows through
the chosen forward; every device's rows are queued before any is waited
on, so the devices overlap, and each device keeps the two-deep pipeline.
The logprobs are gathered in row order, then split and decoded as on one
device.

A batch goes to the device unpadded: its calls' own samples are copied
once, back to back, into a host staging buffer (int16 where every call is
int16, else int32), each device is sent its own rows' part of it, and the
padded rows are built there (zeros, then each call copied into its place).
The staging buffers and, on a card, the pinned buffers the logprobs come
back into are rings of two, reused from batch to batch and call to call and
grown only when a batch needs more room; before the host writes into one
again it waits for the events recorded after the device's last copy from
or into it.  On a card the rings are pinned and the copies do not block.

Traced (``profiling``), each batch records the spans ``offline.assemble``
(stage, bucket, queue the copy to the device and build the padded rows
there), ``offline.forward`` (the forward's dispatch and the copies back),
``offline.wait``, ``offline.split``, ``offline.decode`` and
``offline.align``, with the batch's index in the call as their id, and the
counts ``offline.audio_samples`` (the rows' own samples),
``offline.padded_samples`` (the samples the forward computes),
``offline.upload_bytes`` (the bytes staged and sent to the devices) and
``offline.staging_allocs`` (ring buffers allocated or grown).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.acoustic import cast_params_for_inference
from tone_tpu_torch.config import (
    FASTCONFORMER_AED,
    FASTCONFORMER_TDT,
    LABELS,
    FastConformerConfig,
    ModelConfig,
)
from tone_tpu_torch.core import aed, transducer
from tone_tpu_torch.core.fastconformer import apply_fastconformer, encode_fastconformer
from tone_tpu_torch.core.model import apply_offline, apply_streaming, init_streaming_state
from tone_tpu_torch.device import record_event, resolve_device
from tone_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, replicate
from tone_tpu_torch.pipeline import TextPhrase, phrase_times
from tone_tpu_torch.splitter import StreamingLogprobSplitter

__all__ = ["OfflineTranscriber"]


class _HostRing:
    """Two reusable host buffers (pinned on a card), each guarded by the
    events recorded after the device's last copy from or into it."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self._buffers: list[torch.Tensor | None] = [None, None]
        self._events: list[list] = [[], []]

    def take(self, slot: int, n: int, dtype: torch.dtype) -> torch.Tensor:
        """Buffer ``slot`` as ``n`` elements of ``dtype``, once the device is
        done with it; allocated, or grown, only when it is too small."""
        for event in self._events[slot]:
            event.synchronize()
        self._events[slot] = []
        nbytes = n * dtype.itemsize
        buffer = self._buffers[slot]
        if buffer is None or buffer.numel() < nbytes:
            buffer = self._buffers[slot] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                                       pin_memory=self.pinned)
            profiling.count("offline.staging_allocs", 1)
        return buffer[:nbytes].view(dtype)

    def guard(self, slot: int, events: list) -> None:
        """The events after the device's copies from or into buffer ``slot``."""
        self._events[slot] = events


@dataclass(frozen=True)
class _Model:
    """What the transcriber does differently for each architecture, chosen
    once from its config (``OfflineTranscriber._choose_model``)."""

    unit_frames: int  # logprob frames per unit of a row's length (the rows' units)
    assemble: Callable  # (idx, audios, batch) -> (rows' units, each device's batch, queued)
    # The transcriber's method (variables, a device's batch) -> logprobs, by
    # name: looked up at each launch, so that one replaced on the instance runs.
    forward: str
    splitter: StreamingLogprobSplitter
    labels: str | tuple[str, ...]  # the default greedy decoder's vocabulary
    # The transcriber's method (launched batch, results) that turns a batch
    # into phrases, by name: split and decode logprobs, or a decoder's tokens.
    finish: str = "_finish"
    # On a card, the device loop that replays a decoder's steps as a CUDA
    # graph: made from (variables, config); None where the head has none.
    graphed: Callable | None = None
    window: int = 0  # samples of the windows a call is cut into (0: whole calls)


@dataclass
class _Windows:
    """An AED batch's rows beside its audio: each row's (call, window), its
    encoder frames and cap, and the rows whose steps' logits the loop
    keeps; once the forward is queued, the rows the loop computed and, by
    (call, window) on the device, each kept row's logits (steps, V) float32
    and the cross-attention keys and values its steps read
    (``aed.greedy_aed``)."""

    keys: list[tuple[int, int]]
    frames: list[int]
    caps: list[int]
    keep: list[int]
    rows: int = 0
    kept: dict = field(default_factory=dict)


@dataclass
class OfflineTranscriber:
    """Batched utterance transcription on one device, or on the data devices
    of a mesh."""

    variables: dict
    config: ModelConfig
    decoder: object = None  # GreedyCTCDecoder-compatible; default greedy
    batch_size: int = 16
    bucket_samples: int = 8 * 2400  # pad lengths up to multiples of this
    use_offline_forward: bool = False  # full-sequence forward instead of the scan
    mesh: Mesh | None = None  # split batch rows over the mesh's data devices
    word_timestamps: bool = False  # per-word times + confidences on phrases
    device: str | torch.device | None = None  # cuda unless the caller asks for the CPU

    def __post_init__(self):
        self._model = self._choose_model()
        if self._model.finish != "_finish" and self.decoder is not None:
            raise ValueError("OfflineTranscriber: a transducer or an attention decoder decodes "
                             "on the device; decoder= takes a CTC decoder")
        if self.mesh is None:
            devices = [resolve_device(self.device)]
        else:
            if not isinstance(self.mesh, Mesh):
                raise TypeError(f"OfflineTranscriber(mesh=...) takes a parallel.mesh.Mesh, "
                                f"not {type(self.mesh).__name__}")
            if self.device is not None:
                raise ValueError("OfflineTranscriber: give a device or a mesh, not both")
            devices = [resolve_device(d) for d in self.mesh.data_devices()]
            if self.batch_size % len(devices):
                raise ValueError(f"batch_size {self.batch_size} must be a multiple of the "
                                 f"mesh '{DATA_AXIS}' axis size {len(devices)}")
        self.device = devices[0]
        if self.decoder is None and self._model.finish == "_finish":
            from tone_tpu_torch.decoder import GreedyCTCDecoder

            self.decoder = GreedyCTCDecoder(self._model.labels)
        self._shards = list(zip(devices, replicate(
            cast_params_for_inference(self.variables, self.config), devices)))
        self.variables = self._shards[0][1]
        pinned = self.device.type == "cuda"
        # a decoder's loop on a card: its steps replayed as a CUDA graph
        self._graphed = (self._model.graphed(self.variables, self.config)
                         if pinned and self._model.graphed is not None else None)
        # The AED's windows whose steps' logits the loop keeps, as (call,
        # window) of each ``transcribe``: a check's, such as the benchmark's.
        self.keep_logits: set = set()
        self._owners: list[tuple[int, int]] = []   # the rows of a call to transcribe
        self._staging = _HostRing(pinned)   # the batches' unpadded samples
        self._host_logprobs = _HostRing(pinned)   # the logprobs' copies back (a card's)

    def _choose_model(self) -> _Model:
        cfg = self.config
        if isinstance(cfg, FastConformerConfig):
            if not self.use_offline_forward:
                raise ValueError("a FastConformer CTC model has no chunk scan (T-one's "
                                 "streaming step): pass use_offline_forward=True")
            if self.mesh is not None or self.word_timestamps:
                raise ValueError("OfflineTranscriber: the mesh and word times run T-one only")
            # rows in output frames, split at the blank alone (a transducer's
            # at frames with no token)
            splitter = StreamingLogprobSplitter(cfg.vocab_size_with_blank, silence_classes=1)
            if cfg.architecture == FASTCONFORMER_TDT:
                return _Model(1, self._assemble_calls, "_transducer_forward", splitter,
                              cfg.vocabulary, "_finish_tokens", transducer.GraphedLoop)
            if cfg.architecture == FASTCONFORMER_AED:
                window = round(cfg.aed.window_seconds * cfg.frontend.sample_rate)
                return _Model(1, self._assemble_windows, "_aed_forward", splitter,
                              cfg.vocabulary, "_finish_aed", aed.GraphedDecoder, window)
            return _Model(1, self._assemble_calls, "_fastconformer_forward", splitter,
                          cfg.vocabulary)
        # rows in chunks, split at the space and the blank
        return _Model(cfg.encoder.chunk_size, self._assemble_chunks,
                      "_offline_forward" if self.use_offline_forward else "_chunk_scan",
                      StreamingLogprobSplitter(), LABELS)

    def _chunk_scan(self, variables, chunks: torch.Tensor) -> torch.Tensor:
        """(B, n_chunks, chunk_samples) -> (B, n_chunks * frames, V)."""
        state = init_streaming_state(self.config, chunks.shape[0], device=chunks.device)
        out = []
        for i in range(chunks.shape[1]):
            logprobs, state = apply_streaming(variables, self.config, chunks[:, i], state)
            out.append(logprobs)
        return torch.cat(out, dim=1)

    def _offline_forward(self, variables, chunks: torch.Tensor) -> torch.Tensor:
        b, n, c = chunks.shape
        # No lengths: padding chunks are processed as the scan processes them
        # (as zero audio), keeping the two forwards interchangeable.
        logprobs, _, _ = apply_offline(variables, self.config, chunks.reshape(b, n * c))
        return logprobs

    def _fastconformer_forward(self, variables, batch) -> torch.Tensor:
        """((B, T_samples) audio, its host lengths) -> (B, frames, V)."""
        audio, lengths = batch
        return apply_fastconformer(variables, self.config, audio, lengths)[0]

    def _transducer_forward(self, variables, batch) -> torch.Tensor:
        """((B, T_samples) audio, its host lengths) -> the greedy TDT loop's
        record (B, steps, fields)."""
        audio, lengths = batch
        enc, frames = encode_fastconformer(variables, self.config, audio, lengths)
        return transducer.greedy_tdt(variables, self.config, enc, frames, self._graphed)

    def _aed_forward(self, variables, batch) -> torch.Tensor:
        """((B, T_samples) windows, their host lengths, their ``_Windows``)
        -> the greedy decoder's record (B, steps, fields); the rows computed
        and the kept rows' logits go to the ``_Windows``."""
        audio, lengths, windows = batch
        enc, frames = encode_fastconformer(variables, self.config, audio, lengths)
        record, logits, memory = aed.greedy_aed(variables, self.config, enc, frames,
                                                windows.caps, windows.keep, self._graphed)
        windows.rows = self._graphed.rows if self._graphed is not None else len(frames)
        windows.kept = {windows.keys[row]: kept
                        for row, kept in zip(windows.keep, zip(logits, memory))}
        return record

    def transcribe(self, audios: Sequence[np.ndarray]) -> list[list[TextPhrase]]:
        """Transcribe utterances (int16-range integer arrays); order kept."""
        window = self._model.window
        # this call's rows as (call, window): each call's windows, in order
        self._owners = [(i, k) for i, a in enumerate(audios)
                        for k in range(max(-(-len(a) // window), 1))] if window else []
        rows = [audios[i][k * window:(k + 1) * window] for i, k in self._owners] \
            if window else audios
        results: list = [None] * len(rows)
        finish = getattr(self, self._model.finish)
        self._pipelined(rows, lambda launched: finish(launched, results))
        if not window:
            return results
        calls: list[list[TextPhrase]] = [[] for _ in audios]
        rate = self.config.frontend.sample_rate
        for (i, k), piece, text in zip(self._owners, rows, results):
            if text:
                start = k * window
                calls[i].append(TextPhrase(text, round(start / rate, 2),
                                           round((start + len(piece)) / rate, 2)))
        return calls

    def logprobs(self, audios: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Per-utterance (frames, vocab+1) float32 logprobs, batched and
        bucketed as in ``transcribe`` but not split or decoded: the acoustic
        half of forced alignment (``python -m tone_tpu_torch align``).  A
        transducer or an attention decoder has none."""
        if self._model.finish != "_finish":
            raise ValueError("OfflineTranscriber.logprobs: a transducer or an attention "
                             "decoder gives tokens, not per-frame logprobs")
        out: list[np.ndarray | None] = [None] * len(audios)

        def finish(launched):
            idx, row_chunks, logprobs = self._wait(launched)
            for row, i in enumerate(idx):   # copies: the host buffer is reused
                out[i] = logprobs[row, :row_chunks[row] * self._model.unit_frames].copy()

        self._pipelined(audios, finish)
        return out  # type: ignore[return-value]

    def _pipelined(self, audios, finish) -> None:
        """Launch the batches in length order, finishing each batch after the
        next one is launched."""
        order = np.argsort([len(a) for a in audios], kind="stable")
        pending = None
        for batch, start in enumerate(range(0, len(order), self.batch_size)):
            launched = self._launch(order[start:start + self.batch_size], audios, batch)
            if pending is not None:
                finish(pending)
            pending = launched
        if pending is not None:
            finish(pending)

    def _launch(self, idx, audios, batch: int):
        """Queue one batch's forward on every device and the copies of its
        logprobs to the host; returns (idx, row_chunks, host logprobs, copy
        events, batch) without waiting."""
        with profiling.span("offline.assemble", batch):
            row_chunks, chunks = self._model.assemble(idx, audios, batch)
        with profiling.span("offline.forward", batch):
            forward = getattr(self, self._model.forward)
            logprobs = [forward(variables, c) for (_, variables), c in zip(self._shards, chunks)]
            if self.device.type != "cuda":
                return idx, row_chunks, torch.cat(logprobs), [], batch
            per = logprobs[0].shape[0]
            shape = (per * len(chunks), *logprobs[0].shape[1:])
            host = self._host_logprobs.take(batch % 2, int(np.prod(shape)),
                                            torch.float32).view(shape)
            events = []
            for k, lp in enumerate(logprobs):
                host[k * per:(k + 1) * per].copy_(lp, non_blocking=True)
                events += record_event(lp.device)
            self._host_logprobs.guard(batch % 2, events)
        return idx, row_chunks, host, events, batch

    def _assemble_chunks(self, idx, audios, batch) -> tuple[list[int], list[torch.Tensor]]:
        """(row_chunks, each device's rows of the padded chunks, queued to it)."""
        cfg = self.config
        pad = cfg.padding
        chunk = cfg.audio_chunk_samples
        bucket_chunks = max(self.bucket_samples // chunk, 1)
        calls = [np.asarray(audios[i]) for i in idx]
        # rows (each call between ``pad`` zeros) padded to a shared, bucketed
        # chunk count
        row_chunks = [-(-(len(a) + 2 * pad) // chunk) for a in calls]
        n_chunks = -(-max(row_chunks) // bucket_chunks) * bucket_chunks
        # Zero rows pad the batch to an even split over the devices (dropped
        # after the forward).
        n_rows = -(-len(idx) // len(self._shards)) * len(self._shards)
        rows = self._rows_on_devices(calls, n_rows, n_chunks * chunk, pad, batch)
        if profiling.recording():
            profiling.count("offline.audio_samples", sum(len(a) for a in calls))
            profiling.count("offline.padded_samples", n_rows * n_chunks * chunk)
        return row_chunks, [r.view(r.shape[0], n_chunks, chunk) for r in rows]

    def _assemble_windows(self, idx, audios, batch) -> tuple[_Windows, list[tuple]]:
        """An AED batch of windows: ``_assemble_calls``' rows, with their
        ``_Windows`` (each row's cap of tokens, the rows whose logits are
        kept) in the place of the rows' frames."""
        row_frames, [(audio, lengths)] = self._assemble_calls(idx, audios, batch)
        a, rate = self.config.aed, self.config.frontend.sample_rate
        keys = [self._owners[i] for i in idx]
        windows = _Windows(keys, row_frames, [a.max_tokens(int(n), rate) for n in lengths],
                           [row for row, key in enumerate(keys) if key in self.keep_logits])
        return windows, [(audio, lengths, windows)]

    def _assemble_calls(self, idx, audios, batch) -> tuple[list[int], list[tuple]]:
        """A FastConformer batch: (each row's output frames, [((B, samples)
        audio queued to the device, the rows' host lengths)]); rows padded
        with zeros to a bucketed multiple of an output frame's samples."""
        cfg = self.config
        unit = cfg.frame_samples
        bucket_units = max(self.bucket_samples // unit, 1)
        calls = [np.asarray(audios[i]) for i in idx]
        lengths = np.array([len(a) for a in calls], np.int64)
        units = max(-(-int(lengths.max()) // unit), 1)
        n_units = -(-units // bucket_units) * bucket_units
        (audio,) = self._rows_on_devices(calls, len(idx), n_units * unit, 0, batch)
        if profiling.recording():
            profiling.count("offline.audio_samples", int(lengths.sum()))
            profiling.count("offline.padded_samples", audio.numel())
        row_frames = [cfg.output_frames(int(n)) for n in lengths]
        return row_frames, [(audio, lengths)]

    def _rows_on_devices(self, calls, n_rows: int, width: int, offset: int,
                         batch: int) -> list[torch.Tensor]:
        """Each device's share of ``n_rows`` rows of ``width`` samples, row
        ``r`` holding ``calls[r]`` from ``offset`` and zeros elsewhere (int16
        where every call is int16, else int32).  Only the calls' own samples
        cross to the devices: staged back to back in the host ring's buffer
        of ``batch``, each device sent its rows' part, the rows built there."""
        dtype = torch.int16 if all(a.dtype == np.int16 for a in calls) else torch.int32
        ends = np.cumsum([0] + [len(a) for a in calls]).tolist()
        slot = batch % 2
        staged = self._staging.take(slot, ends[-1], dtype)
        host = staged.numpy()
        for a, start, end in zip(calls, ends, ends[1:]):
            host[start:end] = a
        if profiling.recording():
            profiling.count("offline.upload_bytes", ends[-1] * dtype.itemsize)
        per = n_rows // len(self._shards)
        rows, events = [], []
        for k, (dev, _) in enumerate(self._shards):
            first, last = min(k * per, len(calls)), min((k + 1) * per, len(calls))
            sent = staged[ends[first]:ends[last]].to(dev, non_blocking=True)
            events += record_event(dev)
            out = torch.zeros((per, width), dtype=dtype, device=dev)
            for r in range(first, last):
                out[r - k * per, offset:offset + len(calls[r])].copy_(
                    sent[ends[r] - ends[first]:ends[r + 1] - ends[first]])
            rows.append(out)
        self._staging.guard(slot, events)
        return rows

    @staticmethod
    def _wait(launched):
        """(idx, row_chunks, numpy logprobs) of a launched batch, once its
        copies to the host are done."""
        idx, row_chunks, logprobs, events, batch = launched
        with profiling.span("offline.wait", batch):
            for event in events:
                event.synchronize()
        return idx, row_chunks, logprobs.numpy()

    def _finish(self, launched, results) -> None:
        """Split and decode a launched batch's logprobs."""
        idx, row_chunks, logprobs = self._wait(launched)
        batch = launched[-1]
        frames = self._model.unit_frames
        split = []
        with profiling.span("offline.split", batch):
            for row, i in enumerate(idx):
                phrases, _ = self._model.splitter.forward(logprobs[row, :row_chunks[row] * frames],
                                                    None, is_last=True)
                split.append((i, phrases))

        flat = [p for _, phrases in split for p in phrases]
        forward_batch = getattr(self.decoder, "forward_batch", None)
        with profiling.span("offline.decode", batch):
            if forward_batch is not None:
                # A device decoder: all phrases of the batch in one call.
                texts = forward_batch([np.ascontiguousarray(p.logprobs) for p in flat])
            else:
                texts = [self.decoder.forward(np.ascontiguousarray(p.logprobs)) for p in flat]

        word_spans = [None] * len(flat)
        if self.word_timestamps:
            # All phrases of the batch align in one device call per (T, S)
            # bucket: the batched twin of align.py.
            from tone_tpu_torch.ops.align_device import align_words_batch

            with profiling.span("offline.align", batch):
                word_spans = align_words_batch([p.logprobs for p in flat], texts,
                                               device=self.device)

        it = iter(zip(texts, word_spans))
        for i, phrases in split:
            results[i] = [self._to_text_phrase(p, *next(it)) for p in phrases]

    def _finish_tokens(self, launched, results) -> None:
        """A transducer's launched batch: each row's emitted tokens split
        into phrases at 20 or more frames with no token (cut at 2,000
        frames), each phrase's pieces joined."""
        idx, row_frames, record = self._wait(launched)
        batch = launched[-1]
        cfg = self.config
        with profiling.span("offline.split", batch):
            for row, i in enumerate(idx):
                tokens, frames = transducer.emitted(record[row], cfg.vocab_size_with_blank - 1)
                speech = np.zeros(row_frames[row], bool)
                speech[frames] = True
                phrases = []
                for start, end in self._model.splitter._phrase_spans(speech, is_last=True):
                    inside = tokens[(frames >= start) & (frames < end)]
                    phrases.append(TextPhrase(transducer.tokens_text(inside, cfg.vocabulary),
                                              *phrase_times(cfg, start, end)))
                results[i] = phrases

    def _finish_aed(self, launched, results) -> None:
        """An AED's launched batch of windows: each window's emitted tokens
        before ``eos``, its pieces joined (``transcribe`` times them)."""
        idx, windows, record = self._wait(launched)
        cfg = self.config
        aed.count_steps(cfg, record, windows.frames, windows.rows)
        with profiling.span("offline.split", launched[-1]):
            for row, i in enumerate(idx):
                results[i] = transducer.tokens_text(aed.emitted(record[row], cfg.aed.eos),
                                                    cfg.vocabulary)

    def forward_offline(self, audio: np.ndarray) -> list[TextPhrase]:
        """One utterance; duck-types ``StreamingCTCPipeline`` (so
        ``eval.evaluate_pipeline`` takes a transcriber)."""
        return self.transcribe([audio])[0]

    def _to_text_phrase(self, logprob_phrase, text: str, spans=None) -> TextPhrase:
        cfg = self.config
        start, end = phrase_times(cfg, logprob_phrase.start_frame, logprob_phrase.end_frame)
        words = None
        if spans and self.word_timestamps:
            from tone_tpu_torch.align import spans_to_word_timings

            bias = cfg.mean_time_bias + cfg.padding / cfg.frontend.sample_rate
            words = spans_to_word_timings(spans, logprob_phrase.start_frame,
                                          cfg.frame_size, bias)
        return TextPhrase(text=text, start_time=start, end_time=end, words=words)
