"""Batched offline transcription: bulk throughput for batch jobs and corpus
evaluation (port of ``tone_tpu/offline.py``).

Whole utterances go through the acoustic model in batches, then each is
split into phrases and decoded.  Two forwards give the same function:

* the chunk scan (the default): ``core.model.apply_streaming`` over the
  300 ms chunk columns of the batch, from a zero state;
* ``use_offline_forward=True``: ``core.model.apply_offline``, the
  full-sequence forward whose chunk-simulating masks reproduce the scan.

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

Traced (``profiling``), each batch records the spans ``offline.assemble``
(pad, bucket, pin, queue the copy to the device), ``offline.forward`` (the
forward's dispatch and the copies back), ``offline.wait``,
``offline.split``, ``offline.decode`` and ``offline.align``, with the
batch's index in the call as their id, and the counts
``offline.audio_samples`` (the rows' own samples) and
``offline.padded_samples`` (the samples the forward computes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.acoustic import cast_params_for_inference
from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.core.model import apply_offline, apply_streaming, init_streaming_state
from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, replicate
from tone_tpu_torch.pipeline import TextPhrase, phrase_times
from tone_tpu_torch.splitter import StreamingLogprobSplitter

__all__ = ["OfflineTranscriber"]


@dataclass
class OfflineTranscriber:
    """Batched utterance transcription on one device, or on the data devices
    of a mesh."""

    variables: dict
    config: ToneConfig
    decoder: object = None  # GreedyCTCDecoder-compatible; default greedy
    batch_size: int = 16
    bucket_samples: int = 8 * 2400  # pad lengths up to multiples of this
    use_offline_forward: bool = False  # full-sequence forward instead of the scan
    mesh: Mesh | None = None  # split batch rows over the mesh's data devices
    word_timestamps: bool = False  # per-word times + confidences on phrases
    device: str | torch.device | None = None  # cuda unless the caller asks for the CPU

    def __post_init__(self):
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
        if self.decoder is None:
            from tone_tpu_torch.decoder import GreedyCTCDecoder

            self.decoder = GreedyCTCDecoder()
        self._shards = list(zip(devices, replicate(
            cast_params_for_inference(self.variables, self.config), devices)))
        self.variables = self._shards[0][1]
        self._splitter = StreamingLogprobSplitter()

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

    def transcribe(self, audios: Sequence[np.ndarray]) -> list[list[TextPhrase]]:
        """Transcribe utterances (int16-range integer arrays); order kept."""
        results: list[list[TextPhrase] | None] = [None] * len(audios)
        self._pipelined(audios, lambda launched: self._finish(launched, results))
        return results  # type: ignore[return-value]

    def logprobs(self, audios: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Per-utterance (frames, vocab+1) float32 logprobs, batched and
        bucketed as in ``transcribe`` but not split or decoded: the acoustic
        half of forced alignment (``python -m tone_tpu_torch align``)."""
        out: list[np.ndarray | None] = [None] * len(audios)

        def finish(launched):
            idx, row_chunks, logprobs = self._wait(launched)
            for row, i in enumerate(idx):
                out[i] = logprobs[row, :row_chunks[row] * self.config.encoder.chunk_size]

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
            row_chunks, chunks = self._assemble(idx, audios)
        with profiling.span("offline.forward", batch):
            forward = self._offline_forward if self.use_offline_forward else self._chunk_scan
            logprobs = [forward(variables, c) for (_, variables), c in zip(self._shards, chunks)]
            if self.device.type != "cuda":
                return idx, row_chunks, torch.cat(logprobs), [], batch
            per = chunks[0].shape[0]
            host = torch.empty((per * len(chunks), *logprobs[0].shape[1:]), dtype=torch.float32,
                               pin_memory=True)
            events = []
            for k, lp in enumerate(logprobs):
                host[k * per:(k + 1) * per].copy_(lp, non_blocking=True)
                events.append(torch.cuda.Event())
                events[-1].record(torch.cuda.current_stream(lp.device))
        return idx, row_chunks, host, events, batch

    def _assemble(self, idx, audios) -> tuple[list[int], list[torch.Tensor]]:
        """(row_chunks, each device's rows of the padded chunks, queued to it)."""
        cfg = self.config
        pad = cfg.padding
        chunk = cfg.audio_chunk_samples
        bucket_chunks = max(self.bucket_samples // chunk, 1)
        batch_audios = [np.pad(np.asarray(audios[i], np.int32), (pad, pad)) for i in idx]
        # rows padded to a shared, bucketed chunk count
        row_chunks = [-(-len(a) // chunk) for a in batch_audios]
        n_chunks = -(-max(row_chunks) // bucket_chunks) * bucket_chunks
        # Zero rows pad the batch to an even split over the devices (dropped
        # after the forward).
        n_rows = -(-len(idx) // len(self._shards)) * len(self._shards)
        per = n_rows // len(self._shards)
        audio_arr = np.zeros((n_rows, n_chunks * chunk), np.int32)
        for row, a in enumerate(batch_audios):
            audio_arr[row, :len(a)] = a
        chunks = torch.from_numpy(audio_arr.reshape(n_rows, n_chunks, chunk))
        if self.device.type == "cuda":
            chunks = chunks.pin_memory()
        if profiling.recording():
            profiling.count("offline.audio_samples", sum(len(audios[i]) for i in idx))
            profiling.count("offline.padded_samples", audio_arr.size)
        return row_chunks, [chunks[k * per:(k + 1) * per].to(dev, non_blocking=True)
                            for k, (dev, _) in enumerate(self._shards)]

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
        frames = self.config.encoder.chunk_size
        split = []
        with profiling.span("offline.split", batch):
            for row, i in enumerate(idx):
                phrases, _ = self._splitter.forward(logprobs[row, :row_chunks[row] * frames],
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
