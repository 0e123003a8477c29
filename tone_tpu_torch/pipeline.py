"""The streaming ASR pipeline: acoustic model -> splitter -> decoder (port of
``tone_tpu/pipeline.py:32-233``): greedy or device-beam decoding, optional
word timestamps and n-best alternatives.

The ±300 ms "magic padding" and the timestamp math (frame_size 0.03 s,
mean time bias 0.33 s, padding correction) are the reference's.  The
pipeline state is ``(model_state, splitter_state)`` with the model state
kept on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from tone_tpu_torch.acoustic import StreamingCTCModel
from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.decoder import GreedyCTCDecoder
from tone_tpu_torch.splitter import StreamingLogprobSplitter

if TYPE_CHECKING:
    import numpy.typing as npt


@dataclass
class TextPhrase:
    """A decoded phrase with timestamps (seconds).

    ``words`` (None unless word timestamps were asked for: the pipeline's
    ``word_timestamps=True`` or the engine's) carries per-word times and
    confidences from CTC forced alignment (``align.py``).

    ``nbest`` (None unless n-best was asked for: the pipeline's ``nbest=``
    or the engine's per-stream ``set_stream_nbest``) carries up to N
    alternative ``(text, score)`` transcripts, best first;
    ``nbest[0][0] == text``."""

    text: str
    start_time: float
    end_time: float
    words: "tuple | None" = None
    nbest: "tuple | None" = None


def phrase_times(config: ToneConfig, start_frame: int,
                 end_frame: int) -> tuple[float, float]:
    """(start, end) seconds of a phrase's frame span: frames of 30 ms, less
    the mean time bias and the leading padding, rounded to 10 ms."""
    bias = config.mean_time_bias + config.padding / config.frontend.sample_rate
    start = max(0.0, round(start_frame * config.frame_size - bias, 2))
    end = max(start, round(end_frame * config.frame_size - bias, 2))
    return start, end


def word_timings(config: ToneConfig, logprob_phrase, text: str):
    """Per-word times and confidences of ``text`` in a phrase (CTC forced
    alignment), or None for an empty text."""
    if not text:
        return None
    from tone_tpu_torch.align import align_words, spans_to_word_timings

    bias = config.mean_time_bias + config.padding / config.frontend.sample_rate
    return spans_to_word_timings(align_words(logprob_phrase.logprobs, text),
                                 logprob_phrase.start_frame, config.frame_size, bias)


class StreamingCTCPipeline:
    """Streaming CTC speech recognition over 300 ms chunks."""

    PADDING: int = 2400  # 300 ms * 8 kHz
    CHUNK_SIZE: int = StreamingCTCModel.AUDIO_CHUNK_SAMPLES

    def __init__(self, model: StreamingCTCModel,
                 logprob_splitter: StreamingLogprobSplitter | None = None,
                 decoder=None, *, word_timestamps: bool = False,
                 nbest: int = 0) -> None:
        """``decoder``: a ``GreedyCTCDecoder`` (the default) or a
        ``DeviceBeamSearchCTCDecoder``.  ``word_timestamps``: phrases carry
        per-word times.  ``nbest``: 0 (top-1 only) or N >= 2 alternatives,
        which needs a beam decoder."""
        if nbest == 1:
            raise ValueError(
                "nbest=1 is ambiguous (phrases always carry the top "
                "hypothesis as .text): use 0 for no alternatives or N >= 2")
        decoder = decoder or GreedyCTCDecoder()
        if nbest > 1 and not hasattr(decoder, "nbest"):
            raise ValueError(
                "nbest > 1 needs a beam decoder (greedy has no alternatives)")
        self.nbest = int(nbest) if nbest > 1 else 0
        self.word_timestamps = word_timestamps
        self.model = model
        self.logprob_splitter = logprob_splitter or StreamingLogprobSplitter()
        self.decoder = decoder
        # Instance-level chunk/padding follow the model config.
        self.CHUNK_SIZE = model.config.audio_chunk_samples
        self.PADDING = model.config.padding

    def forward(self, audio_chunk: "npt.NDArray[np.int32]", state=None, *,
                is_last: bool = False) -> tuple[list[TextPhrase], tuple]:
        """Process one 300 ms chunk; return finalized phrases + next state."""
        if not isinstance(audio_chunk, np.ndarray):
            raise TypeError(
                f"Incorrect 'audio_chunk' type: expected np.ndarray, but got {type(audio_chunk)}")
        if audio_chunk.shape != (self.CHUNK_SIZE,):
            raise ValueError(
                f"Shape of 'audio_chunk' must be ({self.CHUNK_SIZE},), but got {audio_chunk.shape}")
        if not isinstance(state, (tuple, type(None))):
            raise TypeError(
                f"Incorrect 'state' type: expected tuple or None, but got {type(state)}")

        model_state = state[0] if state is not None else None
        splitter_state = state[1] if state is not None else None

        logprobs_dev, model_state_next = self.model.forward_native(
            audio_chunk[None, :].astype(np.int32), model_state)
        logprobs = logprobs_dev[0].cpu().numpy().astype(np.float32, copy=False)

        logprob_phrases, splitter_state_next = self.logprob_splitter.forward(
            logprobs, splitter_state, is_last=is_last)
        phrases = [self._decode_phrase(p) for p in logprob_phrases]
        return phrases, (model_state_next, splitter_state_next)

    def _decode_phrase(self, logprob_phrase) -> TextPhrase:
        logprobs = np.ascontiguousarray(logprob_phrase.logprobs)
        alternatives = None
        if self.nbest:
            ranked = self.decoder.nbest(logprobs, self.nbest)
            text = ranked[0][0] if ranked else ""
            alternatives = tuple(ranked)
        else:
            text = self.decoder.forward(logprobs)
        config = self.model.config
        start, end = phrase_times(config, logprob_phrase.start_frame,
                                  logprob_phrase.end_frame)
        words = word_timings(config, logprob_phrase, text) if self.word_timestamps else None
        return TextPhrase(text=text, start_time=start, end_time=end, words=words,
                          nbest=alternatives)

    def forward_offline(self, audio: "npt.NDArray[np.int32]") -> list[TextPhrase]:
        """Recognize a complete utterance as looped streaming."""
        if not isinstance(audio, np.ndarray):
            raise TypeError(
                f"Incorrect 'audio' type: expected np.ndarray, but got {type(audio)}")
        if audio.ndim != 1:
            raise ValueError(f"Shape of 'audio' must be (L,), but got {audio.shape}")

        audio = np.pad(audio, (self.PADDING, self.PADDING))
        audio = np.pad(audio, (0, -len(audio) % self.CHUNK_SIZE))
        chunks = np.split(audio, len(audio) // self.CHUNK_SIZE)

        outputs: list[TextPhrase] = []
        state = None
        for i, chunk in enumerate(chunks):
            out, state = self.forward(chunk, state, is_last=i == len(chunks) - 1)
            outputs.extend(out)
        return outputs

    def finalize(self, state) -> tuple[list[TextPhrase], tuple]:
        """Flush the stream: one zero chunk with ``is_last=True``."""
        zero = np.zeros((self.CHUNK_SIZE,), dtype=np.int32)
        return self.forward(zero, state, is_last=True)
