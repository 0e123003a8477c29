"""CTC decoders of the port: greedy only (port of ``tone_tpu/decoder.py:34-65``).

Beam search — host and device, with LMs and hotwords — waits for its slices
(ROADMAP A10 device decoders, A11 host decoding); asking for it raises
``NotImplementedError``.
"""

from __future__ import annotations

from enum import Enum
from itertools import groupby
from typing import TYPE_CHECKING

import numpy as np

from tone_tpu_torch.config import LABELS

if TYPE_CHECKING:
    import numpy.typing as npt

__all__ = ["LABELS", "DecoderType", "GreedyCTCDecoder", "build_decoder"]


class DecoderType(Enum):
    """Supported decoding strategies for CTC output."""

    GREEDY = "greedy"
    BEAM_SEARCH = "beam_search"


def _validate_logprobs(logprobs) -> None:
    if not isinstance(logprobs, np.ndarray):
        raise TypeError(
            f"Incorrect 'logprobs' type: expected np.ndarray, but got {type(logprobs)}")
    if logprobs.shape[1:] != (len(LABELS) + 1,):
        raise ValueError(
            f"Shape of 'logprobs' must be (L, {len(LABELS) + 1}), but got {logprobs.shape}")
    if logprobs.dtype != np.float32:
        raise ValueError(
            f"Incorrect dtype of 'logprobs': expected np.float32, but got {logprobs.dtype}")


class GreedyCTCDecoder:
    """Greedy CTC decoding: argmax, collapse repeats, drop blanks."""

    def forward(self, logprobs: "npt.NDArray[np.float32]") -> str:
        """Decode (L, vocab+1) logprobs to text."""
        _validate_logprobs(logprobs)
        tokens = logprobs.argmax(axis=-1)
        collapsed = (token for token, _ in groupby(tokens.tolist()))
        return "".join(LABELS[t] for t in collapsed if t < len(LABELS)).strip()


def build_decoder(kind: "str | DecoderType" = DecoderType.GREEDY) -> GreedyCTCDecoder:
    """The decoder for ``kind``; only greedy is ported so far."""
    if kind in (DecoderType.GREEDY, "greedy"):
        return GreedyCTCDecoder()
    if kind in (DecoderType.BEAM_SEARCH, "beam", "beam_search", "device-beam"):
        raise NotImplementedError(
            "beam-search decoding is not ported yet (ROADMAP queue A11 host "
            "decoding, A10 device decoders)")
    raise ValueError(f"unknown decoder type {kind!r}")
