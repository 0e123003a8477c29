"""Batch assembly for CTC fine-tuning (port of
``tone_tpu/training/collator.py``; numpy only).

Pads raw audio and tokenized labels separately, marks label padding with
-100, and pads shapes up to multiples (one 300 ms chunk of audio, 16
labels by default) so that batches come in a few fixed shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tone_tpu_torch.config import LABELS
from tone_tpu_torch.training.wer import normalize_text

_CHAR_TO_ID = {c: i for i, c in enumerate(LABELS)}


def tokenize_text(text: str) -> list[int]:
    """Text -> label ids (characters not in the vocabulary are dropped)."""
    return [_CHAR_TO_ID[c] for c in normalize_text(text) if c in _CHAR_TO_ID]


@dataclass
class DataCollatorCTCWithPadding:
    """Pads ``{"input_values", "labels"}`` features into fixed-shape batches.

    Attributes:
        pad_audio_to_multiple_of: round the padded audio length up to this
            multiple (default: one 300 ms chunk, so offline training shapes
            align with streaming chunk boundaries).
        pad_labels_to_multiple_of: round the padded label length up.
        max_length / max_length_labels: optional hard caps (truncate).
    """

    pad_audio_to_multiple_of: int = 2400
    pad_labels_to_multiple_of: int = 16
    max_length: int | None = None
    max_length_labels: int | None = None

    def __call__(self, features: list[dict]) -> dict[str, np.ndarray]:
        audios = []
        labels = []
        for f in features:
            a = np.asarray(f["input_values"])
            lab = f["labels"]
            if isinstance(lab, str):
                lab = tokenize_text(lab)
            lab = np.asarray(lab, np.int32)
            if self.max_length is not None:
                a = a[: self.max_length]
            if self.max_length_labels is not None:
                lab = lab[: self.max_length_labels]
            audios.append(a)
            labels.append(lab)

        def round_up(n: int, m: int) -> int:
            return -(-n // m) * m

        t_audio = round_up(max(len(a) for a in audios), self.pad_audio_to_multiple_of)
        t_label = round_up(max(max(len(lab) for lab in labels), 1),
                           self.pad_labels_to_multiple_of)

        batch_audio = np.zeros((len(audios), t_audio), np.float32)
        batch_labels = np.full((len(labels), t_label), -100, np.int32)
        input_lengths = np.zeros(len(audios), np.int32)
        for i, (a, lab) in enumerate(zip(audios, labels)):
            batch_audio[i, : len(a)] = a
            batch_labels[i, : len(lab)] = lab
            input_lengths[i] = len(a)

        return {
            "input_values": batch_audio,
            "input_lengths": input_lengths,
            "labels": batch_labels,
        }
