"""Layer training (training/train.py): per cent of the card's bf16 peak,
three times the forward's model operations of the unpadded audio trained
in the traced window over the window."""

from harness.readers import audio_mfu


def read(r):
    return audio_mfu(r, 3.0)
