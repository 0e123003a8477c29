"""Layer offline forward (offline.py, core/model.py apply_offline): per
cent of the card's bf16 peak, the model operations of the unpadded audio
transcribed in the traced window (the streaming step's per frame) over
the window."""

from harness.readers import audio_mfu


def read(r):
    return audio_mfu(r, 1.0)
