"""Audio decode / streaming utilities (a copy of ``tone_tpu/audio/``: the
FLAC reader and writer, WAV reading, resampling, and the example audio,
synthesized on first use into this package's ``audio/examples/``)."""

from tone_tpu_torch.audio.io import (
    read_audio,
    read_example_audio,
    read_stream_audio,
    read_stream_example_audio,
)

__all__ = [
    "read_audio",
    "read_example_audio",
    "read_stream_audio",
    "read_stream_example_audio",
]
