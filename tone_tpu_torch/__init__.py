"""tone_tpu_torch — the PyTorch/CUDA port of tone_tpu.

A second package beside ``tone_tpu`` (the JAX reference it is tested
against).  Module names mirror ``tone_tpu``'s, so each module's counterpart
is found under the same path.  The port imports ``torch`` and numpy only,
never ``jax`` and nothing of ``tone_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of quietly running on the CPU.  The
Hopper kernels of the port live in ``csrc/`` and are built at first use
(``ops/_build.py``).

Importing this package is cheap: the public names load lazily.
"""

from __future__ import annotations

__all__ = [
    "DecoderType",
    "GreedyCTCDecoder",
    "MultiStreamEngine",
    "OfflineTranscriber",
    "StreamingCTCModel",
    "StreamingCTCPipeline",
    "TextPhrase",
    "ToneConfig",
    "read_audio",
    "read_example_audio",
    "read_stream_audio",
    "read_stream_example_audio",
    "word_error_rate",
]

_LAZY = {
    "DecoderType": ("tone_tpu_torch.decoder", "DecoderType"),
    "GreedyCTCDecoder": ("tone_tpu_torch.decoder", "GreedyCTCDecoder"),
    "MultiStreamEngine": ("tone_tpu_torch.runtime.engine", "MultiStreamEngine"),
    "OfflineTranscriber": ("tone_tpu_torch.offline", "OfflineTranscriber"),
    "StreamingCTCModel": ("tone_tpu_torch.acoustic", "StreamingCTCModel"),
    "StreamingCTCPipeline": ("tone_tpu_torch.pipeline", "StreamingCTCPipeline"),
    "TextPhrase": ("tone_tpu_torch.pipeline", "TextPhrase"),
    "ToneConfig": ("tone_tpu_torch.config", "ToneConfig"),
    "read_audio": ("tone_tpu_torch.audio", "read_audio"),
    "read_example_audio": ("tone_tpu_torch.audio", "read_example_audio"),
    "read_stream_audio": ("tone_tpu_torch.audio", "read_stream_audio"),
    "read_stream_example_audio": ("tone_tpu_torch.audio", "read_stream_example_audio"),
    "word_error_rate": ("tone_tpu_torch.training.wer", "word_error_rate"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'tone_tpu_torch' has no attribute {name!r}")
