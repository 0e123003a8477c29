"""Device selection and the float32 numerics policy of the port.

Every entry point of the port (``StreamingCTCModel``, ``StreamArena``,
``MultiStreamEngine``, ``bridge.from_jax_variables``, the CLI) resolves its
device here: ``cuda`` unless the caller asks for the CPU, and an error —
never a quiet fall back to the CPU — when no GPU is present.

TF32: the reference computes its float32 matmuls (the frontend STFT and
mel products, the float32 CTC head, the ``compute_dtype="float32"``
model) and its float32 convolutions in full float32.  On the card PyTorch
runs float32 matmuls in full float32 by default but float32 convolutions in
TF32 (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits.  ``resolve_device`` therefore sets both flags to False for
the process when it hands out a CUDA device.  The bf16 path is unaffected:
on the card its inference products and convolutions run on the bf16
operands with float32 accumulators, and elsewhere it widens them to float32
first (core/layers.py); either way products of bf16 values are summed in
float32, as the reference's ``preferred_element_type=float32`` matmuls are.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a GPU raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tone_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def record_event(device: torch.device) -> list:
    """An event recorded on ``device``'s current stream, in a list (empty
    off a card, whose copies have finished when they return)."""
    if device.type != "cuda":
        return []
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return [event]
