"""The acoustic-model runtime: the streaming step with state (port of
``tone_tpu/acoustic.py``).

Two call paths:

* ``forward_native(chunk, state)`` — the fast path: a fixed batch, the
  state stays on the device and is consumed (its buffers are updated in
  place, as the reference's donated buffers are).  The serving runtime and
  the pipeline use it.
* ``forward(audio_chunk, state)`` — the reference-compatible call: numpy in
  and out, the flat (B, 219729) fp16 state blob, the reference's input
  validation.  It never mutates the caller's arrays.

``from_local`` and ``from_hugging_face`` wait for the interop slice
(ROADMAP A14): build the model from ``bridge.from_jax_variables`` or
``core.model.init_model_params``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from tone_tpu_torch.bridge import to_device
from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.core.model import (
    StreamingState,
    apply_streaming,
    init_streaming_state,
    pack_state,
    unpack_state,
)
from tone_tpu_torch.device import resolve_device

if TYPE_CHECKING:
    import numpy.typing as npt


def cast_params_for_inference(variables, config: ToneConfig):
    """Prepare weights for serving: matrices (``"w"`` leaves with ndim >= 2)
    in the compute dtype, and each GLU feed-forward's in-projections
    ``lin1 ‖ linv`` merged into one (D, 2F) ``lin12``, which the fused
    ``glu_ff2`` consumes.  The float32 config returns the variables
    untouched (so it never reaches the bf16 kernel)."""
    dtype = getattr(torch, config.compute_dtype)
    if dtype == torch.float32:
        return variables

    def cast(tree):
        if isinstance(tree, dict):
            return {k: (v.to(dtype) if k == "w" and isinstance(v, torch.Tensor) and v.ndim >= 2
                        else cast(v)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cast(v) for v in tree)
        return tree

    variables = cast(variables)

    def merge_ff(ff):
        if "lin1" not in ff:
            return ff
        return {
            "lin12": {
                "w": torch.cat([ff["lin1"]["w"], ff["linv"]["w"]], dim=1),
                "b": torch.cat([ff["lin1"]["b"], ff["linv"]["b"]]),
            },
            "lin2": ff["lin2"],
        }

    params = dict(variables["params"])
    enc = dict(params["encoder"])
    enc["layers"] = tuple(
        {**layer, "ff1": merge_ff(layer["ff1"]), "ff2": merge_ff(layer["ff2"])}
        for layer in enc["layers"])
    params["encoder"] = enc
    return {**variables, "params": params}


class StreamingCTCModel:
    """Runs the streaming acoustic model; keeps no stream state itself."""

    SAMPLE_RATE = 8000
    MEAN_TIME_BIAS = 0.33  # seconds
    AUDIO_CHUNK_SAMPLES = 2400
    FRAME_SIZE = 0.03  # seconds
    STATE_SIZE = 219729

    def __init__(self, variables, config: ToneConfig | None = None,
                 device: str | torch.device | None = None) -> None:
        """``variables``: ``{"params", "batch_stats"}`` of torch tensors (from
        ``core.model.init_model_params`` or ``bridge.from_jax_variables``).
        ``device``: ``cuda`` unless the caller asks for the CPU."""
        self.config = config or ToneConfig()
        self.device = resolve_device(device)
        self.variables = to_device(cast_params_for_inference(variables, self.config),
                                   self.device)

    def init_state(self, batch_size: int) -> StreamingState:
        return init_streaming_state(self.config, batch_size, device=self.device)

    def forward_native(self, audio_chunk, state: StreamingState | None = None,
                       ) -> tuple[torch.Tensor, StreamingState]:
        """Device-resident streaming step.

        Args:
            audio_chunk: (B, 2400) integer or float audio (tensor or numpy).
            state: previous state, or None to start streams.  It is
                CONSUMED: its buffers may be updated in place, so use only
                the returned state afterwards.

        Returns:
            (logprobs (B, 10, 35) float32 on the device, next state).
        """
        chunk = torch.as_tensor(audio_chunk).to(self.device)
        if state is None:
            state = self.init_state(chunk.shape[0])
        return apply_streaming(self.variables, self.config, chunk, state)

    def forward(
        self,
        audio_chunk: "npt.NDArray[np.int32]",
        state: "npt.NDArray[np.float16] | None" = None,
    ) -> tuple["npt.NDArray[np.float32]", "npt.NDArray[np.float16]"]:
        """Strict reference-parity call: (B, 2400, 1) int32 in, flat fp16
        state blob in and out."""
        if not isinstance(audio_chunk, np.ndarray):
            raise TypeError(
                f"Incorrect 'audio_chunk' type: expected np.ndarray, but got {type(audio_chunk)}")
        if audio_chunk.shape[1:] != (self.AUDIO_CHUNK_SAMPLES, 1):
            raise ValueError(
                f"Shape of 'audio_chunk' must be (B, {self.AUDIO_CHUNK_SAMPLES}, 1), "
                f"but got {audio_chunk.shape}")
        if audio_chunk.dtype != np.int32:
            raise ValueError(
                f"Incorrect dtype of 'audio_chunk': expected np.int32, but got {audio_chunk.dtype}")
        if audio_chunk.min() < -32768 or audio_chunk.max() > 32767:
            raise ValueError(
                "Samples in 'audio_chunk' must be in range [-32768; 32767], "
                f"but it is in range [{audio_chunk.min()}; {audio_chunk.max()}]")
        batch_size = audio_chunk.shape[0]
        if state is None:
            state_tree = self.init_state(batch_size)
        else:
            if not isinstance(state, np.ndarray):
                raise TypeError(
                    f"Incorrect 'state' type: expected np.ndarray or None, but got {type(state)}")
            if state.shape != (batch_size, self.STATE_SIZE):
                raise ValueError(
                    f"Shape of 'state' must be ({batch_size}, {self.STATE_SIZE}), "
                    f"but got {state.shape}")
            if state.dtype != np.float16:
                raise ValueError(
                    f"Incorrect dtype of 'state': expected np.float16, but got {state.dtype}")
            state_tree = unpack_state(state, self.config, device=self.device)

        chunk = torch.tensor(audio_chunk[:, :, 0], device=self.device)
        logprobs, next_state = self.forward_native(chunk, state_tree)
        return logprobs.cpu().numpy(), pack_state(next_state, self.config)
