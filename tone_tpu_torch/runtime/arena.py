"""Device-resident multi-stream state arena + masked batched tick step
(port of ``tone_tpu/runtime/arena.py``).

A fixed pool of S stream slots whose recurrent state lives on the device as
one batched ``StreamingState``.  Every tick ONE streaming step advances all
S slots together; slots without a pending chunk keep their previous state
through a masked select, and freshly acquired slots are zeroed on the
device through a reset mask.  Only int16 audio chunks (in) and logprobs
(out) cross the host boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from tone_tpu_torch.acoustic import cast_params_for_inference
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


def _mask_on_axis(mask: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[axis] = mask.shape[0]
    return mask.reshape(shape)


class StreamArena:
    """Owns the batched streaming state for a fixed number of slots."""

    def __init__(self, variables, config: ToneConfig, n_slots: int,
                 device: str | torch.device | None = None) -> None:
        """Args:
            variables: model variables ``{"params", "batch_stats"}`` (torch).
            n_slots: number of concurrent stream slots (the batch of every tick).
            device: ``cuda`` unless the caller asks for the CPU.
        """
        self.config = config
        self.n_slots = n_slots
        self.device = resolve_device(device)
        self.variables = to_device(cast_params_for_inference(variables, config), self.device)
        self.state: StreamingState = init_streaming_state(config, n_slots, device=self.device)

    def tick(self, chunks: np.ndarray, active: np.ndarray,
             reset: np.ndarray) -> np.ndarray:
        """Advance all slots one 300 ms step.

        Args:
            chunks: (S, chunk_samples) int16/int32 (16-bit audio range);
                rows of inactive slots ignored.
            active: (S,) bool — slots that consume their chunk this tick.
            reset: (S,) bool — slots whose state is zeroed before the step
                (new streams; may also be active in the same tick).

        Returns:
            logprobs (S, chunk_frames, vocab+1) float32 (host numpy).
        """
        # Chunks cross the host boundary as int16 (half the bytes of the
        # int32 API dtype) and are widened on the device.
        chunks_dev = torch.from_numpy(np.asarray(chunks, np.int16)).to(self.device).to(torch.int32)
        active_dev = torch.from_numpy(np.asarray(active, bool)).to(self.device)
        reset_dev = torch.from_numpy(np.asarray(reset, bool)).to(self.device)
        old = self.state
        # Zero freshly acquired slots.  torch.where allocates, so the step
        # below (which updates its input in place) never touches ``old``.
        zeroed = old.map(lambda x, ax: torch.where(_mask_on_axis(reset_dev, x, ax),
                                                   torch.zeros((), dtype=x.dtype, device=x.device),
                                                   x))
        logprobs, new = apply_streaming(self.variables, self.config, chunks_dev, zeroed)
        # Slots without a pending chunk keep their previous state.
        self.state = new.map(
            lambda n, o, ax: torch.where(_mask_on_axis(active_dev, n, ax), n, o), old)
        return logprobs.cpu().numpy()

    def read_slot(self, slot: int) -> np.ndarray:
        """One slot's state as the reference-compatible flat fp16 blob
        ((STATE_SIZE,)) — the suspend half of stream migration.  Safe
        concurrently with a tick: a tick replaces ``self.state`` and never
        writes into the tensors it read."""
        row = self.state.map(lambda x, ax: x.narrow(ax, slot, 1))
        return pack_state(row, self.config)[0]

    def write_slot(self, slot: int, blob: np.ndarray) -> None:
        """Restore a ``read_slot`` blob (possibly from another arena, the JAX
        package, or the reference's own ONNX state) into a slot.  NOT safe
        concurrently with a tick (the tick's new state would overwrite the
        write): callers serialize against the step (MultiStreamEngine holds
        its device lock)."""
        row = unpack_state(np.asarray(blob, np.float16)[None], self.config,
                           device=self.device)
        self.state.map(lambda big, r, ax: big.narrow(ax, slot, 1).copy_(r), row)

    def warmup(self) -> None:
        """Run one tick with no active slot before serving traffic (on CUDA
        this builds and loads the kernels)."""
        zeros = np.zeros((self.n_slots, self.config.audio_chunk_samples), np.int16)
        none = np.zeros(self.n_slots, bool)
        self.tick(zeros, none, none)

