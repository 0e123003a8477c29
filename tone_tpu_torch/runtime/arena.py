"""Device-resident multi-stream state arena + masked batched tick step
(port of ``tone_tpu/runtime/arena.py``).

A fixed pool of S stream slots whose recurrent state lives on the device as
one batched ``StreamingState``.  Every tick ONE streaming step advances all
S slots together; slots without a pending chunk keep their previous state
through a masked select, and freshly acquired slots are zeroed on the
device through a reset mask.  Only int16 audio chunks (in) and logprobs
(out) cross the host boundary.

With ``sharding`` (``parallel.mesh.arena_shardings``) the slots are split
evenly over the mesh's data devices: each device holds a replica of the
inference weights (one per distinct device) and the state of its slots.
A tick copies every device's chunks first, then queues each device's step
in turn, so that the devices overlap, and gathers the logprobs in slot
order; ``read_slot``/``write_slot`` go to the slot's device.

Traced (``profiling``), a tick records the spans ``arena.upload`` (the
chunks and masks to the devices), ``arena.dispatch`` (the steps queued)
and ``arena.readback`` (the logprobs to the host, which waits for the
devices).
"""

from __future__ import annotations

import numpy as np
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.acoustic import cast_params_for_inference
from tone_tpu_torch.config import ToneConfig, require_streaming
from tone_tpu_torch.core.model import (
    StreamingState,
    apply_streaming,
    init_streaming_state,
    pack_state,
    unpack_state,
)
from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.parallel.mesh import DATA_AXIS, replicate


def _mask_on_axis(mask: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[axis] = mask.shape[0]
    return mask.reshape(shape)


class StreamArena:
    """Owns the batched streaming state for a fixed number of slots."""

    def __init__(self, variables, config: ToneConfig, n_slots: int,
                 device: str | torch.device | None = None, sharding=None) -> None:
        """Args:
            variables: model variables ``{"params", "batch_stats"}`` (torch).
            n_slots: number of concurrent stream slots (the batch of every tick).
            device: ``cuda`` unless the caller asks for the CPU.
            sharding: instead of ``device``, a ``StreamingState`` of
                ``parallel.mesh.Sharding`` (``arena_shardings``): the slots
                split over the mesh's data devices.  ``device`` is then the
                first of them.
        """
        require_streaming(config, "StreamArena")
        self.config = config
        self.n_slots = n_slots
        if sharding is None:
            devices = [resolve_device(device)]
        else:
            if device is not None:
                raise ValueError("StreamArena: give a device or a sharding, not both")
            devices = [resolve_device(d) for d in _slot_devices(sharding, n_slots)]
        self.device = devices[0]
        self.slots_per_device = n_slots // len(devices)
        self._devices = devices
        self._replicas = replicate(cast_params_for_inference(variables, config), devices)
        self.variables = self._replicas[0]
        self._states: list[StreamingState] = [
            init_streaming_state(config, self.slots_per_device, device=dev) for dev in devices]

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
        with profiling.span("arena.upload"):
            host = (torch.from_numpy(np.asarray(chunks, np.int16)),
                    torch.from_numpy(np.asarray(active, bool)),
                    torch.from_numpy(np.asarray(reset, bool)))
            per = self.slots_per_device
            inputs = [[t[k * per:(k + 1) * per].to(dev) for t in host]
                      for k, dev in enumerate(self._devices)]
        with profiling.span("arena.dispatch"):
            logprobs = [self._step(k, *args) for k, args in enumerate(inputs)]
        with profiling.span("arena.readback"):
            return np.concatenate([lp.cpu().numpy() for lp in logprobs])

    def _step(self, k: int, chunks_dev: torch.Tensor, active_dev: torch.Tensor,
              reset_dev: torch.Tensor) -> torch.Tensor:
        """One step of device ``k``'s slots; returns its logprobs (on it)."""
        old = self._states[k]
        # Zero freshly acquired slots.  torch.where allocates, so the step
        # below (which updates its input in place) never touches ``old``.
        zeroed = old.map(lambda x, ax: torch.where(_mask_on_axis(reset_dev, x, ax),
                                                   torch.zeros((), dtype=x.dtype, device=x.device),
                                                   x))
        logprobs, new = apply_streaming(self._replicas[k], self.config,
                                        chunks_dev.to(torch.int32), zeroed)
        # Slots without a pending chunk keep their previous state.
        self._states[k] = new.map(
            lambda n, o, ax: torch.where(_mask_on_axis(active_dev, n, ax), n, o), old)
        return logprobs

    def read_slot(self, slot: int) -> np.ndarray:
        """One slot's state as the reference-compatible flat fp16 blob
        ((STATE_SIZE,)) — the suspend half of stream migration.  Safe
        concurrently with a tick: a tick replaces the state and never
        writes into the tensors it read."""
        k, row = divmod(slot, self.slots_per_device)
        state = self._states[k].map(lambda x, ax: x.narrow(ax, row, 1))
        return pack_state(state, self.config)[0]

    def write_slot(self, slot: int, blob: np.ndarray) -> None:
        """Restore a ``read_slot`` blob (possibly from another arena, the JAX
        package, or the reference's own ONNX state) into a slot.  NOT safe
        concurrently with a tick (the tick's new state would overwrite the
        write): callers serialize against the step (MultiStreamEngine holds
        its device lock)."""
        k, row = divmod(slot, self.slots_per_device)
        state = unpack_state(np.asarray(blob, np.float16)[None], self.config,
                             device=self._devices[k])
        self._states[k].map(lambda big, r, ax: big.narrow(ax, row, 1).copy_(r), state)

    def warmup(self) -> None:
        """Run one tick with no active slot before serving traffic (on CUDA
        this builds and loads the kernels); it steps every device."""
        zeros = np.zeros((self.n_slots, self.config.audio_chunk_samples), np.int16)
        none = np.zeros(self.n_slots, bool)
        self.tick(zeros, none, none)


def _slot_devices(sharding, n_slots: int) -> list[torch.device]:
    """The data devices of an arena's state shardings, checked: every leaf
    split over ``data`` along its slot axis, the slots evenly."""
    meshes = []

    def check(s, axis):
        if s.axis_of(DATA_AXIS) != axis:
            raise ValueError(f"stream state sharding {s.spec} does not split slot axis {axis} "
                             f"over '{DATA_AXIS}' (parallel.mesh.arena_shardings)")
        meshes.append(s.mesh)

    sharding.map(check)
    if any(m != meshes[0] for m in meshes):
        raise ValueError("stream state shardings on more than one mesh")
    devices = meshes[0].data_devices()
    if n_slots % len(devices):
        raise ValueError(f"n_slots ({n_slots}) must be a multiple of the mesh "
                         f"'{DATA_AXIS}' axis size ({len(devices)})")
    return devices
