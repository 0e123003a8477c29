"""Device meshes and sharding rules (port of ``tone_tpu/parallel/mesh.py``).

The JAX package drives a ``('data', 'model')`` mesh from one process and
lets XLA's partitioner insert the collectives.  PyTorch has no
partitioner, so the port gives each use its own mechanism:

* bulk transcription and serving shard over ``data`` only (as the JAX
  package's CLI does, ``n_model=1``): one process holds a replica of the
  inference weights on every data device, splits the rows (bulk) or slots
  (serving) over them, queues each device's step in turn, so that the
  devices overlap, and gathers the results on the host.  No collective is
  needed.  A ``Mesh`` here is the grid of those devices; it may name one
  device more than once (``[cpu, cpu]``, ``[cuda:0, cuda:0]``), the port's
  stand-in for the JAX package's virtual CPU devices, so nothing assumes
  the devices are distinct.
* training runs one process per mesh position over ``torch.distributed``
  (``collectives.ProcessMesh``): the Megatron splits below, the global
  BatchNorm statistics and the gradient average are collectives inside the
  step.

``param_spec`` is the JAX package's rule of which parameter splits on which
axis; a spec is a tuple with one entry per leading dimension of the leaf,
an axis name or None (JAX's ``PartitionSpec``).  The serving weights'
packed GLU in-projection ``lin12`` (``acoustic.cast_params_for_inference``,
the input of kernel B1) stays replicated: serving and bulk meshes have no
``model`` axis, and a column split of ``lin12`` would have to split its
``lin1`` and ``linv`` halves apart.  Tensor parallelism exists only in
training, which keeps ``lin1`` and ``linv`` separate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from tone_tpu_torch.bridge import to_device, tree_map
from tone_tpu_torch.config import ToneConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of devices driven by one process."""

    devices: tuple[tuple[torch.device, ...], ...]  # [data][model]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    def data_devices(self) -> list[torch.device]:
        """The device of each data position; raises unless the mesh has no
        ``model`` axis (bulk and serving split over ``data`` only)."""
        if self.shape[MODEL_AXIS] != 1:
            raise ValueError(
                f"bulk transcription and serving shard over '{DATA_AXIS}' only: the mesh "
                f"has '{MODEL_AXIS}' = {self.shape[MODEL_AXIS]} (tensor parallelism is "
                "for training, collectives.ProcessMesh)")
        return [row[0] for row in self.devices]


def replicate(tree, devices: list[torch.device]) -> list:
    """``tree`` on each of ``devices``: one copy per distinct device, shared
    by the positions that name it."""
    copies = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = to_device(tree, dev)
    return [copies[dev] for dev in devices]


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (default: every CUDA device),
    row-major: data position ``d`` holds ``devices[d * n_model:(d + 1) *
    n_model]``.  ``n_data`` defaults to as many rows as the devices fill."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] "
                               "(e.g. [torch.device('cpu')] * 2) to mesh the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} devices, "
                         f"{len(devices)} given")
    return Mesh(tuple(tuple(devices[d * n_model:(d + 1) * n_model]) for d in range(n_data)))


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: ``spec[i]`` names the mesh axis that
    dimension ``i`` is split over, or None (JAX's ``NamedSharding``)."""

    mesh: Any  # Mesh, or collectives.ProcessMesh in training
    spec: tuple = ()

    def axis_of(self, name: str) -> int | None:
        """The dimension split over mesh axis ``name``, or None."""
        return self.spec.index(name) if name in self.spec else None


def batch_sharding(mesh) -> Sharding:
    """The leading (batch / stream-slot) dimension split over ``data``."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


# ---------------------------------------------------------------------------
# Parameter partition specs (tensor parallelism over the 'model' axis).
# ---------------------------------------------------------------------------
#
# Megatron-style column/row split of each Conformer layer:
#   * FF lin1/linv: (d_model, d_ff)  -> split d_ff      (column)
#   * FF lin2:      (d_ff, d_model)  -> split d_ff      (row; sum after)
#   * attention q/k/v: (d, d)        -> split heads dim (column)
#   * attention out:   (d, d)        -> split input dim (row; sum after)
# The conv module's pointwise convs stay replicated: its GLU pairs channel
# i with channel i + d, which a plain column split would separate.  Norms,
# depthwise convs, subsampling and head are replicated too (a small share
# of the operations and parameters).


def param_spec(path: tuple, leaf) -> tuple:
    """The partition spec of the parameter at ``path`` (its keys from the
    root of ``params``)."""
    keys = list(path)
    spec: tuple = ()
    if "ff1" in keys or "ff2" in keys:
        if "lin1" in keys or "linv" in keys:
            spec = (None, MODEL_AXIS) if keys[-1] == "w" else (MODEL_AXIS,)
        elif "lin2" in keys:
            spec = (MODEL_AXIS, None) if keys[-1] == "w" else ()
    elif "att" in keys:
        if any(k in keys for k in ("linear_q", "linear_k", "linear_v")):
            spec = (None, MODEL_AXIS) if keys[-1] == "w" else (MODEL_AXIS,)
        elif "linear_out" in keys:
            spec = (MODEL_AXIS, None) if keys[-1] == "w" else ()
    if len(spec) > getattr(leaf, "ndim", 0):
        spec = ()
    return spec


def _with_paths(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _with_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _with_paths(v, path + (i,))]
    return [(path, tree)]


def param_specs(params: Any) -> list[tuple]:
    """``param_spec`` of every leaf of ``params``, in leaf order."""
    return [param_spec(path, leaf) for path, leaf in _with_paths(params)]


def param_shardings(mesh, params: Any) -> Any:
    """The ``Sharding`` of every parameter (tensor parallelism over
    ``model``), as a tree shaped like ``params``.

    Raises if the mesh has a ``model`` axis but the name rules split less
    than a quarter of the parameter bytes, e.g. after a parameter-tree
    rename, instead of quietly replicating every weight.
    """
    flat = _with_paths(params)
    specs = param_specs(params)
    if mesh.shape.get(MODEL_AXIS, 1) > 1:
        total = sum(getattr(leaf, "numel", lambda: 0)() for _, leaf in flat)
        sharded = sum(leaf.numel() for (_, leaf), spec in zip(flat, specs)
                      if MODEL_AXIS in spec)
        if total and sharded / total < 0.25:
            raise ValueError(
                f"tensor-parallel mesh (model={mesh.shape[MODEL_AXIS]}) but "
                f"only {sharded / total:.1%} of parameter bytes matched the "
                "TP sharding rules — the parameter tree no longer matches "
                "param_spec's naming (ff1/ff2 lin1/linv/lin2, att "
                "linear_q/k/v/out)")
    shardings = iter([Sharding(mesh, spec) for spec in specs])
    return tree_map(lambda _: next(shardings), params)


def stream_state_shardings(mesh, state) -> Any:
    """The ``Sharding`` of every tensor of a ``StreamingState``: its
    stream-slot axis (axis 1 of the stacked per-layer ``mhsa``/``conv``
    caches, else 0, as ``StreamingState.map`` gives it) split over ``data``.
    A ``StreamingState`` of ``Sharding`` leaves."""
    return state.map(lambda x, axis: Sharding(mesh, (None,) * axis + (DATA_AXIS,)))


def arena_shardings(mesh, config: ToneConfig, n_slots: int) -> Any:
    """Stream-state shardings of an ``n_slots`` serving arena, from a state
    on the ``meta`` device (no arena-sized allocation just to read its
    layout).  Checks the slot count first: an uneven split raises here,
    before the model loads."""
    from tone_tpu_torch.core.model import init_streaming_state

    n_data = mesh.shape[DATA_AXIS]
    if n_slots % n_data:
        raise ValueError(
            f"n_slots ({n_slots}) must be a multiple of the mesh '{DATA_AXIS}' "
            f"axis size ({n_data}) to shard the stream arena evenly")
    return stream_state_shardings(mesh, init_streaming_state(config, n_slots, device="meta"))
