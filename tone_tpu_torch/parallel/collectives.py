"""The process mesh of training and its collectives.

Training runs one process (rank) per position of a ``(data, model)`` grid
over ``torch.distributed`` (``ranks.init_rank`` joins the group), as DDP
and SyncBatchNorm do.  Rank ``r`` sits at data position ``r // n_model``
and model position ``r % n_model``, the JAX package's row-major grid.

``ProcessMesh`` holds the two groups of this rank (its ``data`` column and
its ``model`` row; every rank creates every group, in one order, as
``torch.distributed.new_group`` requires) and the collectives of the step:

* ``copy_to_model``: identity forward, sum over ``model`` backward (the
  Megatron operator before a column-split product);
* ``reduce_from_model``: sum over ``model`` forward, identity backward
  (after a row-split product);
* ``sum_over_data``: sum over ``data`` forward and backward (the global
  BatchNorm statistics);
* ``average_over_data``, ``average_over_model``, ``sum_over_model`` and
  ``gather_model_split``, outside autograd (the gradient average, the
  replicated leaves' gradients kept equal on the model ranks, the
  global-norm clip, and the full variables of a checkpoint).

Only ``all_reduce`` and ``barrier`` are used: the gloo backend offers
little else on CUDA tensors.  Every reduction runs in float32.  The
groups are made with ``new_group`` rather than ``DeviceMesh``, whose group
creation differs between PyTorch versions and backends; two axes need
nothing more.  ``bytes_reduced`` counts the bytes this rank has
all-reduced in groups of more than one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tone_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS


class ProcessMesh:
    """This rank's place in a ``(data, model)`` grid of ranks."""

    def __init__(self, n_data: int, n_model: int = 1) -> None:
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh: torch.distributed is not initialized "
                               "(parallel.ranks.init_rank)")
        world = dist.get_world_size()
        if n_data * n_model != world:
            raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, "
                             f"the world has {world}")
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.rank = dist.get_rank()
        self.data_rank, self.model_rank = divmod(self.rank, n_model)
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == self.model_rank:
                self.data_group = group
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == self.data_rank:
                self.model_group = group
        self.bytes_reduced = 0

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    def all_reduce(self, x: torch.Tensor, group) -> torch.Tensor:
        """The sum of ``x`` over ``group``, in float32, as a new tensor of
        ``x``'s dtype (``x`` is not changed)."""
        y = x.detach().float().clone()
        dist.all_reduce(y, group=group)
        if dist.get_world_size(group) > 1:
            self.bytes_reduced += y.numel() * y.element_size()
        return y.to(x.dtype)

    # -- inside autograd ---------------------------------------------------

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self)

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        return _SumOverData.apply(x, self)

    # -- outside autograd --------------------------------------------------

    def average_over_data(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor averaged over ``data``, in one all-reduce of their
        concatenation."""
        return self._average(tensors, self.data_group, self.n_data)

    def average_over_model(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        return self._average(tensors, self.model_group, self.n_model)

    @torch.no_grad()
    def _average(self, tensors: list[torch.Tensor], group, n: int) -> list[torch.Tensor]:
        if not tensors:
            return []
        flat = self.all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]), group) / n
        out, start = [], 0
        for t in tensors:
            out.append(flat[start:start + t.numel()].reshape(t.shape).to(t.dtype))
            start += t.numel()
        return out

    @torch.no_grad()
    def sum_over_model(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(x, self.model_group)

    @torch.no_grad()
    def gather_model_split(self, shards: list[torch.Tensor], specs: list[tuple]
                           ) -> list[torch.Tensor]:
        """The full tensors of this rank's ``model`` shards (``specs[i]``
        names the split dimension), in one all-reduce: each rank writes its
        shard into zeros at its offset, and the sum is the whole."""
        fulls = []
        for shard, spec in zip(shards, specs):
            axis = spec.index(MODEL_AXIS)
            shape = list(shard.shape)
            shape[axis] *= self.n_model
            full = torch.zeros(shape, dtype=torch.float32, device=shard.device)
            full.narrow(axis, self.model_rank * shard.shape[axis], shard.shape[axis]).copy_(shard)
            fulls.append(full)
        if not fulls:
            return []
        flat = self.all_reduce(torch.cat([f.reshape(-1) for f in fulls]), self.model_group)
        out, start = [], 0
        for f, shard in zip(fulls, shards):
            out.append(flat[start:start + f.numel()].reshape(f.shape).to(shard.dtype))
            start += f.numel()
        return out

    def barrier(self) -> None:
        dist.barrier()


def shard_along(x: torch.Tensor, spec: tuple, mesh: ProcessMesh) -> torch.Tensor:
    """This rank's ``model`` shard of the full tensor ``x`` (a copy)."""
    if MODEL_AXIS not in spec:
        return x
    axis = spec.index(MODEL_AXIS)
    if x.shape[axis] % mesh.n_model:
        raise ValueError(f"dimension {axis} of {tuple(x.shape)} does not split over "
                         f"{mesh.n_model} model ranks")
    size = x.shape[axis] // mesh.n_model
    return x.narrow(axis, mesh.model_rank * size, size).clone()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x, mesh.data_group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.mesh.data_group), None
