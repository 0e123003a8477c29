"""Weights carried across from the JAX package.

``from_jax_variables`` takes the JAX variables pytree ``{"params",
"batch_stats"}`` with numpy leaves — e.g.
``jax.tree.map(np.asarray, tone_tpu.core.model.init_model_params(key, cfg))``
— and returns the same tree of torch tensors.  The two packages share the
parameter layout (``tone_tpu/core/encoder.py:81-145``), so after the bridge
both compute the same function.  The serving cast (bf16 matrices, merged
``lin12``) is applied by the runtimes, as in the JAX package
(acoustic.cast_params_for_inference).
"""

from __future__ import annotations

import numpy as np
import torch

from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.device import resolve_device


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def to_device(tree, device: torch.device | str):
    """The same tree with every tensor moved to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def from_jax_variables(tree, config: ToneConfig, device: str | torch.device | None = None):
    """The JAX variables pytree (numpy leaves) as torch tensors on ``device``
    (``cuda`` unless the caller asks for the CPU), dtypes kept."""
    dev = resolve_device(device)
    n_layers = len(tree["params"]["encoder"]["layers"])
    if n_layers != config.encoder.n_layers:
        raise ValueError(f"variables have {n_layers} layers, the config "
                         f"{config.encoder.n_layers}")
    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # ml_dtypes, which torch cannot read
            return torch.tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
        return torch.tensor(a, device=dev)

    return tree_map(leaf, tree)
