"""Model export and ahead-of-time builds (port of ``tone_tpu/export.py``).

The reference's deployment artifact chain is torch -> ONNX -> TensorRT plan
(tone/scripts/export.py, scripts/trt_build.sh); the JAX package serializes
the streaming step as StableHLO.  Here:

* :func:`export_streaming` — ``torch.export`` of the streaming step with the
  weights as an input (one artifact serves any checkpoint of the same
  architecture and dtype), one ``streaming_b{B}.pt2`` per batch size;
* :func:`load_exported` — run a saved artifact.  Unlike a StableHLO file,
  the program calls kernel B1 as the registered op
  ``torch.ops.tone_tpu_torch.glu_ff2`` (a ctypes launch cannot be traced),
  so loading imports that registration from the package (ROADMAP §C);
* :func:`enable_compilation_cache` — the port has no XLA cache: what it
  compiles ahead are its kernels (``nvcc``) and host libraries (``g++``),
  so the cache is the build directory, and a container pointing it at a
  volume builds each library once;
* :func:`aot_warmup` — build the kernels and run one streaming step per
  serving batch size before traffic arrives.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Sequence

import torch
import torch.utils._pytree as pytree

from tone_tpu_torch.bridge import tree_leaves
from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.core.encoder import EncoderStreamState
from tone_tpu_torch.core.frontend import get_frontend_constants
from tone_tpu_torch.core.layers import _rope_tables
from tone_tpu_torch.core.model import StreamingState, apply_streaming, init_streaming_state
from tone_tpu_torch.ops import _build
from tone_tpu_torch.ops import glu_ff as _glu_ff  # noqa: F401  (registers the op)

logger = logging.getLogger(__name__)

_STATE_TYPES = (StreamingState, EncoderStreamState)


def _register_state_types() -> None:
    """Make the state dataclasses pytree nodes torch.export can trace and
    serialize (the counterpart of JAX's ``register_pytree_node_serialization``).
    Their children are keyed like mapping entries (``['mhsa']``), not like
    attributes: the input guards torch.export generates find a leaf by its
    key path as text, and ``.mhsa`` is a prefix of ``.mhsa_len``."""
    for cls in _STATE_TYPES:
        names = [f.name for f in dataclasses.fields(cls)]

        def flatten(obj, names=names):
            return [getattr(obj, n) for n in names], names

        def flatten_with_keys(obj, names=names):
            return [(pytree.MappingKey(n), getattr(obj, n)) for n in names], names

        def unflatten(values, context, cls=cls):
            return cls(**dict(zip(context, values)))

        try:
            pytree.register_pytree_node(
                cls, flatten, unflatten,
                serialized_type_name=f"tone_tpu_torch.{cls.__name__}",
                flatten_with_keys_fn=flatten_with_keys)
        except ValueError:
            pass  # already registered (module reload)


_register_state_types()


class _StreamingStep(torch.nn.Module):
    """``apply_streaming`` as a module: torch.export traces modules."""

    def __init__(self, config: ToneConfig, device: torch.device) -> None:
        super().__init__()
        self.config = config
        # made outside the trace, so the program holds them as constants
        self.constants = get_frontend_constants(config.frontend, device)

    def forward(self, variables, chunk, state):
        return apply_streaming(variables, self.config, chunk, state, self.constants)


def export_streaming(variables: Any, config: ToneConfig, batch_sizes: Sequence[int],
                     out_dir: str | Path) -> list[Path]:
    """Export the streaming step to ``out_dir/streaming_b{B}.pt2`` artifacts.

    Weights stay an argument (like ONNX initializers supplied at session
    load), so artifacts are architecture-specific but checkpoint-agnostic.
    The program is traced on the device of ``variables`` and runs there;
    pass the variables as ``StreamingCTCModel.variables`` holds them (the
    serving cast: bf16 matrices and the merged ``lin12`` that B1 takes),
    and call the loaded program with variables of the same tree and dtypes.
    Not to be run while another thread steps a model: tracing shares the
    step's constant caches.

    Args:
        batch_sizes: one artifact per batch size (static shapes).

    Returns:
        list of written artifact paths.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = tree_leaves(variables)[0].device
    step = _StreamingStep(config, device)
    written = []
    for b in batch_sizes:
        chunk = torch.zeros((b, config.audio_chunk_samples), dtype=torch.int32, device=device)
        # One eager step first: it fills the step's cached tables (RoPE) with
        # real tensors, which the trace then finds instead of making its own.
        step(variables, chunk, init_streaming_state(config, b, device=device))
        try:
            with torch.no_grad():  # as the step runs: no grad-mode regions to record
                program = torch.export.export(
                    step, (variables, chunk, init_streaming_state(config, b, device=device)),
                    strict=False)
        finally:
            _rope_tables.cache_clear()  # never keep a tensor made while tracing
        program.example_inputs = None  # the weights: not part of the artifact
        path = out_dir / f"streaming_b{b}.pt2"
        torch.export.save(program, path)
        written.append(path)
    (out_dir / "export_config.json").write_text(json.dumps({
        "config": config.to_dict(),
        "batch_sizes": list(batch_sizes),
        "device": device.type,
        "torch_version": torch.__version__,
    }, indent=2))
    return written


def load_exported(path: str | Path):
    """Load a saved streaming-step artifact.

    Returns a callable ``fn(variables, chunk, state) -> (logprobs, state)``
    that runs the exported program; like the eager step it consumes
    ``state`` (its buffers are updated in place).
    """
    module = torch.export.load(str(path)).module()

    def fn(variables, chunk, state):
        return module(variables, chunk, state)

    return fn


def enable_compilation_cache(cache_dir: str | Path) -> bool:
    """Build the port's kernels and host libraries into ``cache_dir``;
    returns True on success.  Call it before the first build: a library
    already loaded stays loaded.

    An unusable directory (a container may set TONE_TPU_COMPILE_CACHE to a
    root-owned bind mount) must not abort startup — the cache is an
    optimization, so degrade to a logged warning and build where
    ``ops/_build.py build_dir`` chooses.
    """
    cache_dir = Path(cache_dir)
    try:
        _build.probe_writable(cache_dir)
    except OSError as e:
        logger.warning("persistent compile cache disabled (%s unusable: %s)", cache_dir, e)
        return False
    _build.BUILD_DIR = cache_dir.resolve()
    return True


def aot_warmup(model, batch_sizes: Sequence[int]) -> None:
    """Build the kernels and run one streaming step for each batch size (the
    serving-startup equivalent of Triton's model_warmup)."""
    for b in batch_sizes:
        chunk = torch.zeros((b, model.config.audio_chunk_samples), dtype=torch.int32,
                            device=model.device)
        logprobs, _ = model.forward_native(chunk, model.init_state(b))
        float(logprobs.sum())  # waits for the device
