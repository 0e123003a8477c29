"""Fused GLU gate -> output projection of the serving feed-forward (port of
``tone_tpu/ops/glu_ff.py``).

``glu_ff2(av, p2)`` computes ``lin2(silu(a) * v)`` for ``av = [a | v]``, the
output of the merged in-projection (``lin12``, acoustic.cast_params_for_inference),
without writing the gated product to device memory.  On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/glu_ff.cu`` or raises; on a
CPU tensor it runs ``glu_ff2_plain``, the same numerics in plain PyTorch:

* sigmoid in float32, the gate ``silu(a)`` rounded to bf16;
* the gate times ``v`` in bf16;
* the product with ``W2`` on bf16 operands, summed in float32;
* the float32 bias added, then one rounding to bf16.

``glu_ff2.launches`` counts kernel launches (only launches, not plain runs).
"""

from __future__ import annotations

import ctypes

import torch

from tone_tpu_torch.ops import _build

__all__ = ["glu_ff2", "glu_ff2_plain"]


def glu_ff2_plain(av: torch.Tensor, p2, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``av`` (..., 2F), ``p2`` =
    ``{"w": (F, D), "b": (D,)}``; returns (..., D) in ``compute_dtype``."""
    f = p2["w"].shape[0]
    av = av.to(compute_dtype)
    a32 = av[..., :f].float()
    g = (a32 * torch.sigmoid(a32)).to(compute_dtype) * av[..., f:]
    y = torch.matmul(g.float(), p2["w"].to(compute_dtype).float()) + p2["b"].float()
    return y.to(compute_dtype)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("glu_ff")
    fn = lib.tone_glu_ff2
    if fn.argtypes is None:  # declare once: ctypes would pass ints as 32-bit
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tone_glu_ff2_tile_f.restype = ctypes.c_int
        lib.tone_glu_ff2_tile_d.restype = ctypes.c_int
    return lib


def glu_ff2(av: torch.Tensor, p2, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``lin2(silu(av[..., :F]) * av[..., F:])``; ``av`` (..., 2F),
    ``p2`` = ``{"w": (F, D) bf16, "b": (D,) float32}``."""
    *lead, two_f = av.shape
    f, d = p2["w"].shape
    if two_f != 2 * f:
        raise ValueError(f"av has {two_f} features, W2 expects 2 x {f}")
    if av.device.type == "cpu":
        return glu_ff2_plain(av, p2, compute_dtype)
    if av.device.type != "cuda":
        raise ValueError(f"glu_ff2 runs on CUDA or CPU tensors, not {av.device}")

    w, b = p2["w"], p2["b"]
    if compute_dtype != torch.bfloat16 or av.dtype != torch.bfloat16 \
            or w.dtype != torch.bfloat16 or b.dtype != torch.float32:
        raise TypeError("the glu_ff kernel takes bf16 av and W2, a float32 bias "
                        f"and bf16 compute (got {av.dtype}, {w.dtype}, {b.dtype}, "
                        f"{compute_dtype})")
    av2 = av.reshape(-1, two_f)
    for name, t in (("av", av2), ("W2", w), ("b", b)):
        if t.device != av.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"glu_ff kernel: {name} must be a contiguous, "
                             f"16-byte aligned tensor on {av.device}")
    lib = _kernel_lib()
    tile_f, tile_d = lib.tone_glu_ff2_tile_f(), lib.tone_glu_ff2_tile_d()
    if f % tile_f or d % tile_d:
        raise ValueError(f"glu_ff kernel: F={f} must be a multiple of {tile_f} "
                         f"and D={d} a multiple of {tile_d}")
    m = av2.shape[0]
    y = torch.empty((m, d), dtype=torch.bfloat16, device=av.device)
    if m:
        stream = torch.cuda.current_stream(av.device).cuda_stream
        err = lib.tone_glu_ff2(av2.data_ptr(), w.data_ptr(), b.data_ptr(),
                               y.data_ptr(), m, f, d, stream)
        if err:
            raise RuntimeError(f"glu_ff kernel launch failed (cudaError {err})")
        glu_ff2.launches += 1
    return y.reshape(*lead, d)


glu_ff2.launches = 0
