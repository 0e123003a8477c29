"""The FastConformer's residual-and-norm junction as one hand-written
Hopper kernel (``csrc/norm_junction.cu``), for ``core/fastconformer.py``
on the card.

Between two sublayers the eager path adds the last ``linear``'s bias to
its float32 product and rounds (``layers._add_bias``), scales the result
(0.5 after a feed-forward), adds it to the bf16 residual stream and
normalizes the sum for the next sublayer (``layers.layernorm``).
``norm_junction(y, bias, x, scale, norm)`` does all of it in one pass and
returns ``(x', LN(x'))``: y (B, Ty, D) float32, the product without its
bias, with Ty <= T (frames at or past Ty add nothing); x (B, T, D) bf16.
With ``layer_end=True`` it is the junction after the last feed-forward,
which ends the layer with ``norm`` (``norm_out``): it returns ``(LN(x'),
LN_next(LN(x')))``, the layer's output and, normed by ``next_norm``, the
next layer's first input, or ``(LN(x'), None)`` without ``next_norm``.
``layer_norm(x, norm)`` is the norm alone (the first layer's
``norm_ff1``).  Norms are ``{"scale", "bias"}`` (D,), eps 1e-5.

On a CUDA tensor each call is one launch (counted in
``norm_junction.launches``), with autograd off, bf16 stream and
d_model a multiple of 8 up to 2,048; anything else raises.  On a CPU
tensor each call is its plain version, the eager path's composition of
``layers._add_bias``, the scale, the add and ``layers.layernorm``, bit for
bit.  The kernel's x' is bit-equal to the plain version's; its norms
differ only by the order of their float32 sums.

``JUNCTION_BYTES`` is the bytes a junction of each form must move per
element of d_model (inputs read once, outputs written once).
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch
import torch.nn.functional as F

from tone_tpu_torch.core import layers as L
from tone_tpu_torch.ops import _build

__all__ = ["JUNCTION_BYTES", "kernel_constants", "layer_bytes", "layer_norm",
           "norm_junction", "norm_junction_plain"]

SOURCE = "norm_junction"
EPS = 1e-5
# The kernel's forms (``form`` in the source) and the bytes each must move
# per element of d_model: y (4) and x (2) read, two bf16 outputs written.
FORMS = {"norm": 0, "single": 1, "double": 2, "last": 3}
JUNCTION_BYTES = {"norm": 2 + 2, "single": 4 + 2 + 2 + 2, "double": 4 + 2 + 2 + 2,
                  "last": 4 + 2 + 2}


def layer_bytes(n_layers: int) -> int:
    """Bytes per valid frame and element of d_model that a forward's
    junctions move: the first norm alone, three single junctions a layer,
    a double one ending every layer but the last, which ends in ``last``."""
    return (JUNCTION_BYTES["norm"] + 3 * n_layers * JUNCTION_BYTES["single"]
            + (n_layers - 1) * JUNCTION_BYTES["double"] + JUNCTION_BYTES["last"])


@functools.cache
def kernel_constants() -> dict[str, int]:
    """The ``constexpr int NJ_*`` constants of ``csrc/norm_junction.cu``."""
    text = (_build.SOURCE_DIR / f"{SOURCE}.cu").read_text()
    return {name: int(value)
            for name, value in re.findall(r"^constexpr int (NJ_\w+) = (\d+);", text, re.M)}


def max_d_model() -> int:
    c = kernel_constants()
    return 32 * c["NJ_VEC"] * c["NJ_MAX_CHUNKS"]


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.tone_norm_junction
    if fn.argtypes is None:  # declare once: ctypes would pass pointers as 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_float] * 2 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _vector(p, key: str) -> torch.Tensor:
    return p[key].float().contiguous()


def _launch(form: str, x: torch.Tensor, norm, next_norm=None, y: torch.Tensor | None = None,
            bias: torch.Tensor | None = None, scale: float = 1.0,
            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of the kernel in ``form`` (counted); returns its outputs
    (a, b), b None for the forms that write one."""
    if torch.is_grad_enabled():
        raise RuntimeError("norm_junction: the kernel has no backward; call it with "
                           "autograd off (torch.no_grad())")
    if x.ndim != 3:
        raise ValueError(f"norm_junction kernel: x must be (B, T, D), got {tuple(x.shape)}")
    b, t, d = x.shape
    if d % kernel_constants()["NJ_VEC"] or not 0 < d <= max_d_model():
        raise ValueError(f"norm_junction kernel: d_model {d} is not a multiple of "
                         f"{kernel_constants()['NJ_VEC']} up to {max_d_model()}")
    dev = x.device
    tensors = {"x": (x, (b, t, d), torch.bfloat16)}
    if y is not None:
        if y.ndim != 3 or y.shape[0] != b or not 0 < y.shape[1] <= t or y.shape[2] != d:
            raise ValueError(f"norm_junction kernel: y must be (B, Ty <= T, D) for x of "
                             f"{tuple(x.shape)}, got {tuple(y.shape)}")
        tensors.update(y=(y, tuple(y.shape), torch.float32), bias=(bias, (d,), torch.float32))
    vectors = {"gamma1": _vector(norm, "scale"), "beta1": _vector(norm, "bias")}
    if next_norm is not None:
        vectors.update(gamma2=_vector(next_norm, "scale"), beta2=_vector(next_norm, "bias"))
    tensors.update({name: (v, (d,), torch.float32) for name, v in vectors.items()})
    for name, (tensor, shape, dtype) in tensors.items():
        if tensor is None:
            raise ValueError(f"norm_junction kernel: {name} is missing")
        if tensor.dtype != dtype or tuple(tensor.shape) != shape:
            raise ValueError(f"norm_junction kernel: {name} must be {dtype} of shape {shape} "
                             f"(got {tensor.dtype} {tuple(tensor.shape)})")
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError(f"norm_junction kernel: {name} must be contiguous and 16-byte "
                             f"aligned")
    if dev.type != "cuda" or any(t.device != dev for t, _, _ in tensors.values()):
        raise ValueError(f"norm_junction kernel: every tensor must be on x's CUDA device "
                         f"(x on {dev})")
    out_a = torch.empty_like(x)
    out_b = torch.empty_like(x) if form in ("single", "double") else None
    index = dev.index if dev.index is not None else torch.cuda.current_device()

    def ptr(tensor):
        return None if tensor is None else tensor.data_ptr()

    with torch.cuda.device(index):  # the kernel launches on the current device
        err = _kernel_lib().tone_norm_junction(
            ptr(y), ptr(bias), x.data_ptr(), ptr(vectors["gamma1"]), ptr(vectors["beta1"]),
            ptr(vectors.get("gamma2")), ptr(vectors.get("beta2")), out_a.data_ptr(),
            ptr(out_b), scale, EPS, b * t, t, 0 if y is None else y.shape[1], d, FORMS[form],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"norm_junction kernel launch failed (cudaError {err})")
    norm_junction.launches += 1
    return out_a, out_b


def norm_junction_plain(y: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, scale: float,
                        norm, next_norm=None, *, layer_end: bool = False,
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The junction as the eager path composes it (module docstring), in
    the compute dtype of ``x``."""
    r = L._add_bias(y, bias.float(), x.dtype, False)
    if scale != 1.0:
        r = r * scale
    x = x + F.pad(r, (0, 0, 0, x.shape[1] - r.shape[1]))
    if not layer_end:
        return x, L.layernorm(norm, x)
    out = L.layernorm(norm, x)
    return out, None if next_norm is None else L.layernorm(next_norm, out)


def norm_junction(y: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, scale: float, norm,
                  next_norm=None, *, layer_end: bool = False,
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The junction after a sublayer (module docstring): ``(x', LN(x'))``,
    or with ``layer_end`` ``(LN(x'), LN_next(LN(x')) or None)``.  The
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if next_norm is not None and not layer_end:
        raise ValueError("norm_junction: next_norm is the layer end's (layer_end=True)")
    if not x.is_cuda:
        return norm_junction_plain(y, bias, x, scale, norm, next_norm, layer_end=layer_end)
    form = "single" if not layer_end else "last" if next_norm is None else "double"
    return _launch(form, x, norm, next_norm, y, bias, scale)


def layer_norm(x: torch.Tensor, norm) -> torch.Tensor:
    """``layers.layernorm(norm, x)``: the kernel's norm-only form on a CUDA
    tensor (counted in ``norm_junction.launches``), ``layers.layernorm`` on
    a CPU one."""
    if not x.is_cuda:
        return L.layernorm(norm, x)
    return _launch("norm", x, norm)[0]


norm_junction.launches = 0
