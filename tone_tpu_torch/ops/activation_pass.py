"""The FastConformer's activation passes as one hand-written Hopper kernel
(``csrc/activation_pass.cu``), for ``core/fastconformer.py`` on the card.

Between one product of a sublayer and the next, the eager path ran a chain
of passes: the product's bias (``layers._add_bias``), SiLU or GLU, the
length mask, the edge padding and the transposes around the depthwise
convolution, its bias and batch norm.  Each form here does one such chain
in one pass and writes what the next product (or the depthwise
convolution) reads as it stands:

* ``silu(y, bias)``: y (..., N) float32, ``linear1``'s product without its
  bias; returns ``layers.silu(linear1(x))``, (..., N) bf16.
* ``glu(y, bias, lengths, kernel)``: y (B, T, 2d) float32, ``pw1``'s
  product without its bias; returns GLU of ``pw1(x)`` with frames at or
  past each row's length zeroed, laid out as the depthwise convolution's
  input: (B, d, ``padded_frames(T, kernel)``) with (kernel - 1) / 2 zero
  frames before each row's T frames and zeros after them.
* ``bn_silu(y, bias, bn, stats, frames)``: y (B, d, Tc) the depthwise
  convolution's output without its bias, in the compute dtype, Tc >=
  ``frames``; returns ``layers.silu`` of eval-mode ``layers.batchnorm`` of
  the biased convolution, (B, frames, d) contiguous.

On a CUDA tensor each call is one launch (counted in ``launches``), with
autograd off, bf16 outputs and widths a multiple of 8; anything else
raises.  On a CPU tensor each call is its plain version, the eager path's
composition, bit for bit; the kernel's outputs are the plain version's bit
for bit too (``csrc/activation_pass.cu``).

``FORM_BYTES`` is the bytes each form must move per element of its output
width (inputs read once, outputs written once); ``layer_bytes`` those of a
layer's four passes per frame.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch
import torch.nn.functional as F

from tone_tpu_torch.core import layers as L
from tone_tpu_torch.ops import _build

__all__ = ["FORM_BYTES", "bn_silu", "bn_silu_plain", "glu", "glu_plain", "kernel_constants",
           "layer_bytes", "padded_frames", "silu", "silu_plain"]

SOURCE = "activation_pass"
BN_EPS = 1e-5
# silu: y read (4), one bf16 written; glu: both halves of y read (8), one
# bf16 written; bn_silu: one bf16 read, one written.
FORM_BYTES = {"silu": 4 + 2, "glu": 2 * 4 + 2, "bn_silu": 2 + 2}

launches = 0   # kernel launches, every form


def layer_bytes(d_model: int, d_ff: int) -> int:
    """Bytes per frame that a layer's four passes must move: two feed-forwards'
    silu over d_ff, the convolution module's glu and bn_silu over d_model."""
    return 2 * FORM_BYTES["silu"] * d_ff + (FORM_BYTES["glu"] + FORM_BYTES["bn_silu"]) * d_model


@functools.cache
def kernel_constants() -> dict[str, int]:
    """The ``constexpr int AP_*`` constants of ``csrc/activation_pass.cu``."""
    text = (_build.SOURCE_DIR / f"{SOURCE}.cu").read_text()
    return {name: int(value)
            for name, value in re.findall(r"^constexpr int (AP_\w+) = (\d+);", text, re.M)}


def padded_frames(frames: int, kernel: int) -> int:
    """The frames of a row of ``glu``'s output: the depthwise convolution's
    T + kernel - 1 rounded up to a whole 16-byte vector of bf16."""
    vec = kernel_constants()["AP_VEC"]
    return -(-(frames + kernel - 1) // vec) * vec


def _bn_vectors(bn, stats) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode batch norm's float32 scale and shift, as ``layers.batchnorm``
    computes them."""
    scale = bn["scale"].float() * torch.rsqrt(stats["var"].float() + BN_EPS)
    shift = bn["bias"].float() - stats["mean"].float() * scale
    return scale, shift


# ---------------------------------------------------------------------------
# Plain versions: the eager path's composition.
# ---------------------------------------------------------------------------


def silu_plain(y: torch.Tensor, bias: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return L.silu(L._add_bias(y, bias.float(), dtype, False))


def glu_plain(y: torch.Tensor, bias: torch.Tensor, lengths: torch.Tensor, kernel: int,
              dtype=torch.bfloat16) -> torch.Tensor:
    t = y.shape[1]
    v = L.glu(L._add_bias(y, bias.float(), dtype, False), dim=-1)
    past = torch.arange(t, device=lengths.device)[None] >= lengths[:, None]
    v = v.masked_fill_(past[:, :, None], 0.0)
    left = (kernel - 1) // 2
    v = F.pad(v, (0, 0, left, padded_frames(t, kernel) - t - left))
    return v.transpose(1, 2).contiguous()


def bn_silu_plain(y: torch.Tensor, bias: torch.Tensor, bn, stats, frames: int) -> torch.Tensor:
    dtype = y.dtype
    v = (y[:, :, :frames].transpose(1, 2).float() + bias.float()).to(dtype)
    v, _ = L.batchnorm(bn, stats, v, channel_axis=2, eps=BN_EPS)
    return L.silu(v).contiguous()


# ---------------------------------------------------------------------------
# The kernel.
# ---------------------------------------------------------------------------


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.tone_activation_silu.argtypes is None:  # declare once: ctypes would cut pointers
        ptr, i = ctypes.c_void_p, ctypes.c_int
        for name, args in (("tone_activation_silu", [ptr] * 3 + [i] * 2),
                           ("tone_activation_glu", [ptr] * 4 + [i] * 5),
                           ("tone_activation_bn_silu", [ptr] * 5 + [i] * 4)):
            fn = getattr(lib, name)
            fn.argtypes = args + [ptr]
            fn.restype = ctypes.c_int
    return lib


def _check(form: str, tensors: dict) -> torch.device:
    """Refuses what the kernel does not take (``tensors``: name -> (tensor,
    shape, dtype)); returns the CUDA device they share."""
    if torch.is_grad_enabled():
        raise RuntimeError(f"activation_pass {form}: the kernel has no backward; call it with "
                           f"autograd off (torch.no_grad())")
    for name, (tensor, shape, dtype) in tensors.items():
        if tensor.dtype != dtype or tuple(tensor.shape) != shape:
            raise ValueError(f"activation_pass {form}: {name} must be {dtype} of shape {shape} "
                             f"(got {tensor.dtype} {tuple(tensor.shape)})")
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError(f"activation_pass {form}: {name} must be contiguous and 16-byte "
                             f"aligned")
    dev = next(iter(tensors.values()))[0].device
    if dev.type != "cuda" or any(t.device != dev for t, _, _ in tensors.values()):
        raise ValueError(f"activation_pass {form}: every tensor must be on one CUDA device "
                         f"(got {sorted({str(t.device) for t, _, _ in tensors.values()})})")
    return dev


def _width(form: str, name: str, n: int) -> None:
    vec = kernel_constants()["AP_VEC"]
    if n <= 0 or n % vec:
        raise ValueError(f"activation_pass {form}: {name} {n} is not a multiple of {vec}")


def _launch(fn_name: str, dev: torch.device, *args) -> None:
    global launches
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):  # the kernel launches on the current device
        err = getattr(_kernel_lib(), fn_name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"activation_pass kernel launch failed (cudaError {err})")
    launches += 1


def _silu_kernel(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    n = y.shape[-1]
    _width("silu", "width", n)
    dev = _check("silu", {"y": (y, tuple(y.shape), torch.float32),
                          "bias": (bias, (n,), torch.float32)})
    out = torch.empty(y.shape, dtype=torch.bfloat16, device=dev)
    _launch("tone_activation_silu", dev, y.data_ptr(), bias.data_ptr(), out.data_ptr(),
            y.numel() // n, n)
    return out


def _glu_kernel(y: torch.Tensor, bias: torch.Tensor, lengths: torch.Tensor,
                kernel: int) -> torch.Tensor:
    if y.ndim != 3 or y.shape[-1] % 2:
        raise ValueError(f"activation_pass glu: y must be (B, T, 2d), got {tuple(y.shape)}")
    b, t, d = y.shape[0], y.shape[1], y.shape[2] // 2
    _width("glu", "d", d)
    if kernel < 1 or kernel % 2 == 0:
        raise ValueError(f"activation_pass glu: the convolution's kernel {kernel} is not odd")
    dev = _check("glu", {"y": (y, (b, t, 2 * d), torch.float32),
                         "bias": (bias, (2 * d,), torch.float32),
                         "lengths": (lengths, (b,), torch.int64)})
    frames = padded_frames(t, kernel)
    out = torch.empty(b, d, frames, dtype=torch.bfloat16, device=dev)
    _launch("tone_activation_glu", dev, y.data_ptr(), bias.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, t, d, frames, (kernel - 1) // 2)
    return out


def _bn_silu_kernel(y: torch.Tensor, bias: torch.Tensor, bn, stats, frames: int) -> torch.Tensor:
    if y.ndim != 3 or not 0 < frames <= y.shape[2]:
        raise ValueError(f"activation_pass bn_silu: y must be (B, d, Tc >= {frames}), got "
                         f"{tuple(y.shape)}")
    b, d, tc = y.shape
    _width("bn_silu", "d", d)
    scale, shift = _bn_vectors(bn, stats)
    dev = _check("bn_silu", {"y": (y, (b, d, tc), torch.bfloat16),
                             "bias": (bias, (d,), torch.float32),
                             "scale": (scale, (d,), torch.float32),
                             "shift": (shift, (d,), torch.float32)})
    out = torch.empty(b, frames, d, dtype=torch.bfloat16, device=dev)
    _launch("tone_activation_bn_silu", dev, y.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), b, d, tc, frames)
    return out


def _bf16(form: str, dtype) -> None:
    if dtype != torch.bfloat16:
        raise ValueError(f"activation_pass {form}: the kernel writes bf16, not {dtype}")


def silu(y: torch.Tensor, bias: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``layers.silu(layers.linear(...))`` from the bias-less float32 product
    (module docstring): the kernel on a CUDA tensor, the plain version on a
    CPU one."""
    if not y.is_cuda:
        return silu_plain(y, bias, dtype)
    _bf16("silu", dtype)
    return _silu_kernel(y, bias)


def glu(y: torch.Tensor, bias: torch.Tensor, lengths: torch.Tensor, kernel: int,
        dtype=torch.bfloat16) -> torch.Tensor:
    """The convolution module's GLU, length mask and edge padding, as the
    depthwise convolution's (B, d, padded_frames) input (module docstring)."""
    if not y.is_cuda:
        return glu_plain(y, bias, lengths, kernel, dtype)
    _bf16("glu", dtype)
    return _glu_kernel(y, bias, lengths, kernel)


def bn_silu(y: torch.Tensor, bias: torch.Tensor, bn, stats, frames: int) -> torch.Tensor:
    """The depthwise convolution's bias, eval-mode batch norm and SiLU, as
    pw2's (B, frames, d) input (module docstring)."""
    if not y.is_cuda:
        return bn_silu_plain(y, bias, bn, stats, frames)
    return _bn_silu_kernel(y, bias, bn, stats, frames)
