"""The FastConformer's activation passes (``ops/activation_pass.py``) on the
CPU: each form's plain version against the eager chain it replaces, bit
for bit, at tiny widths over rows of unequal length; the kernel wrapper's
refusals; the bytes the passes are held to.  The kernel itself is held to
the plain versions on the card (``tests/test_torch_activation_pass_gpu.py``).
"""

from __future__ import annotations

import re

import pytest
import torch
import torch.nn.functional as F

from tone_tpu_torch.core import fastconformer as FC
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.ops import activation_pass as AP

LENGTHS = (13, 5, 1, 9)   # rows of unequal length, the longest the batch's frames


def _inputs(dtype, d=24, d_in=40, kernel=9, seed=3):
    """A sublayer's input x (B, T, d_in), a linear d_in -> 2d (pw1's), the
    depthwise convolution, a batch norm with running statistics, and the
    rows' lengths."""
    gen = torch.Generator().manual_seed(seed)
    t = max(LENGTHS)
    lin = L.init_linear(gen, d_in, 2 * d)
    lin["b"] = torch.randn(2 * d, generator=gen)
    dw = L.init_conv(gen, d, 1, (kernel,))
    bn = {"scale": 1 + 0.2 * torch.randn(d, generator=gen),
          "bias": 0.2 * torch.randn(d, generator=gen)}
    stats = {"mean": 0.3 * torch.randn(d, generator=gen),
             "var": 0.5 + torch.rand(d, generator=gen)}
    x = (2 * torch.randn(len(LENGTHS), t, d_in, generator=gen)).to(dtype)
    return x, lin, dw, bn, stats, torch.tensor(LENGTHS)


def _eager_glu(lin, x, lengths, kernel, dtype):
    """The eager convolution module up to the depthwise convolution's input,
    (B, T + kernel - 1, d)."""
    pad = torch.arange(x.shape[1])[None] >= lengths[:, None]
    y = L.glu(L.linear(lin, x, dtype), dim=-1).masked_fill_(pad[:, :, None], 0.0)
    return F.pad(y, (0, 0, (kernel - 1) // 2, (kernel - 1) // 2))


DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [8, 24, 200])
def test_plain_silu_is_the_eager_chain(width, dtype):
    """``linear_product`` then the plain silu equals ``silu(linear(x))``."""
    gen = torch.Generator().manual_seed(width)
    lin = L.init_linear(gen, 40, width)
    x = torch.randn(len(LENGTHS), max(LENGTHS), 40, generator=gen).to(dtype)
    launches = AP.launches
    got = AP.silu(L.linear_product(lin, x, dtype), lin["b"], dtype)
    assert AP.launches == launches
    expect = L.silu(L.linear(lin, x, dtype))
    assert got.dtype == dtype and torch.equal(got, expect)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", [9, 5, 3, 1])
def test_plain_glu_is_the_eager_chain_in_the_convolutions_layout(kernel, dtype):
    """The plain glu is (B, d, padded_frames) contiguous: the eager chain's
    padded (B, T + k - 1, d) transposed, zeros after it; frames past each
    row's length are zero."""
    x, lin, _, _, _, lengths = _inputs(dtype, kernel=kernel)
    t = x.shape[1]
    got = AP.glu(L.linear_product(lin, x, dtype), lin["b"], lengths, kernel, dtype)
    frames = AP.padded_frames(t, kernel)
    assert frames % 8 == 0 and t + kernel - 1 <= frames < t + kernel + 7
    assert got.shape == (len(LENGTHS), 24, frames) and got.is_contiguous()
    eager = _eager_glu(lin, x, lengths, kernel, dtype)
    assert torch.equal(got[:, :, :t + kernel - 1], eager.transpose(1, 2))
    assert not got[:, :, t + kernel - 1:].any()
    left = (kernel - 1) // 2
    for row, n in enumerate(LENGTHS):
        assert not got[row, :, left + n:].any() and got[row, :, left:left + n].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", [9, 5])
def test_plain_bn_silu_is_the_eager_chain_in_pw2s_layout(kernel, dtype):
    """The depthwise convolution without its bias over glu's layout, then
    the plain bn_silu, equals the eager path's biased convolution,
    ``batchnorm`` and ``silu``, as (B, T, d) contiguous."""
    x, lin, dw, bn, stats, lengths = _inputs(dtype, kernel=kernel)
    t, d = x.shape[1], dw["w"].shape[0]
    v = AP.glu(L.linear_product(lin, x, dtype), lin["b"], lengths, kernel, dtype)
    y = L.conv1d_nhc({"w": dw["w"]}, v.transpose(1, 2), groups=d, compute_dtype=dtype)
    y = y.transpose(1, 2)
    assert y.shape == (len(LENGTHS), d, AP.padded_frames(t, kernel) - kernel + 1)
    got = AP.bn_silu(y, dw["b"], bn, stats, t)
    assert got.shape == (len(LENGTHS), t, d) and got.is_contiguous() and got.dtype == dtype
    eager = L.conv1d_nhc(dw, _eager_glu(lin, x, lengths, kernel, dtype), groups=d,
                         compute_dtype=dtype)
    eager, _ = L.batchnorm(bn, stats, eager, channel_axis=2)
    assert torch.equal(got, L.silu(eager))


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_module_is_the_eager_composition(dtype):
    """``fastconformer._conv_module`` through the three passes equals the
    eager module it replaces (pw1, GLU, mask, padding, the biased
    depthwise convolution, batch norm, SiLU, pw2's product) bit for bit."""
    x, lin, dw, bn, stats, lengths = _inputs(dtype, d=24, d_in=24)
    gen = torch.Generator().manual_seed(8)
    p = {"pw1": lin, "dw": dw, "bn": bn, "pw2": L.init_linear(gen, 24, 24)}
    got = FC._conv_module(p, stats, x, lengths, 9, dtype)
    y = L.conv1d_nhc(dw, _eager_glu(lin, x, lengths, 9, dtype), groups=24, compute_dtype=dtype)
    y, _ = L.batchnorm(bn, stats, y, channel_axis=2)
    assert torch.equal(got, L.linear_product(p["pw2"], L.silu(y), dtype))


def test_activation_bytes_per_layer():
    """Bytes per element of the output width: silu reads the float32
    product (4) and writes bf16 (2); glu reads both float32 halves (8) and
    writes one bf16; bn_silu reads and writes bf16.  A layer: two silu over
    d_ff, one glu and one bn_silu over d_model (63.5 KB a frame at the
    published widths)."""
    assert AP.FORM_BYTES == {"silu": 6, "glu": 10, "bn_silu": 4}
    assert AP.layer_bytes(64, 256) == 2 * 6 * 256 + 14 * 64
    assert AP.layer_bytes(1024, 4096) == 63_488


# ---------------------------------------------------------------------------
# The kernel wrapper's refusals (each before it looks for the card).
# ---------------------------------------------------------------------------


def _misaligned(shape, dtype=torch.float32):
    """A contiguous tensor whose data starts 4 bytes past a 16-byte boundary."""
    base = torch.zeros(int(torch.tensor(shape).prod()) + 4, dtype=dtype)
    return base[1:1 + int(torch.tensor(shape).prod())].view(shape)


def _fault(fault):
    """(the wrapper to call, its arguments, the words of the error)."""
    y_ff, b_ff = torch.zeros(2, 5, 64), torch.zeros(64)
    y_pw, b_pw, lengths = torch.zeros(2, 5, 48), torch.zeros(48), torch.tensor([5, 3])
    x_dw = torch.zeros(2, 24, 8, dtype=torch.bfloat16)
    bn, stats = L.init_batchnorm(24)
    silu, glu, bn_silu = AP._silu_kernel, AP._glu_kernel, AP._bn_silu_kernel
    return {
        "silu_y_dtype": (silu, (y_ff.to(torch.bfloat16), b_ff), "y must be torch.float32"),
        "silu_bias_shape": (silu, (y_ff, b_ff[:32]), "bias must be"),
        "silu_y_not_contiguous": (silu, (y_ff.transpose(0, 1), b_ff), "contiguous"),
        "silu_y_misaligned": (silu, (_misaligned((2, 5, 64)), b_ff), "16-byte aligned"),
        "silu_width_not_a_multiple_of_8": (silu, (y_ff[..., :60].contiguous(), b_ff[:60]),
                                           "width 60"),
        "glu_y_shape": (glu, (y_pw[0], b_pw, lengths, 9), "(B, T, 2d)"),
        "glu_d_not_a_multiple_of_8": (glu, (y_pw[..., :44].contiguous(), b_pw[:44], lengths, 9),
                                      "d 22"),
        "glu_lengths_dtype": (glu, (y_pw, b_pw, lengths.int(), 9), "lengths must be torch.int64"),
        "glu_even_kernel": (glu, (y_pw, b_pw, lengths, 8), "kernel 8"),
        "bn_silu_y_dtype": (bn_silu, (x_dw.float(), torch.zeros(24), bn, stats, 8),
                            "y must be torch.bfloat16"),
        "bn_silu_frames_past_y": (bn_silu, (x_dw, torch.zeros(24), bn, stats, 9), "Tc >= 9"),
        "bn_silu_bias_shape": (bn_silu, (x_dw, torch.zeros(16), bn, stats, 8), "bias must be"),
        "on_the_cpu": (silu, (y_ff, b_ff), "CUDA device"),
    }[fault]


FAULTS = ["silu_y_dtype", "silu_bias_shape", "silu_y_not_contiguous", "silu_y_misaligned",
          "silu_width_not_a_multiple_of_8", "glu_y_shape", "glu_d_not_a_multiple_of_8",
          "glu_lengths_dtype", "glu_even_kernel", "bn_silu_y_dtype", "bn_silu_frames_past_y",
          "bn_silu_bias_shape", "on_the_cpu"]


@pytest.mark.parametrize("fault", FAULTS)
def test_kernel_wrapper_refuses(fault):
    """The kernel's launcher refuses what the kernel does not take, each
    fault by name, before it looks for the card (here it never finds one);
    with autograd on it refuses first; nothing is launched or counted."""
    fn, args, words = _fault(fault)
    launches = AP.launches
    with torch.no_grad(), pytest.raises(ValueError, match=re.escape(words)):
        fn(*args)
    with pytest.raises(RuntimeError, match="autograd"):
        AP._silu_kernel(torch.zeros(2, 8), torch.zeros(8))
    assert AP.launches == launches


def test_kernel_path_writes_bf16_only():
    """A CUDA tensor asks for the kernel, which writes bf16: another compute
    dtype is refused, not computed another way."""
    class FakeCuda:
        is_cuda = True
    with pytest.raises(ValueError, match="writes bf16"):
        AP.silu(FakeCuda(), torch.zeros(8), torch.float32)
    with pytest.raises(ValueError, match="writes bf16"):
        AP.glu(FakeCuda(), torch.zeros(16), torch.zeros(2, dtype=torch.int64), 9, torch.float32)
