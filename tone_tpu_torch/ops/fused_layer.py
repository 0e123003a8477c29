"""One whole Macaron Conformer layer of the streaming step in one kernel
(port of ``tone_tpu/ops/fused_layer.py``).

``fused_conformer_layer`` runs FF1, rotary MHSA (score reuse, sliding
window), the conv module, FF2 and the output RMSNorm for a batch of
streams.  On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/fused_layer.cu`` (one cooperative launch per layer over a grid sized
to the card, tensor-core tiles of several streams) or raises; on a CPU
tensor it runs ``fused_conformer_layer_plain``, the same function in plain
PyTorch with the kernel's rounding points:

* RMSNorm sums in float32, divides by ``rms + 1e-8`` and rounds to bf16;
* every projection takes bf16 operands, sums in float32 and adds the
  float32 bias, giving float32;
* the feed-forward gate ``silu(lin1) * linv`` stays float32 until it is
  the operand of ``lin2``;
* the residual is float32: each sub-block adds ``bf16(res) + bf16(y)``
  (``y`` halved in the feed-forwards), and the RMSNorm that follows reads
  the sum unrounded — where XLA rounds when it runs the JAX kernel (it
  fuses each add into the norm that reads it and stores the residual in
  bf16 for the next add);
* q and k: per-head LayerNorm (eps 1e-5) and RoPE in float32, then bf16;
  the scores are ``dot(q, k)`` in float32 times ``1/sqrt(d_head)``; keys
  before ``invalid`` are set to -1e4 before the float32 softmax and to 0
  after it; the weights are rounded to bf16 before the product with v;
* the conv GLU output is rounded to bf16, the depthwise sum (taps in
  order), its bias, the folded BatchNorm and the SiLU are float32.

``flatten_layer_params`` packs a layer once: its bf16 matrices in one
contiguous buffer, its float32 vectors (BatchNorm folded, RoPE tables for
the layer's lengths) in another, with their offsets in a ctypes structure
that the kernel takes by value.  Heads stay ``d_head`` wide and contiguous
(the TPU kernel's 128-lane head padding and lane-roll RoPE are gone).

``plan_launch`` works out a launch: the grid, every stage's tiles or
items and the layout of the kernel's scratch buffer, from the tile sizes in
``csrc/fused_layer_plan.cuh`` (the kernel compiles the same file).

``fused_conformer_layer.launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
from dataclasses import dataclass

import torch

from tone_tpu_torch.core import layers as L
from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.ops import _build

__all__ = ["FusedLayerWeights", "LaunchPlan", "flatten_layer_params", "fused_conformer_layer",
           "fused_conformer_layer_plain", "ff_split", "kernel_constants", "plan_launch"]

DIM_NAMES = ("t", "window", "d", "f", "n_heads", "rope_dim", "conv_k", "recompute")
MAT_NAMES = ("ff1_w1", "ff1_wv", "ff1_w2", "wq", "wk", "wv", "wout", "pw1", "dw", "pw2",
             "ff2_w1", "ff2_wv", "ff2_w2")
VEC_NAMES = ("n_ff1", "ff1_b1", "ff1_bv", "ff1_b2", "n_att", "bq", "bk", "qln_s", "qln_b",
             "kln_s", "kln_b", "cos_q", "sin_q", "cos_k", "sin_k", "bv", "bout", "n_conv",
             "pw1_b", "dw_b", "bn_scale", "bn_shift", "pw2_b", "n_ff2", "ff2_b1", "ff2_bv",
             "ff2_b2", "n_out")
_RECOMPUTE_ONLY = ("wq", "bq", "wk", "bk", "qln_s", "qln_b", "kln_s", "kln_b",
                   "cos_q", "sin_q", "cos_k", "sin_k")
_ALIGN = 8  # elements: every leaf starts 16-byte aligned in its buffer
# Leaf order of the JAX package's flattened list (flatten_layer_params).
_JAX_ORDER = (
    "n_ff1", "ff1_w1", "ff1_b1", "ff1_wv", "ff1_bv", "ff1_w2", "ff1_b2", "n_att",
    *_RECOMPUTE_ONLY,
    "wv", "bv", "wout", "bout", "n_conv", "pw1", "pw1_b", "dw", "dw_b", "bn_scale",
    "bn_shift", "pw2", "pw2_b", "n_ff2", "ff2_w1", "ff2_b1", "ff2_wv", "ff2_bv",
    "ff2_w2", "ff2_b2", "n_out")


class FusedLayerArgs(ctypes.Structure):
    """The layer's dims and its leaves' element offsets (``struct
    FusedLayerArgs`` of csrc/fused_layer.cu, field for field)."""

    _fields_ = [(name, ctypes.c_int) for name in DIM_NAMES + MAT_NAMES + VEC_NAMES]


class FusedLayerWeights:
    """One layer packed for the kernel: ``mats`` (bf16) and ``vecs``
    (float32), flat and contiguous, and ``args`` with dims and offsets."""

    def __init__(self, mats: torch.Tensor, vecs: torch.Tensor, args: FusedLayerArgs,
                 shapes: dict[str, tuple[int, ...]]):
        self.mats, self.vecs, self.args, self.shapes = mats, vecs, args, shapes

    @property
    def t(self) -> int:
        return self.args.t

    @property
    def window(self) -> int:
        return self.args.window

    @property
    def recompute(self) -> bool:
        return bool(self.args.recompute)

    def names(self) -> list[str]:
        """Leaf names in the order of the JAX package's flattened list."""
        return [n for n in _JAX_ORDER if self.recompute or n not in _RECOMPUTE_ONLY]

    def leaf(self, name: str) -> torch.Tensor:
        """A view of one leaf in its packed buffer."""
        buf = self.mats if name in MAT_NAMES else self.vecs
        shape = self.shapes[name]
        off = getattr(self.args, name)
        return buf[off:off + math.prod(shape)].view(shape)


def _ff_leaves(ff, prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}_{name}": ff[lin][key] for name, lin, key in (
        ("w1", "lin1", "w"), ("b1", "lin1", "b"), ("wv", "linv", "w"), ("bv", "linv", "b"),
        ("w2", "lin2", "w"), ("b2", "lin2", "b"))}


def flatten_layer_params(layer, stats, cfg, *, t: int, window: int, recompute: bool,
                         device: str | torch.device | None = None) -> FusedLayerWeights:
    """Pack one layer's weights for the fused layer (``cfg`` is the
    ``EncoderConfig``): matrices in bf16, vectors in float32, the
    depthwise kernel as (K, D), BatchNorm folded into a scale and shift,
    RoPE tables for queries at ``0..t-1`` and keys from ``-window``."""
    dev = resolve_device(device)
    att, conv = layer["att"], layer["conv"]
    bn, bn_stats = conv["bn"], stats["conv_bn"]
    scale = bn["scale"].float() * torch.rsqrt(bn_stats["var"].float() + 1e-5)
    shift = bn["bias"].float() - bn_stats["mean"].float() * scale
    leaves = {
        "n_ff1": layer["norm_ff1"]["weight"], **_ff_leaves(layer["ff1"], "ff1"),
        "n_att": layer["norm_att"]["weight"],
        "wv": att["linear_v"]["w"], "bv": att["linear_v"]["b"],
        "wout": att["linear_out"]["w"], "bout": att["linear_out"]["b"],
        "n_conv": layer["norm_conv"]["weight"],
        "pw1": conv["pw1"]["w"], "pw1_b": conv["pw1"]["b"],
        "dw": conv["dw"]["w"][:, 0, :].T, "dw_b": conv["dw"]["b"],
        "bn_scale": scale, "bn_shift": shift,
        "pw2": conv["pw2"]["w"], "pw2_b": conv["pw2"]["b"],
        "n_ff2": layer["norm_ff2"]["weight"], **_ff_leaves(layer["ff2"], "ff2"),
        "n_out": layer["norm_out"]["weight"],
    }
    if recompute:
        cpu = torch.device("cpu")
        cos_q, sin_q = L._rope_tables(t, cfg.rope_dim, 0, 10_000.0, torch.float32, cpu)
        cos_k, sin_k = L._rope_tables(window + t, cfg.rope_dim, window, 10_000.0,
                                      torch.float32, cpu)
        leaves.update({
            "wq": att["linear_q"]["w"], "bq": att["linear_q"]["b"],
            "wk": att["linear_k"]["w"], "bk": att["linear_k"]["b"],
            "qln_s": att["q_ln"]["scale"], "qln_b": att["q_ln"]["bias"],
            "kln_s": att["k_ln"]["scale"], "kln_b": att["k_ln"]["bias"],
            "cos_q": cos_q, "sin_q": sin_q, "cos_k": cos_k, "sin_k": sin_k})

    parts = {"mats": [], "vecs": []}
    offsets, shapes = {}, {}
    for name in _JAX_ORDER:
        if name not in leaves:
            continue
        value = leaves[name].detach().to("cpu", torch.float32)
        kind = "mats" if name in MAT_NAMES else "vecs"
        offsets[name] = sum(p.numel() for p in parts[kind])
        shapes[name] = tuple(value.shape)
        flat = value.reshape(-1)
        parts[kind] += [flat, flat.new_zeros((-flat.numel()) % _ALIGN)]
    args = FusedLayerArgs(t=t, window=window, d=cfg.d_model, f=cfg.d_ff, n_heads=cfg.n_heads,
                          rope_dim=cfg.rope_dim, conv_k=cfg.conv_kernel_size,
                          recompute=int(recompute), **offsets)
    return FusedLayerWeights(torch.cat(parts["mats"]).to(torch.bfloat16).to(dev),
                             torch.cat(parts["vecs"]).to(dev), args, shapes)


# ---------------------------------------------------------------------------
# The plain version (CPU tensors, and the comparison on the card).
# ---------------------------------------------------------------------------

_BF16 = torch.bfloat16


def _rms(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = x32.square().sum(dim=-1, keepdim=True).sqrt() / math.sqrt(x.shape[-1])
    return (weight * (x32 / (rms + 1e-8))).to(_BF16)


def _mm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.to(_BF16).float(), w.float()) + b


def _add(res: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The next float32 residual: bf16(res) + bf16(y).  The norm after it
    reads the sum unrounded."""
    return res.to(_BF16).float() + y.to(_BF16).float()


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _ff(res: torch.Tensor, w: FusedLayerWeights, p: str) -> torch.Tensor:
    h = _rms(res, w.leaf(f"n_{p}"))
    g = _silu(_mm(h, w.leaf(f"{p}_w1"), w.leaf(f"{p}_b1"))) \
        * _mm(h, w.leaf(f"{p}_wv"), w.leaf(f"{p}_bv"))
    return _add(res, 0.5 * _mm(g, w.leaf(f"{p}_w2"), w.leaf(f"{p}_b2")))


def _head_ln_rope(y: torch.Tensor, scale, bias, cos, sin, rope_dim: int) -> torch.Tensor:
    """(B, T, H, dh) float32: per-head LayerNorm, then rotate-half RoPE on
    the first ``rope_dim`` features with (T, rope_dim) tables."""
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + 1e-5) * scale + bias
    half = rope_dim // 2
    yr, yp = y[..., :rope_dim], y[..., rope_dim:]
    rot = torch.cat([-yr[..., half:], yr[..., :half]], dim=-1)
    return torch.cat([yr * cos[None, :, None] + rot * sin[None, :, None], yp], dim=-1)


def _check_static(w: FusedLayerWeights, t, window, recompute, n_heads, rope_dim, conv_k):
    a = w.args
    given = (t, window, int(recompute), n_heads, rope_dim, conv_k)
    packed = (a.t, a.window, a.recompute, a.n_heads, a.rope_dim, a.conv_k)
    if given != packed:
        raise ValueError(f"layer called with (t, window, recompute, n_heads, rope_dim, "
                         f"conv_k) = {given}, packed for {packed}")


def fused_conformer_layer_plain(x, conv_state, win, invalid, scores_in, w, *, t: int,
                                window: int, recompute: bool, n_heads: int, rope_dim: int,
                                conv_k: int):
    """The kernel's function in plain PyTorch.

    Args:
        x: (B, T, D); conv_state: (B, K-1, D); win: (B, W, D) or None;
        invalid: (B, 1) int32 count of invalid leading keys, or None;
        scores_in: (B, H, T, W+T) float32 on score-reusing layers, else None.

    Returns:
        (y (B, T, D) in x's dtype, new conv state, new window or None,
        scores (B, H, T, W+T) float32).
    """
    _check_static(w, t, window, recompute, n_heads, rope_dim, conv_k)
    b, _, d = x.shape
    dh = d // n_heads
    tkv = window + t
    res = _ff(x.to(_BF16).float(), w, "ff1")

    a = _rms(res, w.leaf("n_att"))
    new_win = None
    if window:
        winb = win.to(_BF16)
        kv = torch.cat([winb, a], dim=1)
        new_win = torch.cat([winb[:, t:], a], dim=1).to(win.dtype)
    else:
        kv = a
    if recompute:
        q = _mm(a, w.leaf("wq"), w.leaf("bq")).reshape(b, t, n_heads, dh)
        k = _mm(kv, w.leaf("wk"), w.leaf("bk")).reshape(b, tkv, n_heads, dh)
        q = _head_ln_rope(q, w.leaf("qln_s"), w.leaf("qln_b"), w.leaf("cos_q"),
                          w.leaf("sin_q"), rope_dim).to(_BF16)
        k = _head_ln_rope(k, w.leaf("kln_s"), w.leaf("kln_b"), w.leaf("cos_k"),
                          w.leaf("sin_k"), rope_dim).to(_BF16)
        scores = torch.einsum("bqhe,bkhe->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(dh))
    else:
        scores = scores_in
    v = _mm(kv, w.leaf("wv"), w.leaf("bv")).to(_BF16).reshape(b, tkv, n_heads, dh)
    s = scores.float()
    if window:
        cols = torch.arange(tkv, device=x.device)
        mask = (cols[None, :] < invalid.reshape(b, 1))[:, None, None, :]
        attn = torch.softmax(s.masked_fill(mask, -10000.0), dim=-1).masked_fill(mask, 0.0)
    else:
        attn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqk,bkhe->bqhe", attn.to(_BF16).float(), v.float()).reshape(b, t, d)
    res = _add(res, _mm(ctx, w.leaf("wout"), w.leaf("bout")))

    p1 = _mm(_rms(res, w.leaf("n_conv")), w.leaf("pw1"), w.leaf("pw1_b"))
    gl = (p1[..., :d] * torch.sigmoid(p1[..., d:])).to(_BF16)
    padded = torch.cat([conv_state.to(_BF16), gl], dim=1)
    new_conv = padded[:, t:].to(conv_state.dtype)
    p32, dw = padded.float(), w.leaf("dw").float()
    acc = torch.zeros((b, t, d), dtype=torch.float32, device=x.device)
    for tap in range(conv_k):
        acc = acc + p32[:, tap:tap + t] * dw[tap]
    acc = acc + w.leaf("dw_b")
    y = _silu(acc * w.leaf("bn_scale") + w.leaf("bn_shift"))
    res = _add(res, _mm(y, w.leaf("pw2"), w.leaf("pw2_b")))

    res = _ff(res, w, "ff2")
    return _rms(res, w.leaf("n_out")).to(x.dtype), new_conv, new_win, scores


# ---------------------------------------------------------------------------
# The launch plan: grid, stages and scratch, as the kernel walks them.
# ---------------------------------------------------------------------------

PLAN_HEADER = "fused_layer_plan.cuh"
SCRATCH_NAMES = ("res", "act", "hid", "qf", "kf", "v", "part")


@functools.cache
def kernel_constants() -> dict[str, int]:
    """The ``constexpr int FL_*`` tile sizes of ``csrc/fused_layer_plan.cuh``."""
    text = (_build.SOURCE_DIR / PLAN_HEADER).read_text()
    return {name: int(value)
            for name, value in re.findall(r"^constexpr int (FL_\w+) = (\d+);", text, re.M)}


class FusedLayerScratch(ctypes.Structure):
    """Byte offsets of the scratch buffers and its size (``struct
    FusedLayerScratch`` of csrc/fused_layer.cu)."""

    _fields_ = [(name, ctypes.c_longlong) for name in SCRATCH_NAMES + ("total",)]


@dataclass(frozen=True)
class Stage:
    """One stage between grid barriers.  ``unit`` is ``"row"`` (one warp
    per row, rows g, g + warps, ... for global warp g), ``"tile"`` or
    ``"item"`` (one block each, g, g + grid, ... for block g).  A tile
    stage's tiles are its ``products`` ((rows, n, bn) each) in order, each
    numbered row tile major."""

    name: str
    unit: str
    count: int
    products: tuple[tuple[int, int, int], ...] = ()


@dataclass(frozen=True)
class LaunchPlan:
    grid: int                       # blocks of the cooperative launch
    ff_split: int                   # depth slices of the FF down projection
    stages: tuple[Stage, ...]       # in kernel order; "+" joins loops of one stage
    scratch: dict[str, tuple[int, int]]  # name -> (byte offset, bytes)
    scratch_bytes: int

    def scratch_struct(self) -> FusedLayerScratch:
        return FusedLayerScratch(total=self.scratch_bytes,
                                 **{n: off for n, (off, _) in self.scratch.items()})


def ff_split(f: int) -> int:
    """Depth slices of the FF down projection: the most, up to
    FL_FF_SPLIT, that cut d_ff into whole FL_BK steps."""
    c = kernel_constants()
    return max(s for s in range(1, c["FL_FF_SPLIT"] + 1) if f % (s * c["FL_BK"]) == 0)


def plan_launch(args: FusedLayerArgs, batch: int, card_blocks: int) -> LaunchPlan:
    """The launch of one layer at ``batch`` streams on a card that holds
    ``card_blocks`` resident blocks of the kernel (SMs x blocks per SM).
    The grid is the card's, cut to the most blocks any stage can use."""
    c = kernel_constants()
    bm, warps, bn, bn_ff = c["FL_BM"], c["FL_THREADS"] // 32, c["FL_BN"], c["FL_BN_FF"]
    t, w, d, f, h = args.t, args.window, args.d, args.f, args.n_heads
    m, mkv, split = batch * t, batch * (w + t), ff_split(args.f)

    def tiles(name, *products):
        count = sum(-(-rows // bm) * (n // width) for rows, n, width in products)
        return Stage(name, "tile", count, tuple(products))

    def ff(i):
        return [tiles(f"ff{i}_up", (m, f, bn_ff)),
                tiles(f"ff{i}_down", *[(m, d, bn_ff)] * split)]

    # q; then k and v as one product (two weights sharing each A tile)
    q = [(m, d, bn)] if args.recompute else []
    stages = (
        Stage("norm_ff1", "row", m), *ff(1),
        Stage("norm_att", "row", m), Stage("+window_shift", "row", batch * (w - t) if w else 0),
        tiles("qkv", *q, (mkv, d, bn)),
        Stage("attention", "item", batch * h),
        tiles("out", (m, d, bn)),
        Stage("norm_conv", "row", m),
        tiles("pw1", (m, d, bn)),
        Stage("conv", "item", batch * -(-d // c["FL_CONV_COLS"])),
        tiles("pw2", (m, d, bn)),
        Stage("norm_ff2", "row", m), *ff(2),
        Stage("norm_out", "row", m),
    )
    need = max(-(-s.count // warps) if s.unit == "row" else s.count for s in stages)
    sizes = {"res": m * d * 4, "act": m * d * 2, "hid": m * max(f, d) * 2,
             "qf": m * d * 4 if args.recompute else 0,
             "kf": mkv * d * 4 if args.recompute else 0, "v": mkv * d * 2,
             "part": split * m * d * 4}
    align, offset, scratch = c["FL_SCRATCH_ALIGN"], 0, {}
    for name in SCRATCH_NAMES:
        scratch[name] = (offset, sizes[name])
        offset += -(-sizes[name] // align) * align
    return LaunchPlan(grid=max(1, min(card_blocks, need)), ff_split=split, stages=stages,
                      scratch=scratch, scratch_bytes=offset)


@functools.lru_cache(maxsize=1024)
def _launch_params(dims: tuple[int, ...], batch: int,
                   blocks: int) -> tuple[int, int, int, FusedLayerScratch]:
    """(grid, FF down slices, scratch bytes, scratch struct) of plan_launch,
    worked out once per layer shape, batch and card."""
    plan = plan_launch(FusedLayerArgs(**dict(zip(DIM_NAMES, dims))), batch, blocks)
    return plan.grid, plan.ff_split, plan.scratch_bytes, plan.scratch_struct()


# ---------------------------------------------------------------------------
# The kernel wrapper.
# ---------------------------------------------------------------------------


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_layer")
    fn = lib.tone_fused_layer
    if fn.argtypes is None:  # declare once: ctypes would pass ints as 32-bit
        fn.argtypes = ([ctypes.c_void_p] * 7 + [FusedLayerArgs, ctypes.c_int]
                       + [ctypes.c_void_p] * 5
                       + [FusedLayerScratch, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.tone_fused_layer_occupancy
        occ.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        occ.restype = ctypes.c_int
    return lib


_CARD_BLOCKS: dict[int, int] = {}


def card_blocks(device: torch.device) -> int:
    """Resident blocks of the kernel on ``device`` (SMs x blocks per SM, from
    the occupancy query), asked once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CARD_BLOCKS:
        per_sm, sms = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            err = _kernel_lib().tone_fused_layer_occupancy(ctypes.byref(per_sm),
                                                           ctypes.byref(sms))
        if err or per_sm.value < 1:
            raise RuntimeError(f"fused layer kernel cannot launch cooperatively on {device} "
                               f"(cudaError {err}, {per_sm.value} blocks per SM)")
        _CARD_BLOCKS[index] = per_sm.value * sms.value
    return _CARD_BLOCKS[index]


def _require(name: str, t: torch.Tensor | None, shape, dtype, device) -> None:
    if t is None:
        raise ValueError(f"fused layer kernel: {name} is required for this layer")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused layer kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"fused layer kernel: {name} must be {dtype}, not {t.dtype}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"fused layer kernel: {name} must be a contiguous tensor on {device}")
    if t.data_ptr() % 16:
        raise ValueError(f"fused layer kernel: {name} must start 16-byte aligned")


def fused_conformer_layer(x, conv_state, win, invalid, scores_in, w, *, t: int, window: int,
                          recompute: bool, n_heads: int, rope_dim: int, conv_k: int):
    """One fused Conformer layer; arguments and results as
    :func:`fused_conformer_layer_plain`.  CUDA tensors must be bf16 (x,
    conv state, window), int32 (invalid) and float32 (scores), contiguous
    and 16-byte aligned."""
    if x.device.type == "cpu":
        return fused_conformer_layer_plain(
            x, conv_state, win, invalid, scores_in, w, t=t, window=window,
            recompute=recompute, n_heads=n_heads, rope_dim=rope_dim, conv_k=conv_k)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conformer_layer runs on CUDA or CPU tensors, not {x.device}")
    _check_static(w, t, window, recompute, n_heads, rope_dim, conv_k)
    b, d, dev = x.shape[0], w.args.d, x.device
    tkv = window + t
    _require("x", x, (b, t, d), _BF16, dev)
    _require("conv_state", conv_state, (b, conv_k - 1, d), _BF16, dev)
    _require("weights (bf16)", w.mats, w.mats.shape, _BF16, dev)
    _require("weights (float32)", w.vecs, w.vecs.shape, torch.float32, dev)
    if window:
        _require("window", win, (b, window, d), _BF16, dev)
        _require("invalid", invalid, (b, 1), torch.int32, dev)
    if not recompute:
        _require("scores_in", scores_in, (b, n_heads, t, tkv), torch.float32, dev)

    y = torch.empty_like(x)
    new_conv = torch.empty_like(conv_state)
    new_win = torch.empty_like(win) if window else None
    scores = (torch.empty((b, n_heads, t, tkv), dtype=torch.float32, device=dev)
              if recompute else scores_in)
    if b == 0:
        return y, new_conv, new_win, scores
    grid, split, scratch_bytes, layout = _launch_params(
        tuple(getattr(w.args, n) for n in DIM_NAMES), b, card_blocks(dev))
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    # Pointers the kernel does not read for this layer are passed as NULL.
    win_p, inv_p, new_win_p = ((win.data_ptr(), invalid.data_ptr(), new_win.data_ptr())
                               if window else (None, None, None))
    scores_in_p, scores_p = (None, scores.data_ptr()) if recompute else (scores.data_ptr(), None)
    with torch.cuda.device(dev):  # the kernel launches on the current device
        err = _kernel_lib().tone_fused_layer(
            x.data_ptr(), conv_state.data_ptr(), win_p, inv_p, scores_in_p,
            w.mats.data_ptr(), w.vecs.data_ptr(), w.args, b,
            y.data_ptr(), new_conv.data_ptr(), new_win_p, scores_p,
            scratch.data_ptr(), layout, split, grid, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused layer kernel launch failed (cudaError {err})")
    fused_conformer_layer.launches += 1
    return y, new_conv, new_win, scores


fused_conformer_layer.launches = 0
