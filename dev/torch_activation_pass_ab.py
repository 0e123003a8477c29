#!/usr/bin/env python3
"""Times the FastConformer's activation-pass kernel
(``tone_tpu_torch/ops/activation_pass.py``, ``csrc/activation_pass.cu``) at
the shapes of the benchmark's Parakeet cell, on one GPU, and checks what
runs between the products of the sublayers it serves.

    python3 dev/torch_activation_pass_ab.py [--iters 50] [--batches 0 1 2 3]

The shapes are the cell's four batches (``dev/torch_rel_attention_ab.py
cell_batches``): 16 rows of T frames, T the batch's longest call (3,550,
1,142, 763, 491), d_model 1,024, d_ff 4,096, conv kernel 9, every row
computed.  Inputs are seeded: float32 products and biases, the depthwise
convolution's bf16 output, a batch norm with running statistics.  One
JSON line per batch and form (``silu``: after linear1; ``glu``: after pw1,
into the depthwise convolution's layout; ``bn_silu``: after the depthwise
convolution, into pw2's layout) gives:

* ``ms``: the kernel's device time per launch (torch.profiler, back to
  back), ``event_ms`` the same by CUDA events;
* ``bound_ms``: the bytes the form moves at 3.35 TB/s (silu 6 bytes an
  element of every row; glu 8 read for each row's valid frames and 2
  written over its whole (d, padded frames) output; bn_silu 4 an element of
  every row), ``bound_share`` = bound / ms;
* ``plain_ms``: the plain version (the eager chain the card ran before the
  kernel), CUDA events; ``library_ms``: as a yardstick only, one PyTorch
  call on the already biased bf16 input (``F.silu``, ``F.glu``; for
  bn_silu ``F.silu`` on the bf16 convolution output), which the port
  never calls, CUDA events;
* the check against the plain version (``against_plain``): the share of
  elements bit-equal, the largest distance in bf16 ulps and the share one
  ulp off, within the card tests' limits (at most one ulp, at a share under
  1e-5).

Then one line per batch with the sublayers around the passes
(``chain``): ``fastconformer._feed_forward`` and ``_conv_module`` (products
included) against the eager chains they replaced (CUDA events, ``ff_ms``
against ``ff_eager_ms``, ``conv_ms`` against ``conv_eager_ms``), and the
device kernels the new sublayers and the eager ones ran by name
(``kernels``, ``eager_kernels``), none of the new ones PyTorch's
dynamic-cast ``elementwise_kernel<128, 4>`` or a ``direct_copy`` kernel
(``leftover``).

The first line names the card and its power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

HBM_BYTES_PER_S = 3.35e12
D_MODEL, D_FF, KERNEL, BATCH = 1024, 4096, 9, 16
FORMS = ("silu", "glu", "bn_silu")
# Kernels that must not run between the products the passes serve:
# PyTorch's dynamic-cast loop (the float32 bias passes) and its copies.
LEFTOVER = ("elementwise_kernel<128, 4", "direct_copy")


@functools.cache
def _rel_attention_ab():
    """dev/torch_rel_attention_ab.py, whose batches, timers and card line
    this script shares."""
    path = Path(__file__).resolve().parent / "torch_rel_attention_ab.py"
    spec = importlib.util.spec_from_file_location("torch_rel_attention_ab", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_batches() -> list[list[int]]:
    """The Parakeet cell's batches as output frames, longest batch first."""
    return _rel_attention_ab().cell_batches()


def form_inputs(form: str, lengths, gen, d: int = D_MODEL, d_ff: int = D_FF,
                kernel: int = KERNEL) -> dict:
    """Seeded inputs on the card for rows of ``lengths`` frames (the batch's
    frames the longest): silu's (rows, T, d_ff) and glu's (rows, T, 2d)
    float32 products with their biases; bn_silu's (rows, d, Tc) bf16
    convolution output (Tc the convolution's frames over glu's layout),
    its bias and a batch norm."""
    import torch

    from tone_tpu_torch.ops import activation_pass as AP

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    rows, t = len(lengths), max(lengths)
    if form == "silu":
        return {"y": 2 * randn(rows, t, d_ff), "bias": 0.5 * randn(d_ff)}
    if form == "glu":
        return {"y": 2 * randn(rows, t, 2 * d), "bias": 0.5 * randn(2 * d),
                "lengths": torch.tensor(lengths, device="cuda"), "kernel": kernel}
    tc = AP.padded_frames(t, kernel) - kernel + 1
    return {"y": (2 * randn(rows, d, tc)).to(torch.bfloat16), "bias": 0.5 * randn(d),
            "bn": {"scale": 1 + 0.2 * randn(d), "bias": 0.2 * randn(d)},
            "stats": {"mean": 0.3 * randn(d), "var": 0.5 + randn(d).abs()}, "frames": t}


def run_form(form: str, inputs: dict, plain: bool = False):
    """The pass of ``form`` on ``inputs``; the plain version with ``plain``."""
    from tone_tpu_torch.ops import activation_pass as AP

    fn = getattr(AP, f"{form}_plain" if plain else form)
    if form == "silu":
        return fn(inputs["y"], inputs["bias"])
    if form == "glu":
        return fn(inputs["y"], inputs["bias"], inputs["lengths"], inputs["kernel"])
    return fn(inputs["y"], inputs["bias"], inputs["bn"], inputs["stats"], inputs["frames"])


def ulps(a, b):
    """Distance of two bf16 tensors in units in the last place (their bit
    patterns in order; +0 and -0 are one value)."""
    import torch

    def ordered(t):
        v = t.contiguous().view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return (ordered(a) - ordered(b)).abs()


# The card tests' limit: at most one bf16 ulp from the plain version, at a
# share of elements under this.
ONE_ULP_SHARE = 1e-5


def against_plain(form: str, inputs: dict) -> dict:
    """The kernel against the plain version on the same inputs: same shape
    and layout, each element within one bf16 ulp, at a share under
    ``ONE_ULP_SHARE``."""
    a, p = run_form(form, inputs), run_form(form, inputs, plain=True)
    same_layout = a.shape == p.shape and a.stride() == p.stride() and a.dtype == p.dtype
    dist = ulps(a, p)
    n = dist.numel()
    out = {"same_layout": same_layout, "bit_equal_share": float((dist == 0).sum()) / n,
           "max_ulps": int(dist.max()), "share_one_ulp": float((dist == 1).sum()) / n}
    out["within_limits"] = (same_layout and out["max_ulps"] <= 1
                            and out["share_one_ulp"] < ONE_ULP_SHARE)
    return out


def bound_bytes(form: str, lengths, d: int = D_MODEL, d_ff: int = D_FF,
                kernel: int = KERNEL) -> int:
    """The bytes the form must move over the batch (module docstring)."""
    from tone_tpu_torch.ops import activation_pass as AP

    rows, t = len(lengths), max(lengths)
    if form == "silu":
        return rows * t * d_ff * AP.FORM_BYTES["silu"]
    if form == "glu":
        return sum(lengths) * d * 8 + rows * d * AP.padded_frames(t, kernel) * 2
    return rows * t * d * AP.FORM_BYTES["bn_silu"]


def library_call(form: str, inputs: dict):
    """The yardstick's call (module docstring) on a bf16 input made once."""
    import torch
    import torch.nn.functional as F

    if form == "silu":
        x = (inputs["y"] + inputs["bias"]).to(torch.bfloat16)
        return lambda: F.silu(x)
    if form == "glu":
        x = (inputs["y"] + inputs["bias"]).to(torch.bfloat16)
        return lambda: F.glu(x, dim=-1)
    x = inputs["y"]
    return lambda: F.silu(x)


def time_cases(batches, indices, iters: int) -> list[dict]:
    """One line per batch and form (see the module docstring)."""
    import torch

    ab = _rel_attention_ab()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    with torch.no_grad():
        for index in indices:
            lengths = batches[index]
            for form in FORMS:
                inputs = form_inputs(form, lengths, gen)

                def kernel():
                    return run_form(form, inputs)

                def plain():
                    return run_form(form, inputs, plain=True)

                ms = ab.device_ms(kernel, iters, "activation_pass_kernel")
                bound = bound_bytes(form, lengths) / HBM_BYTES_PER_S * 1e3
                lines.append({"rows": len(lengths), "frames": max(lengths),
                              "valid": sum(lengths), "d_model": D_MODEL, "d_ff": D_FF,
                              "form": form, **against_plain(form, inputs), "ms": ms,
                              "event_ms": ab.event_ms(kernel, iters), "bound_ms": bound,
                              "bound_by": "bytes", "bound_share": bound / ms,
                              "plain_ms": ab.event_ms(plain, 5),
                              "library_ms": ab.event_ms(library_call(form, inputs), iters)})
                del inputs
            torch.cuda.empty_cache()
    return lines


def sublayer_params(gen) -> tuple[dict, dict, dict]:
    """A feed-forward, a convolution module and its batch statistics at the
    published widths on the card, matrices in bf16 as the transcriber holds
    them."""
    import torch

    from tone_tpu_torch.core import layers as L

    def card(tree):
        return {k: card(v) if isinstance(v, dict) else
                v.to("cuda", torch.bfloat16 if k == "w" and v.ndim >= 2 else torch.float32)
                for k, v in tree.items()}

    ff = {"linear1": L.init_linear(gen, D_MODEL, D_FF),
          "linear2": L.init_linear(gen, D_FF, D_MODEL)}
    conv = {"pw1": L.init_linear(gen, D_MODEL, 2 * D_MODEL),
            "dw": L.init_conv(gen, D_MODEL, 1, (KERNEL,)),
            "bn": {"scale": 1 + 0.2 * torch.randn(D_MODEL, generator=gen),
                   "bias": 0.2 * torch.randn(D_MODEL, generator=gen)},
            "pw2": L.init_linear(gen, D_MODEL, D_MODEL)}
    stats = {"mean": 0.3 * torch.randn(D_MODEL, generator=gen),
             "var": 0.5 + torch.rand(D_MODEL, generator=gen)}
    return card(ff), card(conv), card(stats)


def eager_feed_forward(p, x, dtype):
    """The feed-forward as the card ran it before the kernel."""
    from tone_tpu_torch.core import layers as L

    return L.linear_product(p["linear2"], L.silu(L.linear(p["linear1"], x, dtype)), dtype)


def eager_conv_module(p, stats, x, lengths, kernel, dtype):
    """The convolution module as the card ran it before the kernel."""
    import torch
    import torch.nn.functional as F

    from tone_tpu_torch.core import layers as L

    pad = torch.arange(x.shape[1], device=x.device)[None] >= lengths[:, None]
    y = L.glu(L.linear(p["pw1"], x, dtype), dim=-1).masked_fill_(pad[:, :, None], 0.0)
    y = F.pad(y, (0, 0, (kernel - 1) // 2, (kernel - 1) // 2))
    y = L.conv1d_nhc(p["dw"], y, stride=1, groups=y.shape[-1], compute_dtype=dtype)
    y, _ = L.batchnorm(p["bn"], stats, y, channel_axis=2)
    return L.linear_product(p["pw2"], L.silu(y), dtype)


def kernel_names(fn) -> list[str]:
    """The device kernels one call of ``fn`` runs, by name, in order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type().name == "CUDA"]


def chain_cases(batches, indices, iters: int) -> list[dict]:
    """One line per batch: the sublayers around the passes against the eager
    chains, and the kernels they run (module docstring)."""
    import torch

    from tone_tpu_torch.core import fastconformer as FC

    ab = _rel_attention_ab()
    gen = torch.Generator().manual_seed(1)
    ff, conv, stats = sublayer_params(gen)
    cuda_gen = torch.Generator(device="cuda").manual_seed(2)
    dtype = torch.bfloat16
    lines = []
    with torch.no_grad():
        for index in indices:
            lengths = batches[index]
            x = torch.randn(len(lengths), max(lengths), D_MODEL, device="cuda",
                            generator=cuda_gen).to(dtype)
            dev_lengths = torch.tensor(lengths, device="cuda")
            runs = {"ff": lambda: FC._feed_forward(ff, x, dtype),
                    "ff_eager": lambda: eager_feed_forward(ff, x, dtype),
                    "conv": lambda: FC._conv_module(conv, stats, x, dev_lengths, KERNEL, dtype),
                    "conv_eager": lambda: eager_conv_module(conv, stats, x, dev_lengths, KERNEL,
                                                            dtype)}
            ms = {f"{name}_ms": ab.event_ms(fn, iters) for name, fn in runs.items()}
            names = kernel_names(runs["ff"]) + kernel_names(runs["conv"])
            eager = kernel_names(runs["ff_eager"]) + kernel_names(runs["conv_eager"])
            lines.append({"chain": True, "rows": len(lengths), "frames": max(lengths), **ms,
                          "ff_equal": bool(torch.equal(runs["ff"](), runs["ff_eager"]())),
                          "conv_equal": bool(torch.equal(runs["conv"](), runs["conv_eager"]())),
                          "kernels": names, "eager_kernels": eager,
                          "leftover": [n for n in names if any(s in n for s in LEFTOVER)]})
            del x
            torch.cuda.empty_cache()
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batches", type=int, nargs="*", default=[0, 1, 2, 3])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    print(json.dumps(_rel_attention_ab().card()), flush=True)
    batches = cell_batches()
    for line in time_cases(batches, args.batches, args.iters) + \
            chain_cases(batches, args.batches, max(5, args.iters // 5)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
