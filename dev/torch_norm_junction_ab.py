#!/usr/bin/env python3
"""Times the FastConformer's residual-and-norm junction kernel
(``tone_tpu_torch/ops/norm_junction.py``, ``csrc/norm_junction.cu``) at the
shapes of the benchmark's Parakeet cell, on one GPU; or, with
``--attribute``, measures what the eager junction costs in a whole job of
that cell on a checkout that has no kernel.

    python3 dev/torch_norm_junction_ab.py [--iters 50] [--batches 0 1 2 3]
    python3 dev/torch_norm_junction_ab.py --decoder [--iters 50]
    python3 dev/torch_norm_junction_ab.py --attribute [--root DIR]

The shapes are the cell's four batches (``dev/torch_rel_attention_ab.py
cell_batches``): 16 rows of T frames, T the batch's longest call (3,550,
1,142, 763, 491), d_model 1,024, every row computed.  Inputs are seeded:
y float32 products, a bias, x a bf16 residual stream, two LayerNorms.  One
JSON line per batch and form (``single``: after a feed-forward, scale 0.5;
``double``: norm_out then the next norm_ff1; ``last``; ``norm``: the norm
alone) gives:

* ``ms``: the kernel's device time per launch (torch.profiler, back to
  back), ``event_ms`` the same by CUDA events;
* ``bound_ms``: the bytes the form moves over every row (10, 10, 8 or 4 per
  element) at 3.35 TB/s, ``bound_share`` = bound / ms;
* ``plain_ms``: the plain version (the eager composition the card ran
  before the kernel), CUDA events; ``library_ms``: as a yardstick only,
  ``torch.nn.functional.layer_norm`` on the bf16 sum alone (which the port
  never calls), CUDA events;
* the check against the plain version (``against_plain``): x' bit-equal,
  and the normed rows' distance in bf16 ulps (``max_ulps``,
  ``share_one_ulp``) and within the card tests' limit.

``--decoder`` times the kernel at the shapes of the attention decoder
(``core/aed.py``) instead: 16 rows of one position (a decode step) or of
8 (the prompt's prefill), d 1,024, scale 1, in the forms the decoder runs
(``decoder_cases``), with the same fields.

``--attribute`` runs one warm job of the cell's 64 calls (random full-width
weights and int16 noise of the calls' lengths) through ``OfflineTranscriber``
of the checkout at ``--root`` (default: this one) under the profiler,
with the eager junction's parts annotated: the five LayerNorms, the four
sublayer-final bias passes, and the feed-forwards' scales and the residual
adds.  It prints their device seconds beside the job's busy time.  It
needs the eager path (a checkout before the kernel).

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
D_MODEL, BATCH = 1024, 16
FORM_SCALES = {"single": 0.5, "double": 0.5, "last": 0.5, "norm": None}


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


def junction_inputs(rows: int, frames: int, d: int, gen, y_frames: int | None = None) -> dict:
    """Seeded inputs on the card: y (rows, y_frames, d) float32 of a
    product's size, the bias, x (rows, frames, d) bf16 of a residual
    stream's, and two LayerNorms near their initial values."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    norm = [{"scale": 1 + 0.1 * randn(d), "bias": 0.1 * randn(d)} for _ in range(2)]
    return {"y": randn(rows, y_frames or frames, d), "bias": 0.5 * randn(d),
            "x": (4 * randn(rows, frames, d)).to(torch.bfloat16), "norm": norm[0],
            "next_norm": norm[1]}


def run_form(form: str, inputs: dict, plain: bool = False):
    """The junction of ``form`` on ``inputs`` (its scale ``FORM_SCALES``'
    unless ``inputs`` holds one): its two outputs (the second None where
    the form writes one); the plain version with ``plain``."""
    from tone_tpu_torch.core import layers as L
    from tone_tpu_torch.ops import norm_junction as NJ

    if form == "norm":
        x, norm = inputs["x"], inputs["norm"]
        return (L.layernorm(norm, x) if plain else NJ.layer_norm(x, norm)), None
    fn = NJ.norm_junction_plain if plain else NJ.norm_junction
    scale = inputs.get("scale", FORM_SCALES[form])
    return fn(inputs["y"], inputs["bias"], inputs["x"], scale, inputs["norm"],
              inputs["next_norm"] if form == "double" else None,
              layer_end=form in ("double", "last"))


def ulps(a, b):
    """Distance of two bf16 tensors in units in the last place (their bit
    patterns in order; +0 and -0 are one value)."""
    import torch

    def ordered(t):
        v = t.contiguous().view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return (ordered(a) - ordered(b)).abs()


# The card tests' limit on a normed element (tests/test_torch_norm_junction_gpu.py):
# one bf16 ulp, or 2^-20 of the row's RMS where the float32 sums' order
# moves a value near zero by more than its ulp.
FLOOR = 2.0 ** -20


def within_norm_limit(kernel, plain) -> tuple[bool, dict]:
    """Whether each element of ``kernel`` (a normed bf16 row) lies within
    one ulp of ``plain``, or within ``FLOOR`` of the row's RMS; and the
    distances."""
    dist = ulps(kernel, plain)
    diff = (kernel.float() - plain.float()).abs()
    rms = plain.float().square().mean(dim=-1, keepdim=True).sqrt()
    ok = (dist <= 1) | (diff <= FLOOR * rms)
    n = dist.numel()
    return bool(ok.all()), {"max_ulps": int(dist.max()),
                            "share_one_ulp": float((dist == 1).sum()) / n,
                            "beyond_one_ulp": int((dist > 1).sum()),
                            "beyond_one_ulp_max_share_of_rms":
                                float((diff / rms)[dist > 1].max()) if bool((dist > 1).any())
                                else 0.0}


def against_plain(form: str, inputs: dict) -> dict:
    """The kernel against the plain version on the same inputs: ``single``'s
    x' bit-equal; each normed output within ``within_norm_limit`` of the
    plain norm of the kernel's own input to it."""
    import torch

    from tone_tpu_torch.core import layers as L

    a, b = run_form(form, inputs)
    pa, pb = run_form(form, inputs, plain=True)
    out = {}
    if form == "single":
        out["x_bit_equal"] = bool(torch.equal(a, pa))
        ok, stats = within_norm_limit(b, pb)
    else:
        ok, stats = within_norm_limit(a, pa)
        if form == "double":
            ok2, stats2 = within_norm_limit(b, L.layernorm(inputs["next_norm"], a))
            ok = ok and ok2
            out["second_norm"] = stats2
    out.update(stats)
    out["within_limits"] = ok and out.get("x_bit_equal", True)
    return out


def bound_ms(form: str, rows: int, frames: int, d: int) -> float:
    from tone_tpu_torch.ops import norm_junction as NJ

    return rows * frames * d * NJ.JUNCTION_BYTES[form] / HBM_BYTES_PER_S * 1e3


def attribute(root: Path) -> dict:
    """Device seconds of the eager junction's parts in one warm job of the
    cell, on the checkout at ``root`` (see the module docstring)."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "benchmark"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tone_tpu_torch.config import FastConformerConfig
    from tone_tpu_torch.core import fastconformer as FC
    from tone_tpu_torch.core import layers as L
    from tone_tpu_torch.offline import OfflineTranscriber
    from traffic.bulk import call_lengths

    if hasattr(FC, "norm_junction"):
        raise SystemExit("--attribute needs the eager junction (a checkout before the kernel)")
    cfg = FastConformerConfig()
    variables = FC.init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    work = json.loads((root / "benchmark/workloads/parakeet-ctc-1.1b.bulk-calls.json")
                      .read_text())["params"]
    rng = np.random.default_rng(0)
    calls = [rng.integers(-8000, 8000, int(n) * 2).astype(np.int16) for n in call_lengths(work)]
    tr = OfflineTranscriber(variables, cfg, batch_size=BATCH, use_offline_forward=True)
    finals = set()
    for layer in tr.variables["params"]["encoder"]["layers"]:
        finals |= {id(layer["ff1"]["linear2"]), id(layer["att"]["linear_out"]),
                   id(layer["conv"]["pw2"]), id(layer["ff2"]["linear2"])}
    linear, layernorm = L.linear, L.layernorm

    def annotated_linear(p, x, compute_dtype=torch.bfloat16, reduce=None):
        if id(p) not in finals:
            return linear(p, x, compute_dtype, reduce)
        w = p["w"]
        x, w = x.to(compute_dtype), w.to(compute_dtype)
        tc = L._products_on_tensor_cores(x, w)
        y = L._product(x, w, tc)
        with record_function("junction.bias"):
            return L._add_bias(y, p["b"].float(), compute_dtype, tc)

    def annotated_layernorm(p, x, eps=1e-5):
        with record_function("junction.layernorm"):
            return layernorm(p, x, eps)

    def annotated_layer(p, stats, x, pos, lengths, pad, host_lengths, config, dtype):
        e = config.encoder
        r = FC._feed_forward(p["ff1"], L.layernorm(p["norm_ff1"], x), dtype)
        with record_function("junction.residual"):
            x = x + r * 0.5
        r = L.rel_mhsa_blocked(p["att"], L.layernorm(p["norm_att"], x), pos, n_heads=e.n_heads,
                               lengths=lengths, host_lengths=host_lengths, compute_dtype=dtype)
        with record_function("junction.residual"):
            x = x + r
        r = FC._conv_module(p["conv"], stats["conv_bn"], L.layernorm(p["norm_conv"], x), pad,
                            e.conv_kernel_size, dtype)
        with record_function("junction.residual"):
            x = x + r
        r = FC._feed_forward(p["ff2"], L.layernorm(p["norm_ff2"], x), dtype)
        with record_function("junction.residual"):
            x = x + r * 0.5
        return L.layernorm(p["norm_out"], x)

    L.linear, L.layernorm, FC._layer = annotated_linear, annotated_layernorm, annotated_layer
    with torch.no_grad():
        tr.logprobs(calls)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.logprobs(calls)
            torch.cuda.synchronize()
    def kernels(event) -> int:
        return len(event.kernels) + sum(kernels(c) for c in event.cpu_children)

    parts = {"junction.layernorm": 0.0, "junction.bias": 0.0, "junction.residual": 0.0}
    launches = dict.fromkeys(parts, 0)
    kernel_s = 0.0
    for e in prof.events():
        if e.name in parts:
            parts[e.name] += e.device_time_total / 1e6
            launches[e.name] += kernels(e)
        elif e.device_type.name == "CUDA":
            kernel_s += e.self_device_time_total / 1e6
    return {"module": FC.__file__, "job_audio_s": sum(len(c) for c in calls) / 16000,
            "device_s": parts, "junction_s": sum(parts.values()),
            "all_kernels_s": kernel_s, "launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batches", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--attribute", action="store_true")
    ap.add_argument("--decoder", action="store_true")
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    if args.attribute:
        sys.path.insert(0, str(args.root))
        print(json.dumps(_rel_attention_ab().card()), flush=True)
        print(json.dumps(attribute(args.root)), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    print(json.dumps(_rel_attention_ab().card()), flush=True)
    lines = decoder_cases(args.iters) if args.decoder else \
        time_cases(cell_batches(), args.batches, args.iters)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


def time_cases(batches, indices, iters: int) -> list[dict]:
    """One line per batch and form (see the module docstring)."""
    import torch
    import torch.nn.functional as F

    ab = _rel_attention_ab()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    with torch.no_grad():
        for index in indices:
            lengths = batches[index]
            frames = max(lengths)
            inputs = junction_inputs(len(lengths), frames, D_MODEL, gen)
            x_sum = run_form("single", inputs, plain=True)[0]
            for form in FORM_SCALES:
                def kernel():
                    return run_form(form, inputs)

                def plain():
                    return run_form(form, inputs, plain=True)

                def library():
                    return F.layer_norm(x_sum, (D_MODEL,), inputs["norm"]["scale"].to(x_sum.dtype),
                                        inputs["norm"]["bias"].to(x_sum.dtype), 1e-5)

                ms = ab.device_ms(kernel, iters, "norm_junction_kernel")
                bound = bound_ms(form, len(lengths), frames, D_MODEL)
                lines.append({"rows": len(lengths), "frames": frames, "valid": sum(lengths),
                              "d_model": D_MODEL, "form": form, **against_plain(form, inputs),
                              "ms": ms, "event_ms": ab.event_ms(kernel, iters), "bound_ms": bound,
                              "bound_by": "bytes", "bound_share": bound / ms,
                              "plain_ms": ab.event_ms(plain, 5),
                              "library_ms": ab.event_ms(library, iters)})
            del inputs, x_sum
        torch.cuda.empty_cache()
    return lines


# The attention decoder's passes (core/aed.py _pass): positions a pass of
# its 16 rows runs.
DECODER_SHAPES = {"step": 1, "prefill": 8}
# The junctions of a decoder pass, as (case, form): after each sublayer
# (scale 1) into the next one's norm (each layer's norm_cross_att and
# norm_ff, the next layer's norm_self_att), after the last layer into
# LN_final, and the first layer's norm_self_att alone on the embedding.
DECODER_JUNCTIONS = (("into_next_norm", "single"), ("into_final_norm", "single"),
                     ("first_norm", "norm"))


def decoder_cases(iters: int) -> list[dict]:
    """One line per decoder shape and junction (see the module docstring):
    each held to the plain version, timed and bounded as ``time_cases``'."""
    import torch

    ab = _rel_attention_ab()
    gen = torch.Generator(device="cuda").manual_seed(1)
    lines = []
    with torch.no_grad():
        for shape, frames in DECODER_SHAPES.items():
            for case, form in DECODER_JUNCTIONS:
                inputs = {**junction_inputs(BATCH, frames, D_MODEL, gen), "scale": 1.0}

                def kernel():
                    return run_form(form, inputs)

                def plain():
                    return run_form(form, inputs, plain=True)

                ms = ab.device_ms(kernel, iters, "norm_junction_kernel")
                bound = bound_ms(form, BATCH, frames, D_MODEL)
                lines.append({"shape": shape, "case": case, "rows": BATCH, "frames": frames,
                              "d_model": D_MODEL, "form": form, **against_plain(form, inputs),
                              "ms": ms, "event_ms": ab.event_ms(kernel, iters),
                              "bound_ms": bound, "bound_by": "bytes",
                              "bound_share": bound / ms, "plain_ms": ab.event_ms(plain, iters)})
    return lines


if __name__ == "__main__":
    sys.exit(main())
