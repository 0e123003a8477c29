#!/usr/bin/env python3
"""Times a kernel of the PyTorch port in several checkouts against each
other, on one GPU: the fused Conformer layer (kernel B2, the default) or the
fused GLU feed-forward (kernel B1).

    python3 dev/torch_fused_layer_ab.py --roots OLD NEW NEW OLD [--batches 64 16 1]
    python3 dev/torch_fused_layer_ab.py --kernel glu_ff2 --roots OLD NEW NEW OLD \
        [--ms 80 160 320 640 2560]

Each root is a directory that holds a ``tone_tpu_torch`` package (a checkout
or a ``git archive`` of one).  The roots run in the order given, each in a
process of its own that builds its kernel, on the same inputs: for B2 the
full-width ``ToneConfig()`` weights (random, seed 0) and seeded inputs for
the six layer kinds of the step at each batch; for B1 seeded av, W2 and b
at F = 1536, D = 384 for each row count M.  One JSON line per (root, kind,
batch) or (root, M) gives the mean of back-to-back launches timed by CUDA
events (``ms``; the host's share included where the host is slower) and
the kernel's own mean device time from ``torch.profiler`` (``device_ms``).
The first line names the card and its power limit (nvidia-smi).

With ``--stages`` (B2 only) each root's kernel is built with
``-DFL_STAGE_CLOCK`` (a root whose ``csrc/fused_layer.cu`` has the stage
clock), and each line also gives ``stages_us``: the time between the grid
barriers of the last launch, stage by stage, read from the global timer by
block 0.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# The kernel's stages between grid barriers, in order (csrc/fused_layer.cu).
STAGES = ("norm_ff1", "ff1_up", "ff1_down", "norm_att", "qkv", "attention", "out",
          "norm_conv", "pw1", "conv", "pw2", "norm_ff2", "ff2_up", "ff2_down", "norm_out")
# Layer of each kind in ToneConfig() (as chip_smoke.py's FUSED_KINDS).
KINDS = {"stateless_recompute_t10": 0, "stateless_reuse_t10": 1,
         "stateless_recompute_t5": 7, "stateless_reuse_t5": 8,
         "stateful_w15": 14, "stateful_w30": 15}


def time_launches(run, iters: int, kernel_name: str) -> tuple[float, float]:
    """(CUDA-event ms, profiler device ms) per launch of ``run`` over
    ``iters`` back-to-back launches, after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    kernel = [ev for ev in prof.key_averages()
              if ev.device_type.name == "CUDA" and kernel_name in ev.key]
    device_ms = (sum(ev.self_device_time_total for ev in kernel) / 1e3
                 / max(1, sum(ev.count for ev in kernel)))
    return start.elapsed_time(end) / iters, device_ms


def glu_worker(root: str, ms: list[int], iters: int) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from tone_tpu_torch.device import resolve_device
    from tone_tpu_torch.ops import glu_ff as G

    if not G.__file__.startswith(root.rstrip("/") + "/"):
        raise RuntimeError(f"imported {G.__file__}, not the package under {root}")
    resolve_device("cuda")
    f, d = 1536, 384
    for m in ms:
        gen = torch.Generator(device="cuda").manual_seed(m)
        av = torch.randn(m, 2 * f, device="cuda", generator=gen).to(torch.bfloat16)
        p2 = {"w": (torch.randn(f, d, device="cuda", generator=gen) * 0.02).to(torch.bfloat16),
              "b": torch.randn(d, device="cuda", generator=gen) * 0.01}
        err = (G.glu_ff2(av, p2).float() - G.glu_ff2_plain(av, p2).float()).abs().max().item()
        event_ms, device_ms = time_launches(lambda: G.glu_ff2(av, p2), iters, "glu_ff2_kernel")
        print(json.dumps({"root": root, "kernel": "glu_ff2", "m": m, "ms": event_ms,
                          "device_ms": device_ms, "max_abs_err": err}), flush=True)


def worker(root: str, batches: list[int], iters: int, stages: bool) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import ctypes

    import torch

    from tone_tpu_torch.ops import _build

    if stages:
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DFL_STAGE_CLOCK")

    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.device import resolve_device
    from tone_tpu_torch.ops import fused_layer as FL
    from tone_tpu_torch.ops.fused_encoder import _layer_static

    if not FL.__file__.startswith(root.rstrip("/") + "/"):
        raise RuntimeError(f"imported {FL.__file__}, not the package under {root}")
    resolve_device("cuda")
    cfg = ToneConfig()
    e = cfg.encoder
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    for kind, layer in KINDS.items():
        st = _layer_static(e, layer)
        t, win = st["t"], st["window"]
        w = FL.flatten_layer_params(variables["params"]["encoder"]["layers"][layer],
                                    variables["batch_stats"]["layers"][layer], e, t=t,
                                    window=win, recompute=st["recompute"], device="cuda")
        static = dict(t=t, window=win, recompute=st["recompute"], n_heads=e.n_heads,
                      rope_dim=e.rope_dim, conv_k=e.conv_kernel_size)
        for b in batches:
            gen = torch.Generator(device="cuda").manual_seed(b)

            def rand(*shape):
                return torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)

            args = (rand(b, t, e.d_model), rand(b, e.conv_kernel_size - 1, e.d_model),
                    rand(b, win, e.d_model) if win else None,
                    torch.randint(0, win + 1, (b, 1), device="cuda", generator=gen,
                                  dtype=torch.int32) if win else None,
                    None if st["recompute"] else
                    2.0 * torch.randn(b, e.n_heads, t, win + t, device="cuda", generator=gen))

            def run():
                return FL.fused_conformer_layer(*args, w, **static)

            event_ms, device_ms = time_launches(run, iters, "fused_layer_kernel")
            row = {"root": root, "kind": kind, "layer": layer, "batch": b,
                   "ms": event_ms, "device_ms": device_ms}
            if stages:
                ns = (ctypes.c_ulonglong * (len(STAGES) + 1))()
                if FL._kernel_lib().tone_fused_layer_stage_ns(ns):
                    raise RuntimeError("reading the stage clock failed")
                row["stages_us"] = {name: (ns[i + 1] - ns[i]) / 1e3
                                    for i, name in enumerate(STAGES)}
            print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("fused_layer", "glu_ff2"), default="fused_layer")
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--batches", nargs="+", type=int, default=[64, 16, 1],
                    help="fused_layer: streams per launch")
    ap.add_argument("--ms", nargs="+", type=int, default=[80, 160, 320, 640, 2560],
                    help="glu_ff2: rows per launch")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--stages", action="store_true",
                    help="fused_layer: build with the stage clock and report time per stage")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.stages and a.kernel != "fused_layer":
        ap.error("--stages applies to the fused_layer kernel")
    if a.worker:
        if a.kernel == "glu_ff2":
            glu_worker(a.worker, a.ms, a.iters)
        else:
            worker(a.worker, a.batches, a.iters, a.stages)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"nvidia_smi": smi.stdout.strip()}), flush=True)
    for root in a.roots:
        subprocess.run([sys.executable, __file__, "--kernel", a.kernel, "--roots", root,
                        "--worker", root, "--batches", *map(str, a.batches),
                        "--ms", *map(str, a.ms), "--iters", str(a.iters),
                        *(["--stages"] if a.stages else [])], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
