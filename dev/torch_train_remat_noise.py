#!/usr/bin/env python3
"""How far apart two gradients of one train step lie on the GPU: without
remat run twice, and with ``remat="full"`` and ``"dots"``, at the full
width of ``ToneConfig()`` on chip_smoke.py's train batch.

    python3 dev/torch_train_remat_noise.py [--trials 3] [--steps 15] [--profile 3]

Trains ``--steps`` steps from the seed-0 weights (the last ``--profile`` of
them under torch.profiler, as chip_smoke.py's train phase does), then,
``--trials`` times and with cuDNN's default and deterministic algorithms,
computes the step's gradients (dropout on, one seed) without remat twice
and once with each policy.  One JSON line per (setting, trial) gives
|Δg| / |g| of the gradients against the first no-remat run and the leaves
that hold most of |Δg|².  The first line names the card and its power limit (nvidia-smi);
the second gives the float32 matmul settings and a float32 product as seen
on the main thread, in a backward (autograd's device thread) and in a
forward recomputed by ``torch.utils.checkpoint`` during the backward.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def probe_threads() -> dict:
    """The float32 matmul settings and one float32 product on the main
    thread, in a backward and in a checkpointed forward's recomputation."""
    import threading

    import torch
    import torch.utils.checkpoint as ckpt

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(512, 512, device="cuda", generator=gen)
    b = torch.randn(512, 512, device="cuda", generator=gen)
    seen = {}

    def look(where):
        seen[where] = {"thread": threading.get_ident(),
                       "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                       "float32_matmul_precision": torch.get_float32_matmul_precision(),
                       "product": (a @ b).cpu()}

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            look("backward")
            return g

    calls = []

    def region(x):
        calls.append(1)
        look("forward" if len(calls) == 1 else "recompute")
        y = x.exp()
        return (y * y).sum()   # saves y: the backward recomputes the region

    look("main")
    x = torch.ones(4, device="cuda", requires_grad=True)
    Probe.apply(x).sum().backward()
    ckpt.checkpoint(region, x, use_reentrant=False).backward()
    main = seen["main"].pop("product")
    out = {}
    for where, flags in seen.items():
        if where != "main":
            flags["product_equals_main"] = bool(torch.equal(flags.pop("product"), main))
        out[where] = flags
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trials", type=int, default=3)
    parser.add_argument("--steps", type=int, default=15)
    parser.add_argument("--profile", type=int, default=0,
                        help="profile the last this many of the steps")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.training import DataCollatorCTCWithPadding, Trainer, TrainerConfig

    print(cs.nvidia_smi(), flush=True)
    from tone_tpu_torch.device import resolve_device

    resolve_device("cuda")  # the port's float32 policy, as every entry point sets it
    print(json.dumps({"threads": probe_threads()}), flush=True)
    cfg = ToneConfig()
    tcfg = TrainerConfig(learning_rate=3e-4, total_steps=20)
    batch = DataCollatorCTCWithPadding()(cs.train_features(range(100, 116), cs.TRAIN_SECONDS))
    trainer = Trainer(cfg, tcfg, device="cuda")
    state = trainer.create_state(init_model_params(torch.Generator().manual_seed(0), cfg))
    for _ in range(args.steps - args.profile):
        state, _ = trainer.train_step(state, batch)
    if args.profile:
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(args.profile):
                state, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()

    def grads(policy):
        t = Trainer(cfg, dataclasses.replace(tcfg, remat=policy), device="cuda")
        _, g, _ = t.compute_gradients(state, batch, seed=12345)
        return cs._flat_leaves(g)

    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        for trial in range(args.trials):
            base = grads(None)
            runs = {"None_again": grads(None), "full": grads("full"), "dots": grads("dots")}
            print(json.dumps({"cudnn_deterministic": deterministic, "trial": trial,
                              **{name: cs.grad_diff(g, base, state.params)
                                 for name, g in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()
