#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tone_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port only — it imports neither ``jax`` nor ``tone_tpu`` — and
prints one JSON line per phase:

1. device   the card's name and power limit (nvidia-smi);
2. build    every CUDA source under tone_tpu_torch/csrc, built in parallel;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the shapes the serving path gives it, with its time, the plain
            version's time and the card's bound for the same work;
4. step     the full-width bf16 ``ToneConfig()`` (random weights, seed 0)
            through ``StreamingCTCModel.forward_native`` for 64 streams over
            5 chunks, checked against the port on the CPU for 2 streams;
            every step must launch the GLU kernel 32 times;
5. serve    the port's ``MultiStreamEngine`` with 16 slots, driven as the
            server's tick loop drives it: three streams of 3 s of seeded
            PCM, each must yield a final phrase, every tick must launch the
            kernel.

Then the kernel summary line and, last, ``{"ok": true, "device": {...}}``.
Any failure raises (exit code non-zero); without a GPU, or without the
package beside this script, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

GLU_TOL = 2e-2      # the JAX oracle's tolerance for this kernel (tests/test_glu_ff.py)
STEP_TOL = 0.1      # bf16 step, card vs CPU: max |Δ logprob| (see PERF.md)
SERVE_SLOTS = 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> dict:
    from tone_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.SOURCE_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        libs = list(pool.map(_build.build, names))
    seconds = time.perf_counter() - t0
    for name in names:
        _build.load(name)
    ptxas = {lib.stem: [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
             for lib in libs}
    return {"phase": "build", "sources": names, "seconds": seconds, "ptxas": ptxas}


def glu_ff_cases(device):
    """(m, av, p2) at F=1536, D=384 for the row counts of the serving path:
    10*B in full-rate layers and 5*B in reduced ones, for B in 256, 64, 16,
    plus ragged tails (37 and 10 rows)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    f, d = 1536, 384
    for m in (2560, 1280, 640, 320, 160, 80, 37, 10):
        av = torch.randn(m, 2 * f, device=device, generator=gen).to(torch.bfloat16)
        w = (torch.randn(f, d, device=device, generator=gen) * 0.02).to(torch.bfloat16)
        b = torch.randn(d, device=device, generator=gen) * 0.01
        yield m, av, {"w": w, "b": b}


def glu_ff_bound_ms(m: int, f: int, d: int) -> tuple[float, str]:
    nbytes = m * 2 * f * 2 + f * d * 2 + d * 4 + m * d * 2
    flops = 2 * m * f * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels() -> dict:
    import torch

    from tone_tpu_torch.ops.glu_ff import glu_ff2, glu_ff2_plain

    rows = []
    for m, av, p2 in glu_ff_cases("cuda"):
        y = glu_ff2(av, p2)
        torch.cuda.synchronize()
        ref = glu_ff2_plain(av, p2)
        err = (y.float() - ref.float()).abs().max().item()
        if not err <= GLU_TOL:
            raise AssertionError(f"glu_ff2 M={m}: max |kernel - plain| = {err} > {GLU_TOL}")
        ms = cuda_time_ms(lambda: glu_ff2(av, p2), 200)
        plain_ms = cuda_time_ms(lambda: glu_ff2_plain(av, p2), 50)
        bound_ms, bound_by = glu_ff_bound_ms(m, p2["w"].shape[0], p2["w"].shape[1])
        rows.append({"m": m, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
    return {"phase": "kernels", "kernel": "glu_ff2", "f": 1536, "d": 384, "tol": GLU_TOL,
            "cases": rows}


def phase_step() -> dict:
    import torch

    from tone_tpu_torch.acoustic import StreamingCTCModel
    from tone_tpu_torch.bridge import tree_leaves
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.ops.glu_ff import glu_ff2

    cfg = ToneConfig()
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    n_params = sum(t.numel() for t in tree_leaves(variables["params"]))
    b, n_chunks, n_cpu = 64, 5, 2
    audio = np.random.default_rng(0).integers(
        -20000, 20000, (b, cfg.audio_chunk_samples * n_chunks)).astype(np.int32)
    chunks = np.split(audio, n_chunks, axis=1)

    gpu = StreamingCTCModel(variables, cfg, device="cuda")
    state = None
    glu_ff2.launches = 0
    lp_gpu = []
    for chunk in chunks:
        lp, state = gpu.forward_native(chunk, state)
        lp_gpu.append(lp.cpu().numpy())
    launches = glu_ff2.launches
    if launches != 32 * n_chunks:
        raise AssertionError(f"{launches} GLU kernel launches for {n_chunks} steps")
    lp_gpu = np.concatenate(lp_gpu, axis=1)
    if lp_gpu.shape != (b, cfg.encoder.chunk_size * n_chunks, cfg.vocab_size_with_blank):
        raise AssertionError(f"logprobs shape {lp_gpu.shape}")
    if not np.isfinite(lp_gpu).all():
        raise AssertionError("non-finite logprobs on the card")
    norm_err = float(np.abs(np.exp(lp_gpu).sum(-1) - 1.0).max())
    if norm_err > 1e-3:
        raise AssertionError(f"logprobs not normalised: {norm_err}")

    cpu = StreamingCTCModel(variables, cfg, device="cpu")
    state_cpu = None
    lp_cpu = []
    for chunk in chunks:
        lp, state_cpu = cpu.forward_native(chunk[:n_cpu], state_cpu)
        lp_cpu.append(lp.numpy())
    lp_cpu = np.concatenate(lp_cpu, axis=1)
    step_err = float(np.abs(lp_gpu[:n_cpu] - lp_cpu).max())
    if not step_err <= STEP_TOL:
        raise AssertionError(f"card vs CPU max |Δ logprob| = {step_err} > {STEP_TOL}")

    # Steady-state step time: host clock around steps ending in a synchronize.
    chunk_dev = torch.as_tensor(chunks[-1], device="cuda")
    for _ in range(3):
        _, state = gpu.forward_native(chunk_dev, state)
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        _, state = gpu.forward_native(chunk_dev, state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3

    profile = _profile_steps(gpu, chunk_dev, state, steps=3)
    # Idle share against the unprofiled step: the profiler slows the host.
    idle = 1.0 - profile["device_ms_per_step"] / step_ms
    return {"phase": "step", "config": "ToneConfig() bf16", "params": n_params,
            "batch": b, "chunks": n_chunks, "glu_launches": launches,
            "launches_per_step": launches / n_chunks,
            "cpu_streams": n_cpu, "max_abs_err_vs_cpu": step_err, "tol": STEP_TOL,
            "mean_abs_err_vs_cpu": float(np.abs(lp_gpu[:n_cpu] - lp_cpu).mean()),
            "norm_err": norm_err, "step_ms": step_ms,
            "streams_realtime": b * 0.3 / (step_ms / 1e3),
            "device_idle_share": idle, **profile}


def _profile_steps(model, chunk_dev, state, steps: int) -> dict:
    """Device time by kernel over ``steps`` steady steps (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _, state = model.forward_native(chunk_dev, state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"profiled_steps": steps, "profiled_wall_ms": wall_ms,
            "device_ops_per_step": sum(e.count for e in events) / steps,
            "device_ms_per_step": device_us / 1e3 / steps,
            "top_device_kernels": [[e.key[:60], e.self_device_time_total / 1e3 / steps,
                                    e.count // steps] for e in top]}


def phase_serve() -> dict:
    import torch

    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.ops.glu_ff import glu_ff2
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    cfg = ToneConfig()
    n = cfg.audio_chunk_samples
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    engine = MultiStreamEngine(variables, cfg, n_slots=SERVE_SLOTS, device="cuda")
    try:
        engine.warmup()
        rng = np.random.default_rng(1)
        sids = [engine.open_stream() for _ in range(3)]
        for sid in sids:
            pcm = rng.integers(-20000, 20000, 10 * n).astype(np.int16)  # 3 s
            # The server's leading and trailing "magic padding".
            audio = np.concatenate([np.zeros(cfg.padding, np.int16), pcm,
                                    np.zeros(cfg.padding, np.int16)])
            for i in range(0, len(audio), n):
                engine.feed(sid, audio[i:i + n])
            engine.close_stream(sid)

        glu_ff2.launches = 0
        ticks0 = engine.stats.ticks
        futures = {sid: [] for sid in sids}
        done: set[int] = set()
        tick_ms = []
        while len(done) < len(sids):
            t0 = time.perf_counter()
            for sid, futs in engine.tick().items():
                futures[sid].extend(futs)
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            done.update(engine.pop_finished())
            if len(tick_ms) > 100:
                raise AssertionError("streams did not finish within 100 ticks")
        ticks = engine.stats.ticks - ticks0
        launches = glu_ff2.launches
        if launches != 32 * ticks:
            raise AssertionError(f"{launches} GLU launches over {ticks} ticks")
        phrases = {sid: [f.result(timeout=60) for f in futs] for sid, futs in futures.items()}
    finally:
        engine.shutdown()
    for sid, ps in phrases.items():
        if not ps:
            raise AssertionError(f"stream {sid} yielded no final phrase")
        times = [t for p in ps for t in (p.start_time, p.end_time)]
        if times != sorted(times) or any(t < 0 for t in times):
            raise AssertionError(f"stream {sid}: phrase times out of order: {times}")
    return {"phase": "serve", "slots": SERVE_SLOTS, "streams": len(sids), "ticks": ticks,
            "glu_launches": launches, "tick_ms_median": float(np.median(tick_ms)),
            "phrases": {str(sid): [[p.text[:40], p.start_time, p.end_time] for p in ps]
                        for sid, ps in phrases.items()}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tone_tpu_torch.device import resolve_device

    resolve_device("cuda")  # sets the float32 policy (no TF32)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    emit(phase_build())
    kernels = phase_kernels()
    emit(kernels)
    step = phase_step()
    emit(step)
    serve = phase_serve()
    emit(serve)

    # The serve phase is the main path: its full-rate layers give M = 10 * slots.
    main_m = SERVE_SLOTS * 10
    case = next(c for c in kernels["cases"] if c["m"] == main_m)
    emit({"kernels": [{
        "name": "glu_ff2", "route": "cuda", "source": "tone_tpu_torch/csrc/glu_ff.cu",
        "replaces": "tone_tpu/ops/glu_ff.py:60", "launches": serve["glu_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in kernels["cases"]),
        "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"], "library_ms": None, "m": main_m}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
