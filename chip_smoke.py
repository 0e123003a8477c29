#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tone_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile-check] [--phases kernels,bulk,...]

Drives the port only — it imports neither ``jax`` nor ``tone_tpu`` — and
prints one JSON line per phase:

1. device   the card's name and power limit (nvidia-smi);
2. build    every CUDA source under tone_tpu_torch/csrc, built in parallel;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the shapes the serving path and the bulk full-sequence forward
            (M = 16,640 and 33,280) give it, with its time (CUDA
            events, and its own device time from the profiler), the plain
            version's time, the card's bound for the same work, the share
            of the bound it reaches and, as a yardstick, cuBLAS's time for
            the product alone (``torch.addmm`` on a precomputed gate);
4. step     the full-width bf16 ``ToneConfig()`` (random weights, seed 0)
            through ``StreamingCTCModel.forward_native`` for 64 streams over
            5 chunks, checked against the port on the CPU for 2 streams;
            every step must launch the GLU kernel 32 times;
5. serve    the port's ``MultiStreamEngine`` with 16 slots, driven as the
            server's tick loop drives it: three streams of 3 s of seeded
            PCM, each must yield a final phrase, every tick must launch the
            kernel; the first ticks are profiled for device time per tick;
6. fused_kernels  the fused Conformer-layer kernel against its plain
            version at full width for every layer kind of the step, at
            B = 64, 16 and 1, with its time, the plain version's, the bound
            and the share of the bound it reaches (bound / time);
7. fused_step  the same model and audio as ``step`` through
            ``ops.fused_encoder.apply_streaming_fused``: 16 fused-layer
            launches per step and none of the GLU kernel, logprobs checked
            against the eager step on the card and the CPU plain path for 2
            streams, with step time, device time, device ops and idle share;
8. beam_decode  ``DeviceBeamSearchCTCDecoder`` on the card at the serving
            defaults (beam width 32, n-best 8, max_len 2048, 64 rows per
            call) on seeded blank-heavy logprobs in every frame bucket 64 …
            2048, LM-free, with an order-3 ARPA LM (estimated by the port
            from a seeded synthetic corpus) and with hotwords; the same LM
            fused into the search (``fusion=True``): as a ``DeviceLM``
            (``fused``), as the probing binary's own tables
            (``fused_probing``) and with hotwords (``fused_hotwords``); ms
            and device ms per call, launches per frame, idle share at every
            bucket (the fused variants at 64 … 512, and also at 1024 and
            2048 with ``--profile-check``); the LM-free, LM and hotword
            variants held against the same decoder on the CPU at every
            bucket, the fused ones at 64, 128 and 256 (equal top texts, best
            scores within 1e-3); with ``--profile-check``, each profile also
            read through ``key_averages()`` and each non-fused call profiled
            twice (adds minutes); the LM once more as a KenLM probing binary (equal texts
            at every bucket); the agreement of the ARPA and probing fused
            texts, and of the fused top-1 with the port's host beam search
            (W=32, T=64);
9. serve_beam  the ``serve`` phase's engine with the ``beam_decode`` LM
            decoder for finals, the interim device beam arena (width 8), word
            timestamps, one stream with request hotwords and one with n-best
            4: every stream yields a final, phrase and word times are
            ordered, every tick launches the GLU kernel 32 times, and every
            final's text equals the port's CPU decoder on that phrase;
10. serve_fused  the same cell with the fused decoder (``fusion=True``):
            warmup runs the fused finals ladder; one stream with request
            hotwords (stacked rows), one with n-best 4; every final equals
            the port's fused decoder on the CPU on that phrase's logprobs;
            every tick launches the GLU kernel 32 times; each finals call is
            timed in the run and alone;
11. serve_host_beam  the same cell with the host ``BeamSearchCTCDecoder``
            (the native C++ search, width 200, built by this run), carried
            host-beam interims and request hotwords on one stream: the
            native library must be built and used, every final equals a
            second decode of its logprobs;
12. bulk    ``OfflineTranscriber`` over 16 utterances of speech-shaped
            audio (the port's synthesizer, seeds 0-15, 4-60 s, 486 s in
            all) as one batch of 16, with the chunk scan and with the
            full-sequence forward: each run once to warm (its logprobs) and
            once timed (audio s, wall s, RTFx, B1 launches per batch, peak
            memory), then once profiled (device ms, idle share); the two
            forwards' logprobs within 0.1, each against the CPU on the two
            shortest utterances (logprobs within 0.1, texts compared);
            ``batched_greedy_decode`` on the card equal to the host decoder;
            every phrase's greedy text force-aligned on the card and the CPU
            (paths equal in every (T, S) bucket, ms per bucket, word tuples
            equal) and through ``word_timestamps=True``; ``evaluate_pipeline``
            over a manifest of the utterances; ``python -m tone_tpu_torch
            transcribe --batch-size 16 --json`` on two FLACs written by the
            port's encoder.

``--phases`` runs a subset after the build (for development; the kernel
summary line needs the kernels, serve, fused_kernels, fused_step and bulk
phases).
Every phase line after ``device`` gives the phase's seconds as
``phase_s``.  Then the kernel summary line and, last, ``{"ok": true, "device": {...}}``.
Any failure raises (exit code non-zero); without a GPU, or without the
package beside this script, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import math
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
SERVE_PROFILED_TICKS = 3
FUSED_TOL = 0.05    # fused layer, kernel vs plain: max |Δ| of y, conv state, window
FUSED_SCORES_TOL = 2e-2  # ... and of the scores (tests/test_torch_fused_layer.py)
# Layer of each kind in ToneConfig() and how many layers of a step are of it.
FUSED_KINDS = {"stateless_recompute_t10": (0, 1), "stateless_reuse_t10": (1, 6),
               "stateless_recompute_t5": (7, 1), "stateless_reuse_t5": (8, 6),
               "stateful_w15": (14, 1), "stateful_w30": (15, 1)}


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


def sass_loads(lib) -> dict | None:
    """How the compiled kernels load: ldmatrix (LDSM), generic (LD.E) and
    shared (LDS) loads, tensor-core instructions (HMMA), counted in the
    library's SASS (cuobjdump), or None where the toolkit has no cuobjdump."""
    import re
    import shutil

    from tone_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    return {op: len(re.findall(pattern, sass)) for op, pattern in (
        ("LDSM", r"\bLDSM\b"), ("LD.E", r"\bLD\.E"), ("LDS", r"\bLDS\b"),
        ("HMMA", r"\bHMMA\b"))}


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
    sass = {lib.stem: sass_loads(lib) for lib in libs}
    return {"phase": "build", "sources": names, "seconds": seconds, "ptxas": ptxas,
            "sass": sass}


# B1's row counts: the bulk full-sequence forward's for 16 utterances of 60 s
# (16 x 2080 frames full-rate, half that reduced), then the serving path's.
BULK_MS = (33280, 16640)
GLU_MS = BULK_MS + (2560, 1280, 640, 320, 160, 80, 37, 10)


def glu_ff_cases(device):
    """(m, av, p2) at F=1536, D=384 for the row counts of the bulk forward
    and the serving path: 10*B in full-rate layers and 5*B in reduced ones,
    for B in 256, 64, 16, plus ragged tails (37 and 10 rows)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    f, d = 1536, 384
    for m in GLU_MS:
        av = torch.randn(m, 2 * f, device=device, generator=gen).to(torch.bfloat16)
        w = (torch.randn(f, d, device=device, generator=gen) * 0.02).to(torch.bfloat16)
        b = torch.randn(d, device=device, generator=gen) * 0.01
        yield m, av, {"w": w, "b": b}


def glu_ff_bound_ms(m: int, f: int, d: int) -> tuple[float, str]:
    nbytes = m * 2 * f * 2 + f * d * 2 + d * 4 + m * d * 2
    flops = 2 * m * f * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_time_ms(fn, iters: int, name: str | None = None) -> float:
    """Device time per call of ``fn`` from torch.profiler over ``iters``
    back-to-back calls: the kernels whose name holds ``name``, or all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and (name is None or name in e.key)]
    if not events:
        raise AssertionError(f"the profiler saw no device time for {name or 'the call'}")
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def phase_kernels() -> dict:
    import torch

    from tone_tpu_torch.ops.glu_ff import _plan, _sm_count, glu_ff2, glu_ff2_plain

    rows = []
    for m, av, p2 in glu_ff_cases("cuda"):
        f, d = p2["w"].shape
        y = glu_ff2(av, p2)
        torch.cuda.synchronize()
        ref = glu_ff2_plain(av, p2)
        err = (y.float() - ref.float()).abs().max().item()
        if not err <= GLU_TOL:
            raise AssertionError(f"glu_ff2 M={m}: max |kernel - plain| = {err} > {GLU_TOL}")
        event_ms = cuda_time_ms(lambda: glu_ff2(av, p2), 200)
        ms = device_time_ms(lambda: glu_ff2(av, p2), 200, "glu_ff2")
        plain_ms = cuda_time_ms(lambda: glu_ff2_plain(av, p2), 50)
        # cuBLAS's product alone, on the gate computed beforehand: a yardstick
        a32 = av[:, :f].float()
        g = (a32 * torch.sigmoid(a32)).to(torch.bfloat16) * av[:, f:]
        b16 = p2["b"].to(torch.bfloat16)
        gemm_ms = device_time_ms(lambda: torch.addmm(b16, g, p2["w"]), 200)
        bound_ms, bound_by = glu_ff_bound_ms(m, f, d)
        plan = _plan(m, f, d, _sm_count(torch.cuda.current_device()))
        rows.append({"m": m, "max_abs_err": err, "ms": ms, "event_ms": event_ms,
                     "plain_ms": plain_ms, "gemm_ms": gemm_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_share": bound_ms / ms,
                     "tile": "big" if plan.big else "small", "grid": list(plan.grid)})
    return {"phase": "kernels", "kernel": "glu_ff2", "f": 1536, "d": 384, "tol": GLU_TOL,
            "ms": "device time per launch (torch.profiler), back to back",
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

    profile = _profile_steps(lambda s: gpu.forward_native(chunk_dev, s)[1], state, steps=3)
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


def _profile_steps(step, state, steps: int) -> dict:
    """Device time by kernel over ``steps`` steady steps (torch.profiler);
    ``step(state)`` runs one step and returns the next state."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in events)
    glu_us = sum(e.self_device_time_total for e in events if "glu_ff2" in e.key)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"profiled_steps": steps, "profiled_wall_ms": wall_ms,
            "device_ops_per_step": sum(e.count for e in events) / steps,
            "device_ms_per_step": device_us / 1e3 / steps,
            "glu_device_ms_per_step": glu_us / 1e3 / steps,
            "top_device_kernels": [[e.key[:60], e.self_device_time_total / 1e3 / steps,
                                    e.count // steps] for e in top]}


def phase_serve() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        # The first ticks run under the profiler (device time per tick); the
        # median tick time is taken over the others.
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        while len(done) < len(sids):
            t0 = time.perf_counter()
            for sid, futs in engine.tick().items():
                futures[sid].extend(futs)
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if len(tick_ms) == SERVE_PROFILED_TICKS:
                torch.cuda.synchronize()
                prof.stop()
            done.update(engine.pop_finished())
            if len(tick_ms) > 100:
                raise AssertionError("streams did not finish within 100 ticks")
        if len(tick_ms) <= SERVE_PROFILED_TICKS:
            raise AssertionError(f"only {len(tick_ms)} ticks: too few to profile")
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3 / SERVE_PROFILED_TICKS
        glu_ms = sum(e.self_device_time_total for e in events
                     if "glu_ff2" in e.key) / 1e3 / SERVE_PROFILED_TICKS
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
            "glu_launches": launches,
            "tick_ms_median": float(np.median(tick_ms[SERVE_PROFILED_TICKS:])),
            "profiled_ticks": SERVE_PROFILED_TICKS, "device_ms_per_tick": device_ms,
            "glu_device_ms_per_tick": glu_ms,
            "phrases": {str(sid): [[p.text[:40], p.start_time, p.end_time] for p in ps]
                        for sid, ps in phrases.items()}}


def fused_bound_ms(w, b: int) -> tuple[float, str]:
    """The card's least time for one fused layer at batch ``b``: weights,
    activations, state and scores moved once each, against the layer's
    operations at the bf16 tensor rate."""
    from tone_tpu_torch.ops.fused_layer import MAT_NAMES

    a = w.args
    t, win, d, f, h, k = a.t, a.window, a.d, a.f, a.n_heads, a.conv_k
    tkv, dh = win + t, d // h
    weights = sum(math.prod(w.shapes[n]) * (2 if n in MAT_NAMES else 4) for n in w.names())
    acts = b * (2 * t * d * 2 + 2 * (k - 1) * d * 2 + 2 * win * d * 2 + (4 if win else 0)
                + h * t * tkv * 4)
    mm = 2 * (3 * t * d * f) + (t + tkv) * d * d * (1 if w.recompute else 0) \
        + tkv * d * d + t * d * d + 2 * t * d * d + t * d * d
    flops = b * 2 * (mm + h * t * tkv * dh * (2 if w.recompute else 1) + t * k * d)
    t_bytes, t_ops = (weights + acts) / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_fused_kernels() -> dict:
    import torch

    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.ops.fused_encoder import _layer_static
    from tone_tpu_torch.ops.fused_layer import (
        flatten_layer_params,
        fused_conformer_layer,
        fused_conformer_layer_plain,
    )

    cfg = ToneConfig()
    e = cfg.encoder
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kind, (layer, _) in FUSED_KINDS.items():
        st = _layer_static(e, layer)
        t, win = st["t"], st["window"]
        w = flatten_layer_params(variables["params"]["encoder"]["layers"][layer],
                                 variables["batch_stats"]["layers"][layer], e, t=t,
                                 window=win, recompute=st["recompute"], device="cuda")
        static = dict(t=t, window=win, recompute=st["recompute"], n_heads=e.n_heads,
                      rope_dim=e.rope_dim, conv_k=e.conv_kernel_size)
        for b in (64, 16, 1):
            def rand(*shape):
                return torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)

            args = (rand(b, t, e.d_model), rand(b, e.conv_kernel_size - 1, e.d_model),
                    rand(b, win, e.d_model) if win else None,
                    torch.randint(0, win + 1, (b, 1), device="cuda", generator=gen,
                                  dtype=torch.int32) if win else None,
                    None if st["recompute"] else
                    2.0 * torch.randn(b, e.n_heads, t, win + t, device="cuda", generator=gen))
            got = fused_conformer_layer(*args, w, **static)
            torch.cuda.synchronize()
            ref = fused_conformer_layer_plain(*args, w, **static)
            errs = {}
            for name, g, r in zip(("y", "new_conv", "new_win", "scores"), got, ref):
                if r is not None:
                    errs[name] = (g.float() - r.float()).abs().max().item()
                    tol = FUSED_SCORES_TOL if name == "scores" else FUSED_TOL
                    if not errs[name] <= tol:
                        raise AssertionError(f"fused layer {kind} B={b}: max |kernel - plain| "
                                             f"of {name} = {errs[name]} > {tol}")
            ms = cuda_time_ms(lambda: fused_conformer_layer(*args, w, **static), 50)
            plain_ms = cuda_time_ms(lambda: fused_conformer_layer_plain(*args, w, **static), 10)
            bound_ms, bound_by = fused_bound_ms(w, b)
            rows.append({"kind": kind, "layer": layer, "batch": b, "max_abs_err": errs,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "bound_share": bound_ms / ms})
    return {"phase": "fused_kernels", "kernel": "fused_conformer_layer", "d": e.d_model,
            "tol": FUSED_TOL, "scores_tol": FUSED_SCORES_TOL, "cases": rows}


def phase_fused_step() -> dict:
    import torch

    from tone_tpu_torch.acoustic import StreamingCTCModel
    from tone_tpu_torch.bridge import to_device
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params, init_streaming_state
    from tone_tpu_torch.ops.fused_encoder import apply_streaming_fused, prepare_fused_params
    from tone_tpu_torch.ops.fused_layer import fused_conformer_layer
    from tone_tpu_torch.ops.glu_ff import glu_ff2

    cfg = ToneConfig()
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    b, n_chunks, n_cpu = 64, 5, 2
    audio = np.random.default_rng(0).integers(
        -20000, 20000, (b, cfg.audio_chunk_samples * n_chunks)).astype(np.int32)
    chunks = [torch.from_numpy(c) for c in np.split(audio, n_chunks, axis=1)]

    eager = StreamingCTCModel(variables, cfg, device="cuda")
    state = None
    lp_eager = []
    for chunk in chunks:
        lp, state = eager.forward_native(chunk, state)
        lp_eager.append(lp.cpu().numpy())
    lp_eager = np.concatenate(lp_eager, axis=1)

    plan = prepare_fused_params(variables, cfg, device="cuda")
    var_gpu = to_device(variables, "cuda")
    chunks_dev = [c.to("cuda") for c in chunks]
    state = init_streaming_state(cfg, b, device="cuda")
    fused_conformer_layer.launches = glu_ff2.launches = 0
    lp_fused = []
    for chunk in chunks_dev:
        lp, state = apply_streaming_fused(var_gpu, plan, cfg, chunk, state)
        lp_fused.append(lp)
    torch.cuda.synchronize()
    launches, glu_launches = fused_conformer_layer.launches, glu_ff2.launches
    if launches != cfg.encoder.n_layers * n_chunks or glu_launches:
        raise AssertionError(f"{launches} fused-layer and {glu_launches} GLU launches "
                             f"for {n_chunks} fused steps")
    lp_fused = np.concatenate([lp.cpu().numpy() for lp in lp_fused], axis=1)
    if lp_fused.shape != lp_eager.shape or not np.isfinite(lp_fused).all():
        raise AssertionError(f"fused logprobs: shape {lp_fused.shape}, or non-finite")
    err_eager = float(np.abs(lp_fused - lp_eager).max())
    if not err_eager <= STEP_TOL:
        raise AssertionError(f"fused vs eager step on the card: {err_eager} > {STEP_TOL}")

    plan_cpu = prepare_fused_params(variables, cfg, device="cpu")
    state_cpu = init_streaming_state(cfg, n_cpu)
    lp_cpu = []
    for chunk in chunks:
        lp, state_cpu = apply_streaming_fused(variables, plan_cpu, cfg, chunk[:n_cpu], state_cpu)
        lp_cpu.append(lp.numpy())
    lp_cpu = np.concatenate(lp_cpu, axis=1)
    err_cpu = float(np.abs(lp_fused[:n_cpu] - lp_cpu).max())
    if not err_cpu <= STEP_TOL:
        raise AssertionError(f"fused step, card vs CPU: {err_cpu} > {STEP_TOL}")

    def step(s):
        return apply_streaming_fused(var_gpu, plan, cfg, chunks_dev[-1], s)[1]

    for _ in range(3):
        state = step(state)
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    profile = _profile_steps(step, state, steps=3)
    idle = 1.0 - profile["device_ms_per_step"] / step_ms
    return {"phase": "fused_step", "config": "ToneConfig() bf16", "batch": b,
            "chunks": n_chunks, "fused_launches": launches, "glu_launches": glu_launches,
            "launches_per_step": launches / n_chunks,
            "max_abs_err_vs_eager": err_eager,
            "mean_abs_err_vs_eager": float(np.abs(lp_fused - lp_eager).mean()),
            "cpu_streams": n_cpu, "max_abs_err_vs_cpu": err_cpu,
            "mean_abs_err_vs_cpu": float(np.abs(lp_fused[:n_cpu] - lp_cpu).mean()),
            "tol": STEP_TOL, "step_ms": step_ms,
            "streams_realtime": b * 0.3 / (step_ms / 1e3), "device_idle_share": idle,
            **profile}


BEAM_WIDTH, BEAM_NBEST, BEAM_ROWS = 32, 8, 64
BEAM_BUCKETS = (64, 128, 256, 512, 1024, 2048)
BEAM_SCORE_TOL = 1e-3   # best score, card vs CPU
BEAM_TIE = 1e-5         # two beams closer than this may rank either way
BEAM_HOTWORDS = ["да", "нет", "привет мир", "колокол"]
# The fused variants' CPU reference runs at these buckets only: above them it
# takes longer than the card's calls and would push the script past half its
# time limit.  The other variants are held against the CPU at every bucket.
FUSED_CPU_BUCKETS = (64, 128, 256)
# The fused variants' calls above 512 frames are timed only (no CPU
# reference) and take about 100 s with their profiles: they run with
# --profile-check, so that the default run, bulk phase included, stays
# within 900 s on a slow host.
FUSED_DEFAULT_BUCKETS = (64, 128, 256, 512)
# key_averages() builds a Python object per event, which takes minutes for the
# ~10^6 launches of a fused call at 2048 frames: above this many events only
# the raw events are summed.
KEY_AVERAGES_MAX_EVENTS = 110_000
LONGEST_PHRASE = 2000 + 2 * 3   # the splitter's force split plus its margins


def beam_logprobs(seed: int, rows: int, t_pad: int) -> list[np.ndarray]:
    """Blank-heavy random phrase logprobs, lengths in (t_pad/2, t_pad]
    (at most the splitter's longest phrase)."""
    rng = np.random.default_rng(seed)
    hi = min(t_pad, LONGEST_PHRASE)
    out = []
    for n in rng.integers(t_pad // 2 + 1, hi + 1, rows):
        logits = rng.normal(0.0, 2.5, (n, 35))
        logits[:, 34] += 4.0                          # blank
        logits[:, 33] += rng.random(n) * 2.0          # space
        x = logits - logits.max(-1, keepdims=True)
        out.append((x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32))
    return out


def beam_lm_tables(seed: int = 0):
    """An order-3 modified-Kneser-Ney LM over a seeded synthetic corpus."""
    from tone_tpu_torch.decoding.estimate import estimate_ngram_lm

    rng = np.random.default_rng(seed)
    letters = list("абвгдеёжзийклмнопрстуфхцчшщъыьэюя")
    words = ["".join(rng.choice(letters, rng.integers(1, 7))) for _ in range(500)]
    words += BEAM_HOTWORDS[:2] + BEAM_HOTWORDS[2].split() + BEAM_HOTWORDS[3:]
    sents = [[words[i] for i in rng.integers(0, len(words), rng.integers(1, 12))]
             for _ in range(5000)]
    return estimate_ngram_lm(sents, order=3)


def beam_decoder(lm, device, hotwords=None, fusion=False):
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder

    dec = DeviceBeamSearchCTCDecoder(lm, beam_width=BEAM_WIDTH, nbest=BEAM_NBEST,
                                     max_len=2048, hotwords=hotwords, fusion=fusion,
                                     device=device)
    dec.batch_floor = dec.max_batch = BEAM_ROWS
    return dec


def _device_profile(fn, check: bool = False, top: int = 0) -> dict:
    """Device ms and kernel launches of one call, by torch.profiler: summed
    over the raw events and, with ``check``, read from the same profile
    through key_averages() as well where the call has at most
    KEY_AVERAGES_MAX_EVENTS events; with ``top``, the ``top`` kernels by
    device ms ([name, ms, launches])."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type().name == "CUDA"]
    if not events:
        raise AssertionError("the profiler saw no device time for the beam search")
    out = {"device_ms": sum(e.duration_ns() for e in events) / 1e6, "launches": len(events)}
    if top:
        by_name: dict[str, list] = {}
        for e in events:
            acc = by_name.setdefault(e.name()[:60], [0.0, 0])
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
        out["top_kernels"] = sorted(([k, *v] for k, v in by_name.items()),
                                    key=lambda r: -r[1])[:top]
    if check and len(events) <= KEY_AVERAGES_MAX_EVENTS:
        avg = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        out["device_ms_key_averages"] = sum(e.self_device_time_total for e in avg) / 1e3
        out["launches_key_averages"] = sum(e.count for e in avg)
    return out


def phase_beam_decode(profile_check: bool = False) -> dict:
    import tempfile
    from pathlib import Path

    from tone_tpu_torch.decoding.estimate import write_arpa
    from tone_tpu_torch.decoding.kenlm_binary import write_kenlm_binary
    from tone_tpu_torch.decoding.lm import load_lm

    from tone_tpu_torch.decoder import BeamSearchCTCDecoder
    from tone_tpu_torch.decoding.device_lm import DeviceLM, DeviceProbingLM, load_device_lm

    tables = beam_lm_tables()
    with tempfile.TemporaryDirectory() as tmp:
        write_arpa(tables, Path(tmp) / "lm.arpa")
        write_kenlm_binary(tables, Path(tmp) / "lm.bin")
        arpa, binary = load_lm(Path(tmp) / "lm.arpa"), load_lm(Path(tmp) / "lm.bin")
        t0 = time.perf_counter()
        dev_arpa = load_device_lm(Path(tmp) / "lm.arpa")
        dev_probing = load_device_lm(Path(tmp) / "lm.bin")
        build_s = time.perf_counter() - t0
        host = BeamSearchCTCDecoder.from_local(Path(tmp) / "lm.arpa")
    if type(binary).__name__ != "KenLMBinary":
        raise AssertionError(f"load_lm read the probing binary as {type(binary).__name__}")
    if not (isinstance(dev_arpa, DeviceLM) and isinstance(dev_probing, DeviceProbingLM)):
        raise AssertionError(f"load_device_lm gave {type(dev_arpa)}, {type(dev_probing)}")
    # (LM, hotwords, fusion, seed group): the fused variants decode the LM
    # variant's logprobs, so their texts can be compared with each other
    variants = {"no_lm": (None, None, False, 0), "lm": (arpa, None, False, 1),
                "hotwords": (None, BEAM_HOTWORDS, False, 2),
                "fused": (dev_arpa, None, True, 1),
                "fused_probing": (dev_probing, None, True, 1),
                "fused_hotwords": (dev_arpa, BEAM_HOTWORDS, True, 3)}
    rows, texts_by_variant = [], {}
    for variant, (lm, hotwords, fusion, group) in variants.items():
        card = beam_decoder(lm, "cuda", hotwords, fusion)
        cpu = beam_decoder(lm, "cpu", hotwords, fusion)
        texts_by_variant[variant] = []
        for t_pad in (BEAM_BUCKETS if profile_check or not fusion else FUSED_DEFAULT_BUCKETS):
            lps = beam_logprobs(1000 * group + t_pad, BEAM_ROWS, t_pad)
            if t_pad == BEAM_BUCKETS[0]:
                card.forward_batch_nbest(lps[:1], 1)   # first use of the stream
            t0 = time.perf_counter()
            got = card.forward_batch_nbest(lps, BEAM_NBEST)
            ms = (time.perf_counter() - t0) * 1e3
            prof = _device_profile(lambda: card.forward_batch_nbest(lps, BEAM_NBEST),
                                        profile_check)
            case = {"variant": variant, "frames": t_pad, "rows": BEAM_ROWS, "ms": ms, **prof,
                    "launches_per_frame": prof["launches"] / t_pad,
                    "device_idle_share": 1.0 - prof["device_ms"] / ms}
            if profile_check and not fusion:
                # the same call profiled again: how far the count moves
                again = _device_profile(lambda: card.forward_batch_nbest(lps, BEAM_NBEST))
                case.update(launches_again=again["launches"], device_ms_again=again["device_ms"])
            texts_by_variant[variant].append([h[0][0] if h else "" for h in got])
            if fusion and t_pad not in FUSED_CPU_BUCKETS:
                rows.append(case)
                continue
            t0 = time.perf_counter()
            want = cpu.forward_batch_nbest(lps, BEAM_NBEST)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            ties = 0
            for r, (g, w) in enumerate(zip(got, want)):
                if not g or not w or g[0][0] != w[0][0]:
                    raise AssertionError(f"beam {variant} T={t_pad} row {r}: card "
                                         f"{g[:2]} != CPU {w[:2]}")
                err = abs(g[0][1] - w[0][1])
                if not err <= BEAM_SCORE_TOL:
                    raise AssertionError(f"beam {variant} T={t_pad} row {r}: best score "
                                         f"card vs CPU {err} > {BEAM_SCORE_TOL}")
                ties += len(g) > 1 and g[0][1] - g[1][1] < BEAM_TIE
            rows.append({**case, "cpu_ms": cpu_ms,
                         "max_score_err": max(abs(g[0][1] - w[0][1])
                                              for g, w in zip(got, want)),
                         "near_ties": ties})
    # The probing binary of the same LM rescores to the ARPA's texts.
    card_bin = beam_decoder(binary, "cuda")
    for k, t_pad in enumerate(BEAM_BUCKETS):
        got = card_bin.forward_batch(beam_logprobs(1000 + t_pad, BEAM_ROWS, t_pad))
        if got != texts_by_variant["lm"][k]:
            raise AssertionError(f"KenLM probing binary vs ARPA texts differ at T={t_pad}")
    # The fused search over the ARPA tables and over the probing binary's own
    # tables (the same LM): the share of rows whose texts agree.
    pairs = [(a, b) for ta, tb in zip(texts_by_variant["fused"], texts_by_variant["fused_probing"])
             for a, b in zip(ta, tb)]
    probing_agree = sum(a == b for a, b in pairs) / len(pairs)
    # The fused top-1 against the host beam search (the native C++ decoder,
    # full shallow fusion) at the same width on the 64-frame bucket.
    host.beam_width = BEAM_WIDTH
    if not host._use_native:
        raise AssertionError("the host beam decoder did not build its native library")
    lps = beam_logprobs(1000 + BEAM_BUCKETS[0], BEAM_ROWS, BEAM_BUCKETS[0])
    host_texts = [host.forward(lp) for lp in lps]
    host_agree = sum(a == b for a, b in zip(texts_by_variant["fused"][0], host_texts)) / len(lps)
    return {"phase": "beam_decode", "beam_width": BEAM_WIDTH, "nbest": BEAM_NBEST,
            "max_len": 2048, "score_tol": BEAM_SCORE_TOL, "tie": BEAM_TIE,
            "lm": {"order": 3, "ngrams": [len(t) for t in tables]},
            "device_lm": {"build_s": build_s, "table_rows": int(dev_arpa.keys1.shape[0]),
                          "probe": dev_arpa.probe, "edge_probe": dev_arpa.edge_probe,
                          "probing_table_rows": int(dev_probing.keys1.shape[0])},
            "fused_cpu_buckets": list(FUSED_CPU_BUCKETS),
            "fused_buckets": list(BEAM_BUCKETS if profile_check else FUSED_DEFAULT_BUCKETS),
            "profile_check": profile_check,
            "fused_arpa_vs_probing_text_agreement": probing_agree,
            "fused_vs_host_beam_top1_agreement": host_agree,
            "ms": "host clock around one call (ends with the n-best read back); "
                  "device_ms and launches summed over torch.profiler's raw events of "
                  "one more call; *_key_averages: the same profile through "
                  "key_averages(), where it has at most KEY_AVERAGES_MAX_EVENTS "
                  "events; *_again: a second profiled call (LM-free, LM, hotwords); "
                  "both with --profile-check only",
            "cases": rows}


def _serve_cell(engine, setup) -> dict:
    """Drive the serve cell through ``engine`` as the server's tick loop
    does: three streams of 3 s of seeded PCM (with the server's padding),
    ``setup(engine, sids)`` before the audio; the first ticks run under the
    profiler; every tick must launch the GLU kernel 32 times and every
    stream must yield ordered final phrases."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tone_tpu_torch.ops.glu_ff import glu_ff2

    cfg = engine.config
    n = cfg.audio_chunk_samples
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    sids = [engine.open_stream() for _ in range(3)]
    setup(engine, sids)
    for sid in sids:
        pcm = rng.integers(-20000, 20000, 10 * n).astype(np.int16)  # 3 s
        audio = np.concatenate([np.zeros(cfg.padding, np.int16), pcm,
                                np.zeros(cfg.padding, np.int16)])
        for i in range(0, len(audio), n):
            engine.feed(sid, audio[i:i + n])
        engine.close_stream(sid)

    glu_ff2.launches = 0
    ticks0 = engine.stats.ticks
    futures = {sid: [] for sid in sids}
    done: set[int] = set()
    tick_ms, interims = [], 0
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    while len(done) < len(sids):
        t0 = time.perf_counter()
        for sid, futs in engine.tick().items():
            futures[sid].extend(futs)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        interims += len(engine.last_interims)
        if len(tick_ms) == SERVE_PROFILED_TICKS:
            torch.cuda.synchronize()
            prof.stop()
        done.update(engine.pop_finished())
        if len(tick_ms) > 100:
            raise AssertionError("streams did not finish within 100 ticks")
    if len(tick_ms) <= SERVE_PROFILED_TICKS:
        raise AssertionError(f"only {len(tick_ms)} ticks: too few to profile")
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / SERVE_PROFILED_TICKS
    ticks = engine.stats.ticks - ticks0
    launches = glu_ff2.launches
    if launches != 32 * ticks:
        raise AssertionError(f"{launches} GLU launches over {ticks} ticks")
    phrases = {sid: [f.result(timeout=600) for f in futs] for sid, futs in futures.items()}
    for sid, ps in phrases.items():
        if not ps:
            raise AssertionError(f"stream {sid} yielded no final phrase")
        times = [t for p in ps for t in (p.start_time, p.end_time)]
        if times != sorted(times) or any(t < 0 for t in times):
            raise AssertionError(f"stream {sid}: phrase times out of order: {times}")
    return {"sids": sids, "phrases": phrases, "out": {
        "slots": SERVE_SLOTS, "streams": len(sids), "ticks": ticks, "glu_launches": launches,
        "warmup_s": warmup_s, "tick_ms_median": float(np.median(tick_ms[SERVE_PROFILED_TICKS:])),
        "tick_ms_max": float(np.max(tick_ms)), "profiled_ticks": SERVE_PROFILED_TICKS,
        "device_ms_per_tick": device_ms, "interim_events": interims,
        "phrases": {str(sid): [[p.text[:40], p.start_time, p.end_time,
                                len(p.words or ()), len(p.nbest or ())] for p in ps]
                    for sid, ps in phrases.items()}}}


def _timed_finals(engine):
    """Wrap the engine decoder's batched finals call: each call's host-clock
    ms, arguments and top texts are recorded."""
    calls, decoded = [], []
    real = engine.decoder.forward_batch_nbest

    def timed(lps, k, hotword_rows=None):
        t0 = time.perf_counter()
        out = real(lps, k, hotword_rows)
        calls.append(((time.perf_counter() - t0) * 1e3, lps, k, hotword_rows))
        decoded.extend(zip(lps, hotword_rows or [None] * len(lps),
                           [r[0][0] if r else "" for r in out]))
        return out

    def alone():
        """Each finals call once more, alone (no tick or alignment beside it)."""
        out = []
        for ms, lps, k, rows in calls:
            t0 = time.perf_counter()
            real(lps, k, rows)
            out.append({"phrases": len(lps), "frames": [len(lp) for lp in lps],
                        "hotword_rows": rows is not None, "n": k, "ms": ms,
                        "alone_ms": (time.perf_counter() - t0) * 1e3})
        return out

    engine.decoder.forward_batch_nbest = timed
    return decoded, alone


def _device_serve_phase(name, lm, fusion, word_timestamps, interim_device_beam) -> dict:
    """The serve cell with a device-beam decoder for finals (batched calls),
    one stream with request hotwords and one with n-best 4; every final
    must equal the port's same decoder on the CPU on that phrase."""
    import torch

    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    cfg = ToneConfig()
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    engine = MultiStreamEngine(variables, cfg, n_slots=SERVE_SLOTS, device="cuda",
                               decoder=beam_decoder(lm, "cuda", fusion=fusion),
                               interim_device_beam=interim_device_beam,
                               interim_beam_width=8, word_timestamps=word_timestamps)
    decoded, alone = [], None

    def setup(engine, sids):
        nonlocal decoded, alone
        decoded, alone = _timed_finals(engine)
        # 23 trie nodes: the 32-node bucket warmup() ran, so no warm starts
        engine.set_stream_hotwords(sids[1], BEAM_HOTWORDS, 5.0)
        engine.set_stream_nbest(sids[2], 4)

    try:
        run = _serve_cell(engine, setup)
        finals_calls = alone()
    finally:
        engine.shutdown()
    sids, phrases = run["sids"], run["phrases"]
    if word_timestamps:
        for sid, ps in phrases.items():
            for p in ps:
                w_times = [t for w in p.words or () for t in (w.start_time, w.end_time)]
                if w_times != sorted(w_times) or (p.text and not p.words):
                    raise AssertionError(f"stream {sid}: word times {w_times} of {p.text!r}")
    for p in phrases[sids[2]]:
        if not p.nbest or p.nbest[0][0] != p.text:
            raise AssertionError(f"n-best stream: alternatives {p.nbest} of {p.text!r}")
    # every final against the port's CPU decoder on that phrase's logprobs
    cpu = beam_decoder(lm, "cpu", fusion=fusion)
    cpu.batch_floor, cpu.max_batch = 1, None
    finals = [p.text for sid in sids for p in phrases[sid]]
    if sorted(finals) != sorted(text for _, _, text in decoded):
        raise AssertionError(f"finals {finals} are not the batched calls' {decoded}")
    for lp, hw, text in decoded:
        want = cpu.forward_batch([lp], [hw] if hw is not None else None)[0]
        if text != want:
            raise AssertionError(f"{name}: final on the card {text!r} != CPU decoder {want!r}")
    return {"phase": name, "fusion": fusion, **run["out"], "finals_checked": len(decoded),
            "finals_calls": finals_calls}


def phase_serve_beam() -> dict:
    """The serve cell with the LM-rescoring device decoder, interim device
    beams and word timestamps."""
    from tone_tpu_torch.decoding.lm import ArpaLM

    return _device_serve_phase("serve_beam", ArpaLM(beam_lm_tables()), fusion=False,
                               word_timestamps=True, interim_device_beam=True)


def phase_serve_fused() -> dict:
    """The serve cell with the fused decoder (the LM inside the device
    search); warmup runs its finals ladder."""
    from tone_tpu_torch.decoding.lm import ArpaLM

    return _device_serve_phase("serve_fused", ArpaLM(beam_lm_tables()), fusion=True,
                               word_timestamps=False, interim_device_beam=False)


def phase_serve_host_beam() -> dict:
    """The serve cell with the host beam decoder (the native C++ search at
    width 200, built by this run): finals per phrase on the pool, carried
    host-beam interims, request hotwords on one stream (a host beam of the
    stream's own).  Every final must equal a second decode of its logprobs
    by the decoder that made it."""
    import tempfile
    from pathlib import Path

    import torch

    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.decoder import BeamSearchCTCDecoder
    from tone_tpu_torch.decoding.estimate import write_arpa
    from tone_tpu_torch.decoding.native import beamsearch
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    t0 = time.perf_counter()
    if not beamsearch.build_native():
        raise AssertionError("g++ failed to build the native beam decoder")
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        write_arpa(beam_lm_tables(), Path(tmp) / "lm.arpa")
        decoder = BeamSearchCTCDecoder.from_local(Path(tmp) / "lm.arpa")
    if not decoder._use_native or decoder._native_lm is None:
        raise AssertionError("the host beam decoder is not on its native library")
    cfg = ToneConfig()
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    engine = MultiStreamEngine(variables, cfg, n_slots=SERVE_SLOTS, device="cuda",
                               decoder=decoder, interim_beam=True)
    decoded = []
    real_decode = engine._decode

    def recorded(phrase, dec=None, nbest=0):
        t0 = time.perf_counter()
        out = real_decode(phrase, dec, nbest)
        decoded.append((phrase, dec or engine.decoder, nbest, out.text,
                        (time.perf_counter() - t0) * 1e3))
        return out

    engine._decode = recorded

    def setup(engine, sids):
        engine.set_stream_hotwords(sids[1], BEAM_HOTWORDS, 5.0)
        over = engine._streams[sids[1]].decoder
        if not isinstance(over, BeamSearchCTCDecoder) or not over._use_native:
            raise AssertionError(f"request hotwords gave {over!r}, not a native host beam")

    try:
        run = _serve_cell(engine, setup)
    finally:
        engine.shutdown()
    if not engine.interim_beam or run["out"]["interim_events"] == 0:
        raise AssertionError("no carried host-beam interims")
    finals = [p.text for sid in run["sids"] for p in run["phrases"][sid]]
    if sorted(finals) != sorted(d[3] for d in decoded):
        raise AssertionError(f"finals {finals} are not the pool's decodes")
    alone_ms = []
    for phrase, dec, _, text, _ in decoded:
        t0 = time.perf_counter()
        again = dec.forward(np.ascontiguousarray(phrase.logprobs))
        alone_ms.append((time.perf_counter() - t0) * 1e3)
        if again != text:
            raise AssertionError(f"host beam final {text!r} != a second decode {again!r}")
    return {"phase": "serve_host_beam", "beam_width": decoder.beam_width,
            "native": decoder._use_native, "native_build_s": build_s, **run["out"],
            "finals_checked": len(decoded),
            "final_ms": [[len(d[0].logprobs), d[4], ms] for d, ms in zip(decoded, alone_ms)],
            "final_ms_fields": ["frames", "ms on the pool in the run", "ms alone"]}

# The bulk cell: 16 utterances of speech-shaped audio (the port's
# synthesize_speech_like, seeds 0-15) of these many seconds, about 8 minutes,
# transcribed as one batch.
BULK_SECONDS = (4, 6, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52, 56, 60)
BULK_BATCH = 16
BULK_CPU_ROWS = 2       # the utterances (4 and 6 s) also run on the CPU
BULK_REFS = ["да нет", "привет мир", "спасибо до свидания", "алло слушаю"]
BULK_DEVICE = "cuda"


def bulk_corpus() -> list[np.ndarray]:
    """The bulk cell's utterances: phrases of about 2.5 s with the
    synthesizer's 0.8 s pauses, filling each utterance's length."""
    from tone_tpu_torch.audio.examples import synthesize_speech_like

    audios = []
    for seed, total in enumerate(BULK_SECONDS):
        n = max(1, round((total - 0.5) / 3.3))
        phrase = (total - 0.5) / n - 0.8
        audios.append(synthesize_speech_like(seed, (phrase,) * n).astype(np.int32))
    return audios


def _phrases(phrases) -> list:
    return [(p.text, p.start_time, p.end_time) for p in phrases]


def _bulk_forward(name, transcriber, audios, frames) -> tuple[dict, list, list]:
    """One forward of the bulk cell: a warm run (the logprobs), a timed run
    (the phrases) with its kernel launches and peak memory, and a profiled
    run for device time."""
    import torch

    from tone_tpu_torch.ops.glu_ff import glu_ff2

    logprobs = transcriber.logprobs(audios)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    glu_ff2.launches = 0
    t0 = time.perf_counter()
    phrases = transcriber.transcribe(audios)
    wall = time.perf_counter() - t0
    launches = glu_ff2.launches
    peak = torch.cuda.max_memory_allocated()
    chunk = transcriber.config.audio_chunk_samples
    pad = transcriber.config.padding
    n_chunks = -(-max(-(-(len(a) + 2 * pad) // chunk) for a in audios) // 8) * 8
    want = 32 * (1 if transcriber.use_offline_forward else n_chunks)
    if launches != want:
        raise AssertionError(f"bulk {name}: {launches} GLU launches, expected {want}")
    prof = _device_profile(lambda: transcriber.transcribe(audios), top=6)
    audio_s = sum(len(a) for a in audios) / 8000
    for k, (lp, a) in enumerate(zip(logprobs, audios)):
        if lp.shape[1] != 35 or not np.isfinite(lp).all() \
                or lp.shape[0] != -(-(len(a) + 2 * pad) // chunk) * frames:
            raise AssertionError(f"bulk {name} utterance {k}: logprobs {lp.shape} or non-finite")
    for k, ps in enumerate(phrases):
        times = [t for p in ps for t in (p.start_time, p.end_time)]
        if times != sorted(times) or any(t < 0 for t in times):
            raise AssertionError(f"bulk {name} utterance {k}: phrase times {times}")
    return ({"forward": name, "audio_s": audio_s, "wall_s": wall, "rtfx": audio_s / wall,
             "chunks_per_row": n_chunks, "glu_launches_per_batch": launches,
             "device_ms": prof["device_ms"], "device_launches": prof["launches"],
             "device_idle_share": 1.0 - prof["device_ms"] / (wall * 1e3),
             "top_kernels": prof["top_kernels"],
             "peak_memory_bytes": peak, "phrases": sum(len(p) for p in phrases)},
            logprobs, phrases)


def phase_bulk() -> dict:
    import tempfile
    from pathlib import Path

    import torch

    from tone_tpu_torch.audio.flac_write import encode_flac
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.decoder import GreedyCTCDecoder
    from tone_tpu_torch.eval import evaluate_pipeline
    from tone_tpu_torch.offline import OfflineTranscriber
    from tone_tpu_torch.ops import align_device
    from tone_tpu_torch.ops.greedy import batched_greedy_decode
    from tone_tpu_torch.splitter import StreamingLogprobSplitter
    from tone_tpu_torch.training.wer import word_error_rate

    cfg = ToneConfig()
    frames = cfg.encoder.chunk_size
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    t0 = time.perf_counter()
    audios = bulk_corpus()
    corpus_s = time.perf_counter() - t0

    def transcriber(device, **kw):
        return OfflineTranscriber(variables, cfg, batch_size=BULK_BATCH, device=device, **kw)

    scan, full = transcriber(BULK_DEVICE), transcriber(BULK_DEVICE, use_offline_forward=True)
    runs, lps, texts = [], {}, {}
    for name, tr in (("scan", scan), ("offline_forward", full)):
        run, lps[name], phrases = _bulk_forward(name, tr, audios, frames)
        runs.append(run)
        texts[name] = [_phrases(p) for p in phrases]
    forward_err = max(float(np.abs(a - b).max()) for a, b in zip(lps["scan"],
                                                                   lps["offline_forward"]))
    if not forward_err <= STEP_TOL:
        raise AssertionError(f"bulk scan vs full-sequence forward on the card: "
                             f"{forward_err} > {STEP_TOL}")
    texts_equal = sum(a == b for a, b in zip(texts["scan"], texts["offline_forward"]))

    # Card against CPU, both forwards, on the two shortest utterances.
    short = audios[:BULK_CPU_ROWS]
    cpu_rows = []
    for name, kw in (("scan", {}), ("offline_forward", {"use_offline_forward": True})):
        cpu = transcriber("cpu", **kw)
        err = max(float(np.abs(a - b).max()) for a, b in zip(lps[name], cpu.logprobs(short)))
        if not err <= STEP_TOL:
            raise AssertionError(f"bulk {name}, card vs CPU: {err} > {STEP_TOL}")
        cpu_texts = [_phrases(p) for p in cpu.transcribe(short)]
        cpu_rows.append({"forward": name, "max_abs_err": err,
                         "texts_equal": cpu_texts == texts[name][:BULK_CPU_ROWS],
                         "card": [[p[0][:40] for p in u] for u in texts[name][:BULK_CPU_ROWS]],
                         "cpu": [[p[0][:40] for p in u] for u in cpu_texts]})

    # Greedy collapse on the card against the host decoder, whole utterances.
    lens = [lp.shape[0] for lp in lps["offline_forward"]]
    padded = np.zeros((len(lens), max(lens), 35), np.float32)
    for k, lp in enumerate(lps["offline_forward"]):
        padded[k, :len(lp)] = lp
    greedy = batched_greedy_decode(torch.from_numpy(padded).to(BULK_DEVICE), lens)
    host = GreedyCTCDecoder()
    if greedy != [host.forward(lp) for lp in lps["offline_forward"]]:
        raise AssertionError("batched greedy decode on the card differs from the host decoder")

    # Forced alignment of every phrase's greedy text: card against CPU, by
    # bucket, and the word tuples of align_words_batch.
    splitter = StreamingLogprobSplitter()
    phrase_lps = [np.ascontiguousarray(p.logprobs) for lp in lps["offline_forward"]
                  for p in splitter.forward(lp, None, is_last=True)[0]]
    phrase_texts = [host.forward(lp) for lp in phrase_lps]
    exts, groups = align_device._bucket_groups(phrase_lps, phrase_texts)
    buckets = []
    for (t_pad, s_pad), idxs in sorted(groups.items()):
        staged = align_device._stage_bucket(phrase_lps, exts, idxs, t_pad, s_pad)
        paths = {}
        for device in ("card", "cpu"):
            args = [torch.from_numpy(a).to(BULK_DEVICE if device == "card" else "cpu")
                    for a in staged]
            align_device._viterbi_path(*args)   # first call: warm
            t0 = time.perf_counter()
            path, _ = align_device._viterbi_path(*args)
            paths[device] = path.cpu().numpy()   # the copy waits for the card
            paths[device + "_ms"] = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(paths["card"], paths["cpu"]):
            raise AssertionError(f"Viterbi paths differ, card vs CPU, bucket {(t_pad, s_pad)}")
        buckets.append({"frames": t_pad, "states": s_pad, "rows": len(idxs),
                        "ms": paths["card_ms"], "cpu_ms": paths["cpu_ms"]})
    words_card = align_device.align_words_batch(phrase_lps, phrase_texts, device=BULK_DEVICE)
    if words_card != align_device.align_words_batch(phrase_lps, phrase_texts, device="cpu"):
        raise AssertionError("align_words_batch: word tuples differ, card vs CPU")
    timed = transcriber(BULK_DEVICE, use_offline_forward=True,
                        word_timestamps=True).transcribe(audios)
    if any((p.words is None) != (not p.text.split()) for ps in timed for p in ps):
        raise AssertionError("word_timestamps: a phrase with text has no word times")

    # Corpus evaluation over a manifest of the utterances, one at a time
    # through the full-sequence forward; the WER recomputed from its outputs.
    class Recorded:
        def __init__(self):
            self.hyps = []

        def forward_offline(self, audio):
            phrases = full.forward_offline(audio)
            self.hyps.append(" ".join(p.text for p in phrases if p.text))
            return phrases

    refs = [BULK_REFS[k % len(BULK_REFS)] for k in range(len(audios))]
    recorded = Recorded()
    result = evaluate_pipeline(recorded, [{"audio": a, "text": r} for a, r in zip(audios, refs)])
    if result.n_utterances != len(audios) \
            or abs(result.audio_seconds - runs[0]["audio_s"]) > 1e-6 \
            or result.wer != word_error_rate(recorded.hyps, refs):
        raise AssertionError(f"evaluate_pipeline: {result}")

    # The CLI: two FLACs (written by the port's encoder) through
    # `python -m tone_tpu_torch transcribe --batch-size 16 --json`, against
    # the same batch transcribed here.
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        files = [str(Path(tmp) / f"utt{k}.flac") for k in range(BULK_CPU_ROWS)]
        for path, a in zip(files, short):
            encode_flac(path, a.astype(np.int16), 8000)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tone_tpu_torch", "transcribe",
                               "--batch-size", str(BULK_BATCH), "--json", "--device", BULK_DEVICE,
                               *files],
                              cwd=repo, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"transcribe CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    records = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    got = [[(p["text"], p["start_time"], p["end_time"]) for p in r["phrases"]]
           for r in records]
    if [r["file"] for r in records] != files or not all(got) or any(
            [t for p in u for t in p[1:]] != sorted(t for p in u for t in p[1:]) for u in got):
        raise AssertionError(f"transcribe CLI: {proc.stdout[-2000:]}")
    # The same batch here: equal texts unless the process's numerics differ.
    cli_equal = got == [_phrases(p) for p in scan.transcribe(short)]
    return {"phase": "bulk", "config": "ToneConfig() bf16", "utterances": len(audios),
            "seconds": list(BULK_SECONDS), "batch": BULK_BATCH, "corpus_s": corpus_s,
            "runs": runs, "max_abs_err_scan_vs_offline_forward": forward_err,
            "tol": STEP_TOL, "texts_equal_scan_vs_offline_forward": texts_equal / len(audios),
            "cpu": cpu_rows, "greedy_texts_equal": True,
            "viterbi": {"phrases": len(phrase_lps), "buckets": buckets},
            "eval": {"wer": result.wer, "utterances": result.n_utterances,
                     "audio_seconds": result.audio_seconds,
                     "wall_seconds": result.wall_seconds, "rtfx": result.rtfx},
            "cli": {"files": len(files), "seconds": cli_s, "texts_equal_in_process": cli_equal}}


PHASES = ("kernels", "step", "serve", "fused_kernels", "fused_step", "beam_decode",
          "serve_beam", "serve_fused", "serve_host_beam", "bulk")


def kernel_summary(out: dict) -> dict:
    """The line of every kernel: its launches on its main paths, errors,
    times and bounds."""
    kernels, serve, fused, fused_step, bulk = (
        out[k] for k in ("kernels", "serve", "fused_kernels", "fused_step", "bulk"))
    # The serve phase is the main path: its full-rate layers give M = 10 * slots.
    main_m = SERVE_SLOTS * 10
    case = next(c for c in kernels["cases"] if c["m"] == main_m)
    # The fused step is B2's main path: its 16 layers at B = 64, so B2's
    # times are the mean per launch over a step's mix of layer kinds.
    step_cases = [(c, FUSED_KINDS[c["kind"]][1]) for c in fused["cases"] if c["batch"] == 64]
    per_launch = {key: sum(c[key] * n for c, n in step_cases) / 16
                  for key in ("ms", "plain_ms", "bound_ms")}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share", "gemm_ms")
    return {"kernels": [{
        "name": "glu_ff2", "route": "cuda", "source": "tone_tpu_torch/csrc/glu_ff.cu",
        "replaces": "tone_tpu/ops/glu_ff.py:60", "launches": serve["glu_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in kernels["cases"]),
        "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"], "bound_share": case["bound_share"], "library_ms": None,
        "event_ms": case["event_ms"], "gemm_ms": case["gemm_ms"], "m": main_m,
        "bulk_launches_per_batch": {r["forward"]: r["glu_launches_per_batch"]
                                    for r in bulk["runs"]},
        "bulk_m": [{"m": c["m"], **{k: c[k] for k in keys}}
                   for c in kernels["cases"] if c["m"] in BULK_MS]}, {
        "name": "fused_conformer_layer", "route": "cuda",
        "source": "tone_tpu_torch/csrc/fused_layer.cu",
        "replaces": "tone_tpu/ops/fused_layer.py:445",
        "launches": fused_step["fused_launches"],
        "max_abs_err": max(v for c in fused["cases"] for v in c["max_abs_err"].values()),
        **per_launch,
        "bound_by": max(("bytes", "operations"), key=lambda by: sum(
            c["bound_ms"] * n for c, n in step_cases if c["bound_by"] == by)),
        "library_ms": None, "shape": "mean per launch over the 16 layers of a B=64 step"}]}


def run_phase(fn, *args) -> dict:
    """Run one phase, add its seconds as ``phase_s`` and print its line."""
    t0 = time.perf_counter()
    out = fn(*args)
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return out


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    parser.add_argument("--profile-check", action="store_true",
                        help="beam_decode: also run the fused variants at 1024 and 2048 "
                             "frames, read each profile through key_averages() "
                             "and profile each non-fused call twice")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run after the build (default: "
                             "all; the kernel summary line needs kernels, serve, "
                             "fused_kernels, fused_step and bulk)")
    args = parser.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        parser.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
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
    run_phase(phase_build)
    out = {}
    for name in phases:
        fn = globals()["phase_" + name]
        out[name] = run_phase(fn, args.profile_check) if name == "beam_decode" else run_phase(fn)
    if {"kernels", "serve", "fused_kernels", "fused_step", "bulk"} <= set(out):
        emit(kernel_summary(out))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
