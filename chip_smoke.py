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
5. artifacts the same model's weights written as .safetensors
            (plain and with the ``tone.`` prefix), .bin, the port's checkpoint
            directory and .nemo (from the serving variables), each loaded with
            ``StreamingCTCModel.from_local`` on the card: write and load
            seconds, bytes, 64 streams x 5 chunks bit-equal to the directly
            built model with 32 GLU kernel launches per step;
            ``transcribe --checkpoint`` and ``$TONE_TPU_MODEL_DIR`` as
            subprocesses, their phrases equal to the in-process pipeline's;
            ``StreamingCTCPipeline.from_local`` over model.safetensors and an
            lm.arpa made by ``python -m tone_tpu_torch lm --native``: its texts
            equal to the directly built model's with the same decoder, its
            logprobs within 0.1 of the same pipeline's on the CPU (the texts
            of both and their character edit distance recorded);
            ``export_streaming`` at B = 64, and at B = 1 in a process of its
            own beside it (``--export-child``; seconds each), the B=64 program
            loaded in a fresh process
            (``--exported-child``): one step
            within 1e-6 of the eager step with 32 launches, ms per step
            against the eager step in turns; ``profiling.step_stats`` at
            B = 64 (the two-point slope over chains of 10 and 60 steps);
6. serve    the port's ``MultiStreamEngine`` with 16 slots, driven as the
            server's tick loop drives it: three streams of 3 s of seeded
            PCM, each must yield a final phrase, every tick must launch the
            kernel; the first ticks are profiled for device time per tick;
7. fused_kernels  the fused Conformer-layer kernel against its plain
            version at full width for every layer kind of the step, at
            B = 64, 16 and 1, with its time, the plain version's, the bound
            and the share of the bound it reaches (bound / time);
8. fused_step  the same model and audio as ``step`` through
            ``ops.fused_encoder.apply_streaming_fused``: 16 fused-layer
            launches per step and none of the GLU kernel, logprobs checked
            against the eager step on the card and the CPU plain path for 2
            streams, with step time, device time, device ops and idle share;
9. beam_decode  ``DeviceBeamSearchCTCDecoder`` on the card at the serving
            defaults (beam width 32, n-best 8, max_len 2048, 64 rows per
            call) on seeded blank-heavy logprobs in every frame bucket 64 …
            2048, LM-free, with an order-3 ARPA LM (estimated by the port
            from a seeded synthetic corpus) and with hotwords; the same LM
            fused into the search (``fusion=True``): as a ``DeviceLM``
            (``fused``), as the probing binary's own tables
            (``fused_probing``) and with hotwords (``fused_hotwords``); ms
            per call at every bucket (the fused variants at 64 … 512, and
            also at 1024 and 2048 with ``--profile-check``), device ms,
            launches per frame and idle share up to 512 frames (at every
            bucket with ``--profile-check``); the LM-free, LM and hotword
            variants held against the same decoder on the CPU at 64 … 512
            (at every bucket with ``--profile-check``), the fused ones at 64,
            128 and 256 (equal top texts, best scores within 1e-3); with
            ``--profile-check``, each profile also
            read through ``key_averages()`` and each non-fused call profiled
            twice (adds minutes); the LM once more as a KenLM probing binary (equal texts
            at every bucket); the agreement of the ARPA and probing fused
            texts, and of the fused top-1 with the port's host beam search
            (W=32, T=64);
10. serve_beam  the ``serve`` phase's engine with the ``beam_decode`` LM
            decoder for finals, the interim device beam arena (width 8), word
            timestamps, one stream with request hotwords and one with n-best
            4: every stream yields a final, phrase and word times are
            ordered, every tick launches the GLU kernel 32 times, and every
            final's text equals the port's CPU decoder on that phrase;
11. serve_fused  the same cell with the fused decoder (``fusion=True``):
            warmup runs the fused finals ladder; one stream with request
            hotwords (stacked rows), one with n-best 4; every final equals
            the port's fused decoder on the CPU on that phrase's logprobs;
            every tick launches the GLU kernel 32 times; each finals call is
            timed in the run and alone;
12. serve_host_beam  the same cell with the host ``BeamSearchCTCDecoder``
            (the native C++ search, width 200, built by this run), carried
            host-beam interims and request hotwords on one stream: the
            native library must be built and used, every final equals a
            second decode of its logprobs;
13. bulk    ``OfflineTranscriber`` over 16 utterances of speech-shaped
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
            port's encoder;
14. train   ``Trainer`` on the full-width ``ToneConfig()`` (seed-0 random
            weights, bf16 compute, float32 parameters and AdamW state,
            dropout 0.1, blocked attention, lr 3e-4 over 20 steps) on one
            batch of 16 utterances of speech-shaped audio (seeds 100-115,
            4-12 s, 128 s in all) labelled with phrases and collated by the
            port's collator: 2 warm steps, 10 timed (ms per step, audio s
            per s, peak memory, every loss; the losses finite and the last
            below the second, the first at lr 0), 3 profiled (device ms per
            step, idle share, launches per step); one step's gradients with
            ``remat="full"`` and ``"dots"`` against none from the same state
            and dropout seed, in bf16 and in float32 compute (loss within
            1e-5, gradients within 1e-2 and 1e-4 of their norm; another
            dropout seed in float32 must differ by 100 times that; peak
            memory of each); the step's loss, gradients and
            BatchNorm statistics on the card against the CPU at dropout 0 on
            2 utterances of 3 s; the trained weights streamed through
            ``StreamingCTCModel.forward_native`` (2 streams x 5 chunks, 32
            GLU kernel launches per step) within 0.1 of the offline forward;
15. parallel  the device mesh on this one card, the same model: bulk
            (``OfflineTranscriber(mesh=make_mesh(devices=[cuda:0, cuda:0]))``,
            one batch of the bulk cell's first 8 utterances, 4 rows per
            replica, both forwards) with the one-device transcriber's texts
            and times, B1 launched on both replicas (2 x 32 per chunk column
            in the scan), wall seconds of the two in turns; serving (the serve
            cell's streams through 16 slots, 8 + 8 over the two replicas)
            with the unsplit engine's finals, 2 x 32 launches per tick and the
            tick median; training (the train cell's first 4 utterances, 3
            steps) as two gloo ranks on the card at (data, model) = (2, 1)
            and (1, 2), each loss within 1e-2 of one process's, ms and
            all-reduced bytes per step; one NCCL rank (a 1 x 1 mesh), its step
            saved: loss within 1e-5 of the step without a mesh, Adam's first
            moment within 1e-2 of it.  Two replicas or ranks on one card
            measure correctness and overhead, not scaling;
16. recipes  the port's recipes and quality studies on a trained model
            (``tone_tpu_torch/examples``, ``tone_tpu_torch/dev``): the tiny
            Conformer trained once, 150 steps in float32 from the JAX
            recipe's seed-0 weights (ms per step), then: train WER < 0.05 and
            at least 5 of 6 exact texts through the streaming pipeline (and,
            reported only, the texts of the same recipe from the port's own
            torch.Generator(0) weights); the same weights deployed in
            bf16 (B1 at F=256, D=128: launches per step, and against its
            plain version within 2e-2 at the deployment's row counts, timed),
            its texts and logprobs against the float32 deployment's;
            ``domain_adapt`` (order-3 KN LM as a KenLM binary, the fused
            device search with a hotword, word times): at least one exact
            text, every word time inside its utterance; the device beam
            (width 32, n-best 8) agreeing with the host width-200 fusion on
            at least 95 % of noisy utterances; ``hotword_quality`` at weights
            0 and 2; ``finetune --synthetic --epochs 1`` at full width from a
            .safetensors of random weights, ``--resume`` restoring its step,
            and the saved model streamed through ``from_local`` with 32 B1
            launches per step; ``device_lm_scale`` at 0.6e6 grams (build s,
            device bytes, fused RTFx); ``debug_sequence``'s invariants at
            full width;
17. bench   the port's measurement tools (``tone_tpu_torch/bench.py``,
            ``tone_tpu_torch/dev/{tick_bench,load_test,train_bench,align_bench}.py``)
            at full width from the JAX bench's initial weights: the step sweep
            at B = 128, 512, 1024, 1280 (ms per step, RTFx, peak memory per
            stream; chains of 10 and 40 steps; B1's launches over it; the largest
            batch profiled: device ms, idle share) and B1 at its rows there
            and in the tick (M = 5,120, 6,400, 10,240 and 12,800) against its
            plain version; the engine tick
            at 1,024 slots (host, device and tick p50/p95, memory per slot, 32
            B1 launches per tick) and the splitter's worst case there; the
            websocket load test against spawned ``serve --device cuda --slots
            64`` processes (real-time and firehose rounds at 16 and 64 streams,
            a round with n-best 4 and 8 hotword streams on a device-beam
            server, an 8 s soak whose RSS must stay flat, and SIGTERM under 64
            live streams: every stream flushed and closed with 4503); the train
            bench (B = 16 clips of 10 s, without and with ``remat="full"``, chains
            of 4 and 12 steps: step ms, audio s per s, peak memory); the align
            bench with ``--kernel``
            (device and host words equal);
18. deploy  the serving image's path without docker (``Dockerfile.torch``
            read for its ENTRYPOINT, ENV, USER and prebuild line): the
            wheel built from a copy of its inputs (``pip wheel --no-deps``)
            and installed with ``pip install --target``, read-only; the
            seed-0 weights saved as a checkpoint directory; an in-process
            ``MultiStreamEngine`` of the ENTRYPOINT's flags (its slots) gives
            9 speech-like streams' finals, B1 launched 32 times per tick;
            the ENTRYPOINT's console script run from the installed copy (no
            repo on the path), as uid 65534 where the phase runs as root,
            cold (no compile cache, an empty ``$XDG_CACHE_HOME``: B1 built
            from the wheel's sources into the user's cache, under this
            checkout's name) and warm (the prebuild line's cache, no nvcc
            reachable, nothing built): ready on ``/v2/health/ready``; 8
            streams end with their end-of-stream frame, a ninth is still open
            at the SIGINT (the image's STOPSIGNAL, sent once the server has
            taken in every frame); every stream's finals equal to the
            engine's, the 8 closed with 1000, the drained one with 4503,
            exit 0, nothing under the installed tree changed; wheel, install,
            prebuild, ready and drain seconds;
19. hub     the Hugging Face Hub path against an endpoint on 127.0.0.1
            (``tone_tpu_torch/dev/local_hub.py``) serving the seed-0
            model.safetensors and a kenlm.bin of the recipes' bigram LM:
            ``StreamingCTCPipeline.from_hugging_face()`` on the card, cold
            (download over loopback and load, s) and, with the endpoint
            stopped and ``HF_HUB_OFFLINE=1``, warm from the cache (s); over
            the short example FLAC, both models' step logprobs equal to the
            bit to ``from_local``'s on the served files, the cold pipeline's
            texts equal to its, B1 launched 32 times per step; ``python -m
            tone_tpu_torch download DIR`` in a process of its own (the served
            bytes); the checkpoint, LM and a VAD file pushed with the port's
            push_hf, its model.safetensors loading bit-equal.
20. rel_attention  kernel B3 (``ops/rel_attention.py``) at the Parakeet
            cell's four batches (``dev/torch_rel_attention_ab.py
            cell_batches``: 16 rows, longest 3,550, 1,142, 763 and 491
            frames; H 8, d_head 128; seeded bf16 projections): one launch per
            call, counted from zero, held to its plain version
            (``layers.rel_attention_plain``) on the same inputs within the card
            tests' limits (max 2^-6 of the larger of 1 and the row's largest
            value, RMS 2^-7 of the row's RMS; rows past each length zero),
            its device time per launch (profiler) beside its bound (6 T^2 d
            useful operations per row at the bf16 peak) and the plain
            version's time; then the full-width ``FastConformerConfig()``
            (random weights, seed 0) through ``OfflineTranscriber`` on 16
            calls: 42 launches, one per layer, in the forward.

``--phases`` runs a subset after the build (for development; the kernel
summary line holds B1 where the kernels, serve and bulk phases ran, B2
where fused_kernels and fused_step ran, B3 where rel_attention ran).
Every phase line after ``device`` gives the phase's seconds as
``phase_s``.  Then the kernel summary line and, last, ``{"ok": true, "device": {...}}``.
Any failure raises (exit code non-zero); without a GPU, or without the
package beside this script, it exits non-zero before printing a result.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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


def glu_ff_cases(device, ms=GLU_MS):
    """(m, av, p2) at F=1536, D=384 for the row counts of the bulk forward
    and the serving path: 10*B in full-rate layers and 5*B in reduced ones,
    for B in 256, 64, 16, plus ragged tails (37 and 10 rows)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    f, d = 1536, 384
    for m in ms:
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


def glu_ff_row(m, av, p2) -> dict:
    """B1 on one case: against its plain version (raises beyond GLU_TOL),
    its device time per launch (profiler) and CUDA-event time over 200
    launches, the plain version's time, the bound and, as a yardstick,
    cuBLAS's product alone on the gate computed beforehand."""
    import torch

    from tone_tpu_torch.ops.glu_ff import _plan, _sm_count, glu_ff2, glu_ff2_plain

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
    a32 = av[:, :f].float()
    g = (a32 * torch.sigmoid(a32)).to(torch.bfloat16) * av[:, f:]
    b16 = p2["b"].to(torch.bfloat16)
    gemm_ms = device_time_ms(lambda: torch.addmm(b16, g, p2["w"]), 200)
    bound_ms, bound_by = glu_ff_bound_ms(m, f, d)
    plan = _plan(m, f, d, _sm_count(torch.cuda.current_device()))
    return {"m": m, "max_abs_err": err, "ms": ms, "event_ms": event_ms,
            "plain_ms": plain_ms, "gemm_ms": gemm_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "tile": "big" if plan.big else "small", "grid": list(plan.grid)}


def phase_kernels() -> dict:
    rows = [glu_ff_row(m, av, p2) for m, av, p2 in glu_ff_cases("cuda")]
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
# time limit.
FUSED_CPU_BUCKETS = (64, 128, 256)
# The other variants' CPU reference runs at these buckets, and with
# --profile-check at every bucket: at 1024 and 2048 frames it takes about
# 100 s on the card host's CPU, a third of the phase.
CPU_BUCKETS = (64, 128, 256, 512)
# The fused variants' calls above 512 frames are timed only (no CPU
# reference) and take about 100 s with their profiles: they run with
# --profile-check, so that the default run, bulk phase included, stays
# within 900 s on a slow host.
FUSED_DEFAULT_BUCKETS = (64, 128, 256, 512)
# Calls above this many frames are timed but not profiled (their hundreds of
# thousands of events cost more than the calls), unless --profile-check.
BEAM_PROFILED_MAX = 512
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
        raise AssertionError("the profiler saw no device time for the call")
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
            case = {"variant": variant, "frames": t_pad, "rows": BEAM_ROWS, "ms": ms}
            if profile_check or t_pad <= BEAM_PROFILED_MAX:
                prof = _device_profile(lambda: card.forward_batch_nbest(lps, BEAM_NBEST),
                                       profile_check)
                case.update(prof, launches_per_frame=prof["launches"] / t_pad,
                            device_idle_share=1.0 - prof["device_ms"] / ms)
            if profile_check and not fusion:
                # the same call profiled again: how far the count moves
                again = _device_profile(lambda: card.forward_batch_nbest(lps, BEAM_NBEST))
                case.update(launches_again=again["launches"], device_ms_again=again["device_ms"])
            texts_by_variant[variant].append([h[0][0] if h else "" for h in got])
            if t_pad not in (FUSED_CPU_BUCKETS if fusion else
                             BEAM_BUCKETS if profile_check else CPU_BUCKETS):
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
            "cpu_buckets": list(BEAM_BUCKETS if profile_check else CPU_BUCKETS),
            "fused_buckets": list(BEAM_BUCKETS if profile_check else FUSED_DEFAULT_BUCKETS),
            "profile_check": profile_check,
            "fused_arpa_vs_probing_text_agreement": probing_agree,
            "fused_vs_host_beam_top1_agreement": host_agree,
            "ms": "host clock around one call (ends with the n-best read back); "
                  "device_ms and launches summed over torch.profiler's raw events of "
                  "one more call (of at most BEAM_PROFILED_MAX frames without "
                  "--profile-check); *_key_averages: the same profile through "
                  "key_averages(), where it has at most KEY_AVERAGES_MAX_EVENTS "
                  "events; *_again: a second profiled call (LM-free, LM, hotwords); "
                  "both with --profile-check only",
            "cases": rows}


def _serve_cell(engine, setup, replicas: int = 1) -> dict:
    """Drive the serve cell through ``engine`` as the server's tick loop
    does: three streams of 3 s of seeded PCM (with the server's padding),
    ``setup(engine, sids)`` before the audio; the first ticks run under the
    profiler; every tick must launch the GLU kernel 32 times on each of the
    arena's ``replicas`` and every stream must yield ordered final
    phrases."""
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
    if launches != 2 * cfg.encoder.n_layers * replicas * ticks:  # 32 a step and replica
        raise AssertionError(f"{launches} GLU launches over {ticks} ticks on {replicas} replicas")
    phrases = {sid: [f.result(timeout=600) for f in futs] for sid, futs in futures.items()}
    for sid, ps in phrases.items():
        if not ps:
            raise AssertionError(f"stream {sid} yielded no final phrase")
        times = [t for p in ps for t in (p.start_time, p.end_time)]
        if times != sorted(times) or any(t < 0 for t in times):
            raise AssertionError(f"stream {sid}: phrase times out of order: {times}")
    return {"sids": sids, "phrases": phrases, "out": {
        "slots": engine.arena.n_slots, "streams": len(sids), "ticks": ticks, "glu_launches": launches,
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


# The train cell: 16 utterances of speech-shaped audio (the port's
# synthesizer, seeds 100-115) of these many seconds, 128 s in all, one batch,
# each labelled with one phrase of TRAIN_TEXTS per synthesized phrase.
TRAIN_SECONDS = tuple(4 + 8 * k / 15 for k in range(16))
TRAIN_TEXTS = ("да нет", "привет мир", "спасибо до свидания", "алло слушаю",
               "добрый день", "всего хорошего")
TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED = 2, 10, 3
TRAIN_LOSS_TOL = 1e-5       # remat against none: relative loss
# ... and |Δg| / |g| of the flattened gradients.  The bf16 backward rounds
# every activation gradient to bf16, so any change of summation order (the
# card picks among GEMM and convolution algorithms per call) grows through
# the layers to about one bf16 step: two runs of the same step differ by 0
# or about 4e-3 (dev/torch_train_remat_noise.py), as much as other dropout
# masks may move them.  In float32 compute the spread stays small, and a
# second dropout seed, the control, must differ by 100x the bound.
TRAIN_REMAT_GRAD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
TRAIN_CPU_LOSS_TOL = 1e-2   # card against CPU at dropout 0: relative loss,
TRAIN_CPU_COSINE = 0.999    # the cosine of the flattened gradients
TRAIN_CPU_STATS_TOL = 1e-3  # and the updated BatchNorm statistics
TRAIN_DEVICE = "cuda"
# Kinds of device kernel by the first match of their name (first 60 chars).
TRAIN_KERNEL_KINDS = (("gemm", ("gemm",)), ("conv", ("cudnn", "conv", "dgrad", "wgrad")),
                      ("glu_ff2", ("glu_ff2",)), ("reduce", ("reduce", "norm", "softmax")),
                      ("ctc", ("ctc",)), ("elementwise", ("elementwise", "foreach", "copy")))


def train_features(seeds, seconds) -> list[dict]:
    """Utterances of phrases of about 2.5 s with the synthesizer's 0.8 s
    pauses, as collator features: float audio in [-1, 1] and the text of
    their phrases."""
    from tone_tpu_torch.audio.examples import synthesize_speech_like

    feats = []
    for seed, total in zip(seeds, seconds):
        n = max(1, round((total - 0.5) / 3.3))
        audio = synthesize_speech_like(seed, ((total - 0.5) / n - 0.8,) * n)
        text = " ".join(TRAIN_TEXTS[(seed + j) % len(TRAIN_TEXTS)] for j in range(n))
        feats.append({"input_values": audio.astype(np.float32) / 32767.0, "labels": text})
    return feats


def _flat_leaves(tree) -> list:
    from tone_tpu_torch.bridge import tree_leaves

    return [t.detach().float().reshape(-1).cpu() for t in tree_leaves(tree)]


def leaf_names(tree, prefix: str = "") -> list[str]:
    """The path of every leaf of a tree of dicts and tuples, in leaf order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def grad_diff(g: list, base: list, params) -> dict:
    """|g - base| / |base| for gradients given as flat per-leaf tensors (in
    the leaf order of ``params``), and the four leaves that hold most of
    |g - base|² with their shares."""
    diff = [((x - y).norm() ** 2).item() for x, y in zip(g, base)]
    total = sum(diff)
    shares = zip(leaf_names(params), (d / (total or 1.0) for d in diff))
    return {"rel_err": (total / sum((y.norm() ** 2).item() for y in base)) ** 0.5,
            "top_leaves": sorted(shares, key=lambda kv: -kv[1])[:4]}


def phase_train() -> dict:
    import dataclasses

    import torch

    from tone_tpu_torch.acoustic import StreamingCTCModel
    from tone_tpu_torch.bridge import tree_leaves, tree_map
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import apply_offline, init_model_params
    from tone_tpu_torch.ops.glu_ff import glu_ff2
    from tone_tpu_torch.training import DataCollatorCTCWithPadding, Trainer, TrainerConfig

    cfg = ToneConfig()
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    collate = DataCollatorCTCWithPadding()
    t0 = time.perf_counter()
    feats = train_features(range(100, 116), TRAIN_SECONDS)
    corpus_s = time.perf_counter() - t0
    batch = collate(feats)
    audio_s = float(batch["input_lengths"].sum()) / 8000
    tcfg = TrainerConfig(learning_rate=3e-4, total_steps=20)
    trainer = Trainer(cfg, tcfg, device=TRAIN_DEVICE)
    state = trainer.create_state(variables)
    losses = []

    def steps(n):
        nonlocal state
        for _ in range(n):
            state, loss = trainer.train_step(state, batch)
            losses.append(loss)

    steps(TRAIN_WARM)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps(TRAIN_TIMED)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated()
    prof = _device_profile(lambda: steps(TRAIN_PROFILED), top=10_000)
    losses = [float(v) for v in losses]
    timed_losses = losses[:TRAIN_WARM + TRAIN_TIMED]
    if not all(math.isfinite(v) for v in losses) or not timed_losses[-1] < timed_losses[1]:
        raise AssertionError(f"train: losses {losses}")
    device_ms = prof["device_ms"] / TRAIN_PROFILED
    # Device ms per step by kind of kernel (by name).
    kinds = {}
    for name, kernel_ms, _ in prof["top_kernels"]:
        kind = next((k for k, keys in TRAIN_KERNEL_KINDS if any(x in name for x in keys)),
                    "other")
        kinds[kind] = kinds.get(kind, 0.0) + kernel_ms / TRAIN_PROFILED

    # Remat: one step's gradients with each policy from the trained state
    # and one dropout seed (dropout on), against no remat: in the cell's
    # bf16 and, where the card's spread is small enough to tell masks apart,
    # in float32 compute, with another dropout seed as the control.
    remat = {}
    for dtype, runs in (("bfloat16", ((None, 12345), ("full", 12345), ("dots", 12345))),
                        ("float32", ((None, 12345), ("full", 12345), ("dots", 12345),
                                     (None, 54321)))):
        for policy, seed in runs:
            t = Trainer(dataclasses.replace(cfg, compute_dtype=dtype),
                        dataclasses.replace(tcfg, remat=policy), device=TRAIN_DEVICE)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, grads, _ = t.compute_gradients(state, batch, seed=seed)
            remat[f"{dtype}/{policy}/{seed}"] = {
                "loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "g": _flat_leaves(grads)}
            del grads
        base = remat[f"{dtype}/None/12345"]
        for name, r in remat.items():
            if name.startswith(dtype) and r is not base:
                r["loss_rel_err"] = abs(r["loss"] - base["loss"]) / abs(base["loss"])
                d = grad_diff(r["g"], base["g"], state.params)
                r["grad_rel_err"], r["grad_diff_top_leaves"] = d["rel_err"], d["top_leaves"]
    for r in remat.values():
        del r["g"]
    bad = {name: r for name, r in remat.items() if "loss_rel_err" in r
           and not name.endswith("54321") and not (
               r["loss_rel_err"] <= TRAIN_LOSS_TOL
               and r["grad_rel_err"] <= TRAIN_REMAT_GRAD_TOL[name.split("/")[0]])}
    control = remat["float32/None/54321"]["grad_rel_err"]
    if bad or not control > 100 * TRAIN_REMAT_GRAD_TOL["float32"]:
        raise AssertionError(f"train remat: {remat}")

    # Card against CPU: the step's forward and backward at dropout 0 on two
    # utterances of 3 s, from the seed-0 weights.
    cfg0 = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.0,
                                                                 dropout_att=0.0))
    small = collate(train_features((116, 117), (3.0, 3.0)))
    sides = {}
    for device in (TRAIN_DEVICE, "cpu"):
        t = Trainer(cfg0, tcfg, device=device)
        t0 = time.perf_counter()
        loss, grads, stats = t.compute_gradients(t.create_state(variables), small)
        sides[device] = (float(loss), _flat_leaves(grads), torch.cat(_flat_leaves(stats)),
                         time.perf_counter() - t0)
    (lg, gg, sg, card_s), (lc, gc, sc, cpu_s) = sides[TRAIN_DEVICE], sides["cpu"]
    d = grad_diff(gg, gc, variables["params"])
    cpu = {"loss_card": lg, "loss_cpu": lc, "loss_rel_err": abs(lg - lc) / abs(lc),
           "grad_cosine": torch.nn.functional.cosine_similarity(
               torch.cat(gg).double(), torch.cat(gc).double(), dim=0).item(),
           "grad_rel_err": d["rel_err"], "grad_diff_top_leaves": d["top_leaves"],
           "stats_max_abs_err": (sg - sc).abs().max().item(), "card_s": card_s, "cpu_s": cpu_s}
    if not (cpu["loss_rel_err"] <= TRAIN_CPU_LOSS_TOL and cpu["grad_cosine"] >= TRAIN_CPU_COSINE
            and cpu["stats_max_abs_err"] <= TRAIN_CPU_STATS_TOL):
        raise AssertionError(f"train, card vs CPU: {cpu}")

    # Deploy: the trained weights through the streaming step (B1 on the
    # path) against the offline forward of the same weights.
    trained = tree_map(lambda t: t.detach(), {"params": state.params,
                                              "batch_stats": state.batch_stats})
    model = StreamingCTCModel(trained, cfg, device=TRAIN_DEVICE)
    chunk, n_chunks = cfg.audio_chunk_samples, 5
    pcm = np.stack([np.round(f["input_values"][:chunk * n_chunks] * 32767.0)
                    for f in feats[:2]]).astype(np.int32)
    glu_ff2.launches = 0
    stream_state, outs = None, []
    for k in range(n_chunks):
        lp, stream_state = model.forward_native(pcm[:, k * chunk:(k + 1) * chunk], stream_state)
        outs.append(lp)
    torch.cuda.synchronize()
    deploy_launches = glu_ff2.launches
    if deploy_launches != 2 * cfg.encoder.n_layers * n_chunks:   # 32 per step
        raise AssertionError(f"train deploy: {deploy_launches} GLU launches in {n_chunks} steps")
    streamed = torch.cat(outs, dim=1)
    offline, _, _ = apply_offline(trained, cfg, torch.from_numpy(pcm).to(TRAIN_DEVICE))
    if streamed.shape != offline.shape or not torch.isfinite(streamed).all():
        raise AssertionError(f"train deploy: shapes {streamed.shape} {offline.shape}")
    deploy_err = (streamed - offline).abs().max().item()
    if not deploy_err <= STEP_TOL:
        raise AssertionError(f"train deploy: streaming vs offline {deploy_err} > {STEP_TOL}")

    return {"phase": "train", "nvidia_smi": nvidia_smi(), "config": "ToneConfig() bf16",
            "parameters": sum(t.numel() for t in tree_leaves(state.params)),
            "trainer": dataclasses.asdict(tcfg), "utterances": len(feats),
            "batch_shape": list(batch["input_values"].shape), "audio_s": audio_s,
            "corpus_s": corpus_s, "ms_per_step": ms, "audio_s_per_s": audio_s / (ms / 1e3),
            "device_ms_per_step": device_ms, "device_idle_share": 1.0 - device_ms / ms,
            "launches_per_step": prof["launches"] / TRAIN_PROFILED,
            "device_ms_per_step_by_kind": kinds, "top_kernels": prof["top_kernels"][:8],
            "peak_memory_bytes": peak, "losses": losses,
            "remat": remat, "remat_grad_tol": TRAIN_REMAT_GRAD_TOL, "cpu": cpu,
            "deploy": {"streams": 2, "chunks": n_chunks, "glu_launches": deploy_launches,
                       "max_abs_err_streaming_vs_offline": deploy_err, "tol": STEP_TOL}}


# The artifacts phase: the full model's seed-0 weights written in every
# format, loaded back with from_local and run at B = 64 over 5 chunks.
ARTIFACT_BATCH, ARTIFACT_CHUNKS = 64, 5
ARTIFACT_EXPORT_BATCHES = (1, ARTIFACT_BATCH)
EXPORT_TOL = 1e-6   # exported vs eager step on the card (0 expected: the same kernels)
ARTIFACT_STATS_STEPS = (10, 60)   # step_stats' two chains
ARTIFACT_WORDS = "да нет привет спасибо пожалуйста хорошо алло слушаю вас завтра утром".split()


def _artifact_run(model, chunks) -> tuple[list, int]:
    """Logprobs of ``chunks`` streamed through ``model`` and B1's launches."""
    import torch

    from tone_tpu_torch.ops.glu_ff import glu_ff2

    glu_ff2.launches = 0
    state, lps = None, []
    for chunk in chunks:
        lp, state = model.forward_native(chunk, state)
        lps.append(lp)
    torch.cuda.synchronize()
    return lps, glu_ff2.launches


def _size(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*")) if path.is_dir() else path.stat().st_size


def _write_wav(path: Path, samples: np.ndarray) -> None:
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(samples.astype("<i2").tobytes())


def _edit_distance(a: str, b: str) -> int:
    """Levenshtein distance of two strings."""
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (ca != cb))
    return row[-1]


def exported_child(tmp: str) -> int:
    """The exported step in a fresh process (``--exported-child DIR``): load
    the model and the B=64 artifact, run one step, then (once the parent
    writes ``DIR/go``, so that nothing else runs) time it against the eager
    step in turns (eager, exported, exported, eager); one JSON line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tone_tpu_torch.acoustic import StreamingCTCModel
    from tone_tpu_torch.device import resolve_device
    from tone_tpu_torch.export import load_exported
    from tone_tpu_torch.ops.glu_ff import glu_ff2

    resolve_device("cuda")
    tmp = Path(tmp)
    t0 = time.perf_counter()
    model = StreamingCTCModel.from_local(tmp / "model")
    model_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = load_exported(tmp / "export_b64" / f"streaming_b{ARTIFACT_BATCH}.pt2")
    load_s = time.perf_counter() - t0
    chunk = torch.from_numpy(np.load(tmp / "chunk0.npy")).to(model.device)
    glu_ff2.launches = 0
    t0 = time.perf_counter()
    lp, _ = fn(model.variables, chunk, model.init_state(ARTIFACT_BATCH))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = glu_ff2.launches
    np.save(tmp / "exported_lp.npy", lp.cpu().numpy())

    def ms_per_step(step, n=20):
        state = model.init_state(ARTIFACT_BATCH)
        for _ in range(3):
            _, state = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            _, state = step(state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def eager(s):
        return model.forward_native(chunk, s)

    def exported(s):
        return fn(model.variables, chunk, s)

    deadline = time.monotonic() + 600
    while not (tmp / "go").exists():
        if time.monotonic() > deadline:
            raise TimeoutError("the parent never signalled")
        time.sleep(0.05)
    turns = [("eager", ms_per_step(eager)), ("exported", ms_per_step(exported)),
             ("exported", ms_per_step(exported)), ("eager", ms_per_step(eager))]
    emit({"model_load_s": model_s, "load_exported_s": load_s, "first_step_s": first_s,
          "glu_launches": launches, "turns_ms": turns})
    return 0


def export_child(tmp: str) -> int:
    """``export_streaming`` at B = 1 in a process of its own (``--export-child
    DIR``), beside the parent's B = 64 export; one JSON line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tone_tpu_torch.acoustic import StreamingCTCModel
    from tone_tpu_torch.device import resolve_device
    from tone_tpu_torch.export import export_streaming

    resolve_device("cuda")
    model = StreamingCTCModel.from_local(Path(tmp) / "model")
    t0 = time.perf_counter()
    (path,) = export_streaming(model.variables, model.config, [1], Path(tmp) / "export_b1")
    emit({"export_s": time.perf_counter() - t0, "bytes": _size(path)})
    return 0


def _communicate(procs: dict, timeout: float = 600) -> dict:
    """Each process's standard output; raises if one failed."""
    results = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"artifacts {name} exited {proc.returncode}: {stderr[-3000:]}")
        results[name] = stdout
    return results


def phase_artifacts() -> dict:
    import tempfile

    import torch

    from tone_tpu_torch.acoustic import StreamingCTCModel
    from tone_tpu_torch.audio import read_audio
    from tone_tpu_torch.audio.examples import synthesize_speech_like
    from tone_tpu_torch.checkpoint import save_checkpoint
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.decoder import BeamSearchCTCDecoder, DecoderType, GreedyCTCDecoder
    from tone_tpu_torch.export import export_streaming
    from tone_tpu_torch.interop import save_nemo_archive, save_torch_checkpoint, to_torch_state_dict
    from tone_tpu_torch.pipeline import StreamingCTCPipeline
    from tone_tpu_torch.profiling import step_stats

    cfg = ToneConfig()
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    pcm = np.random.default_rng(0).integers(
        -20000, 20000, (ARTIFACT_BATCH, cfg.audio_chunk_samples * ARTIFACT_CHUNKS)).astype(np.int32)
    chunks = [torch.from_numpy(c).cuda() for c in np.split(pcm, ARTIFACT_CHUNKS, axis=1)]
    direct = StreamingCTCModel(variables, cfg, device="cuda")
    ref, ref_launches = _artifact_run(direct, chunks)
    steps_launches = 2 * cfg.encoder.n_layers * ARTIFACT_CHUNKS   # 32 per step
    if ref_launches != steps_launches:
        raise AssertionError(f"artifacts: {ref_launches} B1 launches in the direct run")
    repo = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "tone_tpu_torch"]
    utterance = synthesize_speech_like(300, (2.0, 1.5)).astype(np.int32)
    out = {"phase": "artifacts", "nvidia_smi": nvidia_smi(), "config": "ToneConfig() bf16",
           "batch": ARTIFACT_BATCH, "chunks": ARTIFACT_CHUNKS}
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        try:
            # Write every format but the .nemo; export at B = 64 here and at
            # B = 1 in a process of its own (``--export-child``); then, beside
            # the .nemo's write (from the serving variables, as the export CLI
            # writes it), start the processes: the B=64 program loaded fresh
            # (``--exported-child``), `transcribe` with --checkpoint and with
            # $TONE_TPU_MODEL_DIR, and `lm` for the pipeline below.
            writers = {
                "safetensors": (tmp / "model.safetensors",
                                lambda p: save_torch_checkpoint(p, variables, cfg)),
                "safetensors_tone_prefix": (
                    tmp / "prefixed.safetensors",
                    lambda p: save_torch_checkpoint(p, variables, cfg, prefix="tone.")),
                "bin": (tmp / "model.bin",
                        lambda p: torch.save(to_torch_state_dict(variables, cfg), p)),
                "directory": (tmp / "model", lambda p: save_checkpoint(p, variables, cfg)),
                "nemo": (tmp / "model.nemo",
                         lambda p: save_nemo_archive(p, direct.variables, cfg)),
            }
            formats = {}

            def timed_write(name):
                path, write = writers[name]
                t0 = time.perf_counter()
                write(path)
                formats[name] = {"write_s": time.perf_counter() - t0, "bytes": _size(path)}

            for name in ("safetensors", "safetensors_tone_prefix", "bin", "directory"):
                timed_write(name)
            pipes = dict(cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            me = [sys.executable, os.path.abspath(__file__)]
            procs["export_b1"] = subprocess.Popen([*me, "--export-child", str(tmp)], **pipes)
            np.save(tmp / "chunk0.npy", chunks[0].cpu().numpy())
            t0 = time.perf_counter()
            (path,) = export_streaming(direct.variables, cfg, [ARTIFACT_BATCH],
                                       tmp / f"export_b{ARTIFACT_BATCH}")
            export = {f"b{ARTIFACT_BATCH}": {"export_s": time.perf_counter() - t0,
                                             "bytes": _size(path)}}

            _write_wav(tmp / "utt.wav", utterance)
            (tmp / "pipe").mkdir()
            os.link(tmp / "model.safetensors", tmp / "pipe" / "model.safetensors")
            (tmp / "corpus.txt").write_text("\n".join(
                " ".join(np.random.default_rng(k).choice(ARTIFACT_WORDS, 2 + k % 5))
                for k in range(2000)) + "\n", encoding="utf-8")
            procs["exported_child"] = subprocess.Popen([*me, "--exported-child", str(tmp)],
                                                       **pipes)
            procs["checkpoint_flag"] = subprocess.Popen(
                [*cli, "transcribe", str(tmp / "utt.wav"), "--json", "--checkpoint",
                 str(tmp / "model.safetensors")], **pipes)
            procs["model_dir_env"] = subprocess.Popen(
                [*cli, "transcribe", str(tmp / "utt.wav"), "--json"],
                env=dict(os.environ, TONE_TPU_MODEL_DIR=str(tmp / "model")), **pipes)
            procs["lm"] = subprocess.Popen(
                [*cli, "lm", str(tmp / "corpus.txt"), str(tmp / "pipe" / "lm.arpa"), "--native"],
                **pipes)
            timed_write("nemo")

            # Load every format on the card: bit-equal to the direct model.
            for name, (path, _) in writers.items():
                t0 = time.perf_counter()
                model = StreamingCTCModel.from_local(path)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                lps, launches = _artifact_run(model, chunks)
                equal = all(torch.equal(a, b) for a, b in zip(lps, ref))
                formats[name].update({"load_s": load_s, "glu_launches": launches,
                                      "bit_equal": equal, "device": str(model.device)})
                if not equal or launches != steps_launches or model.device.type != "cuda":
                    raise AssertionError(f"artifacts {name}: {formats[name]}")
                del model, lps
            out["formats"] = formats

            results = _communicate({k: procs[k] for k in ("checkpoint_flag", "model_dir_env",
                                                          "lm", "export_b1")})
            export["b1"] = json.loads(results["export_b1"].strip().splitlines()[-1])

            greedy = StreamingCTCPipeline(direct, decoder=GreedyCTCDecoder())
            want = [{"text": p.text, "start_time": p.start_time, "end_time": p.end_time}
                    for p in greedy.forward_offline(read_audio(tmp / "utt.wav"))]
            for name in ("checkpoint_flag", "model_dir_env"):
                (record,) = [json.loads(ln) for ln in results[name].splitlines()
                             if ln.startswith("{")]
                if record["phrases"] != want:
                    raise AssertionError(f"artifacts CLI {name}: {record['phrases']} != {want}")
            out["cli"] = {"phrases": want, "lm": json.loads(results["lm"])}

            # The pipeline from the folder (model.safetensors, lm.arpa): its
            # texts equal those of the directly built model with the same LM
            # decoder on the card; its acoustic model on the card within the
            # step's bf16 tolerance of the same pipeline's on the CPU (the
            # texts of random weights are long near-ties, which that
            # difference may flip: both are recorded, with their character
            # edit distance).
            pipes = {dev: StreamingCTCPipeline.from_local(
                tmp / "pipe", decoder_type=DecoderType.BEAM_SEARCH, device=dev)
                for dev in ("cuda", "cpu")}
            direct_pipe = StreamingCTCPipeline(
                direct, decoder=BeamSearchCTCDecoder.from_local(tmp / "pipe" / "lm.arpa"))
            texts, seconds = {}, {}
            for name, pipe in (("cuda", pipes["cuda"]), ("direct", direct_pipe),
                               ("cpu", pipes["cpu"])):
                t0 = time.perf_counter()
                texts[name] = [p.text for p in pipe.forward_offline(utterance)]
                seconds[name] = time.perf_counter() - t0
            padded = np.pad(utterance, (cfg.padding, cfg.padding))
            padded = np.pad(padded, (0, -len(padded) % cfg.audio_chunk_samples))[None]
            lps = {}
            for dev, pipe in pipes.items():
                state, outs = None, []
                for k in range(0, padded.shape[1], cfg.audio_chunk_samples):
                    lp, state = pipe.model.forward_native(
                        padded[:, k:k + cfg.audio_chunk_samples], state)
                    outs.append(lp.cpu())
                lps[dev] = torch.cat(outs, dim=1)
            lp_err = (lps["cuda"] - lps["cpu"]).abs().max().item()
            out["pipeline"] = {"texts": texts, "seconds": seconds,
                               "decoder": type(pipes["cuda"].decoder).__name__,
                               "native": pipes["cuda"].decoder._use_native,
                               "card_vs_cpu_char_edits": _edit_distance(
                                   " ".join(texts["cuda"]), " ".join(texts["cpu"])),
                               "card_vs_cpu_max_abs_logprob_err": lp_err, "tol": STEP_TOL}
            if texts["cuda"] != texts["direct"] or not lp_err <= STEP_TOL:
                raise AssertionError(f"artifacts pipeline: {out['pipeline']}")

            # The exported program: nothing else runs while the child times it.
            (tmp / "go").touch()
            t0 = time.perf_counter()
            child = json.loads(_communicate({"exported_child": procs["exported_child"]})[
                "exported_child"].strip().splitlines()[-1])
            export["child_wait_s"] = time.perf_counter() - t0
            err = float(np.abs(np.load(tmp / "exported_lp.npy") - ref[0].cpu().numpy()).max())
            export.update({"child": child, "max_abs_err_vs_eager": err, "tol": EXPORT_TOL})
            if child["glu_launches"] != 2 * cfg.encoder.n_layers or not err <= EXPORT_TOL:
                raise AssertionError(f"artifacts export: {export}")
            export["eager_ms"] = [ms for kind, ms in child["turns_ms"] if kind == "eager"]
            export["exported_ms"] = [ms for kind, ms in child["turns_ms"] if kind == "exported"]
            out["export"] = export
        finally:
            for proc in procs.values():  # stop what a failed check left running
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    stats = step_stats(direct, ARTIFACT_BATCH, steps=ARTIFACT_STATS_STEPS)
    out["step_stats"] = {"batch": stats.batch, "ms_per_step": stats.seconds_per_step * 1e3,
                         "streams_realtime": stats.rtfx, "steps": list(ARTIFACT_STATS_STEPS)}
    return out

# The parallel phase: the device mesh on the one card.  Two replicas (bulk,
# serving) or two ranks (training) on one H100 show that the mesh's paths run
# at full width and give one device's results; they measure overhead, not
# scaling: the replicas share the card, and gloo reduces through the host.
PARALLEL_DEVICES = ("cuda:0", "cuda:0")
PARALLEL_BULK_ROWS = 8       # the bulk cell's first 8 utterances (4-28 s), one batch
PARALLEL_TRAIN_ROWS = 4      # the train cell's first 4 utterances (4-5.6 s), one batch
PARALLEL_TRAIN_STEPS = 3     # the third loss follows the first update with lr > 0
PARALLEL_TRAIN_TOL = 1e-2    # relative loss of a mesh against one process (PERF.md §2)
PARALLEL_NCCL_LOSS_TOL = TRAIN_LOSS_TOL  # the 1x1 NCCL step's loss against no mesh
PARALLEL_RANK_TIMEOUT = 300  # seconds for every rank of one run


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def phase_parallel() -> dict:
    import dataclasses
    import tempfile

    import torch

    from tone_tpu_torch.bridge import tree_leaves
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.offline import OfflineTranscriber
    from tone_tpu_torch.ops.glu_ff import glu_ff2
    from tone_tpu_torch.parallel.mesh import arena_shardings, make_mesh
    from tone_tpu_torch.parallel.ranks import train_on_mesh
    from tone_tpu_torch.runtime.arena import StreamArena
    from tone_tpu_torch.runtime.engine import MultiStreamEngine
    from tone_tpu_torch.training import DataCollatorCTCWithPadding, Trainer, TrainerConfig

    cfg = ToneConfig()
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    mesh = make_mesh(devices=list(PARALLEL_DEVICES))
    replicas = len(PARALLEL_DEVICES)

    # Bulk: one batch of 8 utterances, 4 rows on each replica.  Held to the
    # one-device transcriber at each replica's share (4 rows padded alike):
    # the same shapes on the same card, so equal to the bit; and to the
    # one-device transcriber at the whole batch within the step's tolerance
    # (a batch of 8 changes cuBLAS's summation order, which flips near-ties
    # of the random weights' argmax).  Timed in turns: one, split, split, one.
    dev = PARALLEL_DEVICES[0]
    audios = bulk_corpus()[:PARALLEL_BULK_ROWS]
    chunk, pad = cfg.audio_chunk_samples, cfg.padding
    n_chunks = -(-max(-(-(len(a) + 2 * pad) // chunk) for a in audios) // 8) * 8
    per = PARALLEL_BULK_ROWS // replicas
    bulk = []
    for name, off in (("scan", False), ("offline_forward", True)):
        split = OfflineTranscriber(variables, cfg, batch_size=PARALLEL_BULK_ROWS, mesh=mesh,
                                   use_offline_forward=off)
        share = OfflineTranscriber(variables, cfg, batch_size=per, device=dev,
                                   bucket_samples=n_chunks * chunk, use_offline_forward=off)
        one = OfflineTranscriber(variables, cfg, batch_size=PARALLEL_BULK_ROWS, device=dev,
                                 use_offline_forward=off)
        lps = {label: tr.logprobs(audios)
               for label, tr in (("split", split), ("share", share), ("one", one))}
        share_equal = all(np.array_equal(a, b) for a, b in zip(lps["split"], lps["share"]))
        lp_err = max(float(np.abs(a - b).max()) for a, b in zip(lps["split"], lps["one"]))
        flips = sum(int((a.argmax(-1) != b.argmax(-1)).sum())
                    for a, b in zip(lps["split"], lps["one"]))
        walls, texts, launches = {"one_device": [], "two_replicas": []}, {}, None
        for label, tr in (("one_device", one), ("two_replicas", split),
                          ("two_replicas", split), ("one_device", one)):
            torch.cuda.synchronize()
            glu_ff2.launches = 0
            t0 = time.perf_counter()
            phrases = tr.transcribe(audios)
            walls[label].append(time.perf_counter() - t0)
            if label == "two_replicas":
                launches = glu_ff2.launches
            texts.setdefault(label, [_phrases(p) for p in phrases])
        texts["share"] = [_phrases(p) for p in share.transcribe(audios)]
        want = replicas * 2 * cfg.encoder.n_layers * (1 if off else n_chunks)  # 32 a step
        if launches != want:
            raise AssertionError(f"parallel bulk {name}: {launches} GLU launches, expected {want}")
        if not share_equal or texts["two_replicas"] != texts["share"]:
            raise AssertionError(f"parallel bulk {name}: the replicas differ from one device "
                                 f"at their share: {texts}")
        if not lp_err <= STEP_TOL:
            raise AssertionError(f"parallel bulk {name}: logprobs {lp_err} > {STEP_TOL} "
                                 "against one device at the whole batch")
        bulk.append({
            "forward": name, "rows": len(audios), "rows_per_replica": per,
            "audio_s": sum(len(a) for a in audios) / 8000, "chunks_per_row": n_chunks,
            "glu_launches_per_batch": launches, "wall_s": walls,
            "at_share": {"logprobs_equal": share_equal, "texts_equal": True},
            "at_whole_batch": {
                "logprobs_max_abs_err": lp_err, "tol": STEP_TOL, "argmax_flips": flips,
                "frames": sum(len(a) for a in lps["one"]),
                "times_equal": [[p[1:] for p in u] for u in texts["two_replicas"]]
                == [[p[1:] for p in u] for u in texts["one_device"]],
                "texts_equal": sum(a == b for a, b in zip(texts["two_replicas"],
                                                          texts["one_device"]))},
            "phrases": sum(len(u) for u in texts["one_device"])})

    # Serving: the serve cell's streams through 16 slots, 8 on each replica.
    # Held to an unsplit engine of one replica's 8 slots (the streams take
    # the last slots: the same rows, shapes and card, so equal finals), and
    # to the unsplit 16-slot arena within the step's tolerance; the
    # unsplit 16-slot engine's finals and ticks beside them.
    serve, cells = {}, {}
    for label, kw, n_slots, n in (
            ("one_device", {"device": dev}, SERVE_SLOTS, 1),
            ("one_device_share", {"device": dev}, SERVE_SLOTS // replicas, 1),
            ("two_replicas", {"sharding": arena_shardings(mesh, cfg, SERVE_SLOTS)},
             SERVE_SLOTS, replicas)):
        engine = MultiStreamEngine(variables, cfg, n_slots=n_slots, **kw)
        try:
            cells[label] = _serve_cell(engine, lambda e, sids: None, replicas=n)
        finally:
            engine.shutdown()
    finals = {label: [[(p.text, p.start_time, p.end_time) for p in cell["phrases"][sid]]
                      for sid in cell["sids"]] for label, cell in cells.items()}
    if finals["two_replicas"] != finals["one_device_share"]:
        raise AssertionError(f"parallel serve: finals differ from one device at the "
                             f"replica's share: {finals}")
    arenas = [StreamArena(variables, cfg, SERVE_SLOTS, **kw)
              for kw in ({"device": dev}, {"sharding": arena_shardings(mesh, cfg, SERVE_SLOTS)})]
    rng = np.random.default_rng(2)
    tick_err = 0.0
    for k in range(5):
        chunks = rng.integers(-20000, 20000, (SERVE_SLOTS, chunk)).astype(np.int16)
        flags = np.ones(SERVE_SLOTS, bool), np.full(SERVE_SLOTS, k == 0)
        a, b = (arena.tick(chunks, *flags) for arena in arenas)
        tick_err = max(tick_err, float(np.abs(a - b).max()))
    del arenas
    if not tick_err <= STEP_TOL:
        raise AssertionError(f"parallel serve: split arena vs unsplit {tick_err} > {STEP_TOL}")
    serve = {label: {k: cell["out"][k] for k in ("slots", "ticks", "glu_launches",
                                                 "tick_ms_median", "tick_ms_max",
                                                 "device_ms_per_tick", "warmup_s")}
             for label, cell in cells.items()}
    serve["two_replicas"]["slots_per_replica"] = SERVE_SLOTS // replicas
    serve["finals_equal_at_share"] = True
    serve["finals_equal_to_16_slots"] = finals["two_replicas"] == finals["one_device"]
    serve["arena_16_slots_max_abs_err"] = tick_err

    # Training: one process on the card, then two gloo ranks on it at
    # (data, model) = (2, 1) and (1, 2), then one NCCL rank (1 x 1).
    feats = train_features(range(100, 100 + PARALLEL_TRAIN_ROWS),
                           TRAIN_SECONDS[:PARALLEL_TRAIN_ROWS])
    batch = DataCollatorCTCWithPadding()(feats)
    tcfg = TrainerConfig(learning_rate=3e-4, total_steps=20)
    trainer = Trainer(cfg, tcfg, device=dev)
    state = trainer.create_state(variables)
    one_losses, one_ms = [], []
    for step in range(PARALLEL_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        one_losses.append(float(loss))
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            mu_one = torch.cat([t.reshape(-1).cpu() for t in tree_leaves(state.opt_state.mu)])
    del trainer, state
    torch.cuda.empty_cache()
    spec = {"config": cfg.to_dict(), "trainer": dataclasses.asdict(tcfg),
            "variables": variables, "batch": {k: torch.as_tensor(v) for k, v in batch.items()},
            "steps": PARALLEL_TRAIN_STEPS}
    train = {"rows": len(feats), "batch_shape": list(batch["input_values"].shape),
             "steps": PARALLEL_TRAIN_STEPS, "one_process": {"losses": one_losses,
                                                            "ms_per_step": one_ms}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        for n_data, n_model in ((2, 1), (1, 2)):
            t0 = time.perf_counter()
            ranks = train_on_mesh({**spec, "n_data": n_data, "n_model": n_model},
                                  PARALLEL_DEVICES, Path(tmp) / f"mesh_{n_data}x{n_model}",
                                  timeout=PARALLEL_RANK_TIMEOUT)
            wall = time.perf_counter() - t0
            errs = [_rel(a, b) for a, b in zip(ranks[0]["losses"], one_losses)]
            if (any(r["losses"] != ranks[0]["losses"] for r in ranks)
                    or any(r["backend"] != "gloo" for r in ranks)
                    or not max(errs) <= PARALLEL_TRAIN_TOL):
                raise AssertionError(f"parallel train {n_data}x{n_model}: {ranks} against "
                                     f"one process {one_losses}")
            train[f"{n_data}x{n_model}"] = {
                "backend": "gloo", "losses": ranks[0]["losses"], "loss_rel_err": errs,
                "ms_per_step": ranks[0]["ms_per_step"],
                "bytes_reduced_per_step": ranks[0]["bytes_reduced_per_step"],
                "run_wall_s": wall}
        # One NCCL rank: one step, saved, against the first step without a mesh.
        t0 = time.perf_counter()
        (rank,) = train_on_mesh({**spec, "steps": 1, "n_data": 1, "n_model": 1, "save": True},
                                PARALLEL_DEVICES[:1], Path(tmp) / "nccl",
                                timeout=PARALLEL_RANK_TIMEOUT)
        wall = time.perf_counter() - t0
        saved = torch.load(Path(tmp) / "nccl" / "checkpoint" / "train_state.pt",
                           map_location="cpu", weights_only=True)
        mu = torch.cat([t.reshape(-1) for t in tree_leaves(saved["adam"]["mu"])])
        mu_rel = ((mu - mu_one).norm() / mu_one.norm()).item()
        mu_cos = torch.nn.functional.cosine_similarity(mu.double(), mu_one.double(),
                                                       dim=0).item()
        nccl = {"backend": rank["backend"], "loss": rank["losses"][0],
                "loss_rel_err": _rel(rank["losses"][0], one_losses[0]),
                "adam_mu_rel_err": mu_rel, "adam_mu_cosine": mu_cos,
                "resumed_loss": rank["resumed_loss"], "live_loss": rank["live_loss"],
                "ms_per_step": rank["ms_per_step"], "run_wall_s": wall}
        if not (nccl["backend"] == "nccl" and nccl["loss_rel_err"] <= PARALLEL_NCCL_LOSS_TOL
                and mu_rel <= TRAIN_REMAT_GRAD_TOL["bfloat16"] and mu_cos >= TRAIN_CPU_COSINE
                and _rel(rank["resumed_loss"], rank["live_loss"]) <= PARALLEL_NCCL_LOSS_TOL):
            raise AssertionError(f"parallel train 1x1 NCCL: {nccl}")
    return {"phase": "parallel", "nvidia_smi": nvidia_smi(), "config": "ToneConfig() bf16",
            "parameters": sum(t.numel() for t in tree_leaves(variables["params"])),
            "devices": list(PARALLEL_DEVICES), "bulk": bulk, "serve": serve,
            "train": {**train, "tol": PARALLEL_TRAIN_TOL}, "nccl_1x1": nccl}


RECIPE_STEPS = 150           # the tiny model's training steps (tests/test_e2e_synthetic.py)
RECIPE_MAX_WER = 0.05        # train WER of the trained tiny model
RECIPE_MIN_AGREEMENT = 0.95  # device beam against the host width-200 fusion
RECIPE_HOTWORD_WEIGHTS = (0.0, 2.0)
RECIPE_HOTWORD_COPIES = 2    # noisy copies of each utterance per noise level
RECIPE_LM_GRAMS = 600_000
RECIPE_GLU_MS = (10, 5, 80, 640)  # the deployment's rows (B=1: 10 full-rate, 5 reduced)


def _logprob_flips(a: np.ndarray, b: np.ndarray) -> dict:
    """How far two deployments' logprobs of one utterance are apart: the
    largest difference, the frames whose argmax differs, and the smallest
    margin between the best two classes of those frames (a near-tie)."""
    flips = np.flatnonzero(a.argmax(-1) != b.argmax(-1))
    top2 = np.sort(a[flips], axis=-1)[:, -2:] if len(flips) else np.zeros((0, 2))
    return {"max_abs_diff": float(np.abs(a - b).max()), "argmax_flips": int(len(flips)),
            "min_flip_margin": float((top2[:, 1] - top2[:, 0]).min()) if len(flips) else None}


def _stream_logprobs(model, samples: np.ndarray) -> np.ndarray:
    """One utterance's logprobs through ``model.forward_native``, chunked
    as the pipeline's ``forward_offline`` chunks it."""
    a = np.pad(samples, (2400, 2400))
    a = np.pad(a, (0, -len(a) % 2400))
    state, out = None, []
    for chunk in a.reshape(-1, 2400):
        lp, state = model.forward_native(chunk[None], state)
        out.append(lp[0].float().cpu().numpy())
    return np.concatenate(out)


def phase_recipes() -> dict:
    import argparse
    import dataclasses
    import tempfile

    import torch

    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.decoder import DecoderType
    from tone_tpu_torch.dev import beam_quality_sweep, debug_sequence, device_lm_scale
    from tone_tpu_torch.dev import hotword_quality
    from tone_tpu_torch.examples import domain_adapt, finetune
    from tone_tpu_torch.examples import train_tiny_e2e as tiny
    from tone_tpu_torch.interop import save_torch_checkpoint
    from tone_tpu_torch.ops.glu_ff import glu_ff2, glu_ff2_plain
    from tone_tpu_torch.pipeline import StreamingCTCPipeline

    out = {"phase": "recipes", "nvidia_smi": nvidia_smi()}
    # 1. train once, then train -> deploy -> stream
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, trainer, state, collator, items = tiny.run_training(steps=RECIPE_STEPS, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    batch = collator([{"input_values": it["audio"], "labels": it["text"]} for it in items])
    wer = trainer.eval_wer(state, [batch], [it["text"] for it in items])
    variables = tiny.trained_variables(state)
    checked = items[:tiny.EVAL_ITEMS]
    refs = [it["text"] for it in checked]
    glu_ff2.launches = 0
    pipe32 = tiny.deploy(cfg, variables, "cuda")
    texts32 = tiny.stream_texts(pipe32, checked)
    fp32_launches = glu_ff2.launches
    hits = sum(t == r for t, r in zip(texts32, refs))
    out["train"] = {"init": "jax.random.PRNGKey(0) (core/jax_random.py)",
                    "steps": RECIPE_STEPS, "seconds": train_s,
                    "ms_per_step": train_s / RECIPE_STEPS * 1e3, "wer": wer,
                    "exact": hits, "checked": len(refs), "texts": texts32,
                    "fp32_glu_launches": fp32_launches}
    if not wer < RECIPE_MAX_WER:
        raise AssertionError(f"recipes: train WER {wer} >= {RECIPE_MAX_WER}")
    if hits < len(refs) - 1:
        raise AssertionError(f"recipes: {hits}/{len(refs)} exact streaming texts: "
                             f"{list(zip(texts32, refs))}")
    if fp32_launches:
        raise AssertionError(f"recipes: the float32 deployment launched B1 {fp32_launches} times")
    # A control, reported and not held: the same recipe from the port's own
    # torch.Generator(0) weights, whose model is known to emit letters on the
    # pipeline's padding (train_tiny_e2e.run_training).
    _, _, control, _, _ = tiny.run_training(
        steps=RECIPE_STEPS, device="cuda",
        variables=init_model_params(torch.Generator().manual_seed(0), cfg))
    control_texts = tiny.stream_texts(tiny.deploy(cfg, tiny.trained_variables(control), "cuda"),
                                      checked)
    out["train"]["control_torch_init"] = {
        "texts": control_texts, "exact": sum(t == r for t, r in zip(control_texts, refs))}

    # 2. the same weights deployed in bf16: B1 at the tiny width
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    pipe16 = tiny.deploy(cfg16, variables, "cuda")
    chunks = sum(-(-(len(it["audio"]) + 2 * cfg.padding) // cfg.audio_chunk_samples)
                 for it in checked)
    glu_ff2.launches = 0
    texts16 = tiny.stream_texts(pipe16, checked)
    launches16 = glu_ff2.launches
    if launches16 != 2 * cfg.encoder.n_layers * chunks:
        raise AssertionError(f"recipes: bf16 deployment launched B1 {launches16} times over "
                             f"{chunks} steps, not {2 * cfg.encoder.n_layers} per step")
    diffs = [_logprob_flips(_stream_logprobs(pipe16.model, tiny.int_audio(it["audio"])),
                            _stream_logprobs(pipe32.model, tiny.int_audio(it["audio"])))
             for it in checked]
    p2 = pipe16.model.variables["params"]["encoder"]["layers"][0]["ff1"]["lin2"]
    f, d = p2["w"].shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for m in RECIPE_GLU_MS:
        av = torch.randn(m, 2 * f, device="cuda", generator=gen).to(torch.bfloat16)
        y = glu_ff2(av, p2)
        torch.cuda.synchronize()
        err = (y.float() - glu_ff2_plain(av, p2).float()).abs().max().item()
        if not err <= GLU_TOL:
            raise AssertionError(f"glu_ff2 F={f} D={d} M={m}: max |kernel - plain| = "
                                 f"{err} > {GLU_TOL}")
        bound_ms, bound_by = glu_ff_bound_ms(m, f, d)
        ms = device_time_ms(lambda: glu_ff2(av, p2), 200, "glu_ff2")
        cases.append({"m": m, "max_abs_err": err, "ms": ms,
                      "event_ms": cuda_time_ms(lambda: glu_ff2(av, p2), 200),
                      "plain_ms": cuda_time_ms(lambda: glu_ff2_plain(av, p2), 50),
                      "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms})
    out["bf16_deploy"] = {"f": f, "d": d, "glu_launches": launches16, "steps": chunks,
                          "texts": texts16, "texts_equal_fp32": texts16 == texts32,
                          "exact": sum(t == r for t, r in zip(texts16, refs)),
                          "logprobs_vs_fp32": diffs, "glu_cases": cases, "tol": GLU_TOL}

    # 3. domain adaptation on the trained weights
    t0 = time.perf_counter()
    da = domain_adapt.adapt(cfg, variables, items, "cuda")
    words = 0
    for n, phrases in zip(da["audio_samples"], da["results"]):
        seconds = n / cfg.frontend.sample_rate
        for w in (w for p in phrases for w in (p.words or ())):
            words += 1
            if not (0.0 <= w.start_time <= w.end_time <= seconds and 0 < w.confidence <= 1):
                raise AssertionError(f"domain_adapt: word {w} outside its {seconds} s utterance")
    if da["correct"] < 1:
        raise AssertionError("domain_adapt: no exact match")
    out["domain_adapt"] = {"seconds": time.perf_counter() - t0, "grams": da["grams"],
                           "ppl": da["ppl"], "entity": da["entity"], "exact": da["correct"],
                           "of": len(da["refs"]), "words": words,
                           "texts": [" ".join(p.text for p in r if p.text)
                                     for r in da["results"]]}

    # 4. the device beam against the host width-200 fusion
    t0 = time.perf_counter()
    agree, dev_out, host_out = beam_quality_sweep.host_agreement(cfg, variables, device="cuda")
    out["beam_agreement"] = {"seconds": time.perf_counter() - t0, "agreement": agree,
                             "n": len(dev_out), "min": RECIPE_MIN_AGREEMENT}
    if not agree >= RECIPE_MIN_AGREEMENT:
        raise AssertionError(f"recipes: device beam agrees with host w200 on {agree}: "
                             f"{list(zip(dev_out, host_out))}")

    # 5. hotword biasing
    t0 = time.perf_counter()
    rows = hotword_quality.hotword_sweep(cfg, variables, items, RECIPE_HOTWORD_WEIGHTS,
                                         copies=RECIPE_HOTWORD_COPIES, device="cuda")
    out["hotwords"] = {"seconds": time.perf_counter() - t0, "copies": RECIPE_HOTWORD_COPIES,
                       "rows": rows}

    # 6. fine-tuning at full width from a released-format checkpoint
    full = ToneConfig()
    with tempfile.TemporaryDirectory(prefix="tone_finetune_") as tmp:
        tmp = Path(tmp)
        save_torch_checkpoint(tmp / "init.safetensors",
                              init_model_params(torch.Generator().manual_seed(0), full), full)
        argv = ["--synthetic", "--epochs", "1", "--init-checkpoint",
                str(tmp / "init.safetensors"), "--out", str(tmp / "out")]
        t0 = time.perf_counter()
        first = finetune.run(finetune.build_parser().parse_args(argv), full)
        first_s = time.perf_counter() - t0
        resumed = finetune.run(finetune.build_parser().parse_args(
            [*argv, "--resume", str(tmp / "out" / "train_state")]), full)
        if resumed["resumed_at"] != first["step"] or resumed["step"] != 2 * first["step"]:
            raise AssertionError(f"finetune --resume restored step {resumed['resumed_at']} "
                                 f"(saved {first['step']}), ended at {resumed['step']}")
        pipe = StreamingCTCPipeline.from_local(tmp / "out", decoder_type=DecoderType.GREEDY,
                                               device="cuda")
        sample = tiny.int_audio(finetune.synthetic_items()[0]["audio"])
        steps = -(-(len(sample) + 2 * full.padding) // full.audio_chunk_samples)
        glu_ff2.launches = 0
        phrases = pipe.forward_offline(sample)
        launches = glu_ff2.launches
    if launches != 2 * full.encoder.n_layers * steps:
        raise AssertionError(f"finetuned model: B1 launched {launches} times over {steps} "
                             f"steps, not {2 * full.encoder.n_layers} per step")
    losses = [x for e in first["epochs"] + resumed["epochs"] for x in e["losses"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"finetune: losses {losses}")
    out["finetune"] = {"seconds": first_s, "steps": first["step"],
                       "resumed_at": resumed["resumed_at"], "losses": losses,
                       "wer": [e["wer"] for e in first["epochs"] + resumed["epochs"]],
                       "glu_launches": launches, "stream_steps": steps,
                       "phrases": len(phrases)}

    # 7. the device LM at 0.6e6 grams
    lm, grams, build = device_lm_scale.synth_device_lm(RECIPE_LM_GRAMS)
    out["device_lm_scale"] = {**device_lm_scale.measure(lm, grams, 16, 64, "cuda"), **build}
    del lm

    # 8. the engine's sequence invariants at full width
    dbg = debug_sequence.run_sequence(init_model_params(torch.Generator().manual_seed(0), full),
                                      full, device="cuda")
    if dbg["unique_shapes"] != 1 or not dbg["clean_reuse"] or len(set(dbg["norms"])) < 2:
        raise AssertionError(f"debug_sequence: {dbg}")
    out["debug_sequence"] = dbg
    return out


BENCH_BATCHES = (128, 512, 1024, 1280)   # bench.py's sweep on a card
BENCH_STEPS = (10, 40)        # the sweep's two chains (bench.py: 20 and 120)
BENCH_PROFILED_STEPS = 3      # profiled steps at the largest batch
# B1's rows in the sweep at B = 512 ... 1280 and the 1,024-slot tick (5 B reduced,
# 10 B full-rate) that GLU_MS lacks
BENCH_GLU_MS = (5120, 6400, 10240, 12800)
TICK_SLOTS = 1024             # dev/tick_bench.py's default
TICK_TICKS = 30               # tick_bench's default
LOAD_SLOTS = 64
LOAD_STREAMS = (16, 64)       # dev/load_test.py's default rounds
LOAD_SECONDS = 6.0            # its default utterance
LOAD_SOAK_SECONDS = 8.0
LOAD_NBEST, LOAD_HOTWORD_STREAMS = 4, 8
TRAIN_BENCH_STEPS = 4         # chains of 4 and 12 steps (train_bench: 8 and 24)
ALIGN_BENCH_ITERS = 5         # (align_bench: 20)


def _bench_sweep() -> dict:
    """bench.py's step sweep at full width, B1's launches over it, the
    profile of the largest batch reached, and B1 at that batch's rows."""
    import torch

    from tone_tpu_torch import bench
    from tone_tpu_torch.ops.glu_ff import glu_ff2

    model = bench.bench_model(torch.device("cuda"))
    glu_ff2.launches = 0
    rows = bench.sweep(model, BENCH_BATCHES, BENCH_STEPS)
    launches = glu_ff2.launches
    done = [r for r in rows if "rtfx" in r]
    # step_stats: one chain of 5 steps, then two chains of each length
    steps = 5 + 2 * sum(BENCH_STEPS)
    if launches != 32 * steps * len(done):
        raise AssertionError(f"{launches} GLU launches over {len(done)} batches of {steps} steps")
    if len(done) < len(BENCH_BATCHES) and "oom" not in rows[-1]:
        raise AssertionError(f"the sweep stopped early: {rows}")
    top = done[-1]
    chunk = torch.as_tensor(np.random.default_rng(0).integers(
        -20000, 20000, (top["batch"], model.config.audio_chunk_samples)), dtype=torch.int32,
        device="cuda")
    state = model.init_state(top["batch"])
    for _ in range(3):
        _, state = model.forward_native(chunk, state)
    profile = _profile_steps(lambda s: model.forward_native(chunk, s)[1], state,
                             BENCH_PROFILED_STEPS)
    del model, state
    torch.cuda.empty_cache()
    glu = [glu_ff_row(m, av, p2) for m, av, p2 in glu_ff_cases("cuda", BENCH_GLU_MS)]
    return {"rows": rows, "headline": bench.headline(rows, torch.device("cuda")),
            "steps": BENCH_STEPS, "glu_launches": launches,
            "profiled_batch": top["batch"],
            "device_idle_share": 1.0 - profile["device_ms_per_step"] / top["ms_per_step"],
            **profile, "glu_cases": glu}


def _bench_tick() -> dict:
    """dev/tick_bench.py at 1,024 slots (B1 launched 32 times on every
    tick, the warmup tick too) and the splitter's worst case there."""
    import torch

    from tone_tpu_torch.dev import tick_bench
    from tone_tpu_torch.ops.glu_ff import glu_ff2

    glu_ff2.launches = 0
    report = tick_bench.bench(TICK_SLOTS, TICK_TICKS, device="cuda")
    launches = glu_ff2.launches
    if launches != 32 * (TICK_TICKS + 1):
        raise AssertionError(f"{launches} GLU launches over {TICK_TICKS} + 1 ticks")
    phrases = report.pop("phrases")
    torch.cuda.empty_cache()
    return {**report, "glu_launches": launches,
            "phrases": sum(len(p) for p in phrases.values()),
            "splitter_worst": tick_bench.splitter_worst_case(TICK_SLOTS, 40)}


async def _bench_load() -> dict:
    """dev/load_test.py against spawned ``serve --device cuda`` processes:
    the default rounds (real time and firehose) on a greedy server, a round
    with n-best and request hotwords on a device-beam server, the soak and
    the shutdown under load.  Every stream must end cleanly (its socket
    closed by the server after its flush)."""
    from tone_tpu_torch.dev import load_test

    rounds = []

    def check(report):
        # every stream's audio has a silence mid-way, which closes a phrase
        if (report["completed"] != report["streams"] or report["delivered"] != report["streams"]
                or report["phrases_total"] < report["streams"]):
            raise AssertionError(f"load test: not every stream ended cleanly: {report}")
        rounds.append(report)

    exits = []
    async with load_test.spawned_server(LOAD_SLOTS, "cuda") as (proc, url, _):
        for realtime in (True, False):
            for n in LOAD_STREAMS:
                check({**await load_test.run_round(url, n, LOAD_SECONDS, realtime),
                       "realtime": realtime})
    exits.append(proc.returncode)
    t0 = time.perf_counter()
    async with load_test.spawned_server(LOAD_SLOTS, "cuda",
                                        ["--decoder", "device-beam"]) as (proc, url, _):
        ready_s = time.perf_counter() - t0
        check({**await load_test.run_round(url, LOAD_SLOTS, LOAD_SECONDS, True,
                                           nbest=LOAD_NBEST,
                                           hotword_streams=LOAD_HOTWORD_STREAMS),
               "realtime": True, "decoder": "device-beam", "ready_s": ready_s})
    exits.append(proc.returncode)
    soak = await load_test.soak(LOAD_SLOTS, LOAD_SOAK_SECONDS, LOAD_SECONDS, device="cuda")
    if (not soak["flat"] or soak["completed"] != soak["streams_total"]
            or soak["phrases_total"] < soak["streams_total"]):
        raise AssertionError(f"soak: {soak}")
    shutdown = await load_test.shutdown_mid_load(LOAD_SLOTS, LOAD_SECONDS, device="cuda")
    if not shutdown["ok"]:
        raise AssertionError(f"shutdown under load: {shutdown}")
    # Every server drained and exited by itself: none is left holding the card.
    exits += [soak["exit_code"], shutdown["exit_code"]]
    if exits != [0] * 4:
        raise AssertionError(f"a spawned server did not exit cleanly: {exits}")
    return {"slots": LOAD_SLOTS, "rounds": rounds, "soak": soak, "shutdown": shutdown,
            "server_exit_codes": exits}


def phase_bench() -> dict:
    """The measurement tools of the port on the card, at full width (see
    the module docstring, 17)."""
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.jax_random import jax_init_model_params
    from tone_tpu_torch.dev import align_bench, train_bench

    out = {"phase": "bench"}
    for name, fn in (("sweep", _bench_sweep), ("tick", _bench_tick),
                     ("load", lambda: asyncio.run(_bench_load()))):
        t0 = time.perf_counter()
        out[name] = {**fn(), "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    cfg = ToneConfig()
    variables = jax_init_model_params(0, cfg)  # the train bench's weights, drawn once
    out["train"] = [train_bench.measure(steps=TRAIN_BENCH_STEPS, remat=remat, device="cuda",
                                        config=cfg, variables=variables)
                    for remat in (None, "full")]
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["first_loss"]) for r in out["train"]):
        raise AssertionError(f"train bench: a loss is not finite: {out['train']}")
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["align"] = align_bench.measure(iters=ALIGN_BENCH_ITERS, kernel=True, device="cuda")
    out["align_s"] = time.perf_counter() - t0
    return out


DEPLOY_IMAGE = Path(__file__).resolve().parent / "Dockerfile.torch"
# What the image's build stage copies: the wheel's inputs (never _kernels/).
DEPLOY_INPUTS = ("pyproject.toml", "README.md", "LICENSE", "tone_tpu", "tone_tpu_torch")
DEPLOY_STREAMS = 8            # streams that send their end-of-stream frame: closed with 1000
# and one more that never does: open at the SIGINT, the drain finalizes it
# as its end-of-stream frame would (its audio whole 300 ms frames) and
# closes it with 4503 (runtime/server.py CLOSE_SHUTDOWN)
DEPLOY_HELD = 1
DEPLOY_PHRASES = (1.5, 2.0)   # seconds of each utterance's two phrases
DEPLOY_UID = 65534            # the image's unprivileged USER, where the phase runs as root
DEPLOY_READY_TIMEOUT = 300.0  # s until /v2/health/ready, the warmup and B1's build included
DEPLOY_CHUNK_BYTES = 2400 * 2  # one 300 ms frame of 8 kHz PCM16


def dockerfile_stages(path: Path = DEPLOY_IMAGE) -> list[list[tuple[str, str]]]:
    """A Dockerfile's instructions by stage: (INSTRUCTION, arguments), with
    continued lines joined and comments dropped."""
    stages: list[list[tuple[str, str]]] = []
    logical = ""
    for line in path.read_text().splitlines():
        if not logical and (not line.strip() or line.lstrip().startswith("#")):
            continue
        if line.endswith("\\"):
            logical += line[:-1]
            continue
        word, _, rest = (logical + line).strip().partition(" ")
        logical = ""
        if word.upper() == "FROM":
            stages.append([])
        if stages:
            stages[-1].append((word.upper(), rest.strip()))
    return stages


def deploy_image(path: Path = DEPLOY_IMAGE) -> dict:
    """What the deploy phase runs of the serving image: the runtime stage's
    ENTRYPOINT argv, ENV and USER, and the Python code of the build stage's
    prebuild line."""
    import shlex

    stages = dockerfile_stages(path)
    build, runtime = stages[0], stages[-1]
    env = dict(arg.split("=", 1) for word, arg in runtime if word == "ENV")
    (entrypoint,) = [json.loads(arg) for word, arg in runtime if word == "ENTRYPOINT"]
    (user,) = [arg for word, arg in runtime if word == "USER"]
    (prebuild,) = [shlex.split(arg) for word, arg in build
                   if word == "RUN" and "enable_compilation_cache" in arg]
    if prebuild[1] != "-c" or entrypoint[entrypoint.index("--checkpoint") + 1] != \
            env["TONE_TPU_MODEL_DIR"]:
        raise AssertionError(f"{path.name}: unexpected prebuild {prebuild[:2]} or "
                             f"entrypoint {entrypoint}")
    return {"entrypoint": entrypoint, "env": env, "user": user, "prebuild": prebuild[2]}


def deploy_argv(image: dict, site: Path, model_dir: Path, port: int,
                metrics_port: int) -> list[str]:
    """The image's ENTRYPOINT as the deploy phase runs it: the console script
    installed under ``site``, the model directory in place of the mounted
    one, local host and free ports."""
    argv = image["entrypoint"]
    local = {"--checkpoint": str(model_dir), "--host": "127.0.0.1", "--port": str(port),
             "--metrics-port": str(metrics_port)}
    return [str(site / "bin" / argv[0])] + [local.get(flag, arg)
                                             for flag, arg in zip(argv, argv[1:])]


def prebuild_code(image: dict, cache: Path) -> str:
    """The image's prebuild line, building into ``cache`` in place of the
    image's compile cache."""
    return image["prebuild"].replace(image["env"]["TONE_TPU_COMPILE_CACHE"], str(cache))


def _http_get(url: str) -> tuple[int, str]:
    """GET a local URL without any proxy of the environment; (status, body)."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(url, timeout=2) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


def _listing(root: Path) -> dict:
    """Every file and directory under ``root``: mode, size and mtime."""
    out = {}
    for path in [root, *root.rglob("*")]:
        st = path.lstat()
        out[str(path.relative_to(root))] = (st.st_mode, st.st_size, st.st_mtime_ns)
    return out


def _engine_finals(engine, audios) -> dict:
    """The finals of ``audios`` through an in-process engine, each fed as the
    server's handler feeds it (its padding before and after, full chunks,
    the rest as a last chunk) and ticked until every stream finished; the
    ticks, B1's launches and the chunks processed."""
    from tone_tpu_torch.ops.glu_ff import glu_ff2

    cfg = engine.config
    n = cfg.audio_chunk_samples
    pad = np.zeros(cfg.padding, np.int16)
    sids = []
    for audio in audios:
        sid = engine.open_stream()
        data = np.concatenate([pad, audio, pad])
        full = len(data) // n * n
        for i in range(0, full, n):
            engine.feed(sid, data[i:i + n])
        engine.feed(sid, data[full:])
        engine.close_stream(sid)
        sids.append(sid)
    glu_ff2.launches = 0
    ticks0, chunks0 = engine.stats.ticks, engine.stats.chunks_processed
    futures = {sid: [] for sid in sids}
    done: set[int] = set()
    while len(done) < len(sids):
        for sid, futs in engine.tick().items():
            futures[sid].extend(futs)
        done.update(engine.pop_finished())
        if engine.stats.ticks - ticks0 > 200:
            raise AssertionError("the reference streams did not finish within 200 ticks")
    finals = [[[p.text, p.start_time, p.end_time] for p in (f.result(timeout=600)
                                                            for f in futures[sid])]
              for sid in sids]
    return {"finals": json.loads(json.dumps(finals)), "ticks": engine.stats.ticks - ticks0,
            "glu_launches": glu_ff2.launches,
            "chunks": engine.stats.chunks_processed - chunks0}


async def _stream(url: str, audio: np.ndarray, eos: bool) -> dict:
    """One client: the audio as fast as it goes, the end-of-stream frame
    where ``eos``, then every transcript until the server closes the
    socket."""
    import websockets

    pcm = audio.astype("<i2").tobytes()
    finals = []
    async with websockets.connect(url, max_size=2**22) as ws:
        ready = json.loads(await ws.recv())
        if ready.get("event") != "ready":
            raise AssertionError(f"expected the ready event, got {ready}")
        for i in range(0, len(pcm), DEPLOY_CHUNK_BYTES):
            await ws.send(pcm[i:i + DEPLOY_CHUNK_BYTES])
        if eos:
            await ws.send(b"")
        try:
            while True:
                msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=120))
                if msg.get("event") == "transcript":
                    finals.append([msg["text"], msg["start_time"], msg["end_time"]])
        except websockets.ConnectionClosed as e:
            return {"finals": finals, "close_code": e.rcvd.code if e.rcvd else None}


def _chunks_processed(metrics_port: int) -> int:
    status, body = _http_get(f"http://127.0.0.1:{metrics_port}/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    (line,) = [ln for ln in body.splitlines() if ln.startswith("tone_chunks_processed_total ")]
    return int(line.split()[1])


async def _serve_and_drain(proc, port: int, metrics_port: int, audios, chunks: int) -> dict:
    """The streams against a ready server, the last ``DEPLOY_HELD`` without
    their end-of-stream frame; SIGINT (the image's STOPSIGNAL) once the
    server has processed ``chunks`` of them (every frame taken in, so the
    drain cuts none short); every stream's finals and close code, the
    streams still open at the signal, the drain seconds and the exit code."""
    import signal

    base = _chunks_processed(metrics_port)
    url = f"ws://127.0.0.1:{port}/api/ws"
    tasks = [asyncio.create_task(_stream(url, a, i < len(audios) - DEPLOY_HELD))
             for i, a in enumerate(audios)]
    deadline = time.perf_counter() + 120
    while await asyncio.to_thread(_chunks_processed, metrics_port) < base + chunks:
        failed = [repr(t.exception()) for t in tasks if t.done() and t.exception()]
        if time.perf_counter() > deadline or failed:
            for t in tasks:
                t.cancel()
            raise AssertionError(f"the server processed {_chunks_processed(metrics_port) - base}"
                                 f" of {chunks} chunks; streams failed: {failed}")
        await asyncio.sleep(0.02)
    open_at_signal = sum(not t.done() for t in tasks)
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGINT)
    streams = await asyncio.gather(*tasks)
    rc = await asyncio.to_thread(proc.wait, 60)
    return {"streams": streams, "open_at_signal": open_at_signal,
            "drain_s": time.perf_counter() - t0, "exit_code": rc}


def _run_server(argv, env, cwd: Path, log: Path, user: dict, audios, chunks: int) -> dict:
    """Start the server, wait for /v2/health/ready, drive the streams, SIGINT
    it; the child is killed in any case."""
    from tone_tpu_torch.dev.load_test import _tail

    port, metrics_port = int(argv[argv.index("--port") + 1]), int(
        argv[argv.index("--metrics-port") + 1])
    t0 = time.perf_counter()
    with open(log, "wb") as out:
        proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=out, stderr=subprocess.STDOUT,
                                **user)
    try:
        while _ready_status(metrics_port) != 200:
            if proc.poll() is not None:
                raise AssertionError(f"the server exited with {proc.returncode} before it was "
                                     f"ready; its output ends:\n{_tail(log)}")
            if time.perf_counter() - t0 > DEPLOY_READY_TIMEOUT:
                raise AssertionError(f"the server was not ready in {DEPLOY_READY_TIMEOUT} s; "
                                     f"its output ends:\n{_tail(log)}")
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        try:
            run = asyncio.run(_serve_and_drain(proc, port, metrics_port, audios, chunks))
        except AssertionError as e:
            raise AssertionError(f"{e}; the server's output ends:\n{_tail(log)}") from None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    codes = [1000] * (len(audios) - DEPLOY_HELD) + [4503] * DEPLOY_HELD
    if run["exit_code"] != 0 or [s["close_code"] for s in run["streams"]] != codes:
        raise AssertionError(f"drain: exit {run['exit_code']}, close codes "
                             f"{[s['close_code'] for s in run['streams']]}; the server's "
                             f"output ends:\n{_tail(log)}")
    return {"ready_s": ready_s, **run}


def _ready_status(metrics_port: int) -> int | None:
    try:
        return _http_get(f"http://127.0.0.1:{metrics_port}/v2/health/ready")[0]
    except OSError:
        return None


def phase_deploy() -> dict:
    """The serving image's path without docker (see the module docstring, 18)."""
    import torch

    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params

    cfg = ToneConfig()
    return deploy_cell(init_model_params(torch.Generator().manual_seed(0), cfg), cfg)


def deploy_cell(variables, cfg, serve_args=()) -> dict:
    """Build the wheel from a copy of its inputs, install it read-only, save
    the checkpoint, run the image's ENTRYPOINT from the installed copy as its
    unprivileged user, cold (B1 built from the wheel's sources into the
    user's cache) and warm (the image's prebuilt cache, no nvcc reachable),
    each against an in-process engine's finals."""
    import shutil
    import tempfile

    import torch

    from tone_tpu_torch import checkpoint
    from tone_tpu_torch.__main__ import build_engine, build_parser
    from tone_tpu_torch.audio.examples import synthesize_speech_like
    from tone_tpu_torch.dev.load_test import _free_port
    from tone_tpu_torch.ops import _build

    image = deploy_image()
    root = Path(tempfile.mkdtemp(prefix="tone_deploy_"))
    root.chmod(0o755)
    out: dict = {"phase": "deploy", "nvidia_smi": nvidia_smi(), "image": DEPLOY_IMAGE.name}
    try:
        if os.geteuid() == 0:
            # the image's USER: the server runs unprivileged, over trees it can read
            uid, user = DEPLOY_UID, {"user": DEPLOY_UID, "group": DEPLOY_UID, "extra_groups": []}
            blocked = [p for p in root.parents if not p.stat().st_mode & 0o001]
            if blocked:
                raise AssertionError(f"uid {uid} cannot reach {root} through {blocked[0]} "
                                     "(set TMPDIR to a directory others can search)")
        else:
            uid, user = os.geteuid(), {}
        out["server_uid"] = uid
        out["server_user"] = "uid 65534 (dropped from root)" if user else "the caller"

        def owned(name: str) -> Path:  # a directory the server's user may write
            path = root / name
            path.mkdir()
            if user:
                os.chown(path, uid, uid)
            return path

        src, cwd = root / "src", owned("cwd")
        src.mkdir()
        repo = DEPLOY_IMAGE.parent
        for name in DEPLOY_INPUTS:
            if (repo / name).is_dir():
                shutil.copytree(repo / name, src / name, ignore=shutil.ignore_patterns(
                    "_kernels", "__pycache__", "*.so", "*.pyc"))
            else:
                shutil.copy2(repo / name, src / name)
        pip = [sys.executable, "-m", "pip", "--disable-pip-version-check", "--no-cache-dir"]
        t0 = time.perf_counter()
        subprocess.run([*pip, "wheel", "--no-deps", "--no-build-isolation", "--no-index",
                        "-w", str(root / "dist"), str(src)], check=True, capture_output=True)
        out["wheel_s"] = time.perf_counter() - t0
        (wheel,) = (root / "dist").glob("*.whl")
        out["wheel"], out["wheel_bytes"] = wheel.name, wheel.stat().st_size
        site = root / "site"
        t0 = time.perf_counter()
        subprocess.run([*pip, "install", "--no-deps", "--no-index", "--no-warn-script-location",
                        "--target", str(site), str(wheel)], check=True, capture_output=True)
        out["install_s"] = time.perf_counter() - t0
        subprocess.run(["chmod", "-R", "a-w", str(site)], check=True)
        before = _listing(site)
        out["site_files"] = len(before)

        model_dir = root / "model"
        checkpoint.save_checkpoint(model_dir, variables, cfg)
        audios = [synthesize_speech_like(seed, DEPLOY_PHRASES)
                  for seed in range(DEPLOY_STREAMS + DEPLOY_HELD)]
        frame = cfg.audio_chunk_samples
        audios[-DEPLOY_HELD:] = [a[:len(a) // frame * frame] for a in audios[-DEPLOY_HELD:]]
        out["audio_s"] = sum(len(a) for a in audios) / cfg.frontend.sample_rate

        # the reference: the same argv's engine in this process, on the same card
        argv = deploy_argv(image, site, model_dir, _free_port(), _free_port()) + list(serve_args)
        t0 = time.perf_counter()
        engine = build_engine(build_parser().parse_args(argv[1:]))
        try:
            engine.warmup()
            ref = _engine_finals(engine, audios)
        finally:
            engine.shutdown()
        del engine
        torch.cuda.empty_cache()
        check_deploy_launches(ref, cfg)
        if not all(ref["finals"]):
            raise AssertionError(f"a reference stream yielded no final: {ref['finals']}")
        out["engine"] = {"slots": build_parser().parse_args(argv[1:]).slots,
                         **{k: ref[k] for k in ("ticks", "glu_launches", "chunks")},
                         "s": time.perf_counter() - t0}

        base_env = {k: v for k, v in os.environ.items()
                    if k not in ("PYTHONPATH", "TONE_TPU_COMPILE_CACHE", "XDG_CACHE_HOME")}

        def server_env(xdg: Path, cache: Path | None, nvcc: bool) -> dict:
            env = {**base_env, "PYTHONPATH": str(site), "HOME": str(owned(f"home-{xdg.name}")),
                   "TMPDIR": str(owned(f"tmp-{xdg.name}")), "XDG_CACHE_HOME": str(xdg),
                   "TONE_TPU_MODEL_DIR": str(model_dir)}
            if cache is not None:
                env["TONE_TPU_COMPILE_CACHE"] = str(cache)
            if not nvcc:  # as in the runtime image: no nvcc on PATH, CUDA_HOME leads nowhere
                env["PATH"] = os.pathsep.join(d for d in env["PATH"].split(os.pathsep)
                                              if not (Path(d) / "nvcc").exists())
                env["CUDA_HOME"] = str(root / "no-cuda")
                env.pop("CUDA_PATH", None)
                if shutil.which("nvcc", path=env["PATH"]):
                    raise AssertionError("nvcc is still reachable")
            return env

        def serve(name: str, env: dict) -> dict:
            argv = deploy_argv(image, site, model_dir, _free_port(), _free_port())
            run = _run_server(argv + list(serve_args), env, cwd, root / f"{name}.log", user,
                              # a held stream's last two chunks (the padding after it and
                              # an empty one) come with the drain
                              audios, ref["chunks"] - 2 * DEPLOY_HELD)
            finals = [s["finals"] for s in run.pop("streams")]
            if finals != ref["finals"]:
                bad = [i for i, (a, b) in enumerate(zip(finals, ref["finals"])) if a != b]
                raise AssertionError(f"{name}: streams {bad} differ from the in-process engine: "
                                     f"{[finals[i] for i in bad]} != "
                                     f"{[ref['finals'][i] for i in bad]}")
            return {**run, "streams": len(finals), "phrases": sum(map(len, finals))}

        # cold: nothing built, the package read-only: B1 builds into the user's cache
        cold_xdg = owned("xdg-cold")
        out["cold"] = serve("cold", server_env(cold_xdg, None, nvcc=True))
        built = sorted(p.name for p in (cold_xdg / "tone_tpu_torch" / "kernels").glob("*.so"))
        out["cold"]["built"] = built
        check_cold_build(built, _build.library_path("glu_ff").name)

        # warm: the image's prebuild line, then its chown, then no nvcc
        cache = root / "kernels"
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", prebuild_code(image, cache)], cwd=cwd, check=True,
                       capture_output=True, env={**base_env, "PYTHONPATH": str(site),
                                                 "PYTHONDONTWRITEBYTECODE": "1"})
        out["prebuild_s"] = time.perf_counter() - t0
        if user:
            subprocess.run(["chown", "-R", f"{uid}:{uid}", str(cache)], check=True)
        prebuilt = {k: v for k, v in _listing(cache).items() if k != "."}  # its mtime: probes
        out["prebuilt"] = sorted(p.name for p in cache.glob("*.so"))
        warm_xdg = owned("xdg-warm")
        out["warm"] = serve("warm", server_env(warm_xdg, cache, nvcc=False))
        if {k: v for k, v in _listing(cache).items() if k != "."} != prebuilt or any(
                warm_xdg.rglob("*.so")):
            raise AssertionError("the warm server built a library")
        if _listing(site) != before:
            changed = sorted(set(_listing(site).items()) ^ set(before.items()))
            raise AssertionError(f"the installed tree changed: {changed[:10]}")
        return out
    finally:
        subprocess.run(["chmod", "-R", "u+w", str(root)], check=False)
        shutil.rmtree(root, ignore_errors=True)


def check_deploy_launches(ref: dict, cfg) -> None:
    """B1 launched on every layer's two products on every tick of the
    reference engine."""
    if ref["glu_launches"] != 2 * cfg.encoder.n_layers * ref["ticks"]:
        raise AssertionError(f"{ref['glu_launches']} GLU launches over {ref['ticks']} ticks")


def check_cold_build(built: list[str], glu_ff_name: str) -> None:
    """The cold server built B1, under the name of this checkout's sources,
    into the user's cache."""
    if glu_ff_name not in built:
        raise AssertionError(f"{glu_ff_name} was not built in the user's cache: {built}")


# The hub phase: the Hugging Face Hub path through an endpoint on 127.0.0.1
# (tone_tpu_torch/dev/local_hub.py): nothing leaves the machine.
HUB_PUSHED = "tone/pushed"


def _hub_stream(pipe, audio, *, decode: bool) -> dict:
    """``audio`` through ``pipe``: ``pipe.forward_offline`` (its phrase
    texts) where ``decode``, else the model's streaming steps alone (padded
    as the pipeline pads), with every step's logprobs on the host, B1's
    launches over the steps and the seconds of the pass."""
    import torch

    from tone_tpu_torch.ops.glu_ff import glu_ff2

    model, logprobs = pipe.model, []
    step = model.forward_native

    def recorded(chunk, state):
        lp, state = step(chunk, state)
        logprobs.append(lp.cpu())
        return lp, state

    model.forward_native = recorded
    glu_ff2.launches = 0
    t0 = time.perf_counter()
    try:
        texts = None
        if decode:
            texts = [p.text for p in pipe.forward_offline(audio)]
        else:
            x = np.pad(audio, (pipe.PADDING, pipe.PADDING))
            x = np.pad(x, (0, -len(x) % pipe.CHUNK_SIZE)).astype(np.int32)
            state = None
            for chunk in x.reshape(-1, pipe.CHUNK_SIZE):
                _, state = model.forward_native(chunk[None], state)
        torch.cuda.synchronize()
    finally:
        del model.forward_native
    return {"texts": texts, "steps": len(logprobs), "glu_launches": glu_ff2.launches,
            "stream_s": time.perf_counter() - t0, "logprobs": torch.cat(logprobs)}


def phase_hub() -> dict:
    """``StreamingCTCPipeline.from_hugging_face()`` on the card from a local
    endpoint serving the seed-0 model.safetensors and a kenlm.bin (the
    recipes' bigram LM): cold (download over loopback and load) and, with
    the endpoint stopped and ``HF_HUB_OFFLINE=1``, warm from the cache; over
    the short example FLAC, both models' step logprobs equal to the bit to
    ``from_local``'s on the served files, the cold pipeline's texts equal to
    its, B1 launched 32 times per step; ``python -m tone_tpu_torch download
    DIR`` (in a process beside the passes); the checkpoint pushed with the
    port's push_hf, its model.safetensors loading bit-equal."""
    import contextlib
    import io
    import tempfile

    import torch

    from tone_tpu_torch.audio import read_example_audio
    from tone_tpu_torch.bridge import tree_leaves
    from tone_tpu_torch.checkpoint import load_torch_checkpoint, save_checkpoint
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.decoder import BeamSearchCTCDecoder
    from tone_tpu_torch.decoding.kenlm_binary import write_kenlm_binary
    from tone_tpu_torch.decoding.native.beamsearch import build_native
    from tone_tpu_torch.dev import push_hf
    from tone_tpu_torch.dev.beam_quality_sweep import corpus_lm
    from tone_tpu_torch.dev.local_hub import LocalHub, hub_env
    from tone_tpu_torch.hub import TONE_REPO
    from tone_tpu_torch.interop import save_torch_checkpoint
    from tone_tpu_torch.pipeline import StreamingCTCPipeline

    cfg = ToneConfig()
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    audio = read_example_audio()
    per_step = 2 * cfg.encoder.n_layers
    out = {"phase": "hub", "nvidia_smi": nvidia_smi(), "config": "ToneConfig() bf16",
           "audio_s": len(audio) / cfg.frontend.sample_rate}
    if not build_native():  # built before the clock: the ready times are download and load
        raise AssertionError("hub: the native beam decoder did not build")
    runs = {}
    download = None
    with tempfile.TemporaryDirectory() as tmp, hub_env():
        tmp = Path(tmp)
        save_torch_checkpoint(tmp / "model.safetensors", variables, cfg)
        write_kenlm_binary(corpus_lm(), tmp / "kenlm.bin")
        served = {n: (tmp / n).read_bytes() for n in ("model.safetensors", "kenlm.bin")}
        out["served_bytes"] = {n: len(b) for n, b in served.items()}
        ref_dir = tmp / "local"
        ref_dir.mkdir()
        for name, data in served.items():
            (ref_dir / name).write_bytes(data)
        local = LocalHub({TONE_REPO: served}).start()
        url = local.url   # where the warm start finds nothing
        try:
            with hub_env(HF_ENDPOINT=url, HF_HOME=tmp / "hf"):
                t0 = time.perf_counter()
                pipe = StreamingCTCPipeline.from_hugging_face()
                torch.cuda.synchronize()
                out["cold_ready_s"] = time.perf_counter() - t0
            if pipe.model.device.type != "cuda" or not isinstance(
                    pipe.decoder, BeamSearchCTCDecoder) or pipe.decoder._lm is None:
                raise AssertionError(f"hub: {pipe.model.device} {type(pipe.decoder)}")
            # the download subcommand into a fresh cache, beside the passes
            with hub_env(HF_ENDPOINT=url, HF_HOME=tmp / "hf_cli"):
                download = subprocess.Popen(
                    [sys.executable, "-m", "tone_tpu_torch", "download", str(tmp / "dl")],
                    cwd=os.path.dirname(os.path.abspath(__file__)), env=dict(os.environ),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            runs["hub"] = _hub_stream(pipe, audio, decode=True)
            del pipe
            runs["from_local"] = _hub_stream(StreamingCTCPipeline.from_local(ref_dir), audio,
                                             decode=True)

            # the port's push_hf: the checkpoint, the LM and a VAD file
            save_checkpoint(tmp / "ckpt", variables, cfg)
            (tmp / "silero_vad.onnx").write_bytes(np.random.default_rng(0).bytes(4096))
            t0 = time.perf_counter()
            with hub_env(HF_ENDPOINT=url, HF_TOKEN="chip-smoke"), \
                    contextlib.redirect_stdout(io.StringIO()) as printed:
                push_hf.main(["--repo", HUB_PUSHED, "--checkpoint", str(tmp / "ckpt"),
                              "--lm", str(tmp / "kenlm.bin"),
                              "--vad", str(tmp / "silero_vad.onnx")])
            out["push_s"] = time.perf_counter() - t0
            out["push_printed"] = printed.getvalue().strip()
            pushed = local.files(HUB_PUSHED)
            _, stderr = download.communicate(timeout=600)
            if download.returncode != 0:
                raise AssertionError(f"hub download exited {download.returncode}: "
                                     f"{stderr[-3000:]}")
        finally:
            local.stop()
            if download is not None and download.poll() is None:  # a failed check's
                download.kill()
                download.wait()
        got = {p.name: p.read_bytes() for p in (tmp / "dl").iterdir()}
        if got != served:
            raise AssertionError(f"hub download: {sorted(got)} differ from the served files")
        want = {"model.safetensors", "kenlm.bin", "onnx/silero_vad.onnx",
                "tone_tpu_torch_checkpoint/config.json",
                "tone_tpu_torch_checkpoint/variables.safetensors"}
        if set(pushed) != want or pushed["kenlm.bin"] != served["kenlm.bin"]:
            raise AssertionError(f"hub push: {sorted(pushed)}")
        (tmp / "pushed.safetensors").write_bytes(pushed["model.safetensors"])
        loaded = tree_leaves(load_torch_checkpoint(tmp / "pushed.safetensors", cfg))
        if not all(torch.equal(a, b) for a, b in zip(loaded, tree_leaves(variables),
                                                     strict=True)):
            raise AssertionError("hub push: model.safetensors does not load bit-equal")
        out["pushed"] = {p: len(b) for p, b in sorted(pushed.items())}

        # warm: the endpoint stopped, offline, from the cache
        with hub_env(HF_ENDPOINT=url, HF_HOME=tmp / "hf", HF_HUB_OFFLINE=1):
            t0 = time.perf_counter()
            pipe = StreamingCTCPipeline.from_hugging_face()
            torch.cuda.synchronize()
            out["warm_ready_s"] = time.perf_counter() - t0
        runs["warm"] = _hub_stream(pipe, audio, decode=False)
        del pipe
    reference = runs["from_local"]["logprobs"]
    if reference.shape[1:] != (cfg.encoder.chunk_size, cfg.vocab_size_with_blank) or not bool(
            torch.isfinite(reference).all()):
        raise AssertionError(f"hub from_local: logprobs {tuple(reference.shape)}")
    for name, run in runs.items():
        if run["glu_launches"] != per_step * run["steps"] or not run["steps"]:
            raise AssertionError(f"hub {name}: {run['glu_launches']} B1 launches over "
                                 f"{run['steps']} steps")
        run["logprobs_bit_equal"] = torch.equal(run.pop("logprobs"), reference)
        if not run["logprobs_bit_equal"]:
            raise AssertionError(f"hub {name}: logprobs differ from from_local's")
        out[name] = run
    if runs["hub"]["texts"] != runs["from_local"]["texts"]:
        raise AssertionError(f"hub: texts {runs['hub']['texts']} != from_local's "
                             f"{runs['from_local']['texts']}")
    out["glu_launches"] = runs["hub"]["glu_launches"]
    return out


REL_ATTENTION_ITERS = 20


def _rel_attention_ab():
    """dev/torch_rel_attention_ab.py as a module: the cell's batches, its
    inputs, the useful operations and the check against the plain version."""
    import importlib.util

    path = Path(__file__).resolve().parent / "dev" / "torch_rel_attention_ab.py"
    spec = importlib.util.spec_from_file_location("torch_rel_attention_ab", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_rel_attention() -> dict:
    """B3 at the Parakeet cell's batches, then in a full-width forward (see
    the module docstring, 20)."""
    import torch

    from tone_tpu_torch.config import FastConformerConfig
    from tone_tpu_torch.core import layers as L
    from tone_tpu_torch.core.fastconformer import init_fastconformer_params
    from tone_tpu_torch.offline import OfflineTranscriber
    from tone_tpu_torch.ops import rel_attention as RA

    ab = _rel_attention_ab()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    with torch.no_grad():
        for lengths in ab.cell_batches():
            args = ab.cell_inputs(lengths, gen)
            dev_lengths = torch.tensor(lengths, device="cuda")

            def kernel():
                return RA.rel_attention(*args, lengths, ab.N_HEADS)

            def plain():
                return L.rel_attention_plain(*args, n_heads=ab.N_HEADS, lengths=dev_lengths,
                                             host_lengths=lengths)

            RA.rel_attention.launches = 0
            out = kernel()
            launches = RA.rel_attention.launches
            if launches != 1:
                raise AssertionError(f"rel_attention: {launches} launches for one call")
            check = ab.against_plain(out, plain(), lengths)
            if not check["within_limits"]:
                raise AssertionError(f"rel_attention at {max(lengths)} frames: {check}")
            ms = device_time_ms(kernel, REL_ATTENTION_ITERS, "rel_attention_kernel")
            bound_ms = ab.useful_flops(lengths, ab.N_HEADS * ab.D_HEAD) / BF16_FLOPS * 1e3
            cases.append({"rows": len(lengths), "longest": max(lengths), "frames": sum(lengths),
                          "launches": launches, **check, "ms": ms,
                          "event_ms": cuda_time_ms(kernel, REL_ATTENTION_ITERS),
                          "plain_ms": cuda_time_ms(plain, 4), "bound_ms": bound_ms,
                          "bound_by": "operations", "bound_share": bound_ms / ms})
            del args, out
        torch.cuda.empty_cache()

    cfg = FastConformerConfig()
    variables = init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    calls = [rng.integers(-8000, 8000, n).astype(np.int16)
             for n in rng.integers(5 * 16000, 60 * 16000, 16)]
    tr = OfflineTranscriber(variables, cfg, batch_size=16, use_offline_forward=True)
    RA.rel_attention.launches = 0
    logprobs = tr.logprobs(calls)
    forward_launches = RA.rel_attention.launches
    if forward_launches != cfg.encoder.n_layers:
        raise AssertionError(f"rel_attention: {forward_launches} launches in a forward of "
                             f"{cfg.encoder.n_layers} layers")
    if not all(np.isfinite(lp).all() for lp in logprobs):
        raise AssertionError("rel_attention: the full-width forward gave non-finite logprobs")
    return {"phase": "rel_attention", "kernel": "rel_attention", "n_heads": ab.N_HEADS,
            "d_head": ab.D_HEAD, "ms": "device time per launch (torch.profiler), back to back",
            "cases": cases, "forward_launches": forward_launches,
            "forward_calls": len(calls), "forward_layers": cfg.encoder.n_layers}


PHASES = ("kernels", "step", "artifacts", "serve", "fused_kernels", "fused_step", "beam_decode",
          "serve_beam", "serve_fused", "serve_host_beam", "bulk", "train", "parallel",
          "recipes", "bench", "deploy", "hub", "rel_attention")


def kernel_summary(out: dict) -> dict:
    """The line of every kernel whose phases ran: its launches on its main
    paths, errors, times and bounds."""
    lines = []
    if {"kernels", "serve", "bulk"} <= set(out):
        lines.append(_glu_ff_line(out))
    if {"fused_kernels", "fused_step"} <= set(out):
        lines.append(_fused_layer_line(out))
    if "rel_attention" in out:
        lines.append(_rel_attention_line(out["rel_attention"]))
    return {"kernels": lines}


def _glu_ff_line(out: dict) -> dict:
    kernels, serve, bulk = (out[k] for k in ("kernels", "serve", "bulk"))
    # The serve phase is the main path: its full-rate layers give M = 10 * slots.
    main_m = SERVE_SLOTS * 10
    case = next(c for c in kernels["cases"] if c["m"] == main_m)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share", "gemm_ms")
    return {
        "name": "glu_ff2", "route": "cuda", "source": "tone_tpu_torch/csrc/glu_ff.cu",
        "replaces": "tone_tpu/ops/glu_ff.py:60", "launches": serve["glu_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in kernels["cases"]
                           + (out["bench"]["sweep"]["glu_cases"] if "bench" in out else [])),
        "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"], "bound_share": case["bound_share"], "library_ms": None,
        "event_ms": case["event_ms"], "gemm_ms": case["gemm_ms"], "m": main_m,
        "bulk_launches_per_batch": {r["forward"]: r["glu_launches_per_batch"]
                                    for r in bulk["runs"]},
        "bulk_m": [{"m": c["m"], **{k: c[k] for k in keys}}
                   for c in kernels["cases"] if c["m"] in BULK_MS],
        **({"exported_launches_per_step": out["artifacts"]["export"]["child"]["glu_launches"]}
           if "artifacts" in out else {}),
        **({"parallel_launches": {
            "bulk_per_batch_two_replicas": {r["forward"]: r["glu_launches_per_batch"]
                                            for r in out["parallel"]["bulk"]},
            "serve_two_replicas": out["parallel"]["serve"]["two_replicas"]["glu_launches"],
            "serve_two_replicas_ticks": out["parallel"]["serve"]["two_replicas"]["ticks"]}}
           if "parallel" in out else {}),
        **({"tiny_width": {
            "f": out["recipes"]["bf16_deploy"]["f"], "d": out["recipes"]["bf16_deploy"]["d"],
            "launches": out["recipes"]["bf16_deploy"]["glu_launches"],
            "cases": out["recipes"]["bf16_deploy"]["glu_cases"]},
            "finetuned_launches": out["recipes"]["finetune"]["glu_launches"]}
           if "recipes" in out else {}),
        **({"bench": {
            "sweep_launches": out["bench"]["sweep"]["glu_launches"],
            "sweep_batches": [r["batch"] for r in out["bench"]["sweep"]["rows"] if "rtfx" in r],
            "tick_launches": out["bench"]["tick"]["glu_launches"],
            "tick_slots": TICK_SLOTS, "ticks": TICK_TICKS + 1,
            "step_m": [{"m": c["m"], "max_abs_err": c["max_abs_err"], **{k: c[k] for k in keys}}
                       for c in out["bench"]["sweep"]["glu_cases"]]}}
           if "bench" in out else {}),
        **({"deploy_launches": out["deploy"]["engine"]["glu_launches"],
            "deploy_ticks": out["deploy"]["engine"]["ticks"],
            "deploy_slots": out["deploy"]["engine"]["slots"]}
           if "deploy" in out else {}),
        **({"hub_launches": out["hub"]["glu_launches"], "hub_steps": out["hub"]["hub"]["steps"]}
           if "hub" in out else {})}


def _fused_layer_line(out: dict) -> dict:
    fused, fused_step = out["fused_kernels"], out["fused_step"]
    # The fused step is B2's main path: its 16 layers at B = 64, so B2's
    # times are the mean per launch over a step's mix of layer kinds.
    step_cases = [(c, FUSED_KINDS[c["kind"]][1]) for c in fused["cases"] if c["batch"] == 64]
    per_launch = {key: sum(c[key] * n for c, n in step_cases) / 16
                  for key in ("ms", "plain_ms", "bound_ms")}
    return {
        "name": "fused_conformer_layer", "route": "cuda",
        "source": "tone_tpu_torch/csrc/fused_layer.cu",
        "replaces": "tone_tpu/ops/fused_layer.py:445",
        "launches": fused_step["fused_launches"],
        "max_abs_err": max(v for c in fused["cases"] for v in c["max_abs_err"].values()),
        **per_launch,
        "bound_by": max(("bytes", "operations"), key=lambda by: sum(
            c["bound_ms"] * n for c, n in step_cases if c["bound_by"] == by)),
        "library_ms": None, "shape": "mean per launch over the 16 layers of a B=64 step"}


def _rel_attention_line(phase: dict) -> dict:
    # The Parakeet cell is B3's main path; its longest batch takes most of
    # the kernel's time, so the line gives that batch and lists the others.
    case = max(phase["cases"], key=lambda c: c["longest"])
    return {
        "name": "rel_attention", "route": "cuda", "source": "tone_tpu_torch/csrc/rel_attention.cu",
        "replaces": None, "launches": phase["forward_launches"],
        "max_abs_err": max(c["max_abs_diff"] for c in phase["cases"]),
        **{k: case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share")},
        "library_ms": None, "shape": f"16 rows, longest {case['longest']} frames, H 8, dh 128",
        "cases": [{k: c[k] for k in ("longest", "launches", "ms", "bound_ms", "bound_share",
                                     "max_share", "rms_share")} for c in phase["cases"]]}


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
                             "all; the kernel summary line holds the kernels whose "
                             "phases ran)")
    # the artifacts phase's processes
    parser.add_argument("--exported-child", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--export-child", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.exported_child:
        return exported_child(args.exported_child)
    if args.export_child:
        return export_child(args.export_child)
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
    summary = kernel_summary(out)
    if summary["kernels"]:
        emit(summary)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
