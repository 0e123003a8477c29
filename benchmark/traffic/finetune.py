"""Traffic kind ``finetune``: fine-tuning steps on batches of call audio.

The cell's parameters give the batch (``batch``), the utterance lengths
(``utterance_seconds``: median, sigma, min, max of a clipped lognormal),
the labels per second of audio (``labels_per_second``), the number of
distinct batches in the cycle the window trains on (``batches``), the
seed of their sizes (``base_seed``) and the traced steps
(``trace_steps``).  Every run's seed gives the same sizes in another order:
the lengths of each batch are drawn once from ``base_seed``, the order of
the batches, the audio cut from a speech-like pool and the labels (random
letters) from the run's seed.  The port's collator pads each batch, and
each step takes its batch from the host, as users' loaders hand it over.

Set-up builds one train state from the seed's weights, runs the first
three steps through ``Trainer.train_step`` on three different batches, and
reads from them what the reference checks: each step's loss, the first
gradient as AdamW got it (its first moment after one step, / (1 - b1)) and
the parameters' change after the three steps.  The same state then trains
in the window: steps until ``--seconds`` have passed, the window closing
when the device has finished the last step queued.  End to end: the
unpadded audio seconds of the steps in the window per second.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import audio, compare, program
from harness.flops import chunk_flops
from harness.report import Outcome
from harness.trace import DeviceTrace
from reference import model as ref_model
from reference import train as ref_train

CORRECTNESS_STEPS = 3


def _lengths(p: dict) -> np.ndarray:
    """(batches, batch) utterance lengths in samples, from ``base_seed``."""
    u = p["utterance_seconds"]
    rng = np.random.default_rng(p["base_seed"])
    secs = np.clip(rng.lognormal(np.log(u["median"]), u["sigma"], (p["batches"], p["batch"])),
                   u["min"], u["max"])
    return (secs * audio.SAMPLE_RATE).astype(np.int64)


def make_batches(p: dict, seed: int, letters: int) -> list[dict]:
    """The cycle of collated host batches of run ``seed``."""
    from tone_tpu_torch.training.collator import DataCollatorCTCWithPadding

    lengths = _lengths(p)
    rng = np.random.default_rng([seed, 3])
    order = rng.permutation(len(lengths))
    speech = audio.pool(seed, p["pool_seconds"])
    collate = DataCollatorCTCWithPadding()
    batches = []
    for k in order:
        rows = []
        for n in lengths[k]:
            wav = audio.cut(speech, int(rng.integers(len(speech))), int(n),
                            float(rng.uniform(0.5, 1.0))).astype(np.float32) / 32768.0
            labels = rng.integers(0, letters, int(round(p["labels_per_second"] * n / audio.SAMPLE_RATE)))
            rows.append({"input_values": wav, "labels": labels.astype(np.int32)})
        batch = collate(rows)
        batch["audio_seconds"] = float(lengths[k].sum()) / audio.SAMPLE_RATE
        batches.append(batch)
    return batches


def run(c, *, seed, seconds, trace, device, started, control=False, faults=None):
    from tone_tpu_torch.bridge import tree_leaves
    from tone_tpu_torch.training.train import ADAM_B1, Trainer, TrainerConfig

    from harness.weights import make_variables

    faults = faults or {}
    p = c.params
    dev = torch.device(device)
    cfg = program.tone_config(c.model)
    variables = make_variables(c.model, seed, dev)
    batches = make_batches(p, seed, len(cfg.labels))
    trainer = Trainer(cfg, TrainerConfig(seed=seed), device=dev)
    _break(trainer, faults)
    state = trainer.create_state(variables)
    program.start_memory(dev)

    # The first steps: the reference's readings, and the warm-up.
    losses, grads = [], None
    paths = [path for path, _ in ref_model.tree_items(variables["params"])]
    for k in range(CORRECTNESS_STEPS):
        state, loss = trainer.train_step(state, batches[k])
        losses.append(float(loss))
        if k == 0:
            mu = tree_leaves(state.opt_state.mu)
            grads = {path: float(torch.linalg.vector_norm(m)) / (1 - ADAM_B1)
                     for path, m in zip(paths, mu)}
    change = {path: float(torch.linalg.vector_norm(q.detach() - p0))
              for (path, p0), q in zip(ref_model.tree_items(variables["params"]),
                                       tree_leaves(state.params))}
    readings = {"loss": losses, "grad": grads, "change": change}

    # The window.
    dtrace = DeviceTrace() if trace and dev.type == "cuda" else None
    if dtrace is not None:
        dtrace.prime()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_window = time.monotonic()
    setup_s = t_window - started
    steps, audio_s, k = 0, 0.0, CORRECTNESS_STEPS
    trace_at = t_window + max(0.0, (seconds - p["trace_seconds"]) / 2)
    traced_steps, traced_audio, spans = None, 0.0, {"train_step (host)": []}
    trace_cost = {}
    while True:
        if dtrace is not None and traced_steps is None and time.monotonic() >= trace_at:
            a = time.monotonic()
            dtrace.start()
            trace_cost["start_s"] = time.monotonic() - a
            traced_steps = 0
        batch = batches[k % len(batches)]
        k += 1
        a = time.monotonic_ns()
        state, _ = trainer.train_step(state, batch)
        spans["train_step (host)"].append((a, time.monotonic_ns()))
        steps += 1
        audio_s += batch["audio_seconds"]
        if traced_steps is not None and dtrace.t1 == 0:
            traced_steps += 1
            traced_audio += batch["audio_seconds"]
            if traced_steps >= p["trace_steps"]:
                a = time.monotonic()
                dtrace.stop()
                trace_cost["stop_s"] = time.monotonic() - a
        if time.monotonic() - t_window >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window = time.monotonic() - t_window
    if traced_steps is not None and dtrace.t1 == 0:
        dtrace.stop()
    peak = program.memory_peak(dev)

    per_layer, busy, wsec, brk = {}, None, None, None
    if dtrace is not None and dtrace.t1:
        counters = {"audio_s": traced_audio, "steps": traced_steps,
                    "flops_per_audio_s": chunk_flops(ref_model.sizes(c.model))
                    / (cfg.audio_chunk_samples / cfg.frontend.sample_rate)}
        per_layer, busy, wsec, brk = program.per_layer(
            c, dev, dtrace, program.clip_spans(spans, dtrace.t0, dtrace.t1), counters,
            "between steps")

    del state, trainer
    program.release(dev)
    compared, notes = _check(c, variables, batches[:CORRECTNESS_STEPS], seed, readings, dev,
                             control)
    return Outcome(attempted=steps, failed=0,
                   end_to_end={"setup_s": setup_s, "train_audio_s_per_s": audio_s / window},
                   compared=compared, memory_peak_bytes=peak,
                   device_kind=program.device_kind(dev), per_layer=per_layer, busy_s=busy,
                   window_s=wsec, breakdown=brk,
                   notes={"steps": steps, "window_s": window, "loss": losses,
                          "trace_cost_s": trace_cost, **notes})


def _break(trainer, faults: dict) -> None:
    """Faults the tests plant under the timed path."""
    step = trainer.train_step
    if faults.get("state_unchanged"):
        def unchanged(state, batch):
            loss, _, _ = trainer.compute_gradients(state, batch)
            return state, loss
        trainer.train_step = unchanged
    if faults.get("half_batch"):
        def half(state, batch):
            n = len(batch["input_lengths"]) // 2
            return step(state, {k: (v[:n] if isinstance(v, np.ndarray) else v)
                                for k, v in batch.items()})
        trainer.train_step = half


def _check(c, variables, batches, seed, readings, dev, control):
    from tone_tpu_torch.training.train import TrainerConfig

    tc = TrainerConfig(seed=seed)
    hyper = {"learning_rate": tc.learning_rate, "warmup_ratio": tc.warmup_ratio,
             "total_steps": tc.total_steps, "weight_decay": tc.weight_decay,
             "max_grad_norm": tc.max_grad_norm}
    s = ref_model.sizes(c.model)
    on_dev = [{k: torch.as_tensor(b[k]).to(dev) for k in ("input_values", "input_lengths", "labels")}
              for b in batches]
    with ref_model.float32_exactly():
        ref = ref_train.train_steps(variables, s, on_dev, seed, hyper)
    compared, worst = _numbers(readings, ref)
    notes = {"reference_loss": ref["loss"], "worst_leaves": worst}
    if control:
        with ref_model.float32_exactly():
            low = ref_train.train_steps(variables, s, on_dev, seed, hyper,
                                        ref_model.Precision("fp8"))
        notes["control"], _ = _numbers(low, ref)
    return compared, notes


def _numbers(side: dict, ref: dict) -> tuple[dict, dict]:
    """The three numbers compared, and the leaf that sets each gap."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(side["loss"], ref["loss"]))
    # Leaves whose gradient is nought to rounding in the reference (the
    # biases just before a training BatchNorm, whose batch mean cancels
    # them) carry only round-off: left out of both numbers.
    moved = compare.moved_leaves(ref["grad"])
    grad_gap, grad_leaf = compare.leaf_gaps(side["grad"], ref["grad"], moved)
    change_gap, change_leaf = compare.leaf_gaps(side["change"], ref["change"], moved)
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap},
            {"grad_gap": grad_leaf, "change_gap": change_leaf})
