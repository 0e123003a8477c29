"""Headline benchmark of the port: aggregate streaming RTFx on one GPU
(port of the repo's ``bench.py``).

Measures the steady-state batched streaming step — the serving hot path:
B concurrent telephony streams each advancing one 300 ms chunk per step
with full carried recurrent state, bf16 compute, the full ``ToneConfig()``
from the JAX bench's initial weights (``init_model_params(PRNGKey(0))``,
drawn in numpy by ``core/jax_random.py``).  RTFx = audio-seconds processed
per wall-second; the north star is > 500x per chip (BASELINE.md).

    python -m tone_tpu_torch.bench [--device cpu]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"power_limit"}, and a line per batch size on stderr.  The sweep stops at the
first batch size the card has no memory for; any other error fails the run.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.profiling import device_label, step_stats

BASELINE_RTFX = 500.0  # north-star target per chip (BASELINE.md)
CHUNK_SECONDS = 0.3
GPU_BATCHES = (128, 512, 1024, 1280)
CPU_BATCHES = (8, 16)


def measure_batch(model, batch_size: int, steps: tuple[int, int] = (20, 120)) -> float:
    """Steady-state seconds per step at a given stream count (the two-point
    slope of ``profiling.step_stats``)."""
    return step_stats(model, batch_size, steps).seconds_per_step


def sweep(model, batches, steps: tuple[int, int] = (20, 120)) -> list[dict]:
    """``measure_batch`` at each batch size in turn: one row per batch
    (ms per step, RTFx and, on a card, the peak of allocated memory during
    its chains), ending early with an ``"oom"`` row at the first batch size
    the card has no memory for."""
    rows = []
    on_card = model.device.type == "cuda"
    for batch in batches:
        if on_card:
            torch.cuda.synchronize(model.device)
            torch.cuda.reset_peak_memory_stats(model.device)
            resident = torch.cuda.memory_allocated(model.device)
        try:
            sec_per_step = measure_batch(model, batch, steps)
        except torch.cuda.OutOfMemoryError as e:  # the card is full: stop the sweep
            print(f"batch {batch}: {type(e).__name__}: {e}", file=sys.stderr)
            rows.append({"batch": batch, "oom": str(e).splitlines()[0]})
            break
        row = {"batch": batch, "ms_per_step": sec_per_step * 1e3,
               "rtfx": batch * CHUNK_SECONDS / sec_per_step}
        if on_card:
            peak = torch.cuda.max_memory_allocated(model.device)
            row.update(peak_bytes=peak, bytes_per_stream=(peak - resident) / batch)
        print(f"batch {batch}: {row['ms_per_step']:.2f} ms/step, RTFx {row['rtfx']:.0f}, "
              f"chunk latency {row['ms_per_step']:.2f} ms", file=sys.stderr)
        rows.append(row)
    return rows


def headline(rows: list[dict], device: torch.device) -> dict:
    """The JAX bench's JSON line over ``sweep`` rows: the best RTFx, and the
    card it ran on."""
    best = max((r for r in rows if "rtfx" in r), key=lambda r: r["rtfx"], default={})
    best_rtfx = best.get("rtfx", 0.0)
    return {
        "metric": f"aggregate streaming RTFx per chip ({device.type}, "
                  f"batch {best.get('batch')}, {best.get('ms_per_step', 0):.1f} ms/chunk-step)",
        "value": round(best_rtfx, 1),
        "unit": "x realtime",
        "vs_baseline": round(best_rtfx / BASELINE_RTFX, 3),
        **device_label(device),
    }


def bench_model(device: torch.device):
    """The full-width bf16 model from the JAX bench's initial weights."""
    from tone_tpu_torch.acoustic import StreamingCTCModel
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.jax_random import jax_init_model_params

    config = ToneConfig()  # bf16 compute policy
    return StreamingCTCModel(jax_init_model_params(0, config), config, device=device)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    model = bench_model(device)
    batches = GPU_BATCHES if device.type == "cuda" else CPU_BATCHES
    print(json.dumps(headline(sweep(model, batches), device)))


if __name__ == "__main__":
    main()
