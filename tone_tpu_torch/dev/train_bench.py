"""Train-step throughput of the full model (port of ``dev/train_bench.py``).

Steady-state wall time of ``Trainer.train_step`` for the production
``ToneConfig()`` (from the JAX bench's initial weights,
``core/jax_random.py``) at a realistic fine-tuning shape, reported as
audio-seconds consumed per second — the same unit as the serving RTFx
headline, so the two budgets compare directly.  The batch (random audio and
labels from ``default_rng(0)``) is staged on the device once, as the JAX
script does; the step ends each timed chain by reading the loss on the host.

    python -m tone_tpu_torch.dev.train_bench [--batch 16] [--seconds 10] [--steps 8] [--remat full] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.profiling import device_label


def make_batch(batch: int, seconds: float, label_len: int, sample_rate: int = 8000) -> dict:
    """The JAX script's batch: ``batch`` clips of ``seconds`` of N(0, 0.1)
    audio and ``label_len`` random labels each, from ``default_rng(0)``."""
    from tone_tpu_torch.config import LABELS

    rng = np.random.default_rng(0)
    n_samples = int(seconds * sample_rate)
    return {
        "input_values": rng.normal(0, 0.1, (batch, n_samples)).astype(np.float32),
        "input_lengths": np.full(batch, n_samples, np.int32),
        "labels": rng.integers(0, len(LABELS), (batch, label_len)).astype(np.int32),
    }


def measure(batch: int = 16, seconds: float = 10.0, label_len: int = 100, steps: int = 8,
            grad_accum: int = 1, remat: str | None = None, device=None, config=None,
            variables=None) -> dict:
    """The JAX script's report: one first step (``compile_s``: no compiler
    here, the first step's wall time), then the two-point slope over chains
    of ``steps`` and ``3 * steps`` steps (each the shorter of two runs).
    Adds the first step's loss, the card and, on a card, the peak of
    allocated memory over the timed steps."""
    from tone_tpu_torch.bridge import tree_leaves
    from tone_tpu_torch.training.train import Trainer, TrainerConfig

    dev = resolve_device(device)
    if config is None:
        from tone_tpu_torch.config import ToneConfig
        from tone_tpu_torch.core.jax_random import jax_init_model_params

        config = ToneConfig()
        variables = jax_init_model_params(0, config)
    # Stage the batch on the device once (a real input pipeline overlaps its
    # transfers with compute).
    staged = {k: torch.from_numpy(v).to(dev)
              for k, v in make_batch(batch, seconds, label_len,
                                     config.frontend.sample_rate).items()}
    trainer = Trainer(config, TrainerConfig(grad_accum_steps=grad_accum, remat=remat),
                      device=dev)
    state = trainer.create_state(variables)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    on_card = dev.type == "cuda"

    t0 = time.monotonic()
    state, loss = trainer.train_step(state, staged)
    first_loss = float(loss)                         # forced host sync
    compile_s = time.monotonic() - t0

    def chain(n: int) -> float:
        nonlocal state, loss
        t0 = time.monotonic()
        for _ in range(n):
            state, loss = trainer.train_step(state, staged)
        float(loss)
        return time.monotonic() - t0

    chain(2)  # settle the allocator
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    n1, n2 = steps, 3 * steps
    t1 = min(chain(n1) for _ in range(2))
    t2 = min(chain(n2) for _ in range(2))
    step_s = max((t2 - t1) / (n2 - n1), 1e-9)

    audio_s = batch * seconds
    return {
        "params_m": round(n_params / 1e6, 1),
        "devices": torch.cuda.device_count() if on_card else 1,
        "batch": batch,
        "clip_s": seconds,
        "step_ms": round(step_s * 1e3, 1),
        "audio_s_per_s": round(audio_s / step_s, 1),
        "samples_per_s": round(batch / step_s, 1),
        "compile_s": round(compile_s, 1),
        "loss": round(float(loss), 3),
        "first_loss": first_loss,
        "remat": remat,
        **({"peak_memory_mb": round(torch.cuda.max_memory_allocated(dev) / 2**20, 1)}
           if on_card else {}),
        **device_label(dev),
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=10.0,
                        help="clip length per sample (8 kHz)")
    parser.add_argument("--label-len", type=int, default=100)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--grad-accum", type=int, default=1)
    parser.add_argument("--remat", choices=["dots", "full"], default=None)
    parser.add_argument("--cpu", action="store_true", help="same as --device cpu")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    print(json.dumps(measure(args.batch, args.seconds, args.label_len, args.steps,
                             args.grad_accum, args.remat, "cpu" if args.cpu else args.device)))


if __name__ == "__main__":
    main()
