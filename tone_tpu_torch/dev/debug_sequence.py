"""Sequence-batching smoke test (port of ``dev/debug_sequence.py``): run N
random chunks through one engine stream and print the state evolution
invariants — shapes stay static, state actually changes, slot reuse is
clean (a second stream in the freed slot, fed the first stream's first
chunk, starts from the state the first stream started from).

    python -m tone_tpu_torch.dev.debug_sequence [--steps 8] [--slots 4] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tone_tpu_torch.device import resolve_device


def _leaves(engine) -> list:
    """Every tensor of the engine's arena state."""
    leaves = []
    for state in engine.arena._states:
        state.map(lambda x, ax: leaves.append(x) or x)
    return leaves


def run_sequence(variables, config, steps: int = 8, slots: int = 4, device=None) -> dict:
    """Drive one stream of ``steps`` seeded chunks through a fresh engine,
    then a second stream in the freed slot; returns the state norms, the
    distinct leaf-shape lists and whether the reused slot started clean.
    Raises AssertionError when an invariant fails."""
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    engine = MultiStreamEngine(variables, config, n_slots=slots, device=resolve_device(device))
    try:
        engine.arena.warmup()
        rng = np.random.default_rng(0)
        chunks = [rng.integers(-20000, 20000, config.audio_chunk_samples).astype(np.int32)
                  for _ in range(steps)]

        def drive(sid, feed):
            norms, shapes, blobs = [], [], []
            for step, chunk in enumerate(feed):
                engine.feed(sid, chunk, is_last=step == len(feed) - 1)
                slot = engine._streams[sid].slot
                engine.tick()
                leaves = _leaves(engine)
                norms.append(float(sum(x.float().abs().sum().item() for x in leaves)))
                shapes.append(tuple(tuple(x.shape) for x in leaves))
                blobs.append(engine.arena.read_slot(slot))
            return norms, shapes, blobs

        first = engine.open_stream()
        norms, shapes, blobs = drive(first, chunks)
        for step, (norm, shape) in enumerate(zip(norms, shapes)):
            print(f"step {step}: state |x|={norm:.1f}  leaves={len(shape)} "
                  f"(static shapes: {len(set(shapes))} unique)")
        assert len(set(f"{n:.1f}" for n in norms)) > 1, "state never changed!"
        assert len(set(shapes)) == 1, "the state's shapes changed between ticks"
        second = engine.open_stream()
        _, _, reused = drive(second, chunks[:1])
        clean = bool(np.array_equal(reused[0], blobs[0]))
        assert clean, "the reused slot did not start from a zero state"
        print("sequence state evolves, shapes are static and slot reuse is clean: OK")
        return {"norms": norms, "unique_shapes": len(set(shapes)),
                "leaves": len(shapes[0]), "clean_reuse": clean}
    finally:
        engine.shutdown()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--checkpoint", type=Path, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from tone_tpu_torch.config import ToneConfig

    config = ToneConfig()
    if args.checkpoint:
        from tone_tpu_torch.checkpoint import load_checkpoint

        variables, stored = load_checkpoint(args.checkpoint)
        config = stored or config
    else:
        import torch

        from tone_tpu_torch.core.model import init_model_params

        variables = init_model_params(torch.Generator().manual_seed(0), config)
    run_sequence(variables, config, args.steps, args.slots, device)


if __name__ == "__main__":
    main()
