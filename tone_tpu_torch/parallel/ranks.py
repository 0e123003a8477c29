"""Starting the ranks of a training mesh, and a rank program that trains
from a spec file.

``launch_ranks(argv, devices, timeout)`` starts one process per device,
``python argv...``, each told its rank, the world size, its device, the
backend and a ``file://`` rendezvous in a temporary directory through the
environment; it waits for all of them, and stops every one if one fails or
the time runs out.  In the rank, ``init_rank()`` joins the group.  The
backend is NCCL where every rank has a GPU of its own, and gloo on the CPU
and where ranks share a GPU (gloo reduces CUDA tensors through the host).

The rank program, ``python -m tone_tpu_torch.parallel.ranks SPEC OUT``
(started by ``train_on_mesh``), reads a ``torch.save``'d spec: the model
and trainer configurations, the full variables, one collated batch (or
one per step), the number of steps and the mesh shape.  It trains that many steps on its
mesh position, optionally evaluates the WER and saves, restores and
resumes the state, and writes ``OUT/rank<r>.json``: its losses, ms and
all-reduced bytes per step.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ENV_RANK = "TONE_TPU_RANK"
ENV_WORLD_SIZE = "TONE_TPU_WORLD_SIZE"
ENV_DEVICE = "TONE_TPU_DEVICE"
ENV_BACKEND = "TONE_TPU_BACKEND"
ENV_RENDEZVOUS = "TONE_TPU_RENDEZVOUS"
ENV_TIMEOUT = "TONE_TPU_RANK_TIMEOUT"
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def choose_backend(devices) -> str:
    """``nccl`` where every rank has a GPU of its own, else ``gloo``."""
    devices = [torch.device(d) for d in devices]
    distinct = len({d.index for d in devices}) == len(devices)
    return "nccl" if all(d.type == "cuda" for d in devices) and distinct else "gloo"


def init_rank() -> tuple[int, int, torch.device]:
    """Join the group that ``launch_ranks`` started: (rank, world size,
    device).  The device becomes the current CUDA device."""
    rank, world = int(os.environ[ENV_RANK]), int(os.environ[ENV_WORLD_SIZE])
    device = torch.device(os.environ[ENV_DEVICE])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(os.environ[ENV_BACKEND],
                            init_method="file://" + os.environ[ENV_RENDEZVOUS],
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=float(os.environ[ENV_TIMEOUT])))
    return rank, world, device


def launch_ranks(argv: list[str], devices, timeout: float = 600.0,
                 env: dict[str, str] | None = None) -> list[str]:
    """Run ``python argv...`` as one rank per entry of ``devices`` (a device
    may be named more than once) and return each rank's standard output.
    Raises RuntimeError, naming the rank and the end of its standard error,
    if a rank exits non-zero, and TimeoutError after ``timeout`` seconds;
    either way every rank still running is killed."""
    devices = [str(torch.device(d)) for d in devices]
    backend = choose_backend(devices)
    with tempfile.TemporaryDirectory(prefix="tone_ranks_") as tmp:
        base = {**os.environ, **(env or {}),
                ENV_WORLD_SIZE: str(len(devices)), ENV_BACKEND: backend,
                ENV_RENDEZVOUS: os.path.join(tmp, "rendezvous"),
                ENV_TIMEOUT: str(timeout),
                "PYTHONPATH": os.pathsep.join(
                    p for p in (_PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)}
        procs, files = [], []
        try:
            for rank, device in enumerate(devices):
                out = open(os.path.join(tmp, f"out{rank}"), "w+", encoding="utf-8")
                err = open(os.path.join(tmp, f"err{rank}"), "w+", encoding="utf-8")
                files += [out, err]
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], stdout=out, stderr=err,
                    env={**base, ENV_RANK: str(rank), ENV_DEVICE: device}))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    rank = failed[0]
                    files[2 * rank + 1].seek(0)
                    raise RuntimeError(f"rank {rank} of {len(devices)} ({backend}) exited "
                                       f"{codes[rank]}: {files[2 * rank + 1].read()[-3000:]}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{len(devices)} ranks ({backend}) did not finish "
                                       f"within {timeout} s")
                time.sleep(0.05)
            outputs = []
            for out in files[0::2]:
                out.seek(0)
                outputs.append(out.read())
            return outputs
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in files:
                f.close()


def train_on_mesh(spec: dict, devices, out_dir: Path, timeout: float = 600.0,
                  env: dict[str, str] | None = None) -> list[dict]:
    """Write ``spec`` (see ``main``) to ``out_dir`` and train it on one rank
    per device; returns each rank's result, in rank order."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(spec, out_dir / "spec.pt")
    launch_ranks(["-m", "tone_tpu_torch.parallel.ranks", str(out_dir / "spec.pt"),
                  str(out_dir)], devices, timeout, env)
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(len(devices))]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> int:
    """The rank program.  The spec holds ``config`` (``ToneConfig.to_dict``),
    ``trainer`` (``TrainerConfig`` fields), ``variables`` (full, on the
    CPU), ``batch`` (a collated batch as tensors, taken at every step) or
    ``batches`` (one per step, in turn), ``steps``, ``n_data``, ``n_model``
    and optionally ``references`` (WER of the last batch after the steps)
    and ``save`` (save, restore and take one more step on the last batch
    from both the restored and the live state)."""
    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.parallel.collectives import ProcessMesh
    from tone_tpu_torch.training.train import Trainer, TrainerConfig

    spec_path, out_dir = (argv if argv is not None else sys.argv[1:])
    out_dir = Path(out_dir)
    spec = torch.load(spec_path, map_location="cpu", weights_only=True)
    rank, _, device = init_rank()
    try:
        mesh = ProcessMesh(spec["n_data"], spec["n_model"])
        trainer = Trainer(ToneConfig.from_dict(spec["config"]),
                          TrainerConfig(**spec["trainer"]), mesh=mesh, device=device)
        state = trainer.create_state(spec["variables"])
        batches = [{k: np.asarray(v) for k, v in b.items()}
                   for b in spec.get("batches", [spec.get("batch")])]
        losses, ms, reduced = [], [], []
        for step in range(spec["steps"]):
            batch = batches[step % len(batches)]
            _sync(device)
            t0, b0 = time.perf_counter(), mesh.bytes_reduced
            state, loss = trainer.train_step(state, batch)
            losses.append(float(loss))
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            reduced.append(mesh.bytes_reduced - b0)
        result = {"rank": rank, "data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
                  "backend": dist.get_backend(), "device": str(device), "losses": losses,
                  "ms_per_step": ms, "bytes_reduced_per_step": reduced}
        if spec.get("references"):
            result["wer"] = trainer.eval_wer(state, [batch], list(spec["references"]))
        if spec.get("save"):
            trainer.save(out_dir / "checkpoint", state)
            restored = trainer.restore(out_dir / "checkpoint", state)
            _, resumed = trainer.train_step(restored, batch)
            _, live = trainer.train_step(state, batch)
            result["resumed_loss"], result["live_loss"] = float(resumed), float(live)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
