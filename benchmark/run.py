#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is named in BENCHMARK.json; its traffic and limits are in
``benchmark/workloads/<cell>.json``, its configuration in
``benchmark/configs/<config>.json`` and its traffic kind's code in
``benchmark/traffic/<kind>.py``.  With ``--trace 0`` the result line holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``benchmark/metrics/<metric>.py``).  Either way the run checks what its
timed path produced against the plain reference (``benchmark/reference/``)
and prints each number compared beside its limit.  It runs on the card it
is started on and refuses to run without one.

For finding a cell's rates and limits, not for the benchmark's runs:
``--param key=<json>`` overrides one of the cell's traffic parameters,
``--control`` also reads the control (the reference in fp8 in the
program's place) on the same inputs, and ``--fault <name>`` plants a fault
under the timed path (``state_unchanged``, ``half_batch``,
``token_altered``; each traffic kind takes those it can have).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import cell as cells  # noqa: E402
from harness import report  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             started: float, overrides: dict | None = None, control: bool = False,
             faults: dict | None = None):
    """(cell, outcome) of one run of cell ``name`` on ``device``.
    ``faults`` (tests only) breaks the timed path underneath."""
    c = cells.load(name, overrides=overrides)
    kind = importlib.import_module(f"traffic.{c.kind}")
    return c, kind.run(c, seed=seed, seconds=seconds, trace=trace, device=device,
                       started=started, control=control, faults=faults or {})


def main(argv=None) -> int:
    started = cells.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--param", action="append", default=[], metavar="KEY=JSON")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[])
    args = ap.parse_args(argv)
    params = {}
    for item in args.param:
        key, _, value = item.partition("=")
        params[key] = json.loads(value)
    cells.set_cache_dirs()
    c = cells.load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {c.chips} CUDA device(s); found {found}", file=sys.stderr)
        return 3
    c, outcome = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                          started, {"params": params}, args.control,
                          {name: True for name in args.fault})
    return report.finish(c, outcome, bool(args.trace), c.chips)


if __name__ == "__main__":
    sys.exit(main())
