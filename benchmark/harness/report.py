"""A run's outcome and its printing: earlier lines of notes, each number
compared beside its limit on standard error, and the result as the last
line of standard output."""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field

from harness import cell as cells


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict                 # metric name -> value
    compared: dict                   # number name -> value (held to the cell's limits)
    memory_peak_bytes: int
    device_kind: str
    per_layer: dict = field(default_factory=dict)   # metric name -> value (traced runs)
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
    notes: dict = field(default_factory=dict)       # printed on an earlier line


def judge(compared: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number passes at or under it); a
    number that is missing, or not finite, fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = compared.get(name)
        passed = value is not None and math.isfinite(value) and value <= limit
        ok &= passed
        table[name] = {"value": value, "limit": limit}
    return ok, table


def finish(c: cells.Cell, out: Outcome, trace: bool, chips: int) -> int:
    """Print the run's result; returns the exit code (not 0, and no
    result, where a forbidden module was loaded)."""
    bad = cells.forbidden_loaded(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    if out.notes:
        print(json.dumps({"notes": out.notes}), flush=True)
    correct, table = judge(out.compared, c.limits)
    wanted = c.per_layer if trace else c.end_to_end
    values = out.per_layer if trace else out.end_to_end
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values.get(m["name"]) is not None}
    device = {"platform": "gpu", "kind": out.device_kind, "count": chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if trace:
        device.update(busy_s=out.busy_s, window_s=out.window_s)
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if trace and out.breakdown:
        result["breakdown"] = out.breakdown
    result["compared"] = table
    for name, row in table.items():
        print(f"compared {name} {row['value']} limit {row['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
