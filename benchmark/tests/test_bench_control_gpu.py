"""The control of each cell on the card, at the published widths and a
size a test run holds: a whole run of the harness (fewer slots, calls and
rows than the cell's), on three seeds.  The program's numbers keep within
the cell's limits; the control, the plain reference computed in fp8 in
the program's place on the same inputs, fails at least one of them.

    python -m pytest --noconftest -p no:cacheprovider -m gpu benchmark/tests/test_bench_control_gpu.py
"""

import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run as bench  # noqa: E402
from harness import cell as cells  # noqa: E402
from harness import report  # noqa: E402

pytestmark = pytest.mark.gpu

SMALL = {
    "t-one-300ms.voicebot-1024": ({"slots": 64, "concurrency": 24, "client_processes": 1,
                                   "sample_slots": 8, "tail_seconds": 20}, 6.0),
    "t-one-400ms.voicebot-1024": ({"slots": 64, "concurrency": 24, "client_processes": 1,
                                   "sample_slots": 8, "tail_seconds": 20}, 6.0),
    "t-one-300ms.bulk-calls": ({"job_calls": 8, "sample_calls": 3,
                                "call_seconds": {"median": 20.0, "sigma": 0.8, "min": 5.0,
                                                 "max": 120.0}}, 2.0),
    "t-one-300ms.finetune": ({"batch": 4, "batches": 4}, 2.0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none here)")
    cells.set_cache_dirs()
    return "cuda"


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_passes_and_control_fails(cuda, cell, seed):
    params, seconds = SMALL[cell]
    c, out = bench.run_cell(cell, seed, seconds, False, cuda, time.monotonic(),
                            {"params": params}, control=True)
    ok, table = report.judge(out.compared, c.limits)
    assert ok, table
    control = out.notes["control"]
    control_ok, control_table = report.judge(control, {k: c.limits[k] for k in control})
    assert not control_ok, control_table
