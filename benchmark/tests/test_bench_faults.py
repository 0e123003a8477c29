"""A whole run of each cell at a tiny width on the CPU, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath (a step that returns its state unchanged, half of the batch
left out, a token altered where it is produced), ``correct`` comes out
false under the cell's own limits.  The cells run on one card, so there
is no exchange between cards to leave out."""

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run as bench  # noqa: E402
from harness import report  # noqa: E402

TINY = {"encoder": {"d_model": 64, "n_heads": 2}}
SMALL = {
    "t-one-300ms.voicebot-1024": {"slots": 16, "concurrency": 6, "client_processes": 1,
                                  "sample_slots": 6, "pool_seconds": 40, "tail_seconds": 10},
    "t-one-300ms.bulk-calls": {"job_calls": 8, "pool_seconds": 60, "sample_calls": 3,
                               "transcriber": {"use_offline_forward": True, "batch_size": 4},
                               "call_seconds": {"median": 8.0, "sigma": 0.8, "min": 2.0,
                                                "max": 30.0}},
    "t-one-300ms.finetune": {"batch": 4, "batches": 4, "pool_seconds": 30,
                             "utterance_seconds": {"median": 3.0, "sigma": 0.3, "min": 2.0,
                                                   "max": 4.0}},
}
SECONDS = {"t-one-300ms.voicebot-1024": 8.0, "t-one-300ms.bulk-calls": 2.0,
           "t-one-300ms.finetune": 2.0}
CASES = [
    ("t-one-300ms.voicebot-1024", None), ("t-one-300ms.voicebot-1024", "state_unchanged"),
    ("t-one-300ms.voicebot-1024", "half_batch"), ("t-one-300ms.voicebot-1024", "token_altered"),
    ("t-one-300ms.bulk-calls", None), ("t-one-300ms.bulk-calls", "half_batch"),
    ("t-one-300ms.bulk-calls", "token_altered"),
    ("t-one-300ms.finetune", None), ("t-one-300ms.finetune", "state_unchanged"),
    ("t-one-300ms.finetune", "half_batch"),
]


@pytest.mark.parametrize("cell, fault", CASES)
def test_correct_only_when_sound(cell, fault):
    c, out = bench.run_cell(cell, 2**31 + 99, SECONDS[cell], False, "cpu", time.monotonic(),
                            {"model": TINY, "params": SMALL[cell]},
                            faults={fault: True} if fault else None)
    correct, table = report.judge(out.compared, c.limits)
    assert correct == (fault is None), table
    assert out.attempted > 0
