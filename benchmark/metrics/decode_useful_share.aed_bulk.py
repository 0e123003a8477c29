"""Layer AED decoder: greedy decode with a KV cache (core/aed.py
greedy_aed): the lockstep's useful share, the steps at which a row was
still live (Σ ``aed.row_steps``) over the batches' rows times the steps
the loop ran (Σ ``aed.steps_computed``) (%)."""

from harness.program_spans import useful_share


def read(r):
    return useful_share(r, "aed.row_steps", "aed.steps_computed")
