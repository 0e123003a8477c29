"""Layer AED decoder: greedy decode with a KV cache (core/aed.py
greedy_aed): the share of the traced window in which the card was idle
while the host was in a batch's ``aed.prefill`` or ``aed.decode`` span:
how far the decode is bound by its launches and its checks (%)."""

from harness.program_spans import idle_in


def read(r):
    return idle_in(r, ("aed.prefill", "aed.decode"))
