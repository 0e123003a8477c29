"""Layer training: batch upload (training/train.py _batch): the share of
the traced window in which the card was idle while the host converted
and uploaded a batch (%)."""

from harness.program_spans import idle_in


def read(r):
    return idle_in(r, ("train.batch",))
