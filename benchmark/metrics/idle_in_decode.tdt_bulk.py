"""Layer transducer: greedy TDT loop (core/transducer.py greedy_tdt): the
share of the traced window in which the card was idle while the host was
in a batch's ``transducer.decode`` span: how far the loop is bound by its
launches and its checks (%)."""

from harness.program_spans import idle_in


def read(r):
    return idle_in(r, ("transducer.decode",))
