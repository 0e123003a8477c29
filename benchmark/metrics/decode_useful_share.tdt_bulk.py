"""Layer transducer: greedy TDT loop (core/transducer.py greedy_tdt): the
lockstep's useful share, the steps at which a row was still decoding
(Σ ``transducer.row_steps``) over the rows times the steps the loop ran
(Σ ``transducer.steps_computed``) (%)."""

from harness.program_spans import useful_share


def read(r):
    return useful_share(r, "transducer.row_steps", "transducer.steps_computed")
