"""Layer FastConformer forward (core/fastconformer.py apply_fastconformer):
the share of the traced window in which the card was idle while the host
dispatched the forward's frontend, subsampling, layers or head (%)."""

from harness.program_spans import idle_in


def read(r):
    return idle_in(r, ("fastconformer.frontend", "fastconformer.subsampling",
                       "fastconformer.layer", "fastconformer.head"))
