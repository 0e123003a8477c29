"""Layer offline host: batch assembly and dispatch (offline.py _launch):
the share of the traced window in which the card was idle while the host
padded, pinned and queued a batch or dispatched its forward (%)."""

from harness.program_spans import idle_in


def read(r):
    return idle_in(r, ("offline.assemble", "offline.forward"))
