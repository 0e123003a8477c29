"""Layer offline host: split and decode (offline.py _finish): the share of
the traced window in which the card was idle while the host split a batch
of the FastConformer's logprobs into phrases and decoded them (%)."""

from harness.program_spans import idle_in


def read(r):
    return idle_in(r, ("offline.split", "offline.decode", "offline.align"))
