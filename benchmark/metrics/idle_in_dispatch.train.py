"""Layer training: forward, loss, backward, optimizer dispatch
(training/train.py): the share of the traced window in which the card
was idle while the host dispatched a step's forward, loss, backward or
optimizer (%)."""

from harness.program_spans import idle_in


def read(r):
    return idle_in(r, ("train.forward", "train.loss", "train.backward", "train.optimizer"))
