"""Layer device: the share of the traced window with no operation
running on the card (%)."""

from harness.readers import idle_share


def read(r):
    return idle_share(r)
