"""Layer kernel (ops/glu_ff.py, csrc/glu_ff.cu): B1's share of its
roofline over the serving step's launches (%)."""

from harness.readers import b1_roofline


def read(r):
    return b1_roofline(r)
