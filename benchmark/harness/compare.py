"""The numbers that decide ``correct``, each read from what the timed path
produced against the plain reference (numpy only)."""

from __future__ import annotations

import numpy as np


def token_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """(frames, classes) logprobs of one stream from each side: the widest
    gap, over the frames, by which the class the program puts first lies
    below the reference's best, in the reference's logprobs.  Near-ties
    that rounding turns over read small; a class the reference rules out
    reads large."""
    ref = reference.astype(np.float64)
    first = program.argmax(-1)
    return float((ref.max(-1) - np.take_along_axis(ref, first[:, None], -1)[:, 0]).max())


class SquaredError:
    """The root mean square of the gap between two sides' logprobs, over
    every class of every compared frame: how far the program's numbers
    lie from the reference's, whether or not its best class changed
    (with random weights many frames are one class by a wide margin, and
    a lower precision leaves that class first)."""

    def __init__(self):
        self.total, self.count = 0.0, 0

    def add(self, program: np.ndarray, reference: np.ndarray) -> None:
        d = program.astype(np.float64) - reference.astype(np.float64)
        self.total += float(np.square(d).sum())
        self.count += d.size

    def rms(self) -> float | None:
        return (self.total / self.count) ** 0.5 if self.count else None


def leaf_gaps(program: dict, reference: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's (the gap of the norms, not the norm of the difference),
    against the larger of that leaf's reference norm and the median
    leaf's.  ``keep``: the leaves that count (all by default).  Returns
    (gap, the leaf)."""
    median = float(np.median(list(reference.values())))
    worst, where = 0.0, ""
    for path, ref in reference.items():
        if keep is not None and path not in keep:
            continue
        gap = abs(program[path] - ref) / max(ref, median, 1e-30)
        if gap >= worst:
            worst, where = gap, path
    return worst, where


def moved_leaves(first_grad: dict, share: float = 1e-3) -> set[str]:
    """Leaves whose first gradient in the reference is at least ``share``
    of the median leaf's: the others' gradients are round-off (a bias
    just before a training BatchNorm reads 1e-7 to 1e-5 of the median),
    and Adam moves them by its signs."""
    median = float(np.median(list(first_grad.values())))
    return {p for p, g in first_grad.items() if g >= share * median}
