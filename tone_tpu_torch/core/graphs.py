"""CUDA graph capture shared by the device loops of the port's decoders
(``core/transducer.py GraphedLoop``, ``core/aed.py GraphedDecoder``): a
loop's steps captured once as one graph, which the host then replays with a
single launch where it would launch every kernel of every step."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["capture"]


def capture(steps: Callable[[], None], device) -> "torch.cuda.CUDAGraph":
    """``steps`` captured as a CUDA graph on ``device``, after one warm-up
    run on a side stream (which allocates the workspaces the capture then
    reuses).  The graph reads and writes the tensors ``steps`` closes over,
    at their addresses: the caller keeps them, and refills them in place
    before each replay."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        steps()                                  # workspaces allocated
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    return graph
