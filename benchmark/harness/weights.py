"""The model's weights from the run's seed, made on the device in one call.

One ``torch.rand`` of every parameter's and statistic's elements from a
generator on the device, cut into the leaves of the published layout
(``reference.model.param_layout``) and scaled there: weights uniform in
±1/sqrt(fan-in), norm scales and running variances about 1, shifts and
running means about 0.  Float32, the published checkpoint's type; the
program casts what it serves in bf16 itself.  Both the program and the
reference are handed this one tree.
"""

from __future__ import annotations

import math

import torch

from reference.model import Leaf, param_layout, sizes, tree_items


def make_variables(model: dict, seed: int, device) -> dict:
    layout = param_layout(sizes(model))
    leaves = [leaf for _, leaf in tree_items(layout)]
    total = sum(math.prod(leaf.shape) for leaf in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    tensors, at = [], 0
    for leaf in leaves:
        n = math.prod(leaf.shape)
        x = flat[at:at + n].view(leaf.shape)
        at += n
        if leaf.kind == "uniform" or leaf.kind == "zero":
            x.mul_(leaf.scale)
        else:
            x.mul_(leaf.scale).add_(1.0)
        tensors.append(x)
    it = iter(tensors)

    def build(t):
        if isinstance(t, Leaf):
            return next(it)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return type(t)(build(v) for v in t)
    return build(layout)
