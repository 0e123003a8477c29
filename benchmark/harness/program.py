"""What every traffic kind does around the program: its configuration, the
card's name and peak memory, and the traced sub-window's readings."""

from __future__ import annotations

import gc

import torch

from harness import flops, trace
from reference.model import sizes


def tone_config(model: dict):
    from tone_tpu_torch.config import ToneConfig

    return ToneConfig.from_dict(model)


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def start_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def release(device: torch.device) -> None:
    """Return what the program held, before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def per_layer(c, device: torch.device, dtrace, spans: dict, counters: dict, default_label: str):
    """(metrics, busy_s, window_s, breakdown) of a traced run: each
    per-layer metric of the cell read from the trace, the harness's spans
    and counters; metrics that find nothing to read are left out."""
    reading = trace.Reading(cell=c, sizes=sizes(c.model), peaks=flops.peak(device_kind(device)),
                            trace=dtrace, spans=spans, counters=counters)
    values = {}
    for m in c.per_layer:
        value = trace.read_metric(m["name"], reading)
        if value is not None:
            values[m["name"]] = value
    busy = dtrace.busy_ns() / 1e9
    return (values, busy, dtrace.window_s,
            trace.breakdown(reading, trace.span_label(spans, default_label)))


def clip_spans(spans: dict, t0: int, t1: int) -> dict:
    """The spans that lie inside [t0, t1]."""
    return {k: [(a, b) for a, b in v if a >= t0 and b <= t1] for k, v in spans.items()}
