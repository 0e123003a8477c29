#!/usr/bin/env python3
"""Times the FastConformer's relative-position attention kernel
(``tone_tpu_torch/ops/rel_attention.py``, ``csrc/rel_attention.cu``) at the
shapes of the benchmark's Parakeet cell, on one GPU.

    python3 dev/torch_rel_attention_ab.py [--iters 20] [--batches 0 1 2 3]

The shapes are the cell's four batches: the 64 calls of
``benchmark/workloads/parakeet-ctc-1.1b.bulk-calls.json`` (the lengths of
``benchmark/traffic/bulk.py call_lengths``, doubled to 16 kHz as the cell's
traffic doubles them), sorted by length and cut in batches of 16, each row
at its own output frames; H 8, d_head 128.  Inputs are seeded random bf16
projections.  One JSON line per batch gives:

* ``ms``: the kernel's mean device time per launch (torch.profiler, back
  to back), ``event_ms`` the same by CUDA events;
* ``bound_ms``: the useful operations (6 T^2 d per row, d = H * d_head:
  the content score, the position score and the weight times V, 2 d each
  per valid pair) at 989 TFLOP/s, and ``bound_share`` = bound / ms; ``computed_tflops`` the
  multiply-adds the kernel runs (its padded tiles and position windows
  included), two operations each, over ``ms``;
* ``plain_ms``: the plain version (``layers.rel_attention_plain``, the
  blocked PyTorch attention the card ran before the kernel), CUDA events;
* ``library_ms``: as a yardstick, one ``scaled_dot_product_attention`` call
  on q + u, k and v with the position term and the key mask passed as a
  precomputed bf16 mask (its making not timed); the port never calls it;
* ``max_abs_diff``: kernel against the plain version over the valid rows,
  and ``max_share`` / ``rms_share``: the largest of the rows' max and RMS
  differences as a share of the card tests' limits (``within_limits``).

The first line names the card and its power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PEAK_BF16 = 989e12
N_HEADS, D_HEAD, BATCH = 8, 128, 16


def cell_batches() -> list[list[int]]:
    """The Parakeet cell's batches as output frames, longest batch first."""
    from tone_tpu_torch.config import FastConformerConfig

    sys.path.insert(0, str(ROOT / "benchmark"))
    from traffic.bulk import call_lengths

    work = json.loads((ROOT / "benchmark/workloads/parakeet-ctc-1.1b.bulk-calls.json")
                      .read_text())["params"]
    samples = sorted(int(n) * 2 for n in call_lengths(work))   # 8 -> 16 kHz
    cfg = FastConformerConfig()
    frames = [cfg.output_frames(n) for n in samples]
    batches = [frames[i:i + BATCH] for i in range(0, len(frames), BATCH)]
    return [sorted(b, reverse=True) for b in reversed(batches)]


def useful_flops(lengths, d: int) -> int:
    """The attention's useful operations over rows of ``lengths`` frames:
    6 d per valid query-key pair."""
    return 6 * d * sum(n * n for n in lengths)


def against_plain(kernel, plain, lengths) -> dict:
    """The kernel's context against the plain version's over each row's
    valid frames, as shares of the card tests' limits
    (tests/test_torch_fastconformer_gpu.py): the max difference against
    2^-6 of the larger of 1 and the row's largest value, the RMS difference
    against 2^-7 of the row's RMS; and whether the rows past each length
    are zero."""
    max_abs = max_share = rms_share = 0.0
    zero_tail = True
    for r, n in enumerate(lengths):
        a, b = kernel[r, :n].float(), plain[r, :n].float()
        diff = a - b
        largest = max(1.0, float(b.abs().max()))
        max_abs = max(max_abs, float(diff.abs().max()))
        max_share = max(max_share, float(diff.abs().max()) / (2.0 ** -6 * largest))
        rms_share = max(rms_share, float(diff.square().mean().sqrt())
                        / (2.0 ** -7 * float(b.square().mean().sqrt())))
        zero_tail = zero_tail and not bool(kernel[r, n:].any())
    return {"max_abs_diff": max_abs, "max_share": max_share, "rms_share": rms_share,
            "zero_tail": zero_tail,
            "within_limits": max_share <= 1.0 and rms_share <= 1.0 and zero_tail}


def cell_inputs(lengths, gen):
    """Seeded bf16 projections for rows of ``lengths`` frames, H 8, dh 128:
    q, k, v (B, T, D), pe (2T - 1, D) and the biases (H, dh) float32."""
    import torch

    b, t, d = len(lengths), max(lengths), N_HEADS * D_HEAD
    q, k, v = (torch.randn(b, t, d, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    pe = torch.randn(2 * t - 1, d, device="cuda", generator=gen).to(torch.bfloat16)
    bias_u, bias_v = (torch.randn(N_HEADS, D_HEAD, device="cuda", generator=gen) * 0.1
                      for _ in range(2))
    return q, k, v, pe, bias_u, bias_v


def device_ms(fn, iters: int, name: str) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and name in e.key]
    if not events:
        raise AssertionError(f"the profiler saw no device time for {name}")
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def event_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> dict:
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": out.stdout.strip(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def library_mask(q, pe, bias_v, lengths):
    """(B, H, T, T) bf16: the position term (q + v) . p_{i-j} / sqrt(dh) by
    direct indexing, -inf at keys past each row's length."""
    import torch

    b, t, d = q.shape
    qv = ((q.float().reshape(b, t, N_HEADS, D_HEAD) + bias_v) / math.sqrt(D_HEAD)).to(
        torch.bfloat16).transpose(1, 2)
    pos = pe.reshape(2 * t - 1, N_HEADS, D_HEAD).transpose(0, 1)            # (H, 2T-1, dh)
    i = torch.arange(t, device=q.device)
    idx = (t - 1) - (i[:, None] - i[None, :])
    mask = torch.empty(b, N_HEADS, t, t, dtype=torch.bfloat16, device=q.device)
    for r in range(b):
        raw = torch.matmul(qv[r], pos.transpose(-1, -2))                      # (H, T, 2T-1)
        mask[r] = raw.gather(2, idx[None].expand(N_HEADS, t, t))
    keys = torch.arange(t, device=q.device)[None] >= torch.tensor(lengths, device=q.device)[:, None]
    return mask.masked_fill_(keys[:, None, None], float("-inf"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batches", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--no-library", action="store_true")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from tone_tpu_torch.core import layers as L
    from tone_tpu_torch.ops import rel_attention as RA

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    print(json.dumps(card()), flush=True)
    batches = cell_batches()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.set_grad_enabled(False)
    for index in args.batches:
        lengths = batches[index]
        b, t, d = len(lengths), max(lengths), N_HEADS * D_HEAD
        q, k, v, pe, bias_u, bias_v = cell_inputs(lengths, gen)
        dev_lengths = torch.tensor(lengths, device="cuda")

        def kernel():
            return RA.rel_attention(q, k, v, pe, bias_u, bias_v, lengths, N_HEADS)

        def plain():
            return L.rel_attention_plain(q, k, v, pe, bias_u, bias_v, n_heads=N_HEADS,
                                         lengths=dev_lengths, host_lengths=lengths)

        check = against_plain(kernel(), plain(), lengths)
        ms = device_ms(kernel, args.iters, "rel_attention_kernel")
        useful = useful_flops(lengths, d)
        plan = RA.plan_rel_attention(lengths)
        computed = 2 * RA.kernel_macs(plan, N_HEADS, D_HEAD)
        row = {"batch": index, "rows": b, "longest": t, "frames": sum(lengths),
               "ms": ms, "event_ms": event_ms(kernel, args.iters),
               "bound_ms": useful / PEAK_BF16 * 1e3,
               "bound_share": useful / PEAK_BF16 * 1e3 / ms,
               "useful_tflops": useful / ms / 1e9, "computed_tflops": computed / ms / 1e9,
               "useful_pairs_share": sum(n * n for n in lengths) / plan.pairs,
               "plain_ms": event_ms(plain, max(2, args.iters // 5)), **check}
        if not args.no_library:
            mask = library_mask(q, pe, bias_v, lengths)
            qu = ((q.float().reshape(b, t, N_HEADS, D_HEAD) + bias_u) / math.sqrt(D_HEAD)).to(
                torch.bfloat16).transpose(1, 2)
            kh, vh = (x.reshape(b, t, N_HEADS, D_HEAD).transpose(1, 2) for x in (k, v))
            row["library_ms"] = event_ms(
                lambda: F.scaled_dot_product_attention(qu, kh, vh, attn_mask=mask, scale=1.0),
                args.iters)
            del mask
        print(json.dumps(row), flush=True)
        del q, k, v, pe
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
