#!/usr/bin/env python3
"""Times kernel B1 (csrc/glu_ff.cu, the fused GLU feed-forward) with parts
of its work taken out, on one GPU, to show which part binds it.

    python3 dev/torch_glu_ff_parts.py [--ms 160 640 2560]

Builds the checkout's kernel as it is ("full") and in copies with the bf16
gate, the tensor-core product, the W2 copies, the av copies or several of
them removed ("no_gate", "no_mma", "no_w_load", "no_av_load", "loads_only",
"compute_only", "skeleton": the loop's waits and barriers, the epilogue
and the launch).  The copies compute wrong results and are only timed.
Each runs at F = 1536, D = 384 with the tile and depth split that
ops/glu_ff.py plans for the card; one JSON line per part gives the mean
device time per launch (torch.profiler, 50 launches back to back).  The
first line names the card and its power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Lines of csrc/glu_ff.cu that each part removes.
GATE = ("    if (kt + 1 < nk) gate(kt + 1);\n", "  gate(0);\n")
MMA = ("    multiply(kt);\n",)
W_LOAD = ("      cp_async16(st + w_dst[i], w_src[i] + (size_t)k0 * d, w_ok[i]);\n",)
AV_LOAD = ("    for (int i = 0; i < T::A_CP; ++i) cp_async16(st + a_dst[i], a_src[i] + k0, "
           "a_ok[i]);\n",)
PARTS = {"full": (), "no_gate": GATE, "no_mma": MMA, "no_w_load": W_LOAD,
         "no_av_load": AV_LOAD, "loads_only": GATE + MMA, "compute_only": W_LOAD + AV_LOAD,
         "skeleton": GATE + MMA + W_LOAD + AV_LOAD}


def build(source: str, removed: tuple[str, ...], out_dir: str, name: str) -> str:
    from tone_tpu_torch.ops import _build

    for line in removed:
        if line not in source:
            raise RuntimeError(f"{name}: csrc/glu_ff.cu no longer has the line {line.strip()!r}")
        source = source.replace(line, "")
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write(source)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SOURCE_DIR), "-o", lib,
                    path], check=True, capture_output=True, text=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ms", nargs="+", type=int, default=[160, 640, 2560])
    a = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tone_tpu_torch.device import resolve_device
    from tone_tpu_torch.ops import _build
    from tone_tpu_torch.ops.glu_ff import plan_glu_ff

    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(json.dumps({"nvidia_smi": smi.stdout.strip()}), flush=True)
    source = (_build.SOURCE_DIR / "glu_ff.cu").read_text()
    f, d = 1536, 384
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(PARTS)) as pool:
        libs = dict(zip(PARTS, pool.map(lambda kv: build(source, kv[1], tmp, kv[0]),
                                        PARTS.items())))
        stream = torch.cuda.current_stream().cuda_stream
        cases = []
        for m in a.ms:
            gen = torch.Generator(device="cuda").manual_seed(m)
            av = torch.randn(m, 2 * f, device="cuda", generator=gen).to(torch.bfloat16)
            w = (torch.randn(f, d, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
            b = torch.randn(d, device="cuda", generator=gen) * 0.01
            cases.append((m, plan_glu_ff(m, f, d, sms), av, w, b,
                          torch.empty(m, d, dtype=torch.bfloat16, device="cuda")))
        for part, path in libs.items():
            fn = ctypes.CDLL(path).tone_glu_ff2
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            row = {"part": part}
            for m, plan, av, w, b, y in cases:
                def run():
                    err = fn(av.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, f, d,
                             int(plan.big), plan.split, stream)
                    if err:
                        raise RuntimeError(f"{part} M={m}: launch failed (cudaError {err})")

                for _ in range(5):
                    run()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(50):
                        run()
                    torch.cuda.synchronize()
                events = [e for e in prof.key_averages()
                          if e.device_type.name == "CUDA" and "glu_ff2" in e.key]
                row[f"m{m}_device_ms"] = (sum(e.self_device_time_total for e in events) / 1e3
                                          / max(1, sum(e.count for e in events)))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
