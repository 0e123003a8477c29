"""The ``canary-1b-v2.bulk-calls`` cell: its manifest entries against its
files (membership checks, so that later cells and metrics leave them
true), its weights, what its reference loads, its four readers on a
recorded session, the program's byte count against the harness's, and
whole runs at a tiny width on the CPU past the harness's look for a card:
sound, it comes out correct; with a token altered where the loop produced
it, ``correct`` comes out false under the cell's own limits.  On the card
(marker ``gpu``) the cell at the published widths on short jobs passes,
its fp8 control fails, and so do its faults."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run as bench  # noqa: E402
from harness import bytes_aed  # noqa: E402
from harness import cell as cells  # noqa: E402
from harness import report  # noqa: E402
from harness import trace as htrace  # noqa: E402
from reference import aed as ref  # noqa: E402

CELL = "canary-1b-v2.bulk-calls"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
MODEL = json.loads((BENCH / "configs" / "canary-1b-v2.json").read_text())["model"]
METRICS = ("decode_share.aed_bulk", "idle_in_decode.aed_bulk", "decode_useful_share.aed_bulk",
           "decode_bandwidth_share.aed_bulk")


def test_manifest_entries():
    config = next(c for c in MAN["configs"] if c["name"] == "canary-1b-v2")
    assert config["reduced"] == []
    assert config["source"] == "https://huggingface.co/nvidia/canary-1b-v2"
    cell = next(w for w in MAN["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "canary-1b-v2"
    bulk = next(m for m in MAN["end_to_end"] if m["name"] == "bulk_audio_s_per_s")
    assert CELL in bulk["workloads"]
    for name in METRICS:
        m = next(m for m in MAN["per_layer"] if m["name"] == name)
        assert CELL in m["workloads"] and m["moves"] == "bulk_audio_s_per_s"
    c = cells.load(CELL)
    assert c.kind == "bulk_aed" and c.chips == 1
    assert {"bulk_audio_s_per_s", "setup_s"} <= {m["name"] for m in c.end_to_end}
    assert set(METRICS) <= {m["name"] for m in c.per_layer}
    from tone_tpu_torch.config import FastConformerConfig, canary_config
    from tone_tpu_torch.core.fastconformer import parameter_count

    assert FastConformerConfig.from_dict(MODEL) == canary_config()
    assert parameter_count(canary_config()) == ref.parameter_count(ref.sizes(MODEL)) \
        == 978_932_736


TINY = {"frontend": {"n_mels": 32},
        "encoder": {"feat_in": 32, "n_layers": 2, "d_model": 64, "n_heads": 2,
                    "subsampling_conv_channels": 16},
        "vocabulary": MODEL["vocabulary"][:64],
        "aed": {"n_layers": 2, "hidden": 64, "inner": 128, "n_heads": 2, "window_seconds": 6.0}}
SMALL = {"job_calls": 8, "pool_seconds": 60, "sample_windows": 3,
         "transcriber": {"use_offline_forward": True, "batch_size": 4},
         "call_seconds": {"median": 8.0, "sigma": 0.8, "min": 2.0, "max": 30.0}}


def _tiny_model() -> dict:
    return {**MODEL, **TINY, "frontend": {**MODEL["frontend"], **TINY["frontend"]},
            "encoder": {**MODEL["encoder"], **TINY["encoder"]},
            "aed": {**MODEL["aed"], **TINY["aed"]}}


def test_weights_from_the_seed():
    from harness.weights_aed import CROSS_GAIN, CROSS_OUT, make_state_dict

    model = _tiny_model()
    a, b = make_state_dict(model, 2**40 + 3, "cpu"), make_state_dict(model, 2**40 + 3, "cpu")
    layout = ref.param_layout(ref.sizes(model))
    assert list(a) == list(layout) and "decoder.decoder_layers.0.weight" not in a
    for name, leaf in layout.items():
        assert tuple(a[name].shape) == leaf.shape and bool((a[name] == b[name]).all())
        centre = 1.0 if leaf.kind == "one" else 0.0
        gain = CROSS_GAIN if name.endswith(CROSS_OUT) else 1.0
        assert float((a[name] - centre).abs().max()) <= gain * leaf.scale
        if gain != 1.0:    # every layer's cross-attention output, raised
            assert float(a[name].abs().max()) > leaf.scale
    assert not bool((make_state_dict(model, 7, "cpu")["log_softmax.mlp.layer0.weight"]
                     == a["log_softmax.mlp.layer0.weight"]).all())


def test_reference_loads_nothing_of_the_port():
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\nimport reference.aed\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, check=True, cwd=str(ROOT))
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"tone_tpu_torch", "tone_tpu", "jax", "harness", "traffic"}


@pytest.mark.parametrize("fault", [None, "token_altered", "cross_rows"])
def test_correct_only_when_sound(fault):
    c, out = bench.run_cell(CELL, 2**31 + 99, 2.0, False, "cpu", time.monotonic(),
                            {"model": TINY, "params": SMALL}, control=fault is None,
                            faults={fault: True} if fault else None)
    correct, table = report.judge(out.compared, c.limits)
    assert correct == (fault is None), table
    assert out.attempted > 0 and out.end_to_end["bulk_audio_s_per_s"] > 0
    assert out.notes["steps_compared"] > out.notes["windows_compared"] == 3
    if fault is None:
        # the control, the reference in fp8 in the program's place, fails
        control = out.notes["control"]
        assert not report.judge(control, {k: c.limits[k] for k in control})[0], control


def test_program_counts_the_harness_bytes():
    from tone_tpu_torch.config import canary_config
    from tone_tpu_torch.core import aed

    rng = np.random.default_rng(1)
    live = rng.random((16, 48)) < 0.7
    live[:, 40:] = False
    frames = rng.integers(1, 502, 16).tolist()
    s = ref.sizes(MODEL)
    assert aed.step_bytes(canary_config(), live, frames) == bytes_aed.step_bytes(s, 2, live,
                                                                                  frames)
    # weights of the step: the decoder's layers read once, about 269 MB at bf16
    assert bytes_aed.weight_bytes(s, 2) == pytest.approx(269e6, rel=0.01)


def test_readers_on_a_recorded_session():
    """The four readers over the program's spans and counts of two decodes
    recorded with ``profiling.record()``, against a device trace of one
    operation inside the first decode."""
    from tone_tpu_torch import profiling
    from tone_tpu_torch.config import FastConformerConfig
    from tone_tpu_torch.core import aed
    from tone_tpu_torch.core.fastconformer import init_fastconformer_params

    cfg = FastConformerConfig.from_dict(_tiny_model())
    v = init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    enc = torch.randn(3, 50, 64, generator=torch.Generator().manual_seed(1))
    t0 = time.monotonic_ns()
    with profiling.record():
        for rows, frames, caps in ((3, [50, 20, 7], [20, 9, 3]), (1, [31], [12])):
            record, _, _ = aed.greedy_aed(v, cfg, enc[:rows], frames, caps)
            aed.count_steps(cfg, record.numpy(), frames, rows)
    t1 = time.monotonic_ns()
    events = profiling.events(t0, t1)
    spans = [e for e in events if hasattr(e, "end_ns") and e.name.startswith("aed.")]
    counts: dict = {}
    for e in events:
        if hasattr(e, "t_ns") and e.name.startswith("aed."):
            counts[e.name] = counts.get(e.name, 0) + e.n
    assert [e.name for e in spans] == ["aed.prefill", "aed.decode"] * 2
    decode = [e for e in spans if e.name == "aed.decode"]
    dtrace = htrace.DeviceTrace()
    dtrace.t0, dtrace.t1 = t0, t1
    a, b = decode[0].start_ns, decode[0].end_ns
    dtrace._ops = [htrace.Op("kernel", a, (b - a) // 2)]
    peaks = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    reading = htrace.Reading(cell=cells.load(CELL), sizes=ref.sizes(MODEL), peaks=peaks,
                             trace=dtrace)
    values = {m: htrace.read_metric(m, reading) for m in METRICS}
    inside = sum(e.end_ns - e.start_ns for e in spans)
    assert values["decode_share.aed_bulk"] == pytest.approx(100.0 * inside / (t1 - t0))
    assert values["idle_in_decode.aed_bulk"] == pytest.approx(
        100.0 * (inside - (b - a) // 2) / (t1 - t0))
    assert values["decode_useful_share.aed_bulk"] == pytest.approx(
        100.0 * counts["aed.row_steps"] / counts["aed.steps_computed"])
    assert 0 < values["decode_useful_share.aed_bulk"] < 100
    wall = sum(e.end_ns - e.start_ns for e in decode) / 1e9
    assert values["decode_bandwidth_share.aed_bulk"] == pytest.approx(
        100.0 * counts["aed.step_bytes"] / 3.35e12 / wall)
    # a program that records nothing gives the readers nothing to read
    dtrace.t0, dtrace.t1 = t1 + 1, t1 + 10**6
    assert all(htrace.read_metric(m, reading) is None for m in METRICS)


# On the card, at the published widths and a job a test run holds: sound,
# the run keeps within the cell's limits; the control (the plain reference
# computed in fp8 in the program's place on the same inputs) and each fault
# fail at least one of them.
CARD = {"job_calls": 8, "sample_windows": 3,
        "call_seconds": {"median": 20.0, "sigma": 0.8, "min": 5.0, "max": 120.0}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none here)")
    cells.set_cache_dirs()
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_program_passes_and_control_fails_on_card(cuda, seed):
    c, out = bench.run_cell(CELL, seed, 2.0, False, cuda, time.monotonic(), {"params": CARD},
                            control=True)
    ok, table = report.judge(out.compared, c.limits)
    assert ok, table
    control = out.notes["control"]
    control_ok, control_table = report.judge(control, {k: c.limits[k] for k in control})
    assert not control_ok, control_table


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["token_altered", "cross_rows"])
def test_faults_fail_on_card(cuda, fault):
    c, out = bench.run_cell(CELL, 2**31 + 5, 2.0, False, cuda, time.monotonic(),
                            {"params": CARD}, faults={fault: True})
    correct, table = report.judge(out.compared, c.limits)
    assert not correct, table
