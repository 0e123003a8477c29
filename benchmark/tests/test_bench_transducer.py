"""The ``parakeet-tdt-0.6b-v3.bulk-calls`` cell: its manifest entries
against its files, its weights, what its reference loads, its three
readers on a recorded session, and whole runs at a tiny width on the CPU
past the harness's look for a card: sound, it comes out correct; with the
timed path broken underneath (half of a batch given the other half's
records, a token altered where the loop produced it) ``correct`` comes out
false under the cell's own limits.  On the card (marker ``gpu``) the cell
at the published widths on short jobs passes, and its fp8 control fails."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run as bench  # noqa: E402
from harness import cell as cells  # noqa: E402
from harness import report  # noqa: E402
from harness import trace as htrace  # noqa: E402
from reference import transducer as ref  # noqa: E402

CELL = "parakeet-tdt-0.6b-v3.bulk-calls"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
MODEL = json.loads((BENCH / "configs" / "parakeet-tdt-0.6b-v3.json").read_text())["model"]
METRICS = ("decode_share.tdt_bulk", "idle_in_decode.tdt_bulk", "decode_useful_share.tdt_bulk")


def test_manifest_entries():
    config = next(c for c in MAN["configs"] if c["name"] == "parakeet-tdt-0.6b-v3")
    assert config["reduced"] == []
    assert config["source"] == "https://huggingface.co/nvidia/parakeet-tdt-0.6b-v3"
    cell = next(w for w in MAN["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "parakeet-tdt-0.6b-v3"
    bulk = next(m for m in MAN["end_to_end"] if m["name"] == "bulk_audio_s_per_s")
    assert bulk["workloads"][-1] == CELL
    for name in METRICS:
        m = next(m for m in MAN["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "bulk_audio_s_per_s"
    c = cells.load(CELL)
    assert c.kind == "bulk_transducer" and c.chips == 1
    assert [m["name"] for m in c.end_to_end] == ["bulk_audio_s_per_s", "setup_s"]
    assert [m["name"] for m in c.per_layer] == list(METRICS)
    from tone_tpu_torch.config import FastConformerConfig, parakeet_tdt_config
    from tone_tpu_torch.core.fastconformer import parameter_count

    assert FastConformerConfig.from_dict(MODEL) == parakeet_tdt_config()
    assert parameter_count(parakeet_tdt_config()) == ref.parameter_count(ref.sizes(MODEL)) \
        == 627_450_502


def test_weights_from_the_seed():
    from harness.weights_transducer import ADVANCE, EMBED, JOINT_BIAS, RAISE, make_state_dict

    model = {**MODEL, "encoder": {**MODEL["encoder"], "n_layers": 1, "d_model": 32,
                                  "n_heads": 2, "subsampling_conv_channels": 8},
             "vocabulary": MODEL["vocabulary"][:16],
             "transducer": {**MODEL["transducer"], "pred_hidden": 16, "joint_hidden": 16}}
    a, b = make_state_dict(model, 2**40 + 3, "cpu"), make_state_dict(model, 2**40 + 3, "cpu")
    s = ref.sizes(model)
    layout = ref.param_layout(s)
    assert list(a) == list(layout) and "decoder.decoder_layers.0.weight" not in a
    # every step's duration: the bias of ADVANCE frames raised by RAISE
    raised = s.blank + 1 + s.durations.index(ADVANCE)
    assert float(a[JOINT_BIAS][raised]) >= RAISE - layout[JOINT_BIAS].scale
    a[JOINT_BIAS][raised] -= RAISE
    b[JOINT_BIAS][raised] -= RAISE
    for name, leaf in layout.items():
        assert tuple(a[name].shape) == leaf.shape and bool((a[name] == b[name]).all())
        centre = 1.0 if leaf.kind == "one" else 0.0
        assert float((a[name] - centre).abs().max()) <= leaf.scale
    assert float(a[EMBED][-1].abs().max()) == 0.0 and float(a[EMBED][:-1].abs().max()) > 0.5
    assert not bool((make_state_dict(model, 7, "cpu")["joint.joint_net.2.weight"]
                     == a["joint.joint_net.2.weight"]).all())


def test_reference_loads_nothing_of_the_port():
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\nimport reference.transducer\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, check=True, cwd=str(ROOT))
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"tone_tpu_torch", "tone_tpu", "jax", "harness", "traffic"}


TINY = {"frontend": {"n_mels": 32},
        "encoder": {"feat_in": 32, "n_layers": 2, "d_model": 64, "n_heads": 2,
                    "subsampling_conv_channels": 16},
        "vocabulary": MODEL["vocabulary"][:40],
        "transducer": {"pred_hidden": 32, "joint_hidden": 32}}
SMALL = {"job_calls": 8, "pool_seconds": 60, "sample_calls": 3,
         "transcriber": {"use_offline_forward": True, "batch_size": 4},
         "call_seconds": {"median": 8.0, "sigma": 0.8, "min": 2.0, "max": 30.0}}


@pytest.mark.parametrize("fault", [None, "half_batch", "token_altered"])
def test_correct_only_when_sound(fault):
    c, out = bench.run_cell(CELL, 2**31 + 99, 2.0, False, "cpu", time.monotonic(),
                            {"model": TINY, "params": SMALL}, control=fault is None,
                            faults={fault: True} if fault else None)
    correct, table = report.judge(out.compared, c.limits)
    assert correct == (fault is None), table
    assert out.attempted > 0 and out.end_to_end["bulk_audio_s_per_s"] > 0
    assert out.notes["steps_compared"] > out.notes["calls_compared"] == 3
    if fault is None:
        # the control, the reference in fp8 in the program's place, fails
        control = out.notes["control"]
        assert not report.judge(control, {k: c.limits[k] for k in control})[0], control


def test_readers_on_a_recorded_session():
    """The three readers over the program's spans and counts of two decodes
    recorded with ``profiling.record()``, against a device trace of one
    operation inside the first decode."""
    from tone_tpu_torch import profiling
    from tone_tpu_torch.config import FastConformerConfig
    from tone_tpu_torch.core import transducer as TD
    from tone_tpu_torch.core.fastconformer import init_fastconformer_params

    cfg = FastConformerConfig.from_dict({**MODEL, **TINY, "encoder": {**MODEL["encoder"],
                                                                      **TINY["encoder"]},
                                         "frontend": {**MODEL["frontend"], **TINY["frontend"]},
                                         "transducer": {**MODEL["transducer"],
                                                        **TINY["transducer"]}})
    v = init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    enc = torch.randn(3, 50, 64, generator=torch.Generator().manual_seed(1))
    t0 = time.monotonic_ns()
    with profiling.record():
        TD.greedy_tdt(v, cfg, enc, [50, 20, 7])
        TD.greedy_tdt(v, cfg, enc[:1], [31])
    t1 = time.monotonic_ns()
    spans = [e for e in profiling.events(t0, t1) if e.name == "transducer.decode"]
    counts: dict = {}
    for e in profiling.events(t0, t1):
        if hasattr(e, "t_ns") and e.name.startswith("transducer."):
            counts[e.name] = counts.get(e.name, 0) + e.n
    assert len(spans) == 2
    dtrace = htrace.DeviceTrace()
    dtrace.t0, dtrace.t1 = t0, t1
    a, b = spans[0].start_ns, spans[0].end_ns
    dtrace._ops = [htrace.Op("kernel", a, (b - a) // 2)]
    reading = htrace.Reading(cell=cells.load(CELL), sizes=ref.sizes(MODEL), peaks=None,
                             trace=dtrace)
    values = {m: htrace.read_metric(m, reading) for m in METRICS}
    in_decode = sum(e.end_ns - e.start_ns for e in spans)
    assert values["decode_share.tdt_bulk"] == pytest.approx(100.0 * in_decode / (t1 - t0))
    idle = in_decode - (b - a) // 2
    assert values["idle_in_decode.tdt_bulk"] == pytest.approx(100.0 * idle / (t1 - t0))
    assert values["decode_useful_share.tdt_bulk"] == pytest.approx(
        100.0 * counts["transducer.row_steps"] / counts["transducer.steps_computed"])
    assert 0 < values["decode_useful_share.tdt_bulk"] < 100
    # a program that records nothing gives the readers nothing to read
    dtrace.t0, dtrace.t1 = t1 + 1, t1 + 10**6
    assert all(htrace.read_metric(m, reading) is None for m in METRICS)


# On the card, at the published widths and a job a test run holds: sound,
# the run keeps within the cell's limits; the control (the plain reference
# computed in fp8 in the program's place on the same inputs) and each fault
# fail at least one of them.
CARD = {"job_calls": 8, "sample_calls": 3,
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
@pytest.mark.parametrize("fault", ["half_batch", "token_altered"])
def test_faults_fail_on_card(cuda, fault):
    c, out = bench.run_cell(CELL, 2**31 + 5, 2.0, False, cuda, time.monotonic(),
                            {"params": CARD}, faults={fault: True})
    correct, table = report.judge(out.compared, c.limits)
    assert not correct, table
