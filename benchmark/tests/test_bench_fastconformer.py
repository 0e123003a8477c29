"""The ``parakeet-ctc-1.1b.bulk-calls`` cell: its manifest entries against
its files, the operation count by hand, its weights, what its reference
loads, and a whole run at a tiny width on the CPU past the harness's look
for a card: sound, it comes out correct; with the timed path broken
underneath (half of the batch left out, a token altered where it is
produced) ``correct`` comes out false under the cell's own limits."""

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
from harness.flops_fastconformer import call_flops  # noqa: E402
from reference import fastconformer as ref  # noqa: E402

CELL = "parakeet-ctc-1.1b.bulk-calls"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
MODEL = json.loads((BENCH / "configs" / "parakeet-ctc-1.1b.json").read_text())["model"]
METRICS = ("forward_mfu.fc_bulk", "attention_useful_share.fc_bulk", "idle_in_dispatch.fc_bulk",
           "device_idle_share.fc_bulk", "idle_in_launch.fc_bulk", "idle_in_finish.fc_bulk",
           "useful_share.fc_bulk")


def test_manifest_entries():
    config = next(c for c in MAN["configs"] if c["name"] == "parakeet-ctc-1.1b")
    assert config["reduced"] == []
    assert config["source"] == "https://huggingface.co/nvidia/parakeet-ctc-1.1b"
    cell = next(w for w in MAN["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "parakeet-ctc-1.1b"
    bulk = next(m for m in MAN["end_to_end"] if m["name"] == "bulk_audio_s_per_s")
    assert bulk["workloads"] == ["t-one-300ms.bulk-calls", CELL]
    for name in METRICS:
        m = next(m for m in MAN["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "bulk_audio_s_per_s"
    spec = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    assert spec["kind"] == "bulk_fastconformer"
    from tone_tpu_torch.config import FastConformerConfig
    from tone_tpu_torch.core.fastconformer import parameter_count

    assert FastConformerConfig.from_dict(MODEL) == FastConformerConfig()
    assert parameter_count(FastConformerConfig.from_dict(MODEL)) == 1_062_540_289


def test_operation_count_by_hand():
    """One 60 s call at 16 kHz at the published sizes: 6,001 feature frames,
    3,001 / 1,501 / 751 after each stride-2 convolution (40, 20, 10 mels)."""
    s = ref.sizes(MODEL)
    frontend = 6001 * (2 * 400 * 2 * 257 + 2 * 257 * 80)
    subsampling = (2 * 3001 * 40 * 256 * 9                       # conv 1 -> 256
                   + 2 * 1501 * 20 * 256 * 9 + 2 * 1501 * 20 * 256 * 256
                   + 2 * 751 * 10 * 256 * 9 + 2 * 751 * 10 * 256 * 256
                   + 2 * 751 * 2560 * 1024)                      # out
    frame = (2 * (2 * 1024 * 4096 * 2)                           # feed-forwards
             + 4 * 2 * 1024 * 1024                               # q, k, v, out
             + 2 * 1024 * 2048 + 2 * 1024 * 9 + 2 * 1024 * 1024)  # convolution module
    layer = 751 * frame + 2 * 1501 * 1024 * 1024 + 8 * 751 * 751 * 1024
    head = 2 * 751 * 1024 * 1025
    assert call_flops(s, 60 * 16000) == frontend + subsampling + 42 * layer + head
    assert call_flops(s, 60 * 16000) == 1_862_128_440_544


def test_weights_from_the_seed():
    from harness.weights_fastconformer import make_state_dict

    model = {**MODEL, "encoder": {**MODEL["encoder"], "n_layers": 1, "d_model": 32,
                                  "n_heads": 2, "subsampling_conv_channels": 8},
             "vocabulary": MODEL["vocabulary"][:16]}
    a, b = make_state_dict(model, 2**40 + 3, "cpu"), make_state_dict(model, 2**40 + 3, "cpu")
    layout = ref.param_layout(ref.sizes(model))
    assert list(a) == list(layout)
    for name, leaf in layout.items():
        assert tuple(a[name].shape) == leaf.shape and bool((a[name] == b[name]).all())
        centre = 1.0 if leaf.kind == "one" else 0.0
        assert float((a[name] - centre).abs().max()) <= leaf.scale
    assert not bool((make_state_dict(model, 7, "cpu")["decoder.decoder_layers.0.weight"]
                     == a["decoder.decoder_layers.0.weight"]).all())


def test_reference_loads_nothing_of_the_port():
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\nimport reference.fastconformer\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, check=True, cwd=str(ROOT))
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"tone_tpu_torch", "tone_tpu", "jax", "harness", "traffic"}


TINY = {"encoder": {"n_layers": 2, "d_model": 64, "n_heads": 2, "subsampling_conv_channels": 16},
        "vocabulary": MODEL["vocabulary"][:32]}
SMALL = {"job_calls": 8, "pool_seconds": 60, "sample_calls": 3,
         "transcriber": {"use_offline_forward": True, "batch_size": 4},
         "call_seconds": {"median": 8.0, "sigma": 0.8, "min": 2.0, "max": 30.0}}


@pytest.mark.parametrize("fault", [None, "half_batch", "token_altered"])
def test_correct_only_when_sound(fault):
    c, out = bench.run_cell(CELL, 2**31 + 99, 2.0, False, "cpu", time.monotonic(),
                            {"model": TINY, "params": SMALL},
                            faults={fault: True} if fault else None)
    correct, table = report.judge(out.compared, c.limits)
    assert correct == (fault is None), table
    assert out.attempted > 0 and out.end_to_end["bulk_audio_s_per_s"] > 0


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
