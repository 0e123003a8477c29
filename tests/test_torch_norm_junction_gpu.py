"""The FastConformer's residual-and-norm junction kernel on the card
(marker ``gpu``; skips without a CUDA device): ``ops/norm_junction.py`` and
``csrc/norm_junction.cu`` held to their plain version (the eager
composition, ``norm_junction_plain`` and ``layers.layernorm``) at d_model
1,024 on the Parakeet cell's four batches (16 rows of 3,550, 1,142, 763 and
491 frames) and at two tiny widths, in all four forms; then the tiny CTC
and TDT forwards through it.  Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_norm_junction_gpu.py

Limits, each with its reason:

* x' (the single form's first output) bit-equal: the kernel rounds the
  bias sum, the scale and the residual add as the eager passes do, one
  float32 operation at a time (no fused multiply-add).
* each normed element within one bf16 ulp of the plain version's on the
  same input, or within 2^-20 of the row's RMS.  The two take the mean and
  the variance in float32 in other orders of summation (a few float32 ulps
  apart); after the shared scale, shift and rounding that turns a value's
  bf16 rounding over (one ulp) about once in 200,000 elements, and moves a
  value near zero, whose ulp is tiny, by a few float32 ulps of the row's
  scale: at most 5.9e-8 (about 2^-24) of the row's RMS on the cell's
  batches, so the floor keeps a factor of 16.  The share of elements one ulp off is
  in PERF.md (``chip_smoke.py norm_junction``).  The second norm of the
  double form is held to the plain norm of the kernel's own first output.
* the tiny forwards: the card tests' limits, the CTC logprobs against the
  float32 reference 0.03 at most and 0.008 RMS
  (``test_torch_fastconformer_gpu.py``), the TDT loop's record by the
  benchmark cell's limits (``test_torch_transducer_gpu.py``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tone_tpu_torch.bridge import to_device
from tone_tpu_torch.checkpoint import convert_fastconformer_state_dict
from tone_tpu_torch.config import (
    FastConformerConfig,
    FastConformerEncoderConfig,
    stand_in_vocabulary,
)
from tone_tpu_torch.core import transducer as TD
from tone_tpu_torch.offline import OfflineTranscriber
from tone_tpu_torch.ops import norm_junction as NJ

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path, package: bool = False):
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=[str(path.parent)] if package else None)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module     # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


AB = _load("torch_norm_junction_ab", ROOT / "dev/torch_norm_junction_ab.py")

pytestmark = pytest.mark.gpu

FORMS = ("single", "double", "last", "norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(form: str, inputs: dict) -> dict:
    launches = NJ.norm_junction.launches
    with torch.no_grad():
        out = AB.against_plain(form, inputs)
    torch.cuda.synchronize()
    assert NJ.norm_junction.launches - launches == 1
    return out


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("batch", [0, 1, 2, 3])
def test_kernel_against_plain_at_the_cells_batches(cuda, batch, form):
    lengths = AB.cell_batches()[batch]
    gen = torch.Generator(device=cuda).manual_seed(batch)
    inputs = AB.junction_inputs(len(lengths), max(lengths), AB.D_MODEL, gen)
    out = _check(form, inputs)
    assert out["within_limits"], out
    assert out.get("x_bit_equal", True)


# (d_model, rows, frames, y's frames, scale): the attention's product covers
# the longest call's frames only, fewer than the padded batch's.
TINY = {"d64": (64, 5, 37, 37, 0.5), "d200": (200, 3, 29, 29, 0.5),
        "d64_short_y": (64, 4, 40, 33, 1.0), "d200_short_y": (200, 2, 17, 9, 1.0)}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", TINY)
def test_kernel_against_plain_at_tiny_widths(cuda, case, form):
    d, rows, frames, y_frames, scale = TINY[case]
    gen = torch.Generator(device=cuda).manual_seed(d + frames)
    inputs = {**AB.junction_inputs(rows, frames, d, gen, y_frames), "scale": scale}
    out = _check(form, inputs)
    assert out["within_limits"], out


def test_kernel_repeats_to_the_bit(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    inputs = AB.junction_inputs(16, 491, AB.D_MODEL, gen)
    with torch.no_grad():
        first = AB.run_form("double", inputs)
        second = AB.run_form("double", inputs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_autograd_and_float32_on_the_card_raise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    inputs = AB.junction_inputs(2, 9, 64, gen)
    with pytest.raises(RuntimeError, match="autograd"):
        AB.run_form("single", inputs)
    with torch.no_grad(), pytest.raises(ValueError, match="x must be torch.bfloat16"):
        NJ.norm_junction(inputs["y"], inputs["bias"], inputs["x"].float(), 0.5, inputs["norm"])


# ---------------------------------------------------------------------------
# Whole tiny forwards through the kernel.
# ---------------------------------------------------------------------------


def _state_dict(ref, model: dict, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, leaf in ref.param_layout(ref.sizes(model)).items():
        x = (torch.rand(leaf.shape, generator=gen) * 2 - 1) * leaf.scale
        out[name] = x + 1.0 if leaf.kind == "one" else x
    return out


def test_tiny_ctc_forward_through_the_kernel(cuda):
    """Four launches a layer and one more in each forward, the logprobs
    within the card tests' limits of the float32 reference."""
    ref = _load("fastconformer_reference", ROOT / "benchmark/reference/fastconformer.py")
    cfg = FastConformerConfig(
        encoder=FastConformerEncoderConfig(n_layers=2, d_model=64, n_heads=2,
                                           subsampling_conv_channels=16),
        vocabulary=stand_in_vocabulary(32))
    sd = _state_dict(ref, cfg.to_dict(), 1)
    rng = np.random.default_rng(1)
    calls = [rng.integers(-8000, 8000, n).astype(np.int16) for n in (27_000, 9_100, 41_000)]
    tr = OfflineTranscriber(to_device(convert_fastconformer_state_dict(sd, cfg), cuda), cfg,
                            batch_size=3, use_offline_forward=True, device=cuda)
    launches = NJ.norm_junction.launches
    logprobs = tr.logprobs(calls)
    assert NJ.norm_junction.launches - launches == 4 * cfg.encoder.n_layers + 1
    s = ref.sizes(cfg.to_dict())
    for call, lp in zip(calls, logprobs):
        expect = ref.forward(sd, s, torch.from_numpy(call.astype(np.float32) / 32767.0)).numpy()
        assert lp.shape == expect.shape
        assert np.abs(lp - expect).max() <= 0.03
        assert np.sqrt(np.mean(np.square(lp - expect))) <= 0.008


def test_tiny_tdt_forward_through_the_kernel(cuda):
    """The transducer's encoder through the kernel (four launches a layer
    and one more), its loop's record within the TDT cell's limits of the
    float32 reference replayed along the program's path."""
    if "reference" not in sys.modules:
        _load("reference", ROOT / "benchmark/reference/__init__.py", package=True)
    import reference.transducer as ref

    gpu = _load("transducer_gpu_tests", ROOT / "tests/test_torch_transducer_gpu.py")
    weights = _load("weights_transducer", ROOT / "benchmark/harness/weights_transducer.py")
    published = json.loads((ROOT / "benchmark/configs/parakeet-tdt-0.6b-v3.json").read_text())
    published = published["model"]
    model = {**published,
             "encoder": {**published["encoder"], "n_layers": 2, "d_model": 64, "n_heads": 2,
                         "subsampling_conv_channels": 16},
             "vocabulary": published["vocabulary"][:32],
             "transducer": {**published["transducer"], "pred_hidden": 32, "joint_hidden": 32}}
    cfg = FastConformerConfig.from_dict(model)
    s = ref.sizes(model)
    sd = weights.make_state_dict(model, 2**31 + 11, cuda)
    tr = OfflineTranscriber(convert_fastconformer_state_dict(sd, cfg), cfg,
                            use_offline_forward=True, batch_size=3, device=cuda)
    kept = {}
    wait = tr._wait

    def keeping(launched):
        idx, row_frames, record = wait(launched)
        for row, i in enumerate(idx):
            steps = record[row].astype(np.float64)
            kept[int(i)] = (steps[steps[:, TD.ACTIVE] > 0], int(row_frames[row]))
        return idx, row_frames, record
    tr._wait = keeping
    audio = gpu._calls((7.0, 3.5, 5.0), seed=4)
    launches = NJ.norm_junction.launches
    assert all(tr.transcribe(audio))
    assert NJ.norm_junction.launches - launches == 4 * cfg.encoder.n_layers + 1
    limits = gpu.CELL["limits"]
    paths = [kept[i] for i in range(len(audio))]
    with ref.float32_exactly(), torch.no_grad():
        enc = [ref.encode(sd, s, torch.from_numpy(a.astype(np.float32) / 32767.0).to(cuda))
               for a in audio]
        sound = gpu._numbers(ref, sd, s, enc, paths, gpu.CELL["params"]["choice_margin"])
    assert all(sound[k] <= limits[k] for k in sound), (sound, limits)
