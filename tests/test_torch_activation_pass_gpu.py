"""The FastConformer's activation-pass kernel on the card (marker ``gpu``;
skips without a CUDA device): ``ops/activation_pass.py`` and
``csrc/activation_pass.cu`` held to their plain versions (the eager chains)
at d_model 1,024 and d_ff 4,096 on the Parakeet cell's four batches (16
rows of 3,550, 1,142, 763 and 491 frames) and at tiny widths, in all three
forms; the launches of whole forwards through ``OfflineTranscriber``; and a
tiny CTC forward through the kernel against the float32 reference.  Run on
the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_activation_pass_gpu.py

Limits, each with its reason:

* each output within one bf16 ulp of the plain version's, at a share of
  elements under 1e-5, in the same shape and layout.  The kernel makes
  every float32 operation of the eager chain one at a time, in the same
  order, and rounds where the eager chain stores bf16; sigmoid's exp is
  the CUDA math library's ``expf``, as in PyTorch's kernel.  A build of
  either with another math library could move an exp by a float32 ulp,
  which turns a bf16 rounding over about once in 2^16 elements.
* the tiny forward: the card tests' limits, the CTC logprobs against the
  float32 reference 0.03 at most and 0.008 RMS
  (``test_torch_fastconformer_gpu.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
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
    canary_config,
    parakeet_tdt_config,
    stand_in_vocabulary,
)
from tone_tpu_torch.core.fastconformer import init_fastconformer_params
from tone_tpu_torch.offline import OfflineTranscriber
from tone_tpu_torch.ops import activation_pass as AP

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module     # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


AB = _load("torch_activation_pass_ab", ROOT / "dev/torch_activation_pass_ab.py")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(form: str, inputs: dict) -> dict:
    launches = AP.launches
    with torch.no_grad():
        out = AB.against_plain(form, inputs)
    torch.cuda.synchronize()
    assert AP.launches - launches == 1
    return out


@pytest.mark.parametrize("form", AB.FORMS)
@pytest.mark.parametrize("batch", [0, 1, 2, 3])
def test_kernel_against_plain_at_the_cells_batches(cuda, batch, form):
    lengths = AB.cell_batches()[batch]
    gen = torch.Generator(device=cuda).manual_seed(batch)
    out = _check(form, AB.form_inputs(form, lengths, gen))
    assert out["within_limits"], out


# (d_model, d_ff, rows' lengths, conv kernel): channel tiles cut short
# (200 = 3 x 64 + 8), frames under one tile, a kernel whose convolution
# output is not a whole number of 16-byte vectors (bn_silu's element loads).
TINY = {"d64": (64, 256, (37, 20, 1), 9), "d200": (200, 800, (29, 29, 7, 12), 9),
        "d64_k5": (64, 256, (40, 33), 5), "d200_k3": (200, 800, (17, 9, 16), 3),
        "d8_k31": (8, 32, (70, 3), 31)}


@pytest.mark.parametrize("form", AB.FORMS)
@pytest.mark.parametrize("case", TINY)
def test_kernel_against_plain_at_tiny_widths(cuda, case, form):
    d, d_ff, lengths, kernel = TINY[case]
    gen = torch.Generator(device=cuda).manual_seed(d + len(lengths))
    out = _check(form, AB.form_inputs(form, list(lengths), gen, d, d_ff, kernel))
    assert out["within_limits"], out


def test_kernel_repeats_to_the_bit(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    lengths = AB.cell_batches()[3]
    with torch.no_grad():
        for form in AB.FORMS:
            inputs = AB.form_inputs(form, lengths, gen)
            assert torch.equal(AB.run_form(form, inputs), AB.run_form(form, inputs))


def test_autograd_and_float32_on_the_card_raise(cuda):
    y, bias = torch.zeros(2, 9, 64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        AP.silu(y, bias)
    with torch.no_grad(), pytest.raises(ValueError, match="writes bf16"):
        AP.silu(y, bias, torch.float32)
    with torch.no_grad(), pytest.raises(ValueError, match="y must be torch.float32"):
        AP.silu(y.to(torch.bfloat16), bias)


def test_depthwise_convolution_reads_and_writes_the_passes_layouts(cuda):
    """PyTorch's depthwise convolution takes glu's (B, d, L) output as it
    stands and returns the contiguous (B, d, Tc) that bn_silu reads."""
    from tone_tpu_torch.core import layers as L

    gen = torch.Generator(device=cuda).manual_seed(4)
    inputs = AB.form_inputs("glu", [491, 300], gen)
    w = (0.3 * torch.randn(AB.D_MODEL, 1, AB.KERNEL, device=cuda, generator=gen)).to(
        torch.bfloat16)
    with torch.no_grad():
        v = AB.run_form("glu", inputs)
        y = L.conv1d_nhc({"w": w}, v.transpose(1, 2), groups=AB.D_MODEL).transpose(1, 2)
    assert v.is_contiguous() and y.is_contiguous() and y.dtype == torch.bfloat16
    assert y.shape == (2, AB.D_MODEL, AP.padded_frames(491, AB.KERNEL) - AB.KERNEL + 1)


# ---------------------------------------------------------------------------
# Whole forwards through the kernel.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ctc", "tdt", "canary"])
def test_launches_a_forward(cuda, name):
    """Four launches a layer, counted from zero through ``OfflineTranscriber``
    over one batch: 168, 96 and 128 at the published depths (here at a
    tiny width)."""
    published = {"ctc": FastConformerConfig(), "tdt": parakeet_tdt_config(),
                 "canary": canary_config()}[name]
    e = published.encoder
    head = {}
    if name == "tdt":
        head["transducer"] = dataclasses.replace(published.transducer, pred_hidden=32,
                                                 joint_hidden=32)
    if name == "canary":
        head["aed"] = dataclasses.replace(published.aed, n_layers=2, hidden=64, inner=128,
                                          n_heads=2)
    cfg = dataclasses.replace(
        published, vocabulary=published.vocabulary[:128],
        encoder=dataclasses.replace(e, d_model=64, n_heads=2, subsampling_conv_channels=16),
        **head)
    variables = init_fastconformer_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    calls = [rng.integers(-8000, 8000, n).astype(np.int16) for n in (48_000, 160_000, 9_000)]
    tr = OfflineTranscriber(variables, cfg, batch_size=16, use_offline_forward=True, device=cuda)
    AP.launches = 0
    tr.transcribe(calls)
    assert AP.launches == 4 * e.n_layers == {"ctc": 168, "tdt": 96, "canary": 128}[name]


def test_tiny_ctc_forward_through_the_kernel(cuda):
    """The logprobs within the card tests' limits of the float32 reference."""
    ref = _load("fastconformer_reference", ROOT / "benchmark/reference/fastconformer.py")
    cfg = FastConformerConfig(
        encoder=FastConformerEncoderConfig(n_layers=2, d_model=64, n_heads=2,
                                           subsampling_conv_channels=16),
        vocabulary=stand_in_vocabulary(32))
    gen = torch.Generator().manual_seed(1)
    sd = {}
    for name, leaf in ref.param_layout(ref.sizes(cfg.to_dict())).items():
        x = (torch.rand(leaf.shape, generator=gen) * 2 - 1) * leaf.scale
        sd[name] = x + 1.0 if leaf.kind == "one" else x
    rng = np.random.default_rng(1)
    calls = [rng.integers(-8000, 8000, n).astype(np.int16) for n in (27_000, 9_100, 41_000)]
    tr = OfflineTranscriber(to_device(convert_fastconformer_state_dict(sd, cfg), cuda), cfg,
                            batch_size=3, use_offline_forward=True, device=cuda)
    launches = AP.launches
    logprobs = tr.logprobs(calls)
    assert AP.launches - launches == 4 * cfg.encoder.n_layers
    s = ref.sizes(cfg.to_dict())
    for call, lp in zip(calls, logprobs):
        expect = ref.forward(sd, s, torch.from_numpy(call.astype(np.float32) / 32767.0)).numpy()
        assert lp.shape == expect.shape
        assert np.abs(lp - expect).max() <= 0.03
        assert np.sqrt(np.mean(np.square(lp - expect))) <= 0.008
