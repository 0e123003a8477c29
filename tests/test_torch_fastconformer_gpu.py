"""The FastConformer forward on the card (marker ``gpu``; skips without a
CUDA device): bf16 products on the tensor cores, held to the plain float32
reference on the CPU at the small size of ``test_torch_fastconformer.py``.
Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fastconformer_gpu.py

Tolerance: 0.03 at most and 0.008 RMS on logprobs, the CPU test's for bf16
(operands rounded to bf16, float32 sums of another order on the card).
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.bridge import to_device
from tone_tpu_torch.checkpoint import convert_fastconformer_state_dict
from tone_tpu_torch.config import (
    FastConformerConfig,
    FastConformerEncoderConfig,
    stand_in_vocabulary,
)
from tone_tpu_torch.core import fastconformer as FC
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.offline import OfflineTranscriber


def _load_reference():
    """The benchmark's plain FastConformer reference, which imports nothing
    of the port, as module ``fastconformer_reference``."""
    path = Path(__file__).resolve().parents[1] / "benchmark/reference/fastconformer.py"
    spec = importlib.util.spec_from_file_location("fastconformer_reference", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module     # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


R = _load_reference()

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(seed: int = 1):
    cfg = FastConformerConfig(
        encoder=FastConformerEncoderConfig(n_layers=2, d_model=64, n_heads=2,
                                           subsampling_conv_channels=16),
        vocabulary=stand_in_vocabulary(32))
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, leaf in R.param_layout(R.sizes(cfg.to_dict())).items():
        x = (torch.rand(leaf.shape, generator=gen) * 2 - 1) * leaf.scale
        sd[name] = x + 1.0 if leaf.kind == "one" else x
    rng = np.random.default_rng(seed)
    calls = [rng.integers(-8000, 8000, n).astype(np.int16) for n in (27_000, 9_100, 41_000)]
    return cfg, sd, calls


@pytest.mark.parametrize("block_elements", [L.REL_SCORE_BLOCK_ELEMENTS, 1])
def test_transcriber_on_the_card_against_the_reference(cuda, block_elements, monkeypatch):
    monkeypatch.setattr(L, "REL_SCORE_BLOCK_ELEMENTS", block_elements)
    cfg, sd, calls = _setup()
    v = to_device(convert_fastconformer_state_dict(sd, cfg), cuda)
    logprobs = OfflineTranscriber(v, cfg, batch_size=3, use_offline_forward=True,
                                  device=cuda).logprobs(calls)
    s = R.sizes(cfg.to_dict())
    for call, lp in zip(calls, logprobs):
        ref = R.forward(sd, s, torch.from_numpy(call.astype(np.float32) / 32767.0)).numpy()
        assert lp.shape == ref.shape
        assert np.abs(lp - ref).max() <= 0.03
        assert np.sqrt(np.mean(np.square(lp - ref))) <= 0.008


def test_products_run_on_the_tensor_cores(cuda):
    cfg, sd, calls = _setup(2)
    v = OfflineTranscriber(to_device(convert_fastconformer_state_dict(sd, cfg), cuda), cfg,
                           use_offline_forward=True, device=cuda).variables
    audio = torch.from_numpy(np.stack([c[:9_000] for c in calls]).astype(np.int32)).to(cuda)
    t0 = time.monotonic_ns()
    with profiling.record():
        FC.apply_fastconformer(v, cfg, audio, [9_000] * 3)
    macs = {e.name: 0 for e in profiling.events(t0) if e.name.startswith("layers.")}
    for e in profiling.events(t0):
        if e.name in macs:
            macs[e.name] += e.n
    # only the one-input-channel convolution of the subsampling is widened:
    # 3 rows x 29 frames x 40 mels x 16 channels x 9 taps
    assert macs["layers.widened_macs"] == 3 * 29 * 40 * 16 * 9
    assert macs["layers.tc_macs"] > 3 * macs["layers.widened_macs"]
