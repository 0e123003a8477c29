"""The FastConformer forward on the card (marker ``gpu``; skips without a
CUDA device): bf16 products on the tensor cores and the relative-position
attention kernel (``ops/rel_attention.py``, ``csrc/rel_attention.cu``),
held to the plain float32 reference on the CPU at the small size of
``test_torch_fastconformer.py``, and the kernel held to its plain version
(``layers.rel_attention_plain``) on the card.  Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fastconformer_gpu.py

Tolerances, each with its reason:

* the transcriber against the reference: 0.03 at most and 0.008 RMS on
  logprobs, the CPU test's for bf16 (operands rounded to bf16, float32 sums
  of another order on the card).
* the kernel against its plain version, both on the same bf16 operands,
  compared as float32 over each row's valid frames: at most 2^-6 of the
  larger of 1 and the row's largest context value and, in RMS, 2^-7 of
  the plain context's RMS.  Both round the context to bf16 (half an ulp:
  at most 2^-9 of the value, or 2^-8 below 2, on each side); the kernel
  rounds the softmax's weights to bf16 before they are normalized, the
  plain version after (2^-9 of each weight, so of the order of 2^-9 of
  the context, on each side), and the kernel's exponentials are 2^x to
  about 2 ulp of float32.  Those add to below 2^-6 at most and about 2^-8
  of the values in RMS, with a factor of two to spare.
"""

from __future__ import annotations

import dataclasses
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
from tone_tpu_torch.ops import rel_attention as RA


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


def _samples_for(cfg, frames: int) -> int:
    """The fewest samples whose call has ``frames`` output frames."""
    n = 160
    while cfg.output_frames(n) < frames:
        n += 160
    while cfg.output_frames(n - 1) == frames:
        n -= 1
    return n


# Calls (as output frames, or samples) whose attention's last key and query
# tiles are partial, full, or the batch's one row.
TRANSCRIBER_CASES = {"partial_last_tiles": (27_000, 9_100, 41_000),
                     "full_last_tiles": ("64 frames", "128 frames", 9_100),
                     "one_call": (41_000,)}


@pytest.mark.parametrize("case", TRANSCRIBER_CASES)
def test_transcriber_on_the_card_against_the_reference(cuda, case):
    cfg, sd, _ = _setup()
    rng = np.random.default_rng(1)
    sizes = [_samples_for(cfg, int(n.split()[0])) if isinstance(n, str) else n
             for n in TRANSCRIBER_CASES[case]]
    calls = [rng.integers(-8000, 8000, n).astype(np.int16) for n in sizes]
    if case == "full_last_tiles":
        assert [cfg.output_frames(n) % 64 for n in sizes[:2]] == [0, 0]
    v = to_device(convert_fastconformer_state_dict(sd, cfg), cuda)
    launches = RA.rel_attention.launches
    logprobs = OfflineTranscriber(v, cfg, batch_size=3, use_offline_forward=True,
                                  device=cuda).logprobs(calls)
    assert RA.rel_attention.launches - launches == cfg.encoder.n_layers
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
        _, out_lens = FC.apply_fastconformer(v, cfg, audio, [9_000] * 3)
    macs = {e.name: [] for e in profiling.events(t0) if e.name.startswith("layers.")}
    for e in profiling.events(t0):
        if e.name in macs:
            macs[e.name].append(e.n)
    # only the one-input-channel convolution of the subsampling is widened:
    # 3 rows x 29 frames x 40 mels x 16 channels x 9 taps
    assert sum(macs["layers.widened_macs"]) == 3 * 29 * 40 * 16 * 9
    assert sum(macs["layers.tc_macs"]) > 3 * sum(macs["layers.widened_macs"])
    # the attention kernel's multiply-adds, once per layer
    e = cfg.encoder
    kernel = RA.kernel_macs(RA.plan_rel_attention(out_lens), e.n_heads, e.d_head)
    assert macs["layers.tc_macs"].count(kernel) == e.n_layers


# ---------------------------------------------------------------------------
# The attention kernel against its plain version on the card.
# ---------------------------------------------------------------------------


def _attention_inputs(lengths, n_heads, d_head, seed=0):
    gen = torch.Generator().manual_seed(seed)
    b, tq, d = len(lengths), max(lengths), n_heads * d_head
    q, k, v = (torch.randn(b, tq, d, generator=gen).to(torch.bfloat16) for _ in range(3))
    pe = torch.randn(2 * tq - 1, d, generator=gen).to(torch.bfloat16)
    bias_u, bias_v = (torch.randn(n_heads, d_head, generator=gen) * 0.1 for _ in range(2))
    return [t.cuda() for t in (q, k, v, pe, bias_u, bias_v)]


def _both(lengths, n_heads, d_head, seed=0):
    args = _attention_inputs(lengths, n_heads, d_head, seed)
    with torch.no_grad():
        kernel = RA.rel_attention(*args, lengths, n_heads)
        plain = L.rel_attention_plain(*args, n_heads=n_heads,
                                      lengths=torch.tensor(lengths, device="cuda"),
                                      host_lengths=lengths)
    torch.cuda.synchronize()
    return kernel.float().cpu(), plain.float().cpu()


ATTENTION_CASES = {
    "ragged": [1, 7, 63, 64, 65, 129],
    "unsorted": [65, 129, 1, 64, 7, 63],
    "one_row": [100],
    "long_row": [3551],
}


@pytest.mark.parametrize("case", ATTENTION_CASES)
@pytest.mark.parametrize("d_head", RA.D_HEADS)
def test_kernel_against_plain(cuda, case, d_head):
    lengths = ATTENTION_CASES[case]
    n_heads = 8 if d_head == 128 else 2
    kernel, plain = _both(lengths, n_heads, d_head)
    for row, n in enumerate(lengths):
        diff = kernel[row, :n] - plain[row, :n]
        largest = max(1.0, float(plain[row, :n].abs().max()))
        assert float(diff.abs().max()) <= 2.0 ** -6 * largest, (row, n)
        rms = float(plain[row, :n].square().mean().sqrt())
        assert float(diff.square().mean().sqrt()) <= 2.0 ** -7 * rms, (row, n)
        assert not kernel[row, n:].any()


def test_kernel_repeats_to_the_bit(cuda):
    lengths = [129, 65, 7]
    args = _attention_inputs(lengths, 8, 128, seed=3)
    with torch.no_grad():
        first = RA.rel_attention(*args, lengths, 8)
        second = RA.rel_attention(*args, lengths, 8)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernel_launches_once_per_layer_and_counts_its_pairs(cuda):
    cfg, sd, calls = _setup(3)
    v = OfflineTranscriber(to_device(convert_fastconformer_state_dict(sd, cfg), cuda), cfg,
                           use_offline_forward=True, device=cuda).variables
    lengths = [len(c) for c in calls]
    audio = torch.zeros(len(calls), max(lengths), dtype=torch.int32)
    for i, c in enumerate(calls):
        audio[i, :len(c)] = torch.from_numpy(c.astype(np.int32))
    launches = RA.rel_attention.launches
    t0 = time.monotonic_ns()
    with profiling.record():
        _, out_lens = FC.apply_fastconformer(v, cfg, audio.to(cuda), lengths)
    assert RA.rel_attention.launches - launches == cfg.encoder.n_layers
    computed = [e.n for e in profiling.events(t0)
                if e.name == "fastconformer.attention_pairs_computed"]
    assert computed == [RA.plan_rel_attention(out_lens).pairs] * cfg.encoder.n_layers


def test_autograd_on_the_card_raises(cuda):
    lengths = [9, 4]
    args = _attention_inputs(lengths, 2, 32)
    with pytest.raises(RuntimeError, match="autograd"):
        RA.rel_attention(*args, lengths, 2)
    cfg, sd, _ = _setup()
    p = to_device(convert_fastconformer_state_dict(sd, cfg), cuda)["params"]
    att = p["encoder"]["layers"][0]["att"]
    x = torch.randn(2, 9, 64, device=cuda)
    pos = FC.positional_encoding(9, 64, cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        L.rel_mhsa_blocked(att, x, pos, n_heads=2, lengths=torch.tensor(lengths, device=cuda),
                           host_lengths=lengths)


def test_float32_on_the_card_is_refused_up_front(cuda):
    """float32 compute runs on the CPU only (the attention kernel computes
    in bf16): the card's forward refuses it before it launches anything."""
    cfg, sd, calls = _setup()
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    tr = OfflineTranscriber(to_device(convert_fastconformer_state_dict(sd, cfg), cuda), cfg,
                            use_offline_forward=True, device=cuda)
    launches = RA.rel_attention.launches
    with pytest.raises(ValueError, match="CPU only"):
        tr.logprobs(calls)
    audio = torch.from_numpy(np.stack([c[:9_000] for c in calls]).astype(np.int32)).to(cuda)
    with profiling.record():
        t0 = time.monotonic_ns()
        with pytest.raises(ValueError, match="CPU only"):
            FC.apply_fastconformer(tr.variables, cfg, audio, [9_000] * 3)
    assert not list(profiling.events(t0))
    assert RA.rel_attention.launches == launches
