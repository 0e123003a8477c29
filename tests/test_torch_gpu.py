"""Tests of the port that need a CUDA device (marker ``gpu``; they skip
without one).  The file imports neither jax nor tone_tpu, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from tone_tpu_torch.acoustic import StreamingCTCModel
from tone_tpu_torch.config import EncoderConfig, ToneConfig
from tone_tpu_torch.core.model import init_model_params
from tone_tpu_torch.ops.glu_ff import glu_ff2, glu_ff2_plain

pytestmark = pytest.mark.gpu

F, D = 1536, 384


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none here)")
    return torch.device("cuda")


def _case(device, m, f=F, d=D, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    av = torch.randn(m, 2 * f, device=device, generator=gen).to(torch.bfloat16)
    p2 = {"w": (torch.randn(f, d, device=device, generator=gen) * 0.02).to(torch.bfloat16),
          "b": torch.randn(d, device=device, generator=gen) * 0.01}
    return av, p2


@pytest.mark.parametrize("m", [2560, 640, 320, 37, 10, 1])
def test_kernel_matches_plain(cuda, m):
    av, p2 = _case(cuda, m, seed=m)
    before = glu_ff2.launches
    y = glu_ff2(av, p2)
    torch.cuda.synchronize()
    assert glu_ff2.launches == before + 1
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, D)
    err = (y.float() - glu_ff2_plain(av, p2).float()).abs().max().item()
    assert err <= 2e-2  # the JAX oracle's tolerance (tests/test_glu_ff.py)


def test_kernel_keeps_leading_dims_and_skips_empty(cuda):
    av, p2 = _case(cuda, 40)
    y = glu_ff2(av.reshape(4, 10, 2 * F), p2)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (4, 10, D)
    before = glu_ff2.launches
    assert tuple(glu_ff2(av[:0], p2).shape) == (0, D)
    assert glu_ff2.launches == before


@pytest.mark.parametrize("bad", ["float32_av", "strided_av", "ragged_f"])
def test_kernel_wrapper_raises_instead_of_falling_back(cuda, bad):
    if bad == "ragged_f":  # F = 48 is not a multiple of the kernel's F tile
        av, p2 = _case(cuda, 10, f=48, d=64)
    else:
        av, p2 = _case(cuda, 10)
        if bad == "float32_av":
            av = av.float()
        else:  # every other column of a (10, 4F) tensor: (10, 2F), not contiguous
            av = torch.cat([av, av], dim=1)[:, ::2]
    before = glu_ff2.launches
    with pytest.raises((TypeError, ValueError)):
        glu_ff2(av, p2)
    assert glu_ff2.launches == before


def test_tiny_bf16_step_on_card_matches_cpu(cuda):
    """The bf16 step (kernel on the card, its plain version on the CPU) at a
    tiny width the kernel's tiles divide (F = 128, D = 64)."""
    cfg = ToneConfig(encoder=EncoderConfig(
        n_layers=5, d_model=64, n_heads=4, rope_dim=8, ff_expansion_factor=2,
        conv_kernel_size=7, subsampling_conv_channels=(4, 8), mhsa_stateless_layers=3,
        reduction_position=1, upsample_position=3,
        should_recompute_att_scores=(True, False, True, True, True)))
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    wav = np.random.default_rng(0).integers(-20000, 20000, (3, 2400 * 4)).astype(np.int32)
    gpu = StreamingCTCModel(variables, cfg, device=cuda)
    cpu = StreamingCTCModel(variables, cfg, device="cpu")
    sg = sc = None
    before = glu_ff2.launches
    for i in range(4):
        chunk = wav[:, i * 2400:(i + 1) * 2400]
        lg, sg = gpu.forward_native(chunk, sg)
        lc, sc = cpu.forward_native(chunk, sc)
        assert np.abs(lg.cpu().numpy() - lc.numpy()).max() < 0.05
    assert glu_ff2.launches == before + 4 * 2 * cfg.encoder.n_layers
