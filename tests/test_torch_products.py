"""Where the port's products and convolutions run (tone_tpu_torch/core/layers.py),
on the CPU with a tiny model.

* the path choice: bf16 operands on a CUDA device with autograd off take
  the tensor cores, every other case the widened path; products only under
  a torch with ``aten::mm.dtype``, which the serving image's torch has;
  convolutions of one input channel stay widened;
* on the CPU every product is the widened one, bit for bit;
* the multiply-add counters under ``profiling.record()``: a bf16 inference
  forward and a training forward count every product and convolution of
  the model as ``layers.widened_macs`` (the analytic count worked out here
  from the config), none as ``layers.tc_macs``; nothing is counted outside
  ``record()``.
"""

import re
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tone_tpu_torch import profiling
from tone_tpu_torch.acoustic import cast_params_for_inference
from tone_tpu_torch.config import EncoderConfig, ToneConfig
from tone_tpu_torch.core import layers as L
from tone_tpu_torch.core.frontend import get_frontend_constants, log_mel_offline
from tone_tpu_torch.core.model import apply_offline, init_model_params

BF, F16, F32 = torch.bfloat16, torch.float16, torch.float32
TINY = dict(n_layers=5, d_model=64, n_heads=4, rope_dim=8, ff_expansion_factor=2,
            conv_kernel_size=7, subsampling_conv_channels=(4, 8), mhsa_stateless_layers=3,
            reduction_position=1, upsample_position=3,
            should_recompute_att_scores=(True, False, True, True, True))
N_SAMPLES = 2400 * 5 + 313


def _operand(is_cuda, dtype):
    return SimpleNamespace(is_cuda=is_cuda, dtype=dtype)


@pytest.mark.parametrize("is_cuda, a, b, grad, expected", [
    (True, BF, BF, False, True),
    (True, F16, F16, False, False),   # no config computes in float16
    (True, BF, BF, True, False),      # autograd recording: the training forward
    (True, F32, F32, False, False),   # a float32 compute config
    (True, BF, F32, False, False),    # mixed operands
    (True, BF, F16, False, False),
    (False, BF, BF, False, False),    # the CPU
], ids=["cuda-bf16", "cuda-fp16", "cuda-bf16-grad", "cuda-fp32", "cuda-bf16-fp32",
        "cuda-bf16-fp16", "cpu-bf16"])
def test_path_choice(is_cuda, a, b, grad, expected):
    with torch.set_grad_enabled(grad):
        assert L._on_tensor_cores(_operand(is_cuda, a), _operand(is_cuda, b)) is expected


@pytest.mark.parametrize("has_mm_dtype", [True, False], ids=["torch-2.8", "older-torch"])
def test_products_need_a_float32_result_of_bf16_operands(monkeypatch, has_mm_dtype):
    """A torch without ``aten::mm.dtype`` runs every product widened."""
    monkeypatch.setattr(L, "_PRODUCTS_TO_FLOAT32", has_mm_dtype)
    with torch.no_grad():
        assert L._products_on_tensor_cores(_operand(True, BF), _operand(True, BF)) is has_mm_dtype
        assert L._on_tensor_cores(_operand(True, BF), _operand(True, BF))


def test_this_torch_has_the_float32_product_of_bf16_operands():
    """Every PyTorch from 2.8 has ``torch.mm``/``torch.bmm`` with
    ``out_dtype`` (``aten::mm.dtype``), the tensor cores' product here."""
    version = tuple(int(v) for v in re.findall(r"\d+", torch.__version__)[:2])
    assert L._PRODUCTS_TO_FLOAT32 == (version >= (2, 8))


def test_serving_image_torch_has_the_float32_product_of_bf16_operands():
    """The serving image's PyTorch is 2.8 or later, so its bf16 products
    run on the tensor cores and not widened (``Dockerfile.torch``)."""
    text = (Path(__file__).resolve().parents[1] / "Dockerfile.torch").read_text()
    major, minor = re.search(r"^ARG PYTORCH_TAG=(\d+)\.(\d+)\.", text, re.M).groups()
    assert (int(major), int(minor)) >= (2, 8)


@pytest.mark.parametrize("in_channels, tensor_cores", [(1, False), (3, True)])
def test_one_input_channel_convolution_stays_widened(monkeypatch, in_channels, tensor_cores):
    """With the tensor cores open to bf16 operands, a convolution of one
    input channel still runs on widened copies; of more, on the bf16
    operands (here bf16 convolutions of the CPU)."""
    monkeypatch.setattr(L, "_on_tensor_cores", lambda a, b: True)
    x = _t(2, in_channels, 20, 16)
    p = {"w": _t(4, in_channels, 5, 3, seed=1, scale=0.2), "b": _t(4, dtype=F32, seed=2)}
    counts, got = _counts(lambda: L.conv2d(p, x, (2, 1)))
    macs = got.numel() * in_channels * 5 * 3
    assert got.dtype == BF and got.shape == (2, 4, 8, 14)
    assert counts == {"layers.tc_macs" if tensor_cores else "layers.widened_macs": macs}


def _t(*shape, dtype=BF, seed=0, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=gen) * scale).to(dtype)


@pytest.mark.parametrize("case", ["bf16-bias", "bf16-nobias", "fp32", "head"])
def test_cpu_linear_is_the_widened_product(case):
    """float32 product of the widened operands, float32 bias, one rounding."""
    compute = F32 if case in ("fp32", "head") else BF
    x = _t(3, 5, 48, dtype=F32 if case == "fp32" else BF)
    p = {"w": _t(48, 24, dtype=F32 if case == "fp32" else BF, seed=1, scale=0.2)}
    if case != "bf16-nobias":
        p["b"] = _t(24, dtype=F32, seed=2)
    want = torch.matmul(x.float(), p["w"].float())
    if "b" in p:
        want = want + p["b"]
    with torch.no_grad():
        got = L.linear(p, x, compute)
    assert got.dtype == compute
    assert torch.equal(got, want.to(compute))


@pytest.mark.parametrize("kind", ["conv2d", "depthwise", "strided"])
def test_cpu_convolutions_are_the_widened_ones(kind):
    """float32 convolution of the widened operands, rounded, then the bias."""
    if kind == "conv2d":
        x, p = _t(2, 3, 20, 16), {"w": _t(4, 3, 5, 3, seed=1, scale=0.2)}
    else:
        x, p = _t(2, 19, 8), {"w": _t(8 if kind == "depthwise" else 32, 1, 3, seed=1)}
    p["b"] = _t(p["w"].shape[0], dtype=F32, seed=2)
    with torch.no_grad():
        if kind == "conv2d":
            got = L.conv2d(p, x, (2, 1))
            y = torch.nn.functional.conv2d(x.float(), p["w"].float(), stride=(2, 1))
            want = y.to(BF).float() + p["b"].reshape(1, -1, 1, 1)
        else:
            stride = 1 if kind == "depthwise" else 2
            got = L.conv1d_nhc(p, x, stride=stride, groups=8)
            y = torch.nn.functional.conv1d(x.float().transpose(1, 2), p["w"].float(),
                                           stride=stride, groups=8).transpose(1, 2)
            want = y.to(BF).float() + p["b"]
    assert torch.equal(got, want.to(BF))


def _model(cast: bool, chunk_ms: int = 300):
    cfg = ToneConfig(encoder=EncoderConfig(**TINY)).with_chunk_duration_ms(chunk_ms)
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    return cfg, (cast_params_for_inference(variables, cfg) if cast else variables)


def _audio():
    wav = np.random.default_rng(0).integers(-20000, 20000, (2, N_SAMPLES)).astype(np.int32)
    return torch.from_numpy(wav), torch.tensor([N_SAMPLES, 9000], dtype=torch.int32)


def _subsampled(cfg: ToneConfig, t_feat: int) -> tuple[int, int]:
    """(frames, mel bins) out of the subsampling's first convolution."""
    e = cfg.encoder
    (kh1, kw1), (st1, sf1) = e.subsampling_kernel_size[0], e.subsampling_strides[0]
    return (t_feat + e.subsampling_state_lens[0] - kh1) // st1 + 1, (e.feat_in - kw1) // sf1 + 1


def one_channel_macs(cfg: ToneConfig, b: int, t_feat: int) -> int:
    """Multiply-adds of the subsampling's first convolution (one input
    channel), over ``b`` rows of ``t_feat`` feature frames."""
    (kh1, kw1), c1 = cfg.encoder.subsampling_kernel_size[0], cfg.encoder.subsampling_conv_channels[0]
    t1, f1 = _subsampled(cfg, t_feat)
    return b * c1 * t1 * f1 * kh1 * kw1


def _analytic_macs(cfg: ToneConfig, b: int, t_feat: int, b1: bool) -> int:
    """Multiply-adds of the model's products and convolutions over a batch
    of ``b`` rows of ``t_feat`` feature frames, from the config; each
    attention block of c queries sees its chunk and its left context, w + c
    keys, whole chunks or not.  ``b1``:
    the feed-forwards' output projections run in kernel B1 (the merged
    ``lin12`` serving weights), which is no product of ``layers``."""
    e = cfg.encoder
    d, f, h, dh = e.d_model, e.d_ff, e.n_heads, e.d_head
    (kh2, kw2), c1, c2 = e.subsampling_kernel_size[1], *e.subsampling_conv_channels
    (st2, sf2), l2 = e.subsampling_strides[1], e.subsampling_state_lens[1]
    t1, f1 = _subsampled(cfg, t_feat)
    t2, f2 = (t1 + l2 - kh2) // st2 + 1, (f1 - kw2) // sf2 + 1
    macs = one_channel_macs(cfg, b, t_feat) + b * c2 * t2 * f2 * c1 * kh2 * kw2
    macs += b * t2 * c2 * f2 * d                                   # pre-encode out
    r = e.reduction_factor
    t_red = -(-t2 // r)
    for i in range(e.n_layers):
        reduced = e.reduction_position < i <= e.upsample_position
        t = t_red if reduced else t2
        rows = b * t
        macs += 2 * (rows * d * 2 * f + (0 if b1 else rows * f * d))   # ff1, ff2
        recompute = e.should_recompute_att_scores[i]
        macs += (4 if recompute else 2) * rows * d * d               # q, k, v, out
        c = e.chunk_size // r if reduced else e.chunk_size
        w = 0
        if i >= e.mhsa_stateless_layers:
            w = e.mhsa_state_size // r if reduced else e.mhsa_state_size
        per_product = b * h * -(-t // c) * c * (w + c) * dh
        macs += (2 if recompute else 1) * per_product                # scores, context
        macs += rows * d * 2 * d + rows * d * e.conv_kernel_size + rows * d * d
        if i == e.reduction_position:
            k = e.reduction_kernel_size
            macs += b * t_red * 4 * d * k + b * t_red * 4 * d * d    # reduction dw, pw
    return macs + b * t2 * d * cfg.vocab_size_with_blank            # head


def _counts(fn):
    """{counter name: total} of the ``layers.*`` counts made while ``fn``
    runs under ``profiling.record()``."""
    t0 = time.monotonic_ns()
    with profiling.record():
        out = fn()
    counts: dict = {}
    for e in profiling.events(t0, time.monotonic_ns()):
        if isinstance(e, profiling.Count) and e.name.startswith("layers."):
            counts[e.name] = counts.get(e.name, 0) + e.n
    return counts, out


def _t_feat(cfg, wav):
    feats, _ = log_mel_offline(wav.float() / 32767, None, get_frontend_constants(cfg.frontend,
                                                                                 wav.device))
    return feats.shape[1]


@pytest.mark.parametrize("chunk_ms", [300, 400], ids=["blocked", "fractional"])
@pytest.mark.parametrize("cast", [False, True], ids=["split-ff", "serving-cast"])
def test_bf16_inference_forward_counts_every_product_as_widened_on_the_cpu(chunk_ms, cast):
    cfg, variables = _model(cast, chunk_ms)
    wav, lens = _audio()
    counts, (logprobs, _, _) = _counts(lambda: apply_offline(variables, cfg, wav, lens))
    t_feat = _t_feat(cfg, wav)
    want = _analytic_macs(cfg, wav.shape[0], t_feat, b1=cast)
    assert counts == {"layers.widened_macs": want}
    assert want > 0 and logprobs.shape[1] > 0


def test_training_forward_counts_nothing_on_the_tensor_cores():
    cfg, variables = _model(cast=False)
    params = {k: v for k, v in variables.items()}
    wav, lens = _audio()

    def forward():
        with torch.enable_grad():
            for leaf in params["params"]["head"].values():
                leaf.requires_grad_(True)
            logprobs, _, _ = apply_offline(params, cfg, wav.float() / 32767, lens, rng=3,
                                           training=True)
            assert logprobs.requires_grad
            return logprobs

    counts, _ = _counts(forward)
    want = _analytic_macs(cfg, wav.shape[0], _t_feat(cfg, wav), b1=False)
    assert "layers.tc_macs" not in counts
    assert counts == {"layers.widened_macs": want}


def test_nothing_is_counted_outside_record(monkeypatch):
    monkeypatch.setattr(profiling, "_recorder", profiling.Recorder())
    cfg, variables = _model(cast=True)
    wav, lens = _audio()
    apply_offline(variables, cfg, wav, lens)
    assert not profiling.recording()
    assert profiling.events() == []
