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


# The step's and the serving path's row counts (the small tile below 1024
# rows, the big one from there, depth splits 2-8), ragged tails, 8448 rows
# (one block per output tile: no split), the bulk full-sequence forward's
# 16 x 2080 and 16 x 1040 rows, and the tiny widths of the CPU tests (D = 64
# is one ragged column tile).
@pytest.mark.parametrize("f, d", [(F, D), (128, 64), (256, 128)])
@pytest.mark.parametrize("m", [33280, 16640, 8448, 2560, 1280, 640, 320, 160, 80, 37, 10, 1])
def test_kernel_matches_plain(cuda, m, f, d):
    av, p2 = _case(cuda, m, f=f, d=d, seed=m)
    before = glu_ff2.launches
    y = glu_ff2(av, p2)
    torch.cuda.synchronize()
    assert glu_ff2.launches == before + 1
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, d)
    err = (y.float() - glu_ff2_plain(av, p2).float()).abs().max().item()
    assert err <= 2e-2  # the JAX oracle's tolerance (tests/test_glu_ff.py)


@pytest.mark.parametrize("m", [2560, 640, 160, 80, 10])
def test_kernel_is_deterministic(cuda, m):
    """The depth slices' partials are added in a fixed order (no atomics):
    two launches on the same inputs agree bit for bit."""
    av, p2 = _case(cuda, m, seed=7)
    first, second = glu_ff2(av, p2), glu_ff2(av, p2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernel_with_weights_cold_in_l2(cuda):
    """The first of 48 W2 matrices (57 MB in all, more than the 50 MB L2),
    run again after the other 47, still matches its plain version."""
    av, _ = _case(cuda, 160, seed=3)
    weights = [_case(cuda, 1, seed=100 + i)[1] for i in range(48)]
    assert sum(p["w"].numel() * 2 for p in weights) > 50e6
    for p2 in weights:
        glu_ff2(av, p2)
    y = glu_ff2(av, weights[0])
    torch.cuda.synchronize()
    err = (y.float() - glu_ff2_plain(av, weights[0]).float()).abs().max().item()
    assert err <= 2e-2


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
    if bad == "ragged_f":  # F = 48 is not a multiple of the kernel's depth stage
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


# ---------------------------------------------------------------------------
# The fused Conformer layer (csrc/fused_layer.cu) against its plain version.
# ---------------------------------------------------------------------------

from tone_tpu_torch.bridge import to_device  # noqa: E402
from tone_tpu_torch.ops import fused_encoder as FE  # noqa: E402
from tone_tpu_torch.ops.fused_layer import (  # noqa: E402
    flatten_layer_params,
    fused_conformer_layer,
    fused_conformer_layer_plain,
)

TINY = dict(n_layers=5, d_model=64, n_heads=4, rope_dim=8, ff_expansion_factor=2,
            conv_kernel_size=7, subsampling_conv_channels=(4, 8), mhsa_stateless_layers=3,
            reduction_position=1, upsample_position=3,
            should_recompute_att_scores=(True, False, True, True, True))
# layer of each kind: (tiny model, full model)
FUSED_KINDS = {"stateless_recompute_t10": (0, 0), "stateless_recompute_t5": (2, 7),
               "stateless_reuse": (1, 1), "stateful_w15": (3, 14), "stateful_w30": (4, 15)}


def _perturbed(tree, gen):
    """Norm and BatchNorm leaves moved off the identity."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list, tuple)):
                out[k] = _perturbed(v, gen)
            elif k in ("weight", "scale"):
                out[k] = v + 0.2 * torch.randn(v.shape, generator=gen)
            elif k in ("bias", "mean"):
                out[k] = v + 0.1 * torch.randn(v.shape, generator=gen)
            elif k == "var":
                out[k] = 0.5 + torch.rand(v.shape, generator=gen)
            else:
                out[k] = v
        return out
    return type(tree)(_perturbed(v, gen) for v in tree)


@pytest.fixture(scope="module")
def fused_models():
    out = {}
    for width, enc in (("tiny", EncoderConfig(**TINY)), ("full", EncoderConfig())):
        cfg = ToneConfig(encoder=enc)
        gen = torch.Generator().manual_seed(0)
        out[width] = (cfg, _perturbed(init_model_params(gen, cfg), gen))
    return out


def fused_case(cfg, variables, layer, batch, device, seed=0):
    """(inputs, packed weights, static kwargs) of one layer at ``batch``."""
    e = cfg.encoder
    st = FE._layer_static(e, layer)
    t, window = st["t"], st["window"]
    gen = torch.Generator().manual_seed(seed)
    w = flatten_layer_params(variables["params"]["encoder"]["layers"][layer],
                             variables["batch_stats"]["layers"][layer], e, t=t,
                             window=window, recompute=st["recompute"], device=device)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(torch.bfloat16).to(device)

    x = rand(batch, t, e.d_model)
    conv = rand(batch, e.conv_kernel_size - 1, e.d_model, scale=0.5)
    win = rand(batch, window, e.d_model) if window else None
    invalid = (torch.randint(0, window + 1, (batch, 1), generator=gen, dtype=torch.int32)
               .to(device) if window else None)
    scores = (None if st["recompute"] else
              (2.0 * torch.randn(batch, e.n_heads, t, window + t, generator=gen)).to(device))
    static = dict(t=t, window=window, recompute=st["recompute"], n_heads=e.n_heads,
                  rope_dim=e.rope_dim, conv_k=e.conv_kernel_size)
    return (x, conv, win, invalid, scores), w, static


def fused_errors(got, ref):
    """{output: (max, mean) |kernel - plain|}."""
    out = {}
    for name, g, r in zip(("y", "new_conv", "new_win", "scores"), got, ref):
        if r is not None:
            err = (g.float() - r.float()).abs()
            out[name] = (err.max().item(), err.mean().item())
    return out


def assert_fused_close(got, ref):
    for name, (mx, mean) in fused_errors(got, ref).items():
        if name == "scores":
            assert mx <= 2e-2, (name, mx)
        else:
            assert mx <= 0.05 and mean <= 2e-3, (name, mx, mean)


# B = 3 and 100 are not multiples of the 64-row tile (ragged last tiles),
# and at B = 100 the full width has more tiles than the card has blocks.
@pytest.mark.parametrize("batch", [1, 3, 16, 64, 100])
@pytest.mark.parametrize("width", ["tiny", "full"])
@pytest.mark.parametrize("kind", sorted(FUSED_KINDS))
def test_fused_kernel_matches_plain(cuda, fused_models, kind, width, batch):
    cfg, variables = fused_models[width]
    layer = FUSED_KINDS[kind][width == "full"]
    args, w, static = fused_case(cfg, variables, layer, batch, cuda, seed=batch)
    before = fused_conformer_layer.launches
    got = fused_conformer_layer(*args, w, **static)
    torch.cuda.synchronize()
    assert fused_conformer_layer.launches == before + 1
    assert_fused_close(got, fused_conformer_layer_plain(*args, w, **static))


@pytest.mark.parametrize("kind", sorted(FUSED_KINDS))
def test_fused_kernel_is_deterministic(cuda, fused_models, kind):
    """No atomics in any sum: two launches on the same inputs agree bit for bit."""
    cfg, variables = fused_models["full"]
    args, w, static = fused_case(cfg, variables, FUSED_KINDS[kind][1], 64, cuda, seed=5)
    first = fused_conformer_layer(*args, w, **static)
    second = fused_conformer_layer(*args, w, **static)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        if a is not None:
            assert torch.equal(a, b)


def test_fused_kernel_with_weights_cold_in_l2(cuda, fused_models):
    """The last layer of a full-width plan, run after the other 15 layers
    (71 MB of weights, more than the 50 MB L2), still matches its plain
    version."""
    cfg, variables = fused_models["full"]
    # Every layer packed (and its inputs made) first, so that the 15 layers
    # run in between are what the L2 holds when the last one starts.
    cases = [fused_case(cfg, variables, layer, 64, cuda, seed=layer)
             for layer in range(cfg.encoder.n_layers)]
    for args, w, static in cases[:-1]:
        fused_conformer_layer(*args, w, **static)
    args, w, static = cases[-1]
    got = fused_conformer_layer(*args, w, **static)
    torch.cuda.synchronize()
    assert_fused_close(got, fused_conformer_layer_plain(*args, w, **static))


@pytest.mark.parametrize("bad", ["float32_x", "strided_x"])
def test_fused_wrapper_raises_instead_of_falling_back(cuda, fused_models, bad):
    cfg, variables = fused_models["tiny"]
    (x, *rest), w, static = fused_case(cfg, variables, 0, 4, cuda)
    if bad == "float32_x":
        x = x.float()
    else:  # every other row of a (4, 2T, D) tensor: (4, T, D), not contiguous
        x = torch.cat([x, x], dim=1)[:, ::2]
    before = fused_conformer_layer.launches
    with pytest.raises((TypeError, ValueError)):
        fused_conformer_layer(x, *rest, w, **static)
    assert fused_conformer_layer.launches == before


def test_tiny_fused_step_on_card_matches_cpu(cuda, fused_models):
    from tone_tpu_torch.core.model import init_streaming_state

    cfg, variables = fused_models["tiny"]
    wav = np.random.default_rng(0).integers(-20000, 20000, (3, 2400 * 4)).astype(np.int32)
    plans = {dev: FE.prepare_fused_params(variables, cfg, device=dev) for dev in (cuda, "cpu")}
    var_gpu = to_device(variables, cuda)
    sg, sc = init_streaming_state(cfg, 3, device=cuda), init_streaming_state(cfg, 3)
    for i in range(4):
        chunk = torch.from_numpy(wav[:, i * 2400:(i + 1) * 2400])
        before = fused_conformer_layer.launches
        lg, sg = FE.apply_streaming_fused(var_gpu, plans[cuda], cfg, chunk.to(cuda), sg)
        torch.cuda.synchronize()
        assert fused_conformer_layer.launches == before + cfg.encoder.n_layers
        lc, sc = FE.apply_streaming_fused(variables, plans["cpu"], cfg, chunk, sc)
        assert np.abs(lg.cpu().numpy() - lc.numpy()).max() < 0.05


def test_fused_plan_refuses_float32_on_the_card(cuda, fused_models):
    cfg, variables = fused_models["tiny"]
    with pytest.raises(TypeError, match="bf16"):
        FE.prepare_fused_params(variables, ToneConfig(encoder=cfg.encoder,
                                                      compute_dtype="float32"), device=cuda)


# ---------------------------------------------------------------------------
# The device beam search (ops/beam_decode.py) on the card against the CPU:
# the same torch ops, so states agree bit for bit on hashes, tokens and
# lengths, and within float rounding on the log probabilities.
# ---------------------------------------------------------------------------

from tone_tpu_torch.ops import beam_decode as BD  # noqa: E402

BEAM_V = 35


def _beam_logprobs(seed, b, t, scale=2.5, blank=4.0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, scale, (b, t, BEAM_V))
    logits[..., BEAM_V - 1] += blank
    x = logits - logits.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _assert_nbest_close(got, want):
    """Same texts in the same order on every row; scores within 1e-4 (the
    hotword bias is a float sum that may round differently on the card)."""
    assert [[h[0] for h in r] for r in got] == [[h[0] for h in r] for r in want]
    for g, w in zip(got, want):
        assert np.allclose([h[1] for h in g], [h[1] for h in w], atol=1e-4)


def _assert_beam_states_equal(card, cpu):
    for f in ("h1", "h2", "lc", "tokens", "lens"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    for f in ("p_b", "p_nb"):
        a, b = getattr(card, f).cpu(), getattr(cpu, f)
        assert torch.equal(torch.isfinite(a), torch.isfinite(b)), f
        fin = torch.isfinite(b)
        assert (a[fin] - b[fin]).abs().max().item() <= 1e-5 if fin.any() else True, f


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("width", [4, 32])
def test_beam_advance_on_card_matches_cpu(cuda, width, hot):
    lp = _beam_logprobs(width, 8, 96)
    lengths = np.array([96, 90, 64, 50, 33, 12, 1, 0])
    if hot:
        tables = BD.make_hotword_tables(["да", "нет привет", "мир"], 4.0)
        card = BD.hot_beam_advance(BD.init_hot_beam_state(8, width, 128, cuda), lp, lengths,
                                   hotwords=tables)
        cpu = BD.hot_beam_advance(BD.init_hot_beam_state(8, width, 128), lp, lengths,
                                  hotwords=tables)
        assert torch.equal(card.node.cpu(), cpu.node)
        assert (card.bias.cpu() - cpu.bias).abs().max().item() <= 1e-5
        card, cpu = card.base, cpu.base
    else:
        card = BD.beam_advance(BD.init_beam_state(8, width, 128, cuda), lp, lengths)
        cpu = BD.beam_advance(BD.init_beam_state(8, width, 128), lp, lengths)
    assert card.p_b.device.type == cuda.type
    _assert_beam_states_equal(card, cpu)
    _assert_nbest_close(BD.beam_nbest(card, width), BD.beam_nbest(cpu, width))


def test_beam_tie_order_on_card(cuda):
    """Uniform frames: every candidate ties with many others, so only the
    stable order (lower index first, as XLA's TopK) keeps card and CPU on
    the same beams and hashes."""
    lp = np.full((4, 12, BEAM_V), -np.log(BEAM_V), np.float32)
    card = BD.beam_advance(BD.init_beam_state(4, 16, 32, cuda), lp)
    cpu = BD.beam_advance(BD.init_beam_state(4, 16, 32), lp)
    _assert_beam_states_equal(card, cpu)
    assert len(set(cpu.h1[0].tolist())) == 16   # ties kept distinct beams


def test_beam_hash_products_on_card(cuda):
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.int64)
    h[:4] = [0, 1, 2**31, 2**32 - 1]
    v = torch.from_numpy(rng.integers(-1, 34, 1 << 16))
    ht = torch.from_numpy(h)
    card = BD._mix(ht.to(cuda), ht.to(cuda), v.to(cuda))
    cpu = BD._mix(ht, ht, v)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)
    u = (v.numpy() + 1).astype(np.uint32)
    want2 = (h.astype(np.uint32) * np.uint32(2654435761) + u).astype(np.int64)
    assert np.array_equal(cpu[1].numpy(), want2)


def test_neg_inf_arithmetic_on_card(cuda):
    ninf = torch.full((3, 5), float("-inf"), device=cuda)
    assert torch.isneginf(torch.logaddexp(ninf, ninf)).all()
    assert torch.isneginf(torch.logsumexp(ninf, -1)).all()
    x = torch.tensor([-1.5, float("-inf")], device=cuda)
    assert torch.logaddexp(x, torch.full_like(x, float("-inf"))).tolist() == [-1.5, float("-inf")]
    state = BD.beam_advance(BD.init_beam_state(2, 8, 16, cuda),
                            np.zeros((2, 0, BEAM_V), np.float32))
    assert torch.isneginf(state.totals[:, 1:]).all() and (state.totals[:, 0] == 0).all()


@pytest.mark.parametrize("variant", ["lm", "hotword_rows"])
def test_device_beam_decoder_on_card_matches_cpu(cuda, variant):
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder
    from tone_tpu_torch.decoding.estimate import estimate_ngram_lm
    from tone_tpu_torch.decoding.lm import ArpaLM

    rng = np.random.default_rng(1)
    words = ["да", "нет", "мир", "вот", "так", "ёж"]
    lm = ArpaLM(estimate_ngram_lm(
        [[words[i] for i in rng.integers(0, 6, rng.integers(1, 6))] for _ in range(200)], 3))
    phrases = [_beam_logprobs(10 + i, 1, t)[0] for i, t in enumerate([40, 64, 100, 7, 300])]
    rows = None
    if variant == "hotword_rows":
        rows = [BD.make_hotword_tables(["да"]), None, BD.make_hotword_tables(["мир вот"], 3.0),
                None, BD.make_hotword_tables(["ёж", "так"])]
    card = DeviceBeamSearchCTCDecoder(lm, beam_width=16, device=cuda)
    cpu = DeviceBeamSearchCTCDecoder(lm, beam_width=16, device="cpu")
    got, want = card.forward_batch_nbest(phrases, 4, rows), cpu.forward_batch_nbest(
        phrases, 4, rows)
    _assert_nbest_close(got, want)
    assert card._cuda_stream is not None   # the search ran on its own stream


# ---------------------------------------------------------------------------
# The fused-LM device search on the card against the CPU: the same torch ops,
# so the hashes, the KenLM chain hash and the LM state agree bit for bit, the
# log probabilities within float rounding.
# ---------------------------------------------------------------------------


def _fused_lm(tmp_path, probing: bool, seed: int = 0):
    """An order-3 LM over a seeded corpus, as a DeviceLM (ARPA) or a
    DeviceProbingLM (the same LM as a KenLM probing binary)."""
    from tone_tpu_torch.decoding.device_lm import DeviceLM, DeviceProbingLM
    from tone_tpu_torch.decoding.estimate import estimate_ngram_lm
    from tone_tpu_torch.decoding.kenlm_binary import write_kenlm_binary

    rng = np.random.default_rng(seed)
    letters = list("абвгдежзиклмнопрстуя")
    words = ["".join(rng.choice(letters, rng.integers(1, 5))) for _ in range(60)]
    tables = estimate_ngram_lm(
        [[words[i] for i in rng.integers(0, 60, rng.integers(1, 8))] for _ in range(400)], 3)
    if not probing:
        return DeviceLM.from_ngrams(tables)
    write_kenlm_binary(tables, tmp_path / "lm.bin")
    return DeviceProbingLM.from_file(tmp_path / "lm.bin", cache=False)


def _fused_logprobs(seed, b, t):
    """Blank-heavy frames with frequent spaces, so that words complete."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.5, (b, t, BEAM_V))
    logits[..., BEAM_V - 1] += 3.0
    logits[..., BEAM_V - 2] += 2.5 * rng.random((b, t))
    x = logits - logits.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _assert_fused_states_equal(card, cpu):
    _assert_beam_states_equal(card.base, cpu.base)
    for f in ("ctx", "node", "wid", "hw_node"):
        if getattr(cpu, f) is not None:
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    for f in ("lm_sc", "hw_tent", "hw_bias"):
        if getattr(cpu, f) is not None:
            a, b = getattr(card, f).cpu(), getattr(cpu, f)
            fin = torch.isfinite(b)
            assert torch.equal(torch.isfinite(a), fin), f
            assert (a[fin] - b[fin]).abs().max().item() <= 1e-5, f


def test_fused_hash_products_on_card(cuda):
    """The 64-bit KenLM chain hash in two u32 limbs and the LM table
    bucket products: bit-equal on the card, the CPU and Python ints."""
    from tone_tpu_torch.decoding.kenlm_binary import combine_word_hash

    rng = np.random.default_rng(1)
    n = 1 << 14
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    wid = rng.integers(-1, 2**31 - 1, n)
    hi[:3], lo[:3], wid[:3] = [0, 2**32 - 1, 2**31], [0, 2**32 - 1, 1], [-1, 2**31 - 2, 0]
    args = [torch.from_numpy(x) for x in (hi, lo, wid)]
    card = BD._combine64(*(a.to(cuda) for a in args))
    cpu = BD._combine64(*args)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)
    for i in list(range(3)) + list(rng.integers(0, n, 200)):
        want = combine_word_hash((int(hi[i]) << 32) | int(lo[i]), int(wid[i]))
        assert (int(cpu[0][i]) << 32) | int(cpu[1][i]) == want
    h = torch.from_numpy(hi)
    assert torch.equal(BD._mul_u32(h.to(cuda), BD._FIB).cpu(), BD._mul_u32(h, BD._FIB))
    assert torch.equal(BD._as_i32(h.to(cuda)).cpu(), BD._as_i32(h))


@pytest.mark.parametrize("probing", [False, True], ids=["arpa", "probing"])
def test_lm_keys_above_2_31_on_card(cuda, tmp_path, probing):
    """Every gram of the LM is found on the card, whose int32 tables hold
    keys >= 2**31 as negative numbers; scores equal the CPU's bit for bit."""
    lm = _fused_lm(tmp_path, probing)
    keys1 = lm.keys1[lm.keys1 != 0xFFFFFFFF].astype(np.int64)
    keys2 = lm.keys2[lm.keys1 != 0xFFFFFFFF].astype(np.int64)
    assert (keys1 >= 2**31).any() and (keys2 >= 2**31).any()
    found, prob, bo = BD._lm_lookup(lm.arrays(cuda), torch.from_numpy(keys1).to(cuda),
                                    torch.from_numpy(keys2).to(cuda))
    assert bool(found.all())
    c_found, c_prob, c_bo = BD._lm_lookup(lm.arrays("cpu"), torch.from_numpy(keys1),
                                          torch.from_numpy(keys2))
    assert torch.equal(prob.cpu(), c_prob) and torch.equal(bo.cpu(), c_bo)
    rng = np.random.default_rng(2)
    n_ids = len(lm.uni_prob) if probing else lm.n_words
    ctx = torch.from_numpy(rng.integers(-1, n_ids, (64, 32, 2)))
    wid = torch.from_numpy(rng.integers(0, n_ids, (64, 32)))
    assert torch.equal(BD._lm_score(lm.arrays(cuda), ctx.to(cuda), wid.to(cuda)).cpu(),
                       BD._lm_score(lm.arrays("cpu"), ctx, wid))


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("probing", [False, True], ids=["arpa", "probing"])
def test_fused_beam_advance_on_card_matches_cpu(cuda, tmp_path, probing, hot):
    lm = _fused_lm(tmp_path, probing)
    lp = _fused_logprobs(7 + probing, 8, 96)
    lengths = np.array([96, 90, 64, 50, 33, 12, 1, 0])
    tables = BD.make_hotword_tables(["аб", "ви гд"], 4.0) if hot else None
    states = []
    for dev in (cuda, torch.device("cpu")):
        st = BD.init_fused_beam_state(8, 16, lm, 128, hotwords=tables, device=dev)
        st = BD.fused_beam_advance(st, lp[:, :40], lm.arrays(dev), np.minimum(lengths, 40),
                                   hotwords=tables)
        st = BD.fused_beam_advance(st, lp[:, 40:], lm.arrays(dev),
                                   np.clip(lengths - 40, 0, None), hotwords=tables)
        states.append(st)
    card, cpu = states
    assert card.lm_sc.device.type == cuda.type
    _assert_fused_states_equal(card, cpu)
    assert (cpu.ctx[..., -1] != lm.bos_id).any()    # words were completed
    _assert_nbest_close(BD.fused_beam_nbest(card, lm, 4), BD.fused_beam_nbest(cpu, lm, 4))


def test_fused_tie_order_on_card(cuda, tmp_path):
    """Uniform frames: every candidate ties, so only the stable order keeps
    card and CPU on the same beams, LM state included."""
    lm = _fused_lm(tmp_path, False)
    lp = np.full((4, 12, BEAM_V), -np.log(BEAM_V), np.float32)
    card = BD.fused_beam_advance(BD.init_fused_beam_state(4, 16, lm, 32, device=cuda), lp,
                                 lm.arrays(cuda))
    cpu = BD.fused_beam_advance(BD.init_fused_beam_state(4, 16, lm, 32), lp, lm.arrays("cpu"))
    _assert_fused_states_equal(card, cpu)


@pytest.mark.parametrize("probing", [False, True], ids=["arpa", "probing"])
def test_fused_decoder_on_card_matches_cpu(cuda, tmp_path, probing):
    from tone_tpu_torch.decoder import DeviceBeamSearchCTCDecoder

    lm = _fused_lm(tmp_path, probing)
    phrases = [_fused_logprobs(20 + i, 1, t)[0] for i, t in enumerate([40, 64, 100, 7])]
    rows = [BD.make_hotword_tables(["аб"]), None, None, BD.make_hotword_tables(["ви", "гд"])]
    card = DeviceBeamSearchCTCDecoder(lm, fusion=True, beam_width=16, device=cuda)
    cpu = DeviceBeamSearchCTCDecoder(lm, fusion=True, beam_width=16, device="cpu")
    for hot in (None, rows):
        got, want = card.forward_batch_nbest(phrases, 4, hot), cpu.forward_batch_nbest(phrases, 4, hot)
        _assert_nbest_close(got, want)
    assert card._cuda_stream is not None


# ---------------------------------------------------------------------------
# The bulk path: the full-sequence forward, the transcriber, greedy collapse
# and forced alignment, card against CPU.
# ---------------------------------------------------------------------------

from tone_tpu_torch.config import BLANK_ID, LABELS  # noqa: E402
from tone_tpu_torch.core.model import apply_offline  # noqa: E402
from tone_tpu_torch.offline import OfflineTranscriber  # noqa: E402
from tone_tpu_torch.ops import align_device  # noqa: E402
from tone_tpu_torch.ops.greedy import greedy_collapse_tokens  # noqa: E402


def _tiny_bf16():
    cfg = ToneConfig(encoder=EncoderConfig(**TINY))
    gen = torch.Generator().manual_seed(1)
    return cfg, _perturbed(init_model_params(gen, cfg), gen)


@pytest.mark.parametrize("blocked", [True, False])
def test_tiny_apply_offline_on_card_matches_cpu(cuda, blocked):
    """The bf16 full-sequence forward (B1 on the card, its plain version on
    the CPU) with ragged lengths, within the bf16 step's 0.1."""
    from tone_tpu_torch.acoustic import cast_params_for_inference
    from tone_tpu_torch.bridge import to_device

    cfg, variables = _tiny_bf16()
    cast = cast_params_for_inference(variables, cfg)
    wav = torch.from_numpy(np.random.default_rng(2).integers(
        -20000, 20000, (3, 2400 * 5 + 313)).astype(np.int32))
    lens = torch.tensor([wav.shape[1], 9000, 3000], dtype=torch.int32)
    before = glu_ff2.launches
    lg, ng, _ = apply_offline(to_device(cast, cuda), cfg, wav.to(cuda), lens.to(cuda),
                              blocked_attention=blocked)
    torch.cuda.synchronize()
    assert glu_ff2.launches == before + 2 * cfg.encoder.n_layers
    lc, nc, _ = apply_offline(cast, cfg, wav, lens, blocked_attention=blocked)
    assert ng.cpu().tolist() == nc.tolist()
    for row, n in enumerate(nc.tolist()):
        assert (lg[row, :n].cpu() - lc[row, :n]).abs().max().item() < 0.1


@pytest.mark.parametrize("offline_forward", [False, True])
def test_tiny_transcriber_on_card_matches_cpu(cuda, offline_forward):
    cfg, variables = _tiny_bf16()
    rng = np.random.default_rng(3)
    audios = [rng.integers(-20000, 20000, n).astype(np.int32) for n in (5000, 7200, 1200)]
    card, cpu = (OfflineTranscriber(variables, cfg, batch_size=2, device=dev,
                                    use_offline_forward=offline_forward)
                 for dev in (cuda, "cpu"))
    for g, c in zip(card.logprobs(audios), cpu.logprobs(audios)):
        assert g.shape == c.shape and np.abs(g - c).max() < 0.1
    phrases = card.transcribe(audios)
    assert len(phrases) == 3 and all(phrases)


def _tied_logprobs(seed, b=4, t=300):
    """Logprobs on a coarse grid with whole flat frames: exact ties."""
    rng = np.random.default_rng(seed)
    lp = np.round(rng.normal(0.0, 1.0, (b, t, len(LABELS) + 1)) * 2) / 2
    lp[:, ::7] = -1.0
    lp[:, 3::11, BLANK_ID] = lp[:, 3::11].max(-1)
    return torch.from_numpy(lp.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_collapse_on_card_matches_cpu(cuda, seed):
    lp = _tied_logprobs(seed)
    tg, kg = greedy_collapse_tokens(lp.to(cuda))
    tc, kc = greedy_collapse_tokens(lp)
    assert torch.equal(tg.cpu(), tc) and torch.equal(kg.cpu(), kc)


def test_viterbi_paths_on_card_match_cpu(cuda):
    """Every bucket's best paths equal the CPU's, element for element, on
    random phrases, a flat (all-tie) phrase and tied grid values."""
    from tone_tpu_torch.decoder import GreedyCTCDecoder

    rng = np.random.default_rng(4)
    lps = []
    for t in (12, 30, 75, 140, 300, 700):
        logits = rng.normal(0, 2.5, (t, len(LABELS) + 1))
        lps.append((logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32))
    lps += [np.full((40, len(LABELS) + 1), -np.log(35.0), np.float32),
            _tied_logprobs(5, b=1, t=90)[0].numpy()]
    host = GreedyCTCDecoder()
    texts = [host.forward(lp) for lp in lps[:-2]] + ["аа бв", host.forward(lps[-1])]
    exts, groups = align_device._bucket_groups(lps, texts)
    for (t_pad, s_pad), idxs in groups.items():
        staged = align_device._stage_bucket(lps, exts, idxs, t_pad, s_pad)
        pg, sg = align_device._viterbi_path(*(torch.from_numpy(a).to(cuda) for a in staged))
        pc, sc = align_device._viterbi_path(*(torch.from_numpy(a) for a in staged))
        assert torch.equal(pg.cpu(), pc)
        assert torch.allclose(sg.cpu(), sc, rtol=1e-6)
    assert align_device.align_words_batch(lps, texts, device=cuda) == \
        align_device.align_words_batch(lps, texts, device="cpu")
