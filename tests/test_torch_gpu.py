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
# 16 x 2080 and 16 x 1040 rows, the step at B = 512 ... 1280 and the
# 1,024-slot tick (10 B full-rate and 5 B reduced rows: 5,120 to 12,800), and
# the tiny widths of the CPU tests (D = 64 is one ragged column tile).
@pytest.mark.parametrize("f, d", [(F, D), (128, 64), (256, 128)])
@pytest.mark.parametrize("m", [33280, 16640, 12800, 10240, 8448, 6400, 5120, 2560, 1280, 640,
                               320, 160, 80, 37, 10, 1])
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


def _tiny_bf16(chunk_ms: int = 300):
    cfg = ToneConfig(encoder=EncoderConfig(**TINY)).with_chunk_duration_ms(chunk_ms)
    gen = torch.Generator().manual_seed(1)
    return cfg, _perturbed(init_model_params(gen, cfg), gen)


@pytest.mark.parametrize("chunk_ms", [300, 400], ids=["blocked", "fractional"])
def test_tiny_apply_offline_on_card_matches_cpu(cuda, chunk_ms):
    """The bf16 full-sequence forward (B1 on the card, its plain version on
    the CPU) with ragged lengths, within the bf16 step's 0.1, with windows
    of whole chunks (300 ms) and not (400 ms)."""
    from tone_tpu_torch.acoustic import cast_params_for_inference
    from tone_tpu_torch.bridge import to_device

    cfg, variables = _tiny_bf16(chunk_ms)
    cast = cast_params_for_inference(variables, cfg)
    wav = torch.from_numpy(np.random.default_rng(2).integers(
        -20000, 20000, (3, 2400 * 5 + 313)).astype(np.int32))
    lens = torch.tensor([wav.shape[1], 9000, 3000], dtype=torch.int32)
    before = glu_ff2.launches
    lg, ng, _ = apply_offline(to_device(cast, cuda), cfg, wav.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    assert glu_ff2.launches == before + 2 * cfg.encoder.n_layers
    lc, nc, _ = apply_offline(cast, cfg, wav, lens)
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


def test_staging_ring_on_card_waits_for_its_upload(cuda):
    """A staging buffer taken again while its upload still waits behind a
    sleeping kernel: ``take`` returns only once the upload is done, so the
    device receives the first contents."""
    from tone_tpu_torch.device import record_event
    from tone_tpu_torch.offline import _HostRing

    ring = _HostRing(pinned=True)
    first = ring.take(0, 1 << 20, torch.int16)
    first.copy_(torch.arange(1 << 20, dtype=torch.int32).to(torch.int16))
    torch.cuda._sleep(200_000_000)   # about 0.1 s at the card's clocks
    sent = first.to(cuda, non_blocking=True)
    events = record_event(cuda)
    ring.guard(0, events)
    assert not events[0].query()     # still queued behind the sleep
    again = ring.take(0, 1 << 20, torch.int16)
    assert events[0].query() and again.data_ptr() == first.data_ptr()
    again.fill_(-1)
    torch.cuda.synchronize()
    assert torch.equal(sent.cpu(), torch.arange(1 << 20, dtype=torch.int32).to(torch.int16))


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_staged_assembly_on_card_equals_the_host_padded_one(cuda, dtype):
    """Two different jobs back to back, twice, with every forward behind a
    sleeping kernel, so that the host refills the staging and logprob rings
    while the card still has earlier batches queued: the logprobs and texts
    equal the synchronous host-padded assembly's bit for bit, and the second
    pass allocates no buffer."""
    from offline_assembly_reference import use_reference_assembly

    cfg, variables = _tiny_bf16()
    rng = np.random.default_rng(5)
    jobs = [[rng.integers(-20000, 20000, n).astype(dtype) for n in lengths]
            for lengths in ((5000, 7200, 1200, 30000, 16000), (2000, 41000, 9000, 12000))]
    card, ref = (OfflineTranscriber(variables, cfg, batch_size=2, device=cuda,
                                    use_offline_forward=True) for _ in range(2))
    use_reference_assembly(ref)
    forward = card._offline_forward

    def slowed(variables, chunks):
        torch.cuda._sleep(20_000_000)
        return forward(variables, chunks)
    card._offline_forward = slowed

    def one_pass():
        for job in jobs:
            for got, want in zip(card.logprobs(job), ref.logprobs(job)):
                assert got.shape == want.shape and np.array_equal(got, want)
            texts = [[p.text for p in u] for u in card.transcribe(job)]
            assert texts == [[p.text for p in u] for u in ref.transcribe(job)]

    one_pass()
    t0 = time.monotonic_ns()
    with profiling.record():
        one_pass()
    counts = [e for e in profiling.events(t0, time.monotonic_ns())
              if isinstance(e, profiling.Count) and e.name == "offline.staging_allocs"]
    assert counts == []


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


# ---------------------------------------------------------------------------
# Training: the train step, remat and the CTC loss, card against CPU.
# ---------------------------------------------------------------------------

from tone_tpu_torch.bridge import tree_leaves  # noqa: E402
from tone_tpu_torch.training import (  # noqa: E402
    DataCollatorCTCWithPadding,
    Trainer,
    TrainerConfig,
    ctc_loss,
)


def _tiny_training(dtype="float32", dropout=0.0):
    cfg = ToneConfig(encoder=EncoderConfig(**dict(TINY, dropout=dropout, dropout_att=dropout)),
                     compute_dtype=dtype)
    gen = torch.Generator().manual_seed(2)
    variables = _perturbed(init_model_params(gen, cfg), gen)
    rng = np.random.default_rng(5)
    batch = DataCollatorCTCWithPadding()(
        [{"input_values": rng.normal(0, 0.1, n).astype(np.float32), "labels": t}
         for n, t in ((4000, "да нет"), (6500, "привет мир"), (2400, "ёж"))])
    return cfg, variables, batch


def _flat(tree):
    return torch.cat([t.detach().float().cpu().reshape(-1) for t in tree_leaves(tree)])


# float32: both devices run float32 products (no TF32), so they differ by
# summation order; bf16: by bf16 roundings, as the bf16 step (0.1 on logprobs).
TRAIN_TOLS = {"float32": (1e-4, 0.99999, 1e-4), "bfloat16": (1e-2, 0.999, 1e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_train_step_on_card_matches_cpu(cuda, dtype):
    """Loss (relative), the cosine of the flattened gradients and the
    updated BatchNorm statistics (absolute), then one train_step each."""
    loss_tol, cos_min, stats_tol = TRAIN_TOLS[dtype]
    cfg, variables, batch = _tiny_training(dtype)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        trainer = Trainer(cfg, TrainerConfig(total_steps=10, learning_rate=1e-3), device=dev)
        state = trainer.create_state(variables)
        loss, grads, stats = trainer.compute_gradients(state, batch)
        state, step_loss = trainer.train_step(state, batch)
        assert state.step == 1 and float(step_loss) == float(loss)
        out[dev.type] = (float(loss), _flat(grads), _flat(stats))
    (lg, gg, sg), (lc, gc, sc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= loss_tol * abs(lc)
    assert torch.nn.functional.cosine_similarity(gg.double(), gc.double(), dim=0).item() \
        >= cos_min
    assert (sg - sc).abs().max().item() <= stats_tol


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_on_card_matches_no_remat(cuda, remat, monkeypatch):
    """With dropout on: the recomputed forward draws the same masks, so the
    loss agrees within 1e-5 (relative) and the gradients within 1e-6 of
    their norm, under cuDNN's deterministic algorithms (its default
    convolution backward adds in a varying order: about 3e-5 at full width,
    dev/torch_train_remat_noise.py)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg, variables, batch = _tiny_training(dropout=0.1)
    out = {}
    for policy in (None, remat):
        trainer = Trainer(cfg, TrainerConfig(remat=policy), device=cuda)
        loss, grads, _ = trainer.compute_gradients(trainer.create_state(variables), batch,
                                                   seed=11)
        out[policy] = (float(loss), _flat(grads))
    (l0, g0), (l1, g1) = out[None], out[remat]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert (g1 - g0).norm().item() <= 1e-6 * g0.norm().item()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_on_card_matches_cpu(cuda, reduction):
    """Loss within 1e-5 relative and the logits' gradient within 3e-5 of its
    largest value, with a row whose target is longer than its output (0 in
    both, gradient 0)."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(0, 2, (4, 40, 35)).astype(np.float32))
    lens = torch.tensor([40, 31, 20, 2], dtype=torch.int32)
    labels = torch.full((4, 8), -100, dtype=torch.int32)
    labels[0, :5] = torch.tensor([1, 2, 3, 4, 5])
    labels[1, :3] = torch.tensor([6, 7, 8])
    labels[2, :2] = torch.tensor([9, 9])
    labels[3, :3] = torch.tensor([1, 2, 3])
    weights = torch.linspace(0.5, 1.5, 4)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        lg = logits.to(dev).requires_grad_(True)
        loss = ctc_loss(torch.log_softmax(lg, -1), lens.to(dev), labels.to(dev),
                        blank_id=BLANK_ID, reduction=reduction)
        val = (loss * weights.to(dev)).sum() if reduction == "none" else loss
        (grad,) = torch.autograd.grad(val, lg)
        out[dev.type] = (loss.detach().cpu(), grad.cpu())
    (vg, gg), (vc, gc) = out["cuda"], out["cpu"]
    assert torch.allclose(vg, vc, rtol=1e-5, atol=0)
    assert (gg - gc).abs().max().item() <= 3e-5 * gc.abs().max().item()
    assert torch.all(gg[3] == 0) and torch.all(gc[3] == 0)


# ---------------------------------------------------------------------------
# Model artifacts: from_local and the exported step on the card.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["model.safetensors", "model.bin", "model"])
def test_from_local_on_card_is_bit_equal_to_direct(cuda, tmp_path, fmt):
    """A loaded artifact gives the directly built model's logprobs to the bit,
    with B1 twice per layer and step."""
    from tone_tpu_torch.checkpoint import save_checkpoint
    from tone_tpu_torch.interop import save_torch_checkpoint, to_torch_state_dict

    cfg, variables = _tiny_bf16()
    path = tmp_path / fmt
    if fmt == "model":
        save_checkpoint(path, variables, cfg)
    elif fmt.endswith(".bin"):
        torch.save(to_torch_state_dict(variables, cfg), path)
    else:
        save_torch_checkpoint(path, variables, cfg, prefix="tone.")
    loaded = StreamingCTCModel.from_local(path, config=None if fmt == "model" else cfg)
    assert loaded.device.type == "cuda"
    direct = StreamingCTCModel(variables, cfg, device=cuda)
    wav = np.random.default_rng(3).integers(-20000, 20000, (3, 2400 * 3)).astype(np.int32)
    sl = sd = None
    for i in range(3):
        chunk = wav[:, i * 2400:(i + 1) * 2400]
        before = glu_ff2.launches
        ll, sl = loaded.forward_native(chunk, sl)
        torch.cuda.synchronize()
        assert glu_ff2.launches == before + 2 * cfg.encoder.n_layers
        ld, sd = direct.forward_native(chunk, sd)
        assert torch.equal(ll, ld)


def test_from_hugging_face_on_card_launches_b1_32_times_per_step(cuda, tmp_path):
    """``from_hugging_face()`` (the full-width default config) from a local
    endpoint lands on the card, gives the directly built model's logprobs
    to the bit, and launches B1 twice per layer and step."""
    from tone_tpu_torch.dev.local_hub import LocalHub, hub_env
    from tone_tpu_torch.hub import TONE_REPO
    from tone_tpu_torch.interop import save_torch_checkpoint

    cfg = ToneConfig()
    variables = init_model_params(torch.Generator().manual_seed(0), cfg)
    save_torch_checkpoint(tmp_path / "model.safetensors", variables, cfg)
    with LocalHub({TONE_REPO: {"model.safetensors":
                               (tmp_path / "model.safetensors").read_bytes()}}) as local, \
            hub_env(HF_ENDPOINT=local.url, HF_HOME=tmp_path / "hf"):
        model = StreamingCTCModel.from_hugging_face()
    assert model.device.type == "cuda" and model.config == cfg
    direct = StreamingCTCModel(variables, cfg, device=cuda)
    wav = np.random.default_rng(4).integers(-20000, 20000, (2, 2400 * 3)).astype(np.int32)
    sm = sd = None
    for i in range(3):
        chunk = wav[:, i * 2400:(i + 1) * 2400]
        before = glu_ff2.launches
        lm, sm = model.forward_native(chunk, sm)
        torch.cuda.synchronize()
        assert glu_ff2.launches == before + 2 * cfg.encoder.n_layers == before + 32
        ld, sd = direct.forward_native(chunk, sd)
        assert torch.equal(lm, ld)


def test_exported_program_on_card_equals_eager(cuda, tmp_path):
    """The exported bf16 step runs kernel B1 (the registered op's CUDA
    kernel, twice per layer and step; never the plain version) and gives
    the eager step's logprobs and state to the bit."""
    from tone_tpu_torch.export import export_streaming, load_exported

    cfg, variables = _tiny_bf16()
    model = StreamingCTCModel(variables, cfg, device=cuda)
    (path,) = export_streaming(model.variables, cfg, [3], tmp_path)
    fn = load_exported(path)
    wav = np.random.default_rng(4).integers(-20000, 20000, (3, 2400 * 3)).astype(np.int32)
    se, sx = model.init_state(3), model.init_state(3)
    for i in range(3):
        chunk = torch.from_numpy(wav[:, i * 2400:(i + 1) * 2400]).to(cuda)
        le, se = model.forward_native(chunk, se)
        before = glu_ff2.launches
        lx, sx = fn(model.variables, chunk, sx)
        torch.cuda.synchronize()
        assert glu_ff2.launches == before + 2 * cfg.encoder.n_layers
        assert torch.equal(lx, le)
    assert torch.equal(sx.encoder.conv, se.encoder.conv)
    assert torch.equal(sx.encoder.mhsa, se.encoder.mhsa)


def _engine_finals(engine, seed=7):
    """Three clips of three chunks through ``engine``: each stream's finals."""
    rng = np.random.default_rng(seed)
    clips = [rng.integers(-20000, 20000, 2400 * 3).astype(np.int32) for _ in range(3)]
    sids = [engine.open_stream() for _ in clips]
    for sid, clip in zip(sids, clips):
        for i in range(3):
            engine.feed(sid, clip[i * 2400:(i + 1) * 2400])
        engine.close_stream(sid)
    finals = {sid: [] for sid in sids}
    for _ in range(5):
        for sid, futures in engine.tick().items():
            finals[sid].extend((p.text, p.start_time, p.end_time)
                               for p in (f.result(timeout=60) for f in futures))
    engine.shutdown()
    return [finals[sid] for sid in sids]


def test_tiny_data_parallel_on_two_replicas_of_the_card_matches_one_device(cuda):
    """Bulk (both forwards) and serving split over ``[cuda:0, cuda:0]``: the
    texts, times and finals of one device, with B1 launched on both
    replicas."""
    from tone_tpu_torch.parallel.mesh import arena_shardings, make_mesh
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    cfg, variables = _tiny_bf16()
    mesh = make_mesh(devices=[cuda, cuda])
    rng = np.random.default_rng(3)
    audios = [rng.integers(-20000, 20000, n).astype(np.int32) for n in (5000, 7200, 1200)]
    for offline_forward in (False, True):
        split, one = (OfflineTranscriber(variables, cfg, batch_size=4, mesh=m, device=d,
                                         use_offline_forward=offline_forward)
                      for m, d in ((mesh, None), (None, cuda)))
        before = glu_ff2.launches
        got = [[(p.text, p.start_time, p.end_time) for p in u] for u in split.transcribe(audios)]
        torch.cuda.synchronize()
        chunk = cfg.audio_chunk_samples
        columns = -(-max(-(-(len(a) + 2 * cfg.padding) // chunk) for a in audios) // 8) * 8
        per_replica = 2 * cfg.encoder.n_layers * (1 if offline_forward else columns)
        assert glu_ff2.launches - before == 2 * per_replica
        assert got == [[(p.text, p.start_time, p.end_time) for p in u]
                       for u in one.transcribe(audios)]
    sharded = MultiStreamEngine(variables, cfg, n_slots=4,
                                sharding=arena_shardings(mesh, cfg, 4))
    assert _engine_finals(sharded) == _engine_finals(
        MultiStreamEngine(variables, cfg, n_slots=4, device=cuda))


# ---------------------------------------------------------------------------
# The recipes on a trained model (tone_tpu_torch/examples/train_tiny_e2e.py,
# tone_tpu_torch/dev/beam_quality_sweep.py): the pins of
# tests/test_e2e_synthetic.py, which the CPU suite never runs.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_trained():
    """The tiny model trained 150 steps from seed 0 on the card (float32):
    (config, trainer, state, collator, items)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none here)")
    from tone_tpu_torch.examples.train_tiny_e2e import run_training

    return run_training(steps=150, device="cuda")


def test_tiny_train_then_stream_is_exact_on_card(tiny_trained):
    """Train WER < 0.05 and at least 5 of 6 exact streaming transcripts."""
    from tone_tpu_torch.examples.train_tiny_e2e import (
        EVAL_ITEMS,
        deploy,
        stream_texts,
        trained_variables,
    )

    cfg, trainer, state, collator, items = tiny_trained
    batch = collator([{"input_values": it["audio"], "labels": it["text"]} for it in items])
    wer = trainer.eval_wer(state, [batch], [it["text"] for it in items])
    assert wer < 0.05, wer
    checked = items[:EVAL_ITEMS]
    texts = stream_texts(deploy(cfg, trained_variables(state), "cuda"), checked)
    hits = sum(t == it["text"] for t, it in zip(texts, checked))
    assert hits >= len(checked) - 1, list(zip(texts, [it["text"] for it in checked]))


def test_device_beam_agrees_with_host_beam_on_trained_model_on_card(tiny_trained):
    """The device search at width 32 (n-best 8 rescored) agrees with the
    host width-200 fusion on at least 95 % of noisy utterances."""
    from tone_tpu_torch.dev.beam_quality_sweep import host_agreement
    from tone_tpu_torch.examples.train_tiny_e2e import trained_variables

    cfg, _, state, _, _ = tiny_trained
    agree, dev_out, host_out = host_agreement(cfg, trained_variables(state), device="cuda")
    assert agree >= 0.95, (agree, list(zip(dev_out, host_out)))


def test_tick_at_256_slots_launches_b1_32_times_per_tick(cuda):
    """The tick bench's engine at full width and 256 slots: every tick (the
    warmup tick too) launches the GLU kernel once per feed-forward."""
    from tone_tpu_torch.dev.tick_bench import bench

    before = glu_ff2.launches
    report = bench(slots=256, ticks=5, device="cuda")
    assert glu_ff2.launches - before == 32 * (5 + 1)
    assert report["slots"] == 256 and report["tick_ms_p50"] > 0
    assert report["state_bytes_per_slot"] > 0 and report["power_limit"].endswith("W")


def test_bench_prints_one_json_line_naming_the_card(cuda):
    """``python -m tone_tpu_torch.bench``: the sweep, then one JSON line
    with the JAX bench's keys and the card's name and power limit."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-m", "tone_tpu_torch.bench"],
                          cwd=Path(__file__).resolve().parent.parent, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["device"] == torch.cuda.get_device_name(0) and line["power_limit"].endswith("W")
    assert line["value"] > 0


# ---------------------------------------------------------------------------
# The 16-bit products and convolutions of core/layers.py on the tensor cores,
# against the widened float32 product of the same bf16 operands (TF32 off,
# as resolve_device leaves the process), at the bulk forward's shapes and a
# tiny one.  The two differ by the order of their float32 sums, at most
# 2^-20 x sum |a * b| here, and then by one bf16 ulp at each rounding.
# ---------------------------------------------------------------------------

import time  # noqa: E402

from tone_tpu_torch import profiling  # noqa: E402
from tone_tpu_torch.acoustic import cast_params_for_inference  # noqa: E402
from tone_tpu_torch.core import layers as L  # noqa: E402
from tone_tpu_torch.core.frontend import get_frontend_constants, log_mel_offline  # noqa: E402
from tone_tpu_torch.device import resolve_device  # noqa: E402
from test_torch_products import _analytic_macs, one_channel_macs  # noqa: E402

SUM_ORDER = 2.0 ** -20


@pytest.fixture
def card(cuda):
    return resolve_device(cuda)


def _bf16_spacing(t: torch.Tensor) -> torch.Tensor:
    """The gap between neighbouring bf16 values at |t| (8 significant bits)."""
    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _rand(dev, shape, seed, scale=1.0, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, device=dev, generator=gen) * scale).to(dtype)


# (rows, K, N): the bulk forward's feed-forward in-projections (lin12),
# q/k/v/out and the conv module's pointwise products at the full and the
# reduced rate, the reduction's pointwise product, the subsampling's output
# (no bias) and the float32 CTC head on bf16 serving weights; and a tiny one.
LINEAR_SHAPES = [(33280, 384, 3072), (16640, 384, 3072), (33280, 384, 384), (33280, 384, 768),
                 (16640, 1536, 384), (33280, 2176, 384), (33280, 384, 35), (7, 24, 10)]


@pytest.mark.parametrize("mode", ["bias", "no_bias", "reduce"])
@pytest.mark.parametrize("m, k, n", LINEAR_SHAPES)
def test_linear_on_tensor_cores_matches_widened(card, m, k, n, mode):
    compute = torch.float32 if n == 35 else torch.bfloat16
    x = _rand(card, (16, m // 16, k) if m > 16 else (m, k), seed=m + k)
    p = {"w": _rand(card, (k, n), seed=n, scale=k ** -0.5)}
    if mode != "no_bias":
        p["b"] = _rand(card, (n,), seed=1, scale=0.1, dtype=torch.float32)
    reduce = (lambda y: 2 * y) if mode == "reduce" else None
    with torch.no_grad():
        got = L.linear(p, x, compute, reduce)
        s = torch.matmul(x.float(), p["w"].float())
        s = 2 * s if reduce else s
        want = (s + p["b"] if "b" in p else s).to(compute)
        scale = torch.matmul(x.float().abs(), p["w"].float().abs()) * (2 if reduce else 1)
    torch.cuda.synchronize()
    assert got.dtype == compute and got.shape == want.shape
    gap = (got.float() - want.float()).abs()
    allowed = SUM_ORDER * scale
    if compute == torch.bfloat16:
        allowed = allowed + _bf16_spacing(torch.maximum(got.float().abs(), want.float().abs()))
    assert bool((gap <= allowed).all()), float((gap - allowed).max())


def test_linear_with_autograd_on_stays_widened_on_card(card):
    """Autograd recording (the training forward): the widened product, to
    the bit."""
    x = _rand(card, (4, 100, 384), seed=3).requires_grad_(True)
    p = {"w": _rand(card, (384, 768), seed=4, scale=0.05), "b": _rand(card, (768,), 5,
                                                                       dtype=torch.float32)}
    got = L.linear(p, x)
    assert got.requires_grad
    want = (torch.matmul(x.detach().float(), p["w"].float()) + p["b"]).to(torch.bfloat16)
    assert torch.equal(got.detach(), want)


# The score and context products of mhsa (B, H, Tq, dh) x (B, H, dh, Tkv) and
# of mhsa_blocked (B, H, n, c, dh) x (B, H, n, dh, w + c) at the bulk
# forward's 16 rows, 8 heads of 48 and 208 chunks, as the layers call them:
# against the key's transposed view, the weights rounded to bf16.
PRODUCT_SHAPES = {"mhsa": ((2, 8, 10, 48), (2, 8, 40, 48)),
                  "blocked_full": ((16, 8, 208, 10, 48), (16, 8, 208, 10, 48)),
                  "blocked_full_ctx": ((16, 8, 208, 10, 48), (16, 8, 208, 40, 48)),
                  "blocked_reduced_ctx": ((16, 8, 104, 5, 48), (16, 8, 104, 20, 48)),
                  "tiny": ((1, 2, 3, 4, 8), (1, 2, 3, 8, 8))}


@pytest.mark.parametrize("case", sorted(PRODUCT_SHAPES))
def test_attention_products_on_tensor_cores_match_widened(card, case):
    qs, ks = PRODUCT_SHAPES[case]
    q, k = _rand(card, qs, seed=6), _rand(card, ks, seed=7)
    with torch.no_grad():
        scores = L._mm(q, k.transpose(-1, -2))
        want = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scale = torch.matmul(q.float().abs(), k.float().abs().transpose(-1, -2))
        assert scores.dtype == torch.float32
        assert bool(((scores - want).abs() <= SUM_ORDER * scale).all())

        attn = torch.softmax(want, dim=-1).to(torch.bfloat16)
        ctx = L._mm(attn, k).to(torch.bfloat16)
        s = torch.matmul(attn.float(), k.float())
        want_ctx = s.to(torch.bfloat16)
        allowed = (SUM_ORDER * torch.matmul(attn.float(), k.float().abs())
                   + _bf16_spacing(torch.maximum(ctx.float().abs(), want_ctx.float().abs())))
    assert bool(((ctx.float() - want_ctx.float()).abs() <= allowed).all())


# (kind, input, weights, stride, groups): the subsampling's two convolutions
# (the first, of one input channel, on its widened path),
# the conv module's depthwise convolution at the full and reduced rate, the
# temporal reduction's strided one (4 outputs per channel), and tiny ones.
CONV_CASES = {"sub_conv1": ("2d", (16, 1, 6250, 64), (32, 1, 11, 21), (1, 1), 1),
              "sub_conv2": ("2d", (16, 32, 6250, 44), (64, 32, 11, 11), (3, 1), 1),
              "depthwise_full": ("1d", (16, 2110, 384), (384, 1, 31), 1, 384),
              "depthwise_reduced": ("1d", (16, 1070, 384), (384, 1, 31), 1, 384),
              "reduction_strided": ("1d", (16, 2081, 384), (1536, 1, 3), 2, 384),
              "tiny_2d": ("2d", (2, 8, 20, 16), (4, 8, 5, 3), (2, 1), 1),
              "tiny_one_channel_strided": ("2d", (2, 1, 20, 16), (4, 1, 5, 3), (2, 3), 1),
              "tiny_depthwise": ("1d", (2, 19, 8), (8, 1, 3), 1, 8)}


def _conv(kind, x, w, stride, groups):
    if kind == "2d":
        return torch.nn.functional.conv2d(x, w, stride=stride)
    return torch.nn.functional.conv1d(x.transpose(1, 2), w, stride=stride,
                                      groups=groups).transpose(1, 2)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolutions_on_tensor_cores_match_widened(card, case):
    """The reference's two roundings: the convolution's, then the sum with
    the float32 bias's."""
    kind, xs, ws, stride, groups = CONV_CASES[case]
    x = _rand(card, xs, seed=8)
    p = {"w": _rand(card, ws, seed=9, scale=(ws[1] * ws[2] * (ws[3] if kind == "2d" else 1))
                    ** -0.5),
         "b": _rand(card, (ws[0],), seed=10, scale=0.1, dtype=torch.float32)}
    shape = (1, -1, 1, 1) if kind == "2d" else (-1,)
    with torch.no_grad():
        got = (L.conv2d(p, x, stride) if kind == "2d"
               else L.conv1d_nhc(p, x, stride=stride, groups=groups))
        c = _conv(kind, x.float(), p["w"].float(), stride, groups)
        want = (c.to(torch.bfloat16).float() + p["b"].reshape(shape)).to(torch.bfloat16)
        allowed = (SUM_ORDER * _conv(kind, x.float().abs(), p["w"].float().abs(), stride, groups)
                   + _bf16_spacing(c)
                   + _bf16_spacing(torch.maximum(got.float().abs(), want.float().abs())))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(((got.float() - want.float()).abs() <= allowed).all())


def test_tiny_offline_forward_on_card_counts_its_products_on_tensor_cores(card):
    """Under ``profiling.record()`` a bf16 inference forward on the card
    counts every multiply-add as ``layers.tc_macs`` (the analytic count of
    tests/test_torch_products.py) but the one-input-channel convolution's,
    which stays widened; a training forward counts none there.  The card's
    torch has the bf16 products with a float32 result."""
    assert L._PRODUCTS_TO_FLOAT32
    cfg, variables = _tiny_bf16()
    cast = to_device(cast_params_for_inference(variables, cfg), card)
    wav = torch.from_numpy(np.random.default_rng(2).integers(
        -20000, 20000, (2, 2400 * 5 + 313)).astype(np.int32)).to(card)

    def counts(fn):
        t0 = time.monotonic_ns()
        with profiling.record():
            fn()
            torch.cuda.synchronize()
        out: dict = {}
        for ev in profiling.events(t0, time.monotonic_ns()):
            if isinstance(ev, profiling.Count) and ev.name.startswith("layers."):
                out[ev.name] = out.get(ev.name, 0) + ev.n
        return out

    inference = counts(lambda: apply_offline(cast, cfg, wav))
    feats, _ = log_mel_offline(wav.float(), None, get_frontend_constants(cfg.frontend, card))
    t_feat = feats.shape[1]
    total = _analytic_macs(cfg, wav.shape[0], t_feat, b1=True)
    widened = one_channel_macs(cfg, wav.shape[0], t_feat)
    assert inference == {"layers.tc_macs": total - widened, "layers.widened_macs": widened}

    train_vars = to_device(variables, card)
    train = counts(lambda: apply_offline(train_vars, cfg, wav.float() / 32767, training=True))
    assert "layers.tc_macs" not in train and train["layers.widened_macs"] > 0
