"""The port's training path (tone_tpu_torch/training: ``ctc_loss``, the
collator, the optimizer and ``Trainer``; the train-mode forward of
core/model.py ``apply_offline``; dropout) against the JAX package on the
same numpy-made weights, batches and gradients.

Tolerances:
* ``ctc_loss``: 1e-5 relative on the loss, 3e-5 × the largest |g| on the
  gradient with respect to the logits (float32; both run the same dynamic
  programme over 25 frames, summed in another order);
* collator and ``tokenize_text``: equal arrays;
* train-mode forward, float32, dropout 0: 1e-4 on logprobs (the offline
  forward's bound, tests/test_torch_offline.py), 1e-5 on the updated
  BatchNorm statistics;
* parameter gradients of ``ctc_loss ∘ apply_offline``, float32: 1e-4 × the
  leaf's largest |g|.  The biases of the convolutions that feed a
  training-mode BatchNorm have an exact gradient of 0 (the batch mean
  removes them), so both packages give rounding noise there: those are
  held to 1e-4 × the largest |g| of the whole tree;
* the 400 ms geometry (windows that are not whole chunks), the port
  against the JAX masked form in train mode: 2e-3 on gradients
  (tests/test_encoder_blocked.py's bound between the JAX package's two
  forms);
* bf16 train-mode forward against the JAX default: 0.05 on logprobs (the
  bf16 step's bound, tests/test_torch_model.py) and 2e-2 relative on the
  statistics (a few bf16 roundings of the convolution outputs);
* optimizer fed the same gradients: 1e-6 relative to the largest update;
  the second update of ``make_optimizer(TrainerConfig(total_steps=4))``
  within 2e-5 of its exact-arithmetic value (float32's 0.999 moves Adam's
  bias correction by 1e-5 in both packages);
* ``Trainer`` against JAX's over 4 steps (the first at lr 0): loss within
  1e-5 relative while the parameters are the same, 1e-4 after updates;
  every parameter within 2 × the summed lr and 99 % of them within 0.01 ×
  it (Adam turns rounding noise in a gradient that is exactly 0, as the
  biases that feed a BatchNorm have, into full-size steps); running
  statistics within 0.25 × the summed lr;
* accumulation against one macro-batch step: the same parameter bounds;
* remat modes and save/restore on the CPU: equal to the bit.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_common import TINY_ENCODER, tiny_variables_with_stats

import tone_tpu.config as jcfg
import tone_tpu.training as JTR
from tone_tpu.core import model as JM
from tone_tpu.parallel.mesh import make_mesh
from tone_tpu.training import train as JTRAIN
import tone_tpu_torch.config as tcfg
import tone_tpu_torch.training as TTR
from tone_tpu_torch.bridge import from_jax_variables, tree_leaves
from tone_tpu_torch.core import encoder as TE
from tone_tpu_torch.core import layers as TL
from tone_tpu_torch.core import model as TM
from tone_tpu_torch.training import train as TTRAIN

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
from train_tiny_e2e import tiny_config  # noqa: E402

BLANK = 34


def _configs(dtype="float32", dropout=0.0, chunk_ms=300):
    enc = dict(TINY_ENCODER, dropout=dropout, dropout_att=dropout)
    return (jcfg.ToneConfig(encoder=jcfg.EncoderConfig(**enc),
                            compute_dtype=dtype).with_chunk_duration_ms(chunk_ms),
            tcfg.ToneConfig(encoder=tcfg.EncoderConfig(**enc),
                            compute_dtype=dtype).with_chunk_duration_ms(chunk_ms))


@functools.lru_cache(maxsize=None)
def _models(dtype="float32", dropout=0.0, chunk_ms=300):
    jc, tc = _configs(dtype, dropout, chunk_ms)
    jv, tv = tiny_variables_with_stats(jc, tc)
    return jc, tc, jv, tv


def _features(seed=0, lengths=(4000, 6000, 2500), texts=("да нет", "привет мир", "ёж")):
    rng = np.random.default_rng(seed)
    return [{"input_values": rng.normal(0, 0.1, n).astype(np.float32), "labels": t}
            for n, t in zip(lengths, texts)]


def _batch(seed=0, **kw):
    return TTR.DataCollatorCTCWithPadding()(_features(seed, **kw))


def _path_get(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _pairs(jtree, ttree):
    """(key string, JAX leaf, port leaf) for every leaf of the JAX tree."""
    return [(jax.tree_util.keystr(p), np.asarray(a),
             _path_get(ttree, p).detach().cpu().float().numpy())
            for p, a in jax.tree_util.tree_leaves_with_path(jtree)]


def _feeds_batchnorm(key: str) -> bool:
    """The biases of the convolutions right before a BatchNorm."""
    return key.endswith("['b']") and ("['conv1']" in key or "['conv2']" in key
                                      or "['dw']" in key and "['reduction']" not in key)


# ---------------------------------------------------------------------------
# ctc_loss
# ---------------------------------------------------------------------------


def _ctc_case(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (3, 25, 35)).astype(np.float32)
    lens = np.array([25, 20, 15], np.int32)
    labels = np.full((3, 8), -100, np.int32)
    labels[0, :5] = [1, 2, 3, 4, 5]
    labels[1, :3] = [6, 7, 8]
    labels[2, :2] = [9, 9]
    return logits, lens, labels


def _ctc_both(logits, lens, labels, reduction):
    weights = np.linspace(0.5, 1.5, logits.shape[0]).astype(np.float32)

    def jax_loss(lg):
        out = JTR.ctc_loss(jax.nn.log_softmax(lg, -1), jnp.asarray(lens), jnp.asarray(labels),
                           blank_id=BLANK, reduction=reduction)
        return (out * weights).sum() if reduction == "none" else out

    j_val, j_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    out = TTR.ctc_loss(torch.log_softmax(lg, -1), torch.from_numpy(lens),
                       torch.from_numpy(labels), blank_id=BLANK, reduction=reduction)
    val = (out * torch.from_numpy(weights)).sum() if reduction == "none" else out
    (t_grad,) = torch.autograd.grad(val, lg)
    return float(j_val), np.asarray(j_grad), float(val.detach()), t_grad.numpy()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_and_grad_match_jax(reduction):
    j_val, j_grad, t_val, t_grad = _ctc_both(*_ctc_case(), reduction)
    assert t_val == pytest.approx(j_val, rel=1e-5)
    top = np.abs(j_grad).max()
    assert top > 1e-2  # a gradient worth comparing
    np.testing.assert_allclose(t_grad, j_grad, atol=3e-5 * top, rtol=0)


@pytest.mark.parametrize("row", ["target_longer_than_output", "loss_above_1e5"])
def test_ctc_zero_infinity_rows(row):
    """Such a row's loss and gradient are 0 in both packages, and the other
    rows are untouched."""
    logits, lens, labels = _ctc_case(1)
    if row == "target_longer_than_output":
        lens[1] = 2          # three labels in two frames: no alignment
    else:
        logits[1, :, 6:9] = -3e5   # every alignment emits a label of logprob -3e5
    per_row = []
    for reduction in ("none", "mean"):
        j_val, j_grad, t_val, t_grad = _ctc_both(logits, lens, labels, reduction)
        assert t_val == pytest.approx(j_val, rel=1e-5)
        assert np.all(t_grad[1] == 0) and np.all(j_grad[1] == 0)
        np.testing.assert_allclose(t_grad, j_grad, atol=3e-5 * np.abs(j_grad).max(), rtol=0)
        per_row.append(t_val)
    none = TTR.ctc_loss(torch.log_softmax(torch.from_numpy(logits), -1), torch.from_numpy(lens),
                        torch.from_numpy(labels), blank_id=BLANK, reduction="none")
    assert float(none[1]) == 0.0 and float(none[0]) > 0.0


# ---------------------------------------------------------------------------
# Collator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    {}, {"pad_audio_to_multiple_of": 1000, "pad_labels_to_multiple_of": 5},
    {"max_length": 3000}, {"max_length_labels": 4, "pad_labels_to_multiple_of": 1}],
    ids=["default", "multiples", "audio_cap", "label_cap"])
def test_collator_matches_jax(kwargs):
    feats = _features(2) + [{"input_values": np.ones(100, np.float32), "labels": [3, 4, 5, 6, 7]}]
    jb = JTR.DataCollatorCTCWithPadding(**kwargs)(feats)
    tb = TTR.DataCollatorCTCWithPadding(**kwargs)(feats)
    assert set(tb) == set(jb)
    for k in jb:
        assert tb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("text", ["привет мир", "ЁЖИК и ёлка", "Да, нет! — ну?..",
                                  "hello мир 123", ""])
def test_tokenize_text_matches_jax(text):
    assert TTR.tokenize_text(text) == JTR.tokenize_text(text)


# ---------------------------------------------------------------------------
# The train-mode forward and its gradients
# ---------------------------------------------------------------------------


def _forward_inputs():
    wav = np.random.default_rng(4).normal(0, 0.1, (3, 2400 * 4 + 313)).astype(np.float32)
    return wav, np.array([wav.shape[1], 7000, 3000], np.int32)


@pytest.mark.parametrize("jax_form", ["blocked", "masked"])
def test_train_forward_matches_jax(jax_form):
    jc, tc, jv, tv = _models()
    wav, lens = _forward_inputs()
    jlp, jlen, jstats = _jax_train_forward("float32", jax_form == "blocked")(jv, wav, lens)
    tlp, tlen, tstats = TM.apply_offline(tv, tc, torch.from_numpy(wav), torch.from_numpy(lens),
                                         rng=0, training=True)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for row, n in enumerate(np.asarray(jlen)):
        np.testing.assert_allclose(tlp[row, :n].detach().numpy(), np.asarray(jlp)[row, :n],
                                   atol=1e-4, rtol=0)
    pairs = _pairs(jstats, tstats)
    assert len(pairs) == 2 * (2 + tc.encoder.n_layers)
    for key, a, b in pairs:
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0, err_msg=key)
    # the statistics moved: training mode really updated them
    moved = [np.abs(a - np.asarray(_path_get(jv["batch_stats"], p))).max()
             for p, a in jax.tree_util.tree_leaves_with_path(jstats)]
    assert min(moved) > 1e-4


@functools.lru_cache(maxsize=None)
def _jax_train_forward(dtype, blocked):
    jc = _models(dtype)[0]
    return jax.jit(lambda v, a, n: JM.apply_offline(v, jc, a, n, rng=jax.random.PRNGKey(0),
                                                    training=True, blocked_attention=blocked))


def _jax_grads(jc, jv, wav, lens, labels, blocked):
    def loss(params):
        lp, out_len, _ = JM.apply_offline({"params": params, "batch_stats": jv["batch_stats"]},
                                          jc, jnp.asarray(wav), jnp.asarray(lens),
                                          rng=jax.random.PRNGKey(0), training=True,
                                          blocked_attention=blocked)
        return JTR.ctc_loss(lp, out_len, jnp.asarray(labels), blank_id=BLANK)

    return jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, jv["params"]))


def _port_grads(tc, tv, wav, lens, labels):
    params = TTRAIN.tree_map(lambda t: t.clone().requires_grad_(True), tv["params"])
    lp, out_len, _ = TM.apply_offline({"params": params, "batch_stats": tv["batch_stats"]}, tc,
                                      torch.from_numpy(wav), torch.from_numpy(lens), rng=0,
                                      training=True)
    loss = TTR.ctc_loss(lp, out_len, torch.from_numpy(labels), blank_id=BLANK)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    return TTRAIN._unflatten(params, list(grads))


def _grad_batch():
    wav, lens = _forward_inputs()
    labels = TTR.DataCollatorCTCWithPadding()(
        [{"input_values": w, "labels": t} for w, t in zip(wav, ("да нет", "мир", "а"))])["labels"]
    return wav, lens, labels


def _assert_grads_close(pairs, rel):
    top = max(np.abs(a).max() for _, a, _ in pairs)
    for key, a, b in pairs:
        scale = top if _feeds_batchnorm(key) else np.abs(a).max()
        assert np.abs(a - b).max() <= rel * scale, (key, np.abs(a - b).max(), scale)


@pytest.mark.parametrize("jax_form", ["blocked", "masked"])
def test_train_gradients_match_jax(jax_form):
    jc, tc, jv, tv = _models()
    wav, lens, labels = _grad_batch()
    pairs = _pairs(_jax_grads(jc, jv, wav, lens, labels, jax_form == "blocked"),
                   _port_grads(tc, tv, wav, lens, labels))
    assert len(pairs) == len(tree_leaves(tv["params"]))
    _assert_grads_close(pairs, 1e-4)


def test_train_blocked_matches_masked_gradients():
    """The 400 ms geometry: the port's blocked gradients against the JAX
    package's masked ones."""
    jc, tc, jv, tv = _models(chunk_ms=400)
    wav, lens, labels = _grad_batch()
    pairs = _pairs(_jax_grads(jc, jv, wav, lens, labels, False),
                   _port_grads(tc, tv, wav, lens, labels))
    assert len(pairs) == len(tree_leaves(tv["params"]))
    for key, a, b in pairs:
        np.testing.assert_allclose(b, a, atol=2e-3, rtol=0, err_msg=key)


def test_train_forward_bf16_matches_jax():
    jc, tc, jv, tv = _models("bfloat16")
    wav, lens = _forward_inputs()
    jlp, jlen, jstats = _jax_train_forward("bfloat16", True)(jv, wav, lens)
    tlp, _, tstats = TM.apply_offline(tv, tc, torch.from_numpy(wav), torch.from_numpy(lens),
                                      rng=0, training=True)
    for row, n in enumerate(np.asarray(jlen)):
        assert np.abs(tlp[row, :n].detach().numpy() - np.asarray(jlp)[row, :n]).max() < 0.05
    for key, a, b in _pairs(jstats, tstats):
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=1e-3, err_msg=key)


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_fraction_and_scale(rate):
    x = torch.ones(200_000)
    y = TL.dropout(x, rate, True, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
    assert torch.all(y[kept] == torch.tensor(1.0) / (1 - rate))


@pytest.mark.parametrize("case", ["eval", "rate_0", "no_generator"])
def test_dropout_is_the_identity(case):
    x = torch.randn(50)
    gen = None if case == "no_generator" else torch.Generator().manual_seed(0)
    y = TL.dropout(x, 0.0 if case == "rate_0" else 0.3, case != "eval", gen)
    assert y is x


def test_dropout_masks_are_pure_functions_of_seed_layer_site():
    cpu = torch.device("cpu")

    def mask(seed, layer, site):
        gen = TE.layer_generators(seed, layer, cpu)[site]
        return TL.dropout(torch.ones(4096), 0.5, True, gen) != 0

    assert torch.equal(mask(7, 2, "att"), mask(7, 2, "att"))
    for other in ((8, 2, "att"), (7, 3, "att"), (7, 2, "ff1")):
        assert not torch.equal(mask(7, 2, "att"), mask(*other))


def test_apply_offline_dropout_follows_rng():
    _, tc, _, tv = _models(dropout=0.1)
    wav, lens = (torch.from_numpy(a) for a in _forward_inputs())

    def run(rng, config=tc):
        return TM.apply_offline(tv, config, wav, lens, rng=rng, training=True)[0]

    assert torch.equal(run(5), run(5))
    assert not torch.allclose(run(5), run(6))
    # no key: no dropout, as the reference does without one
    assert torch.equal(run(None), run(5, _configs()[1]))


def test_dropout_masks_differ_between_steps():
    """With lr 0 on the first step the parameters do not move, so the two
    losses differ only by their masks; a second trainer repeats them."""
    _, tc, _, tv = _models(dropout=0.1)
    batch = _batch()

    def losses():
        trainer = TTR.Trainer(tc, TTR.TrainerConfig(total_steps=10), device="cpu")
        state = trainer.create_state(tv)
        out = []
        for _ in range(2):
            state, loss = trainer.train_step(state, batch)
            out.append(float(loss))
        return out

    first = losses()
    assert first[0] != first[1]
    assert losses() == first


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total, ratio", [(4, 0.05), (20, 0.05), (100, 0.1), (10, 0.5)])
def test_lr_schedule_matches_jax(total, ratio):
    tcfg_ = TTR.TrainerConfig(total_steps=total, warmup_ratio=ratio, learning_rate=3e-4)
    jsched = JTRAIN.make_lr_schedule(JTR.TrainerConfig(**dataclasses.asdict(tcfg_)))
    tsched = TTRAIN.make_lr_schedule(tcfg_)
    for count in range(total + 3):
        assert float(tsched(count)) == pytest.approx(float(jsched(count)), rel=1e-7, abs=1e-12)


def _synthetic_grads(params_like, step, scale):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                        params_like)


def _to_port_tree(jtree, like):
    return from_jax_variables({"params": jtree, "batch_stats": {}}, like, "cpu")["params"]


def test_first_updates_are_zero_then_the_peak_lr():
    """make_optimizer(TrainerConfig(total_steps=4)): the first update has lr
    0, the second the peak lr (as in this sandbox's optax)."""
    params = {"w": np.zeros(3, np.float32)}
    grads = {"w": np.full(3, 1e-3, np.float32)}
    results = []
    for pkg, tree in ((JTRAIN, jnp.asarray), (TTRAIN, torch.from_numpy)):
        cfg = (JTR if pkg is JTRAIN else TTR).TrainerConfig(total_steps=4)
        opt = pkg.make_optimizer(cfg)
        p, g = {"w": tree(params["w"])}, {"w": tree(grads["w"])}
        state = opt.init(p)
        got = []
        for _ in range(2):
            u, state = opt.update(g, state, p)
            got.append(np.asarray(u["w"]))
        np.testing.assert_array_equal(got[0], 0.0)
        # -lr · g / (|g| + 1e-8) at |g| = 1e-3 is -4.99995e-05 in exact
        # arithmetic; float32's 0.999 moves the bias correction by 1e-5.
        np.testing.assert_allclose(got[1], -4.99995e-05, rtol=2e-5)
        results.append(got[1])
    np.testing.assert_allclose(results[1], results[0], rtol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_jax(accum):
    """Clipping, AdamW and the schedule (and MultiSteps) fed the same
    gradients for 6 calls that cross the warmup; some gradients are clipped,
    some not; weight decay on."""
    jc, tc, jv, _ = _models()
    cfg = dict(total_steps=8, warmup_ratio=0.25, learning_rate=1e-3, weight_decay=0.01,
               grad_accum_steps=accum)
    jopt = JTRAIN.make_optimizer(JTR.TrainerConfig(**cfg))
    jupdate = jax.jit(jopt.update)
    topt = TTRAIN.make_optimizer(TTR.TrainerConfig(**cfg))
    jparams = jax.tree.map(jnp.asarray, jv["params"])
    tparams = _to_port_tree(jv["params"], tc)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    nonzero = 0
    for step in range(6):
        g = _synthetic_grads(jv["params"], step, scale=(1e-3, 0.3)[step % 2])
        ju, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        tu, tstate = topt.update(_to_port_tree(g, tc), tstate, tparams)
        jparams = optax.apply_updates(jparams, ju)
        if tu is None:
            assert all(np.all(np.asarray(x) == 0) for x in jax.tree.leaves(ju))
            continue
        for t, u in zip(tree_leaves(tparams), tree_leaves(tu)):
            t.add_(u)
        pairs = _pairs(ju, tu)
        top = max(np.abs(a).max() for _, a, _ in pairs)
        nonzero += top > 0
        for key, a, b in pairs:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * top + 1e-12, err_msg=key)
        for key, a, b in _pairs(jparams, tparams):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9, err_msg=key)
    assert nonzero == 6 // accum - 1  # every update after the first moved


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    g = [np.random.default_rng(s).standard_normal(n).astype(np.float32) * scale
         for s, n in enumerate((5, 300, 7))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(x) for x in g], None)
    got = TTRAIN.clip_by_global_norm([torch.from_numpy(x) for x in g], 1.0)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)
    if scale < 1:
        assert all(torch.equal(b, torch.from_numpy(x)) for x, b in zip(g, got))


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


def test_trainer_matches_jax():
    """4 steps (lr 0, then three past the warmup) on
    examples/train_tiny_e2e.py's tiny config, float32, dropout 0."""
    jc = tiny_config()
    tc = tcfg.ToneConfig.from_dict(jc.to_dict())
    jv = jax.tree.map(np.asarray, JM.init_model_params(jax.random.PRNGKey(0), jc))
    tv = from_jax_variables(jv, tc, "cpu")
    batch = _batch(3)
    cfg = dict(total_steps=10, learning_rate=1e-3)
    jt = JTR.Trainer(jc, JTR.TrainerConfig(**cfg), mesh=make_mesh(n_data=1, n_model=1))
    tt = TTR.Trainer(tc, TTR.TrainerConfig(**cfg), device="cpu")
    js, ts = jt.create_state(jax.tree.map(jnp.asarray, jv)), tt.create_state(tv)
    schedule = TTRAIN.make_lr_schedule(tt.config)
    for step in range(4):
        js, jl = jt.train_step(js, batch)
        ts, tl = tt.train_step(ts, batch)
        # the same parameters until the first non-zero update has been made
        assert float(tl) == pytest.approx(float(jl), rel=1e-5 if step < 2 else 1e-4), step
    assert ts.step == 4 and int(js.step) == 4
    lr_sum = sum(float(schedule(c)) for c in range(4))
    _assert_params_close(_pairs(js.params, ts.params), lr_sum)
    for key, a, b in _pairs(js.batch_stats, ts.batch_stats):
        np.testing.assert_allclose(b, a, atol=0.25 * lr_sum, rtol=0, err_msg=key)


def test_trainer_runs_the_400ms_geometry():
    """Two steps (lr 0, then one past the warmup) of the tiny model at 400 ms
    chunks, whose windows are not whole chunks, against the JAX trainer on
    its masked form, float32, dropout 0: the bounds of
    ``test_trainer_matches_jax``."""
    jc, tc, jv, tv = _models(chunk_ms=400)
    batch = _batch(3)
    cfg = dict(total_steps=10, learning_rate=1e-3)
    jt = JTR.Trainer(jc, JTR.TrainerConfig(**cfg, blocked_attention=False),
                     mesh=make_mesh(n_data=1, n_model=1))
    tt = TTR.Trainer(tc, TTR.TrainerConfig(**cfg), device="cpu")
    js, ts = jt.create_state(jax.tree.map(jnp.asarray, jv)), tt.create_state(tv)
    for step in range(2):
        js, jl = jt.train_step(js, batch)
        ts, tl = tt.train_step(ts, batch)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5), step
    lr_sum = sum(float(TTRAIN.make_lr_schedule(tt.config)(c)) for c in range(2))
    assert lr_sum > 0
    _assert_params_close(_pairs(js.params, ts.params), lr_sum)


def _assert_params_close(pairs, lr_sum):
    """Every element within 2 × the summed lr (an Adam step moves an element
    by about lr at most), and 99 % of them within 0.01 × the summed lr:
    only elements whose gradient is rounding noise (an exact gradient of 0,
    as the biases that feed a BatchNorm have) may differ by whole steps."""
    diffs = np.concatenate([np.abs(a - b).ravel() for _, a, b in pairs])
    worst = max(pairs, key=lambda p: np.abs(p[1] - p[2]).max())
    assert diffs.max() <= 2.0 * lr_sum, (worst[0], diffs.max(), lr_sum)
    assert np.mean(diffs > 0.01 * lr_sum) < 0.01, np.mean(diffs > 0.01 * lr_sum)


def _named(tree, prefix=""):
    """(key string in jax.tree_util.keystr's format, leaf) of a port tree."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _named(v, f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _named(v, f"{prefix}[{i}]")]
    return [(prefix, tree.detach().numpy())]


def test_grad_accumulation_equals_macro_batch():
    """Two calls on a half-batch each with grad_accum_steps=2 update the
    parameters as one call on the two halves together; the halves are the
    same utterances, so that their BatchNorm statistics are the macro
    batch's.  Two updates: the first at lr 0, the second past the warmup."""
    _, tc, _, tv = _models()
    half = _features(5, lengths=(4000, 5200), texts=("да", "нет"))
    collate = TTR.DataCollatorCTCWithPadding()
    macro_t = TTR.Trainer(tc, TTR.TrainerConfig(total_steps=4, learning_rate=1e-3), device="cpu")
    accum_t = TTR.Trainer(tc, TTR.TrainerConfig(total_steps=4, learning_rate=1e-3,
                                                grad_accum_steps=2), device="cpu")
    macro, accum = macro_t.create_state(tv), accum_t.create_state(tv)
    for _ in range(2):
        macro, _ = macro_t.train_step(macro, collate(half + half))
        before = [p.clone() for p in tree_leaves(accum.params)]
        accum, _ = accum_t.train_step(accum, collate(half))
        assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(accum.params)))
        accum, _ = accum_t.train_step(accum, collate(half))
    assert (macro.step, accum.step) == (2, 4)
    assert accum.opt_state.gradient_step == 2 and accum.opt_state.inner_opt_state.count == 2
    moved = max((a - b).abs().max().item() for a, b in
                zip(tree_leaves(accum.params), tree_leaves(tv["params"])))
    assert moved > 1e-4
    lr_sum = sum(float(TTRAIN.make_lr_schedule(accum_t.config)(c)) for c in range(2))
    _assert_params_close([(k, a, b) for (k, a), (_, b) in
                          zip(_named(macro.params), _named(accum.params))], lr_sum)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_modes_match_no_remat_with_dropout(remat):
    _, tc, _, tv = _models(dropout=0.1)
    batch = _batch()

    def run(policy):
        trainer = TTR.Trainer(tc, TTR.TrainerConfig(total_steps=6, learning_rate=1e-3,
                                                    remat=policy), device="cpu")
        state = trainer.create_state(tv)
        loss, grads, stats = trainer.compute_gradients(state, batch)
        first = (float(loss), [g.clone() for g in tree_leaves(grads)], tree_leaves(stats))
        for _ in range(3):
            state, _ = trainer.train_step(state, batch)
        return first, tree_leaves(state.params)

    (loss0, g0, s0), p0 = run(None)
    (loss1, g1, s1), p1 = run(remat)
    assert loss1 == loss0
    for a, b in zip(g0 + s0 + p0, g1 + s1 + p1):
        assert torch.equal(a, b)


def test_remat_dots_saves_the_matrix_products():
    seen = []

    def policy(ctx, op, *args, **kwargs):
        seen.append(op)
        return orig(ctx, op, *args, **kwargs)

    _, tc, _, tv = _models()
    trainer = TTR.Trainer(tc, TTR.TrainerConfig(remat="dots"), device="cpu")
    orig = TTRAIN._dots_policy
    TTRAIN._dots_policy = policy
    try:
        trainer.compute_gradients(trainer.create_state(tv), _batch())
    finally:
        TTRAIN._dots_policy = orig
    assert torch.ops.aten.mm.default in seen and len(set(seen)) > 10


@pytest.mark.parametrize("accum", [1, 2])
def test_save_restore_resumes_bit_for_bit(tmp_path, accum):
    _, tc, _, tv = _models(dropout=0.1)
    batch = _batch(6)
    trainer = TTR.Trainer(tc, TTR.TrainerConfig(total_steps=10, learning_rate=1e-3,
                                                grad_accum_steps=accum), device="cpu")
    state = trainer.create_state(tv)
    for _ in range(3):
        state, _ = trainer.train_step(state, batch)
    trainer.save(tmp_path / "ckpt", state)
    restored = trainer.restore(tmp_path / "ckpt", trainer.create_state(tv))
    assert restored.step == 3 and restored.rng == state.rng
    assert all(p.requires_grad for p in tree_leaves(restored.params))
    for _ in range(3):
        state, loss_a = trainer.train_step(state, batch)
        restored, loss_b = trainer.train_step(restored, batch)
        assert torch.equal(loss_a, loss_b)
    for tree in ("params", "batch_stats"):
        for a, b in zip(tree_leaves(getattr(state, tree)), tree_leaves(getattr(restored, tree))):
            assert torch.equal(a, b)


def test_restore_refuses_another_model(tmp_path):
    _, tc, _, tv = _models()
    trainer = TTR.Trainer(tc, TTR.TrainerConfig(), device="cpu")
    trainer.save(tmp_path, trainer.create_state(tv))
    other_cfg = tcfg.ToneConfig(encoder=tcfg.EncoderConfig(**dict(TINY_ENCODER, d_model=32)),
                                compute_dtype="float32")
    other = TTR.Trainer(other_cfg, TTR.TrainerConfig(), device="cpu")
    template = other.create_state(TM.init_model_params(torch.Generator().manual_seed(0),
                                                       other_cfg))
    with pytest.raises(ValueError, match="template"):
        other.restore(tmp_path, template)


def test_eval_wer_matches_jax():
    jc, tc, jv, tv = _models()
    batches = [_batch(7), _batch(8, lengths=(3000, 8000), texts=("а", "б"))]
    refs = ["да нет", "привет мир", "ёж", "а", "б"]
    jt = JTR.Trainer(jc, JTR.TrainerConfig(), mesh=make_mesh(n_data=1, n_model=1))
    tt = TTR.Trainer(tc, TTR.TrainerConfig(), device="cpu")
    want = jt.eval_wer(jt.create_state(jax.tree.map(jnp.asarray, jv)), batches, refs)
    assert tt.eval_wer(tt.create_state(tv), batches, refs) == want


def test_trainer_mesh_raises():
    """A mesh that is not a ``ProcessMesh`` is refused (the mesh cases are
    tests/test_torch_parallel.py)."""
    _, tc, _, _ = _models()
    with pytest.raises(TypeError, match="ProcessMesh"):
        TTR.Trainer(tc, mesh=object(), device="cpu")


def test_trainer_refuses_unknown_remat():
    _, tc, _, _ = _models()
    with pytest.raises(ValueError, match="remat"):
        TTR.Trainer(tc, TTR.TrainerConfig(remat="everything"), device="cpu")


def test_create_state_copies_to_float32_leaves_with_grad():
    _, tc, _, tv = _models()
    bf16 = TTRAIN.tree_map(lambda t: t.to(torch.bfloat16), tv)
    trainer = TTR.Trainer(tc, device="cpu")
    state = trainer.create_state(bf16)
    params = tree_leaves(state.params)
    assert len(params) == len(tree_leaves(tv["params"]))
    assert all(p.dtype == torch.float32 and p.requires_grad and p.is_leaf
               and p.device.type == "cpu" for p in params)
    assert all(not s.requires_grad and s.dtype == torch.float32
               for s in tree_leaves(state.batch_stats))
    assert state.step == 0 and state.rng == trainer.config.seed
    params[0].data.add_(1.0)
    assert not torch.equal(params[0], tree_leaves(tv["params"])[0])


def test_exports_match_jax():
    assert sorted(TTR.__all__) == sorted(JTR.__all__)
    import tone_tpu_torch

    assert tone_tpu_torch.Trainer is TTR.Trainer
    assert tone_tpu_torch.TrainerConfig is TTR.TrainerConfig
