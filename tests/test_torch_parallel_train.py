"""Training on a mesh of ranks (tone_tpu_torch/parallel/, training/train.py)
against the port on one device and the JAX package's ``Trainer(mesh=...)``.

The ranks are subprocesses of the package's rank program
(``python -m tone_tpu_torch.parallel.ranks``, started by
``parallel.ranks.train_on_mesh``) on gloo with a ``file://`` rendezvous,
every rank on the CPU; they import no JAX.  The model is
tests/test_parallel.py's tiny float32 config, its batch four utterances.
Tolerances (tests/test_parallel.py's where it has one):

* losses over 2 steps at (data, model) = (2, 1), (1, 2), (2, 2), dropout
  0.1: rtol 2e-5 against the port's (1, 1); every rank reports them; step 2
  differs from step 1;
* at dropout 0, 3 steps at (2, 2): 1e-4 relative against JAX's ``Trainer``
  on its (2, 2) mesh (the port's training tolerance);
* the BatchNorm running statistics and the saved variables after two
  steps at (1, 2) and (2, 2): 1e-5 against (1, 1) (float32), but for the
  biases right before a BatchNorm, whose exact gradient is 0: Adam scales
  their rounding noise to steps of the lr, so they may differ by twice the
  lr (as in tests/test_torch_training.py); the checkpoint restores on one
  device, and a step from the restored state equals the live one on the
  mesh;
* the global-norm clip under tensor parallelism: (1, 2) with the clip
  active gives the update of (1, 1) to 1e-4 of its norm;
* the WER of ``eval_wer`` equals one device's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import leaves_with_paths, tiny_configs, tiny_variables

from tone_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tone_tpu.training import Trainer as JaxTrainer
from tone_tpu.training import TrainerConfig as JaxTrainerConfig
from tone_tpu_torch.bridge import tree_leaves
from tone_tpu_torch.core import layers as TL
from tone_tpu_torch.parallel.ranks import choose_backend, launch_ranks, train_on_mesh
from tone_tpu_torch.training import DataCollatorCTCWithPadding, Trainer, TrainerConfig
from tone_tpu_torch.training.train import STATE_FILE

PARALLEL_ENCODER = dict(
    n_layers=2, d_model=64, n_heads=4, rope_dim=16, ff_expansion_factor=2,
    conv_kernel_size=7, subsampling_conv_channels=(4, 8), mhsa_stateless_layers=1,
    reduction_position=0, upsample_position=1, should_recompute_att_scores=(True, True))
REFERENCES = ["да нет да"] * 4
RANK_ENV = {"OMP_NUM_THREADS": "1"}
# Adam divides by sqrt(v) + 1e-8: a clip to 1e-7 makes every element's
# gradient far smaller than that epsilon, so the update is proportional to
# the clip factor and a wrong norm on any rank would show in it.
CLIP = dict(max_grad_norm=1e-7, learning_rate=1e-2, total_steps=4)
RUNS = {  # name: (mesh, dropout, trainer fields, steps, save)
    "drop_21": ((2, 1), 0.1, {"total_steps": 4}, 2, False),
    "drop_12": ((1, 2), 0.1, {"total_steps": 4}, 2, True),
    "drop_22": ((2, 2), 0.1, {"total_steps": 4}, 2, True),
    "nodrop_22": ((2, 2), 0.0, {"total_steps": 4, "learning_rate": 1e-3}, 3, False),
    "clip_12": ((1, 2), 0.0, CLIP, 2, True),
}


def _models(dropout):
    jc, tc = tiny_configs(encoder=dict(PARALLEL_ENCODER, dropout=dropout,
                                       dropout_att=dropout))
    jv, tv = tiny_variables(jc, tc)
    return jc, tc, jv, tv


def _batch():
    rng = np.random.default_rng(0)
    return DataCollatorCTCWithPadding()([
        {"input_values": rng.normal(0, 0.1, 2400 + 160 * i).astype(np.float32),
         "labels": "да нет да"} for i in range(4)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of RUNS on its mesh of ranks, and on one device in this
    process: ``{name: (rank results, mesh dir, one-device result, one-device
    dir)}``."""
    batch = _batch()
    out = {}
    for name, ((n_data, n_model), dropout, fields, steps, save) in RUNS.items():
        _, tc, _, tv = _models(dropout)
        tcfg = TrainerConfig(**fields)
        spec = {"config": tc.to_dict(), "trainer": dataclasses.asdict(tcfg), "variables": tv,
                "batch": {k: torch.as_tensor(v) for k, v in batch.items()}, "steps": steps,
                "n_data": n_data, "n_model": n_model, "references": REFERENCES, "save": save}
        mesh_dir = tmp_path_factory.mktemp(name)
        ranks = train_on_mesh(spec, ["cpu"] * (n_data * n_model), mesh_dir, timeout=240,
                              env=RANK_ENV)
        trainer = Trainer(tc, tcfg, device="cpu")
        state = trainer.create_state(tv)
        losses = []
        for _ in range(steps):
            state, loss = trainer.train_step(state, batch)
            losses.append(float(loss))
        one = {"losses": losses, "wer": trainer.eval_wer(state, [batch], REFERENCES)}
        one_dir = tmp_path_factory.mktemp(name + "_one")
        trainer.save(one_dir / "checkpoint", state)
        out[name] = (ranks, mesh_dir, one, one_dir)
    return out


@pytest.mark.parametrize("name", ["drop_21", "drop_12", "drop_22"])
def test_losses_with_dropout_equal_one_device(runs, name):
    ranks, _, one, _ = runs[name]
    assert len(ranks) == np.prod(RUNS[name][0])
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"], r["rank"]
        assert r["backend"] == "gloo"
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=2e-5)
    assert np.isfinite(one["losses"]).all()
    assert abs(one["losses"][1] - one["losses"][0]) > 1e-7  # another dropout mask


def test_losses_without_dropout_equal_jax(runs):
    ranks, _, one, _ = runs["nodrop_22"]
    jc, _, jv, _ = _models(0.0)
    jt = JaxTrainer(jc, JaxTrainerConfig(**RUNS["nodrop_22"][2]),
                    mesh=jax_make_mesh(n_data=2, n_model=2))
    state = jt.create_state(jax.tree.map(jnp.asarray, jv))
    want = []
    for _ in range(RUNS["nodrop_22"][3]):
        state, loss = jt.train_step(state, _batch())
        want.append(float(loss))
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-4)
    np.testing.assert_allclose(one["losses"], want, rtol=1e-4)


def _feeds_batchnorm(path: str) -> bool:
    """The biases of the convolutions right before a BatchNorm."""
    return path.endswith("/b") and ("/conv1/" in path or "/conv2/" in path
                                    or "/dw/" in path and "/reduction/" not in path)


def _saved(path):
    return torch.load(path / "checkpoint" / STATE_FILE, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("name", ["drop_12", "drop_22"])
def test_saved_state_equals_one_device_and_resumes(runs, name):
    """The checkpoint of a mesh holds the full variables, the running
    statistics and the Adam moments of one device, restores on one device,
    and a step from its restored shards equals the live step on the mesh."""
    ranks, mesh_dir, _, one_dir = runs[name]
    got, want = _saved(mesh_dir), _saved(one_dir)
    lr = TrainerConfig(**RUNS[name][2]).learning_rate
    for key in ("params", "batch_stats"):
        for (path, a), (_, b) in zip(leaves_with_paths(got[key]),
                                     leaves_with_paths(want[key])):
            assert a.shape == b.shape, path
            atol = 2 * lr if key == "params" and _feeds_batchnorm(path) else 1e-5
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0,
                                       err_msg=key + path)
    for key in ("mu", "nu"):
        for a, b in zip(tree_leaves(got["adam"][key]), tree_leaves(want["adam"][key])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)
    assert (got["step"], got["rng"], got["adam"]["count"]) == \
        (want["step"], want["rng"], want["adam"]["count"])
    _, tc, _, tv = _models(RUNS[name][1])
    one = Trainer(tc, TrainerConfig(**RUNS[name][2]), device="cpu")
    restored = one.restore(mesh_dir / "checkpoint", one.create_state(tv))
    assert restored.step == RUNS[name][3]
    for r in ranks:
        assert r["resumed_loss"] == r["live_loss"]


def test_clip_counts_split_leaves_over_model_ranks(runs):
    """With the clip active, (1, 2) makes the update of (1, 1): each model
    rank clips by the global norm (split leaves summed over the ranks,
    replicated leaves once)."""
    _, tc, _, tv = _models(0.0)
    trainer = Trainer(tc, TrainerConfig(**CLIP), device="cpu")
    _, grads, _ = trainer.compute_gradients(trainer.create_state(tv), _batch())
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in tree_leaves(grads)]))
    assert norm > 1e4 * CLIP["max_grad_norm"]  # the clip scales every step
    _, mesh_dir, _, one_dir = runs["clip_12"]
    init = tree_leaves(tv["params"])
    got = [a - b for a, b in zip(tree_leaves(_saved(mesh_dir)["params"]), init)]
    want = [a - b for a, b in zip(tree_leaves(_saved(one_dir)["params"]), init)]
    diff = torch.linalg.vector_norm(torch.stack([(a - b).norm() for a, b in zip(got, want)]))
    size = torch.linalg.vector_norm(torch.stack([b.norm() for b in want]))
    assert size > 0
    assert diff <= 1e-4 * size, (float(diff), float(size))


@pytest.mark.parametrize("name", ["drop_21", "drop_12", "drop_22"])
def test_eval_wer_equals_one_device(runs, name):
    ranks, _, one, _ = runs[name]
    assert [r["wer"] for r in ranks] == [one["wer"]] * len(ranks)


def test_bytes_reduced_per_step(runs):
    """Data ranks all-reduce every gradient each step (float32); model ranks
    add the activations' sums."""
    ranks, _, _, _ = runs["drop_21"]
    n_params = sum(t.numel() for t in tree_leaves(_models(0.1)[3]["params"]))
    assert all(b >= 4 * n_params for b in ranks[0]["bytes_reduced_per_step"])


def test_dropout_shards_cut_the_one_device_mask():
    """A rank's mask is its rows (and heads) of the one-device mask."""
    x = torch.ones(4, 6, 5, 3)
    full = TL.dropout(x, 0.5, True, torch.Generator().manual_seed(9))
    for rows in range(2):
        for heads in range(3):
            part = TL.dropout(x[2 * rows:2 * rows + 2, 2 * heads:2 * heads + 2], 0.5, True,
                              torch.Generator().manual_seed(9),
                              ((0, rows, 2), (1, heads, 3)))
            torch.testing.assert_close(
                part, full[2 * rows:2 * rows + 2, 2 * heads:2 * heads + 2], rtol=0, atol=0)


def test_batch_not_a_multiple_of_data_fails_the_run(tmp_path):
    _, tc, _, tv = _models(0.0)
    batch = {k: torch.as_tensor(v)[:3] for k, v in _batch().items()}
    spec = {"config": tc.to_dict(), "trainer": {}, "variables": tv, "batch": batch,
            "steps": 1, "n_data": 2, "n_model": 1}
    with pytest.raises(RuntimeError, match="multiple of the mesh 'data' axis"):
        train_on_mesh(spec, ["cpu"] * 2, tmp_path, timeout=120, env=RANK_ENV)


def test_launch_ranks_stops_on_failure_and_timeout():
    with pytest.raises(RuntimeError, match="rank 1 of 2 .* exited 3: boom"):
        launch_ranks(["-c", "import os, sys, time\n"
                            "if os.environ['TONE_TPU_RANK'] == '1':\n"
                            "    print('boom', file=sys.stderr)\n"
                            "    sys.exit(3)\n"
                            "time.sleep(60)"], ["cpu"] * 2, timeout=60)
    with pytest.raises(TimeoutError, match="did not finish"):
        launch_ranks(["-c", "import time; time.sleep(60)"], ["cpu"], timeout=1)
    assert launch_ranks(["-c", "import os; print(os.environ['TONE_TPU_RANK'])"],
                        ["cpu"] * 3, timeout=60) == ["0\n", "1\n", "2\n"]


def test_choose_backend():
    assert choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert choose_backend(["cuda:0"]) == "nccl"
    assert choose_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert choose_backend(["cpu", "cpu"]) == "gloo"
