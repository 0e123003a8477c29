"""The port's device mesh (tone_tpu_torch/parallel/mesh.py) on the bulk and
serving paths, against the JAX package's mesh (tone_tpu/parallel/mesh.py,
tests/test_parallel.py) and the port on one device.

The port's data devices are ``[cpu] * n``: a mesh may name one device more
than once, as the JAX tests mesh their 8 virtual CPU devices.  Tolerances:

* the partition specs, the stream-state shardings and the slot-count check
  are the JAX package's (equal);
* bulk texts and times on 2 and 4 data devices, with a last batch padded
  with zero rows, equal the one-device transcriber's and JAX's
  ``OfflineTranscriber(mesh=...)``'s (tests/test_offline.py:44-70); the
  logprobs are within 1e-5 of one device's (float32);
* engine finals with 8 slots over 2 and 4 devices equal the unsplit
  engine's and the JAX engine's on a sharded arena
  (tests/test_parallel.py:215-254);
* ``transcribe``/``eval``/``serve --data-parallel``: the same output as
  without the flag.

The training mesh (ranks over torch.distributed) is
tests/test_torch_parallel_train.py.
"""

import json
import wave

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_common import tiny_configs, tiny_variables, tiny_variables_with_stats

from tone_tpu.core.model import init_streaming_state as jax_init_streaming_state
from tone_tpu.offline import OfflineTranscriber as JaxTranscriber
from tone_tpu.parallel import mesh as JM
from tone_tpu.runtime.engine import MultiStreamEngine as JaxEngine
from tone_tpu_torch.bridge import tree_leaves
from tone_tpu_torch.core.model import init_streaming_state
from tone_tpu_torch.offline import OfflineTranscriber
from tone_tpu_torch.parallel import mesh as TM
from tone_tpu_torch.runtime.arena import StreamArena
from tone_tpu_torch.runtime.engine import MultiStreamEngine

# tests/test_parallel.py's tiny model (its specs are checked on it).
PARALLEL_ENCODER = dict(
    n_layers=2, d_model=64, n_heads=4, rope_dim=16, ff_expansion_factor=2,
    conv_kernel_size=7, subsampling_conv_channels=(4, 8), mhsa_stateless_layers=1,
    reduction_position=0, upsample_position=1, should_recompute_att_scores=(True, True))
BULK_LENGTHS = (5000, 7200, 1200, 4807, 3100)  # batches of 4 and 1: the last one padded
FORWARDS = ["chunk_scan", "offline_forward"]


def _cpus(n):
    return TM.make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def parallel_model():
    jc, tc = tiny_configs(encoder=PARALLEL_ENCODER)
    jv, tv = tiny_variables(jc, tc)
    return jc, tc, jv, tv


@pytest.fixture(scope="module")
def tiny():
    jc, tc = tiny_configs()
    jv, tv = tiny_variables_with_stats(jc, tc, seed=3)
    return jc, tc, jv, tv


# ---------------------------------------------------------------------------
# Mesh and sharding rules
# ---------------------------------------------------------------------------


def test_make_mesh_grid_and_devices():
    mesh = TM.make_mesh(n_data=2, n_model=2, devices=["cpu"] * 5)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.devices == ((torch.device("cpu"),) * 2,) * 2
    with pytest.raises(ValueError, match="'data' only"):
        mesh.data_devices()
    assert _cpus(3).data_devices() == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="needs 4 devices"):
        TM.make_mesh(n_data=2, n_model=2, devices=["cpu"] * 3)
    assert TM.batch_sharding(mesh).axis_of("data") == 0
    assert TM.replicated(mesh).axis_of("data") is None


def test_param_specs_match_jax(parallel_model):
    """Every leaf's partition spec is the JAX package's on a (4, 2) mesh,
    and the named splits of tests/test_parallel.py hold."""
    jc, tc, jv, tv = parallel_model
    jsh = JM.param_shardings(JM.make_mesh(n_data=4, n_model=2), jv["params"])
    tsh = TM.param_shardings(TM.make_mesh(4, 2, ["cpu"] * 8), tv["params"])
    jspecs = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        jsh, is_leaf=lambda x: hasattr(x, "spec"))]
    tspecs = [s.spec for s in tree_leaves(tsh)]
    assert len(tspecs) == len(jspecs)
    # JAX flattens dicts in sorted key order, the port in insertion order
    assert sorted(map(str, tspecs)) == sorted(map(str, jspecs))
    for path in [("ff1", "lin1", "w"), ("ff1", "linv", "w"), ("ff2", "lin1", "w"),
                 ("att", "linear_q", "w"), ("att", "linear_k", "w"), ("att", "linear_v", "w"),
                 ("ff1", "lin1", "b"), ("ff1", "lin2", "w"), ("att", "linear_out", "w"),
                 ("norm_ff1", "weight"), ("ff1", "lin2", "b"), ("att", "q_ln", "scale")]:
        j, t = jsh["encoder"]["layers"][0], tsh["encoder"]["layers"][0]
        for k in path:
            j, t = j[k], t[k]
        assert t.spec == tuple(j.spec), path
    layer = tsh["encoder"]["layers"][0]
    assert layer["ff1"]["lin1"]["w"].spec == tuple(P(None, "model"))
    assert layer["att"]["linear_out"]["w"].spec == ("model", None)


def test_majority_of_param_bytes_sharded(parallel_model):
    _, _, _, tv = parallel_model
    shardings = TM.param_shardings(TM.make_mesh(4, 2, ["cpu"] * 8), tv["params"])
    leaves, specs = tree_leaves(tv["params"]), [s.spec for s in tree_leaves(shardings)]
    total = sum(x.numel() for x in leaves)
    sharded = sum(x.numel() for x, s in zip(leaves, specs) if "model" in s)
    assert sharded / total > 0.5


def test_renamed_tree_fails_loudly(parallel_model):
    _, _, _, tv = parallel_model
    renamed = dict(tv["params"])
    renamed["encoder"] = {**tv["params"]["encoder"], "layers": tuple(
        {("blk_" + k if k in ("ff1", "ff2", "att") else k): v for k, v in layer.items()}
        for layer in tv["params"]["encoder"]["layers"])}
    with pytest.raises(ValueError, match="TP sharding rules"):
        TM.param_shardings(TM.make_mesh(4, 2, ["cpu"] * 8), renamed)
    # without a model axis nothing is split, and nothing is checked
    TM.param_shardings(_cpus(4), renamed)


def test_packed_lin12_stays_replicated():
    w = torch.zeros(64, 256)
    assert TM.param_spec(("encoder", "layers", 0, "ff1", "lin12", "w"), w) == ()
    assert TM.param_spec(("encoder", "layers", 0, "ff1", "lin1", "w"), w) == (None, "model")


def test_stream_state_shardings_match_jax(parallel_model):
    jc, tc, _, _ = parallel_model
    jsh = JM.stream_state_shardings(JM.make_mesh(n_data=4, n_model=2),
                                    jax_init_streaming_state(jc, 8))
    state = init_streaming_state(tc, 8)
    tsh = TM.stream_state_shardings(_cpus(4), state)
    jaxes = [s.spec.index("data") for s in jax.tree_util.tree_leaves(
        jsh, is_leaf=lambda x: hasattr(x, "spec"))]
    taxes = []
    state.map(lambda x, axis: taxes.append((tuple(x.shape), axis)))
    assert [a for _, a in taxes] == jaxes
    assert all(shape[axis] == 8 for shape, axis in taxes)
    tsh.map(lambda s, axis: assert_axis(s, axis))


def assert_axis(sharding, axis):
    assert sharding.axis_of("data") == axis


def test_arena_shardings_match_materialized_and_reject_uneven(parallel_model):
    """``arena_shardings`` (``serve --data-parallel``) equals the shardings of
    a materialized state, and refuses 9 slots on 4 data devices before
    anything is allocated, as the JAX package does."""
    jc, tc, _, _ = parallel_model
    mesh = _cpus(4)
    via_meta = TM.arena_shardings(mesh, tc, 8)
    via_state = TM.stream_state_shardings(mesh, init_streaming_state(tc, 8))
    specs = []
    via_meta.map(lambda a, b, axis: specs.append((a.spec, b.spec)), via_state)
    assert specs and all(a == b for a, b in specs)
    with pytest.raises(ValueError, match="multiple") as ours:
        TM.arena_shardings(mesh, tc, 9)
    with pytest.raises(ValueError, match="multiple") as theirs:
        JM.arena_shardings(JM.make_mesh(n_data=4, n_model=1, devices=jax.devices()[:4]), jc, 9)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Bulk transcription
# ---------------------------------------------------------------------------


def _audios(lengths=BULK_LENGTHS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(-20000, 20000, n).astype(np.int32) for n in lengths]


def _phrases(result):
    return [[(p.text, p.start_time, p.end_time) for p in u] for u in result]


@pytest.mark.parametrize("forward", FORWARDS)
@pytest.mark.parametrize("n_data", [2, 4])
def test_bulk_on_mesh_matches_one_device_and_jax(tiny, n_data, forward):
    jc, tc, jv, tv = tiny
    off = forward == "offline_forward"
    audios = _audios()
    sharded = OfflineTranscriber(tv, tc, batch_size=4, use_offline_forward=off,
                                 mesh=_cpus(n_data))
    one = OfflineTranscriber(tv, tc, batch_size=4, use_offline_forward=off, device="cpu")
    jmesh = JM.make_mesh(n_data=n_data, devices=jax.devices()[:n_data])
    jsharded = JaxTranscriber(jv, jc, batch_size=4, use_offline_forward=off, mesh=jmesh)
    got = _phrases(sharded.transcribe(audios))
    assert got == _phrases(one.transcribe(audios))
    assert got == _phrases(jsharded.transcribe(audios))
    assert all(got)
    for a, b in zip(sharded.logprobs(audios), one.logprobs(audios)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_bulk_batch_not_a_multiple_of_data_raises(tiny):
    _, tc, _, tv = tiny
    with pytest.raises(ValueError, match="multiple"):
        OfflineTranscriber(tv, tc, batch_size=3, mesh=_cpus(2))
    with pytest.raises(ValueError, match="'data' only"):
        OfflineTranscriber(tv, tc, batch_size=4, mesh=TM.make_mesh(2, 2, ["cpu"] * 4))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _run_engine(engine, n=2400, seed=7):
    """tests/test_parallel.py's engine drive: three clips of three chunks,
    each stream's finals (text, start, end)."""
    rng = np.random.default_rng(seed)
    clips = [rng.integers(-20000, 20000, n * 3).astype(np.int32) for _ in range(3)]
    sids = [engine.open_stream() for _ in clips]
    for sid, clip in zip(sids, clips):
        for i in range(len(clip) // n):
            engine.feed(sid, clip[i * n:(i + 1) * n])
        engine.close_stream(sid)
    finals = {sid: [] for sid in sids}
    for _ in range(len(clips[0]) // n + 2):
        for sid, futures in engine.tick().items():
            finals[sid].extend((p.text, p.start_time, p.end_time)
                               for p in (f.result(timeout=60) for f in futures))
    engine.shutdown()
    return [finals[sid] for sid in sids]


@pytest.mark.parametrize("n_data", [2, 4])
def test_engine_finals_on_mesh_match_one_device_and_jax(tiny, n_data):
    jc, tc, jv, tv = tiny
    n_slots = 8
    sharding = TM.arena_shardings(_cpus(n_data), tc, n_slots)
    sharded = MultiStreamEngine(tv, tc, n_slots=n_slots, sharding=sharding)
    assert sharded.arena.device == torch.device("cpu")
    assert sharded.arena.slots_per_device == n_slots // n_data
    got = _run_engine(sharded)
    assert got == _run_engine(MultiStreamEngine(tv, tc, n_slots=n_slots, device="cpu"))
    jmesh = JM.make_mesh(n_data=n_data, devices=jax.devices()[:n_data])
    jsharding = JM.stream_state_shardings(jmesh, jax_init_streaming_state(jc, n_slots))
    assert got == _run_engine(JaxEngine(jv, jc, n_slots=n_slots, sharding=jsharding))
    assert any(got)


def test_arena_on_mesh_ticks_and_migrates_slots(tiny):
    """The split arena's logprobs equal the unsplit arena's (float32), and a
    slot's state is read from and written to the device that owns it."""
    _, tc, _, tv = tiny
    n_slots = 6
    sharded = StreamArena(tv, tc, n_slots, sharding=TM.arena_shardings(_cpus(3), tc, n_slots))
    plain = StreamArena(tv, tc, n_slots, device="cpu")
    rng = np.random.default_rng(11)
    for step in range(3):
        chunks = rng.integers(-20000, 20000, (n_slots, 2400)).astype(np.int16)
        active = rng.random(n_slots) < 0.7
        reset = np.zeros(n_slots, bool) if step else np.ones(n_slots, bool)
        np.testing.assert_allclose(sharded.tick(chunks, active, reset),
                                   plain.tick(chunks, active, reset), atol=1e-5, rtol=0)
    for slot in range(n_slots):
        np.testing.assert_allclose(sharded.read_slot(slot).astype(np.float32),
                                   plain.read_slot(slot).astype(np.float32), atol=2e-3)
    blob = plain.read_slot(1)
    sharded.write_slot(4, blob)  # slot 4 lives on the third device (2 slots each)
    np.testing.assert_array_equal(sharded.read_slot(4), blob)
    with pytest.raises(ValueError, match="not both"):
        StreamArena(tv, tc, n_slots, device="cpu",
                    sharding=TM.arena_shardings(_cpus(3), tc, n_slots))


# ---------------------------------------------------------------------------
# The CLI's --data-parallel (two CPU devices in place of every GPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def two_cpu_mesh(monkeypatch):
    made, two = [], _cpus(2)

    def make_mesh(n_data=None, n_model=1, devices=None):
        made.append(devices)
        return two

    monkeypatch.setattr(TM, "make_mesh", make_mesh)
    return made


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory, tiny):
    from tone_tpu_torch.checkpoint import save_checkpoint

    _, tc, _, tv = tiny
    path = tmp_path_factory.mktemp("model")
    save_checkpoint(path, tv, tc)
    return path


def _write_wavs(tmp_path):
    paths = []
    for k, samples in enumerate(_audios((9000, 4000, 6500), seed=5)):
        paths.append(tmp_path / f"a{k}.wav")
        with wave.open(str(paths[-1]), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(samples.astype(np.int16).tobytes())
    return paths


def test_cli_transcribe_and_eval_data_parallel(tmp_path, capsys, two_cpu_mesh, tiny_checkpoint):
    from tone_tpu_torch.__main__ import main

    wavs = _write_wavs(tmp_path)
    base = ["--checkpoint", str(tiny_checkpoint), "--device", "cpu"]
    main(["transcribe", *map(str, wavs), "--batch-size", "2", "--json", *base])
    want = capsys.readouterr().out
    assert not two_cpu_mesh
    main(["transcribe", *map(str, wavs), "--batch-size", "2", "--json", "--data-parallel", *base])
    assert capsys.readouterr().out == want
    assert two_cpu_mesh == [["cpu"]]

    manifest = tmp_path / "m.jsonl"
    manifest.write_text("".join(json.dumps({"audio_filepath": str(p), "text": "да"}) + "\n"
                                for p in wavs), encoding="utf-8")
    reports = []
    for flags in ([], ["--data-parallel"]):
        main(["eval", str(manifest), "--batch-size", "2", *flags, *base])
        reports.append(json.loads(capsys.readouterr().out))
    assert reports[0]["wer"] == reports[1]["wer"] and reports[0]["utterances"] == 3
    with pytest.raises(SystemExit, match="multiple"):
        main(["eval", str(manifest), "--batch-size", "3", "--data-parallel", *base])


def test_cli_serve_data_parallel(monkeypatch, two_cpu_mesh, tiny_checkpoint):
    from tone_tpu_torch import __main__ as cli

    parse = cli.build_parser().parse_args
    base = ["--checkpoint", str(tiny_checkpoint), "--device", "cpu"]

    def no_model(args):
        raise AssertionError("the model loaded before the slot check")

    with monkeypatch.context() as m:
        m.setattr(cli, "build_model", no_model)
        with pytest.raises(SystemExit, match=r"--slots \(3\) must be a multiple of the "
                                             r"device count \(2\)"):
            cli.build_engine(parse(["serve", "--slots", "3", "--data-parallel", *base]))
    engine = cli.build_engine(parse(["serve", "--slots", "4", "--data-parallel", *base]))
    plain = cli.build_engine(parse(["serve", "--slots", "4", *base]))
    assert engine.arena.slots_per_device == 2 and plain.arena.slots_per_device == 4
    assert _run_engine(engine) == _run_engine(plain)
