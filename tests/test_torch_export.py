"""The port's export module (tone_tpu_torch/export.py) and profiling helpers
(tone_tpu_torch/profiling.py): ``torch.export`` artifacts of the streaming
step against the eager port and against the JAX package's StableHLO
artifact (tone_tpu/export.py), the compile cache as the kernels' build
directory, the warmup, the two-point step statistics and the trace."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tone_tpu.export as JE
from test_torch_common import ARTIFACT_ENCODER, audio, tiny_configs, tiny_variables
from tone_tpu.core.model import init_streaming_state as jax_init_state
from tone_tpu_torch import export as TE
from tone_tpu_torch.acoustic import StreamingCTCModel
from tone_tpu_torch.ops import _build

STEPS = 3
# (dtype, batch sizes exported): float32 at B = 1 and 2, bf16 (B1 inside the
# program) at B = 2.
EXPORTS = {"float32": (1, 2), "bfloat16": (2,)}


class _Exports:
    """Each dtype's artifacts exported once, each artifact loaded once."""

    def __init__(self, tmp_path_factory):
        self._tmp = tmp_path_factory
        self._made, self._fns, self._programs = {}, {}, {}

    def get(self, dtype):
        """(JAX config, JAX variables, port model, artifact paths by B, out dir)."""
        if dtype not in self._made:
            jc, tc = tiny_configs(dtype, ARTIFACT_ENCODER)
            jv, tv = tiny_variables(jc, tc, seed=7)
            model = StreamingCTCModel(tv, tc, device="cpu")
            out = self._tmp.mktemp(f"export_{dtype}")
            paths = TE.export_streaming(model.variables, tc, EXPORTS[dtype], out)
            self._made[dtype] = jc, jv, model, dict(zip(EXPORTS[dtype], paths)), out
        return self._made[dtype]

    def fn(self, dtype, b):
        """The artifact through ``load_exported``."""
        if (dtype, b) not in self._fns:
            self._fns[dtype, b] = TE.load_exported(self.get(dtype)[3][b])
        return self._fns[dtype, b]

    def program(self, dtype, b):
        """The artifact as torch.export loads it."""
        if (dtype, b) not in self._programs:
            self._programs[dtype, b] = torch.export.load(str(self.get(dtype)[3][b]))
        return self._programs[dtype, b]


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    return _Exports(tmp_path_factory)


def _chunks(b, cfg, seed=0):
    return np.split(audio(cfg.audio_chunk_samples * STEPS, batch=b, seed=seed), STEPS, axis=1)


@pytest.mark.parametrize("dtype, b", [("float32", 1), ("float32", 2), ("bfloat16", 2)])
def test_exported_step_equals_eager(exports, dtype, b):
    """Logprobs and every state tensor of the loaded program equal the eager
    port's to the bit over three chunks (the state carried in place)."""
    model = exports.get(dtype)[2]
    fn = exports.fn(dtype, b)
    s_eager, s_exp = model.init_state(b), model.init_state(b)
    for chunk in _chunks(b, model.config, seed=b):
        chunk = torch.as_tensor(chunk)
        lp_eager, s_eager = model.forward_native(chunk, s_eager)
        lp_exp, s_exp = fn(model.variables, chunk, s_exp)
        torch.testing.assert_close(lp_exp, lp_eager, rtol=0, atol=0)
    for a, c in zip(torch.utils._pytree.tree_leaves(s_exp),
                    torch.utils._pytree.tree_leaves(s_eager)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_program_calls_the_registered_kernel_op(exports, dtype):
    """The bf16 program records B1 as the registered op (two per layer: the
    kernel on CUDA tensors, the plain version on CPU tensors); the float32
    program has none (the float32 model never reaches B1)."""
    model, out = exports.get(dtype)[2], exports.get(dtype)[4]
    program = exports.program(dtype, 2)
    calls = sum(str(n.target) == "tone_tpu_torch.glu_ff2.default"
                for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
                for n in gm.graph.nodes)
    assert calls == (2 * model.config.encoder.n_layers if dtype == "bfloat16" else 0)
    # the artifact holds the program, not the weights it was traced with
    assert program.example_inputs is None
    meta = json.loads((out / "export_config.json").read_text())
    assert meta["batch_sizes"] == list(EXPORTS[dtype]) and meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    assert meta["config"] == json.loads(json.dumps(model.config.to_dict()))


def test_exported_matches_jax_artifact(exports, tmp_path):
    """The port's program and JAX's StableHLO artifact of the same float32
    step agree within 1e-4 over three chunks."""
    jc, jv, model, _, _ = exports.get("float32")
    b = 2
    jfn = JE.load_exported(JE.export_streaming(jv, jc, [b], tmp_path)[0])
    tfn = exports.fn("float32", b)
    js, ts = jax_init_state(jc, b), model.init_state(b)
    for chunk in _chunks(b, model.config, seed=11):
        jlp, js = jfn(jv, jnp.asarray(chunk), js)
        tlp, ts = tfn(model.variables, torch.as_tensor(chunk), ts)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4, rtol=0)


def test_compile_cache_redirects_the_builds(tmp_path, monkeypatch):
    from tone_tpu_torch.decoding.native import beamsearch, estimate

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    assert TE.enable_compilation_cache(tmp_path / "cache")
    assert _build.BUILD_DIR == (tmp_path / "cache").resolve()
    for path in (_build.library_path("glu_ff"), beamsearch.library_path(),
                 estimate.library_path()):
        assert path.parent == (tmp_path / "cache").resolve()
    assert estimate.library_path().name.startswith("libtone_estimate-")


def test_compile_cache_unusable_directory_returns_false(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    before = _build.BUILD_DIR
    blocker = tmp_path / "blocker"
    blocker.write_text("")  # a file in the path: mkdir fails, as on a root-owned mount
    assert TE.enable_compilation_cache(blocker / "cache") is False
    assert _build.BUILD_DIR == before
    assert "compile cache disabled" in caplog.text


def test_aot_warmup_and_step_stats():
    from tone_tpu_torch.profiling import step_stats

    jc, tc = tiny_configs("bfloat16", ARTIFACT_ENCODER)
    _, tv = tiny_variables(jc, tc, seed=8)
    model = StreamingCTCModel(tv, tc, device="cpu")
    TE.aot_warmup(model, [1, 3])
    stats = step_stats(model, 2, steps=(2, 4))
    assert stats.batch == 2 and stats.seconds_per_step > 0
    assert stats.rtfx == pytest.approx(2 * 0.3 / stats.seconds_per_step)
    assert stats.chunk_latency_ms == pytest.approx(stats.seconds_per_step * 1e3)


def test_trace_writes_a_chrome_trace(tmp_path):
    from tone_tpu_torch.offline import OfflineTranscriber
    from tone_tpu_torch.profiling import trace

    jc, tc = tiny_configs("float32", ARTIFACT_ENCODER)
    _, tv = tiny_variables(jc, tc, seed=7)
    transcriber = OfflineTranscriber(tv, tc, batch_size=2, device="cpu")
    with trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(8).sum()
        transcriber.transcribe([audio(3000, seed=1), audio(5000, seed=2)])
    with open(os.path.join(log_dir, "trace.json"), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    # the program's spans beside the operations they dispatched
    assert {"offline.assemble", "offline.forward", "offline.wait", "offline.split",
            "offline.decode"} <= names
