"""What a run may load: nothing whose top-level module name is JAX's, its
libraries' or the JAX package's (``tone_tpu``; the port, ``tone_tpu_torch``,
is another name); the plain reference loads nothing of the port; the load
clients load neither torch nor the port."""

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def loaded(code: str) -> set[str]:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``, run with the harness's directories on its path."""
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, check=True, cwd=str(BENCH.parent))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_traffic_metrics_and_reference_load_no_jax():
    metrics = sorted(p.name for p in (BENCH / "metrics").glob("*.py"))
    kinds = sorted(p.stem for p in (BENCH / "traffic").glob("*.py") if p.stem != "__init__")
    code = "\n".join([
        "import run",
        "from harness import audio, cell, compare, flops, program, readers, report, trace, weights",
        "import reference.model, reference.decode, reference.train",
        *[f"import traffic.{k}" for k in kinds],
        "from harness.trace import read_metric",
        "import importlib.util",
        *[f"s = importlib.util.spec_from_file_location('m{i}', {str(BENCH / 'metrics' / m)!r})\n"
          "m = importlib.util.module_from_spec(s)\ns.loader.exec_module(m)\nassert callable(m.read)"
          for i, m in enumerate(metrics)],
        "import tone_tpu_torch.runtime.server, tone_tpu_torch.offline, tone_tpu_torch.training.train",
    ])
    names = loaded(code)
    assert "tone_tpu_torch" in names and "traffic" in names
    assert not names & {"jax", "jaxlib", "flax", "tone_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = loaded("import reference.model, reference.decode, reference.train")
    assert not names & {"tone_tpu_torch", "tone_tpu", "jax", "harness", "traffic"}


def test_clients_load_neither_torch_nor_the_port():
    names = loaded("import traffic.voicebot_client, websockets.asyncio.client")
    assert not names & {"torch", "tone_tpu_torch", "tone_tpu", "jax"}


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, str(BENCH))
    from harness.cell import forbidden_loaded

    assert forbidden_loaded(["tone_tpu_torch", "tone_tpu_torch.core", "jaxtyping"]) == []
    assert forbidden_loaded(["tone_tpu.config", "jax", "numpy"]) == ["jax", "tone_tpu.config"]
