"""The PyTorch port stands alone: nothing under tone_tpu_torch/, and nothing
in chip_smoke.py or the port's dev scripts (dev/torch_*.py), imports jax or
the JAX package tone_tpu; its native decoder is built from its own copy of
the C++ source, under tone_tpu_torch/."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((REPO / "tone_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
              + sorted((REPO / "dev").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tone_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_tone_tpu_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


@pytest.mark.parametrize("module", [
    "tone_tpu_torch", "tone_tpu_torch.acoustic", "tone_tpu_torch.runtime.server",
    "tone_tpu_torch.__main__", "tone_tpu_torch.decoding.device_lm",
    "tone_tpu_torch.decoding.native", "tone_tpu_torch.offline", "tone_tpu_torch.eval",
    "tone_tpu_torch.ops.align_device"])
def test_import_leaves_jax_out_of_sys_modules(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_needs_the_package(tmp_path):
    """In a directory holding only chip_smoke.py the script fails and prints
    no result (without a GPU it fails before that)."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_native_decoder_is_built_from_the_ports_own_source():
    """The C++ decoder builds from the port's copy of the source into the
    port's build directory, and loads nothing of the JAX package's."""
    from tone_tpu_torch.decoding.native import beamsearch

    port = REPO / "tone_tpu_torch"
    assert beamsearch._SRC.resolve().is_relative_to(port)
    assert beamsearch._LIB.resolve().is_relative_to(port / "_kernels")
    src = beamsearch._SRC.read_text(encoding="utf-8")
    assert "extern \"C\"" in src and "tone_ctc_beam_search" in src
    code = ("import sys; from tone_tpu_torch.decoding.native import beamsearch as b; "
            "assert b.build_native(); b._load(); import ctypes, os; "
            "maps = open('/proc/self/maps').read(); "
            "sys.exit(1 if 'tone_tpu/decoding/native' in maps else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
