"""The port's package data (pyproject.toml) carries every file the port
reads at run time besides its Python modules: the CUDA sources and the plan
headers the kernels compile and ``ops/`` parses, the C++ sources of the
native decoder and LM estimator, and the server's browser page.
(tests/test_packaging.py builds the JAX package's wheel.)"""

import fnmatch
import tomllib
from pathlib import Path

import pytest

from tone_tpu_torch.decoding.native import beamsearch, estimate
from tone_tpu_torch.ops import _build, fused_layer, glu_ff
from tone_tpu_torch.runtime import server

REPO = Path(__file__).resolve().parent.parent


def _package_data() -> list[tuple[Path, str]]:
    """(package directory, pattern) of every package-data entry of the port."""
    data = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]
    out = []
    for package, patterns in data["package-data"].items():
        if package.split(".")[0] == "tone_tpu_torch":
            out += [(REPO / package.replace(".", "/"), p) for p in patterns]
    return out


def _runtime_files() -> list[Path]:
    files = [*sorted(_build.SOURCE_DIR.glob("*.cu")), *sorted(_build.SOURCE_DIR.glob("*.cuh")),
             beamsearch._SRC, estimate._SRC,
             Path(server.__file__).parent / "static" / "index.html"]
    return [f.resolve() for f in files]


def _shipped(path: Path) -> bool:
    return any(path.is_relative_to(root.resolve())
               and fnmatch.fnmatch(path.relative_to(root.resolve()).as_posix(), pattern)
               for root, pattern in _package_data())


@pytest.mark.parametrize("path", _runtime_files(), ids=lambda p: p.name)
def test_runtime_file_is_package_data(path):
    assert path.is_file()
    assert _shipped(path), f"{path.relative_to(REPO)} is not in pyproject's package data"


def test_plan_headers_are_the_ones_the_kernels_read():
    """B1 and B2 compile and ``ops/`` parses these headers."""
    names = {p.name for p in _runtime_files()}
    assert {glu_ff.PLAN_HEADER, fused_layer.PLAN_HEADER} <= names
    for src in _build.SOURCE_DIR.glob("*.cu"):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in names, (src.name, line)


def test_package_data_names_only_existing_files():
    for root, pattern in _package_data():
        assert list(root.glob(pattern)), f"{root.relative_to(REPO)}/{pattern} matches nothing"


@pytest.mark.parametrize("package", ["tone_tpu_torch.examples", "tone_tpu_torch.dev"])
def test_recipe_subpackages_are_found(package):
    """pyproject.toml's ``packages.find`` ships the port's recipes."""
    from setuptools import find_packages

    find = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"][
        "packages"]["find"]
    assert package in find_packages(str(REPO), include=find["include"])
