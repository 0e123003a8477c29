"""Deploying the port: its wheel (built from a copy of the packaging inputs,
never in the repo, where tests/test_packaging.py builds the JAX package's)
installed into a read-only prefix and run as an unprivileged user; where
its kernels and host libraries build (``ops/_build.py build_dir``); the
``tone-tpu-torch`` console script and the ``runtime.server`` alias of
``serve``; the serving image ``Dockerfile.torch`` and its compose stack,
read statically, and ``chip_smoke.py``'s ``deploy`` phase reading them.

Root ignores ``chmod``: run as root, the installed copy's children run as
uid 65534 (the image's unprivileged user); where that uid cannot reach the
scratch tree, they run as root and a file stands where the package's
``_kernels/`` would be created."""

from __future__ import annotations

import configparser
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import tomllib
import zipfile
from pathlib import Path

import pytest
import torch
import yaml

from test_torch_common import ARTIFACT_ENCODER, audio, tiny_configs
from tone_tpu_torch import __main__ as TMAIN
from tone_tpu_torch import export as TE
from tone_tpu_torch.audio.flac_write import encode_flac
from tone_tpu_torch.checkpoint import save_checkpoint
from tone_tpu_torch.core.model import init_model_params
from tone_tpu_torch.decoding.native import beamsearch
from tone_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
INPUTS = ("pyproject.toml", "README.md", "LICENSE", "tone_tpu", "tone_tpu_torch")
NOBODY = 65534
PIP = [sys.executable, "-m", "pip", "--disable-pip-version-check", "--no-cache-dir"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()


# -- the wheel, installed read-only -------------------------------------------


@pytest.fixture(scope="module")
def work():
    """A scratch tree every user can search (pytest's own are 0700)."""
    root = Path(tempfile.mkdtemp(prefix="tone_deploy_test_"))
    root.chmod(0o755)
    yield root
    subprocess.run(["chmod", "-R", "u+w", str(root)], check=False)
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def wheel(work):
    src = work / "src"
    src.mkdir()
    for name in INPUTS:
        if (REPO / name).is_dir():
            shutil.copytree(REPO / name, src / name, ignore=shutil.ignore_patterns(
                "_kernels", "__pycache__", "*.so", "*.pyc"))
        else:
            shutil.copy2(REPO / name, src / name)
    subprocess.run([*PIP, "wheel", "--no-deps", "--no-build-isolation", "--no-index",
                    "-w", str(work / "dist"), str(src)], check=True, capture_output=True)
    (path,) = (work / "dist").glob("tone_tpu-*.whl")
    return path


@pytest.fixture(scope="module")
def installed(wheel, work):
    site = work / "site"
    subprocess.run([*PIP, "install", "--no-deps", "--no-index", "--no-warn-script-location",
                    "--target", str(site), str(wheel)], check=True, capture_output=True)
    subprocess.run(["chmod", "-R", "a-w", str(site)], check=True)
    return site


def _env(site: Path, home: Path, xdg: Path) -> dict:
    """The installed copy alone on the path; no nvcc (none here either)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "TONE_TPU_COMPILE_CACHE", "TONE_TPU_MODEL_DIR",
                        "CUDA_PATH")}
    env.update(PYTHONPATH=str(site), HOME=str(home), TMPDIR=str(home),
               XDG_CACHE_HOME=str(xdg), CUDA_HOME=str(home / "no-cuda"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    env["PATH"] = os.pathsep.join(d for d in env["PATH"].split(os.pathsep)
                                  if not (Path(d) / "nvcc").exists())
    return env


@pytest.fixture(scope="module")
def runner(installed, work):
    """Runs Python code or a command against the installed copy, from an
    empty directory, as an unprivileged user; ``real`` where the package
    directory is unwritable by permissions (not by a file in the way)."""
    user: dict = {}
    real = True
    if os.geteuid() == 0:
        user = {"user": NOBODY, "group": NOBODY, "extra_groups": []}
        probe = subprocess.run([sys.executable, "-c", "import torch, tone_tpu_torch"],
                               cwd="/", env=_env(installed, work, work), capture_output=True,
                               **user)
        if probe.returncode != 0:
            user, real = {}, False
            (installed / "tone_tpu_torch" / "_kernels").write_text("")

    def owned(name: str) -> Path:
        path = work / name
        path.mkdir()
        if user:
            os.chown(path, NOBODY, NOBODY)
        return path

    def run(name: str, argv: list[str], xdg: Path | None = None) -> str:
        home = owned(name)
        proc = subprocess.run(argv, cwd=home, env=_env(installed, home, xdg or home / "cache"),
                              capture_output=True, text=True, timeout=600, **user)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    run.real = real
    run.site = installed
    return run


PORT_FILES = ["py.typed", "csrc/*.cu", "csrc/*.cuh", "runtime/static/index.html",
              "decoding/native/src/*.cpp", "examples/*.ipynb", "dev/*.ipynb"]


@pytest.mark.parametrize("pattern", PORT_FILES)
def test_wheel_carries_the_port_files(wheel, pattern):
    names = set(zipfile.ZipFile(wheel).namelist())
    files = sorted((REPO / "tone_tpu_torch").glob(pattern))
    assert files, pattern
    for path in files:
        assert path.relative_to(REPO).as_posix() in names
    assert not [n for n in names if "/_kernels/" in n or n.endswith(".so")]


def test_wheel_names_the_console_script(wheel):
    with zipfile.ZipFile(wheel) as whl:
        (name,) = [n for n in whl.namelist() if n.endswith(".dist-info/entry_points.txt")]
        entry = configparser.ConfigParser()
        entry.read_string(whl.read(name).decode())
    assert entry["console_scripts"]["tone-tpu-torch"] == "tone_tpu_torch.__main__:main"
    assert entry["console_scripts"]["tone-tpu"] == "tone_tpu.__main__:main"


def test_installed_kernel_builds_go_to_the_user_cache(runner):
    """From the read-only install the build directory is the user's cache,
    and a build gets as far as looking for nvcc (instead of failing to
    create the package's ``_kernels/``)."""
    out = json.loads(runner("kernel", [sys.executable, "-c", """
import json
from tone_tpu_torch.ops import _build
out = {"package": str(_build.PACKAGE_DIR), "glu_ff": str(_build.library_path("glu_ff"))}
try:
    _build.build("glu_ff")
except Exception as e:
    out["error"] = [type(e).__name__, str(e)]
print(json.dumps(out))
"""]))
    assert out["package"] == str(runner.site / "tone_tpu_torch")
    cache = runner.site.parent / "kernel" / "cache" / "tone_tpu_torch" / "kernels"
    assert out["glu_ff"] == str(cache / _build.library_path("glu_ff").name)
    assert out["error"][0] == "RuntimeError" and "nvcc not found" in out["error"][1]


def test_installed_build_native_builds_in_the_user_cache(runner):
    out = json.loads(runner("native", [sys.executable, "-c", """
import json
from tone_tpu_torch.decoding.native import beamsearch
print(json.dumps([beamsearch.build_native(), beamsearch.native_available(),
                  str(beamsearch.library_path())]))
"""]))
    cache = runner.site.parent / "native" / "cache" / "tone_tpu_torch" / "kernels"
    assert out[:2] == [True, True]
    assert Path(out[2]) == cache / beamsearch.library_path().name
    assert Path(out[2]).is_file()


def test_installed_build_native_false_where_nothing_is_writable(runner, work):
    """With the user's cache unwritable too, the host libraries give False,
    as the JAX package's ``build_native`` does from the same copy, and a
    kernel build raises naming both directories."""
    blocker = work / "blocker"
    blocker.write_text("")
    out = json.loads(runner("nothing", [sys.executable, "-c", f"""
import json
from tone_tpu_torch.decoding.native import beamsearch, estimate
from tone_tpu_torch.ops import _build
out = {{"port": [beamsearch.build_native(), estimate.build_native()]}}
try:
    _build.build("glu_ff")
except PermissionError as e:
    out["error"] = str(e)
if {runner.real}:
    from tone_tpu.decoding.native import build_native
    from tone_tpu.decoding.native.estimate import build_native as build_estimate
    out["jax"] = [build_native(), build_estimate()]
print(json.dumps(out))
"""], xdg=blocker / "cache"))
    assert out["port"] == [False, False]
    assert str(runner.site / "tone_tpu_torch" / "_kernels") in out["error"]
    assert str(blocker / "cache" / "tone_tpu_torch" / "kernels") in out["error"]
    if runner.real:
        assert out["jax"] == [False, False]


def test_installed_console_script_transcribes(runner, work, capsys):
    """``tone-tpu-torch transcribe`` from the installed copy prints the
    in-repo CLI's phrases for the same checkpoint and audio."""
    _, config = tiny_configs("float32", ARTIFACT_ENCODER)
    save_checkpoint(work / "model", init_model_params(torch.Generator().manual_seed(3), config),
                    config)
    encode_flac(work / "a.flac", audio(12000, seed=5))
    args = ["transcribe", str(work / "a.flac"), "--json", "--device", "cpu", "--checkpoint",
            str(work / "model")]
    out = runner("cli", [str(runner.site / "bin" / "tone-tpu-torch"), *args])
    TMAIN.main(args)
    want = capsys.readouterr().out
    assert "RANDOM" not in out
    (record,) = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    (expected,) = [json.loads(ln) for ln in want.splitlines() if ln.startswith("{")]
    assert record == expected and record["phrases"]


def test_server_module_is_the_serve_subcommand(runner):
    """``python -m tone_tpu_torch.runtime.server`` forwards to ``serve``."""
    alias = runner("alias", [sys.executable, "-m", "tone_tpu_torch.runtime.server", "--help"])
    serve = runner("serve", [sys.executable, "-m", "tone_tpu_torch", "serve", "--help"])
    assert alias == serve and "--metrics-port" in alias


# -- where the libraries build --------------------------------------------------


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """No build directory chosen yet, the package at ``tmp_path/pkg``."""
    monkeypatch.setattr(_build, "BUILD_DIR", None)
    monkeypatch.setattr(_build, "PACKAGE_DIR", tmp_path / "pkg")
    (tmp_path / "pkg").mkdir()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    return tmp_path


def test_build_dir_is_the_package_dir_where_writable(fresh):
    assert _build.build_dir() == fresh / "pkg" / "_kernels"
    assert _build.library_path("glu_ff").parent == fresh / "pkg" / "_kernels"
    assert beamsearch.library_path().parent == fresh / "pkg" / "_kernels"


@pytest.mark.parametrize("cache", ["xdg", "home"])
def test_build_dir_falls_back_to_the_user_cache(fresh, monkeypatch, cache):
    (fresh / "pkg" / "_kernels").write_text("")  # a file in the way, as root meets it
    if cache == "home":
        monkeypatch.delenv("XDG_CACHE_HOME")
        monkeypatch.setenv("HOME", str(fresh / "home"))
        want = fresh / "home" / ".cache" / "tone_tpu_torch" / "kernels"
    else:
        want = fresh / "cache" / "tone_tpu_torch" / "kernels"
    assert _build.build_dir() == want and want.is_dir()
    monkeypatch.setenv("XDG_CACHE_HOME", str(fresh / "elsewhere"))
    assert _build.library_path("glu_ff").parent == want  # chosen once


@pytest.mark.parametrize("when", ["before", "after"])
def test_compilation_cache_overrides_the_choice(fresh, when):
    if when == "after":
        assert _build.build_dir() == fresh / "pkg" / "_kernels"
    assert TE.enable_compilation_cache(fresh / "cc")
    assert _build.build_dir() == (fresh / "cc").resolve()
    assert beamsearch.library_path().parent == (fresh / "cc").resolve()


def test_library_built_elsewhere_is_found_by_name(fresh, monkeypatch):
    """A library prebuilt into the compile cache is used without nvcc."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(fresh / "no-cuda"))
    assert TE.enable_compilation_cache(fresh / "cc")
    prebuilt = fresh / "cc" / _build.library_path("glu_ff").name
    prebuilt.write_bytes(b"")
    assert _build.build("glu_ff") == prebuilt.resolve()


def test_nothing_writable_raises_and_host_libraries_give_false(fresh, monkeypatch):
    (fresh / "pkg" / "_kernels").write_text("")
    (fresh / "blocker").write_text("")
    monkeypatch.setenv("XDG_CACHE_HOME", str(fresh / "blocker" / "cache"))
    with pytest.raises(PermissionError) as e:
        _build.build("glu_ff")
    assert str(fresh / "pkg" / "_kernels") in str(e.value)
    assert str(fresh / "blocker" / "cache" / "tone_tpu_torch" / "kernels") in str(e.value)
    assert _build.BUILD_DIR is None
    library = _build.GxxLibrary(beamsearch._SRC, beamsearch._declare)
    assert library.build() is False and library.load() is None


# -- the serving image and its stack ---------------------------------------------


@pytest.fixture(scope="module")
def image():
    return CHIP_SMOKE.deploy_image()


def test_image_entrypoint_is_the_serve_command(image):
    argv = image["entrypoint"]
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts[argv[0]] == "tone_tpu_torch.__main__:main"
    args = TMAIN.build_parser().parse_args(argv[1:])
    assert args.command == "serve" and args.device is None  # the GPU
    assert args.checkpoint == Path(image["env"]["TONE_TPU_MODEL_DIR"])
    assert (args.host, args.port, args.metrics_port) == ("0.0.0.0", 8080, 8002)


def test_image_env_names_what_the_runtime_stage_makes(image):
    stages = CHIP_SMOKE.dockerfile_stages()
    build, runtime = stages[0], stages[-1]
    cache, models = image["env"]["TONE_TPU_COMPILE_CACHE"], image["env"]["TONE_TPU_MODEL_DIR"]
    copies = [arg.split()[-2:] for word, arg in runtime
              if word == "COPY" and arg.startswith("--from=build")]
    assert [cache, cache] in copies
    runs = " ".join(arg for word, arg in runtime if word == "RUN")
    assert f"mkdir -p {models}" in runs
    assert f"chown -R {image['user']} {str(Path(cache).parent)}" in runs
    assert build[0][1].endswith("-devel AS build") and runtime[0][1].endswith("-runtime")
    installs = [arg for word, arg in build + runtime if word == "RUN" and "pip install" in arg]
    assert installs and all("--no-deps" in arg for arg in installs)


def test_image_user_and_stop_signal(image):
    runtime = CHIP_SMOKE.dockerfile_stages()[-1]
    assert image["user"] not in ("root", "0")
    assert any(word == "RUN" and "useradd" in arg and image["user"] in arg
               for word, arg in runtime)
    assert ("STOPSIGNAL", "SIGINT") in runtime


def test_image_prebuilds_every_kernel_and_host_library(image):
    code = image["prebuild"]
    compile(code, "prebuild", "exec")
    for source in sorted((REPO / "tone_tpu_torch" / "csrc").glob("*.cu")):
        assert f"'{source.stem}'" in code
    assert "beamsearch.build_native" in code and "estimate.build_native" in code
    assert f"enable_compilation_cache('{image['env']['TONE_TPU_COMPILE_CACHE']}')" in code


@pytest.fixture(scope="module")
def compose():
    return yaml.safe_load((REPO / "scripts" / "docker-compose.torch.yml").read_text())


def test_compose_builds_the_image_and_reserves_a_gpu(compose):
    (service,) = compose["services"].values()
    assert service["build"]["dockerfile"] == "Dockerfile.torch"
    assert (REPO / "scripts" / service["build"]["context"] / "Dockerfile.torch").is_file()
    assert service["deploy"]["resources"]["reservations"]["devices"] == [
        {"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}]
    assert service["stop_signal"] == "SIGINT"


def test_compose_health_ports_and_volumes_follow_the_entrypoint(compose, image):
    (service,) = compose["services"].values()
    args = TMAIN.build_parser().parse_args(image["entrypoint"][1:])
    assert f"localhost:{args.metrics_port}/v2/health/ready" in " ".join(
        service["healthcheck"]["test"])
    assert {f"{args.port}:{args.port}", f"{args.metrics_port}:{args.metrics_port}"} == set(
        service["ports"])
    targets = {re.search(r":(/[^:]*)(:r[ow])?$", v).group(1) for v in service["volumes"]}
    assert {image["env"]["TONE_TPU_MODEL_DIR"],
            str(Path(image["env"]["TONE_TPU_COMPILE_CACHE"]).parent)} == targets
    assert service["environment"]["TONE_TPU_MODEL_DIR"] == image["env"]["TONE_TPU_MODEL_DIR"]


def test_chip_smoke_deploy_runs_the_image_argv(image):
    """The deploy phase's server and prebuild come from the Dockerfile's own
    lines, so the two cannot drift."""
    text = (REPO / "Dockerfile.torch").read_text().replace("\\\n", "")
    entry = json.loads(re.search(r"^ENTRYPOINT (\[.*\])$", text, re.M).group(1))
    site, model = Path("/site"), Path("/model")
    local = {"--checkpoint": str(model), "--host": "127.0.0.1", "--port": "1234",
             "--metrics-port": "5678"}
    want = [str(site / "bin" / entry[0])] + [local.get(a, b) for a, b in zip(entry, entry[1:])]
    assert CHIP_SMOKE.deploy_argv(image, site, model, 1234, 5678) == want
    assert "--port" in want and "--metrics-port" in want
    assert CHIP_SMOKE.prebuild_code(image, Path("/x")) == image["prebuild"].replace(
        image["env"]["TONE_TPU_COMPILE_CACHE"], "/x")
    assert "deploy" in CHIP_SMOKE.PHASES
