"""The Hugging Face Hub path of the port (``tone_tpu_torch/hub.py``, the
entry points over it and ``tone_tpu_torch/dev/push_hf.py``) against the JAX
package's (``huggingface_hub``), both through one local endpoint
(``tone_tpu_torch/dev/local_hub.py`` on 127.0.0.1): no request leaves the
machine.

``huggingface_hub`` reads ``HF_ENDPOINT``, ``HF_HOME`` and
``HF_HUB_OFFLINE`` when it is imported, so JAX's side runs in fresh
interpreters, five in all; the port reads them on every call.  Tolerances:

* downloads, the ``download`` CLI and the pushed LM, VAD and exported files:
  byte-equal; the two Hub caches: the same relative paths and symlink
  targets (``.locks/`` aside); ``model.safetensors`` and the ``.nemo``
  pushed: equal tensors;
* ``from_hugging_face`` at the default (bf16) ``ToneConfig``: step logprobs
  within 0.05 of JAX's (the stated B1 gate departure, as in
  tests/test_torch_artifacts_cli.py), and equal, bit for bit, to the port's
  ``from_local`` on the downloaded files, with its texts.  Texts are not
  compared across the packages: random weights give bf16 near-ties.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_common import dead_endpoint, tiny_configs, tiny_variables

import tone_tpu.checkpoint as JC
import tone_tpu_torch.checkpoint as TC
from tone_tpu_torch import hub
from tone_tpu_torch.__main__ import main as port_cli
from tone_tpu_torch.acoustic import StreamingCTCModel
from tone_tpu_torch.audio import read_example_audio
from tone_tpu_torch.config import ToneConfig
from tone_tpu_torch.core.model import init_model_params
from tone_tpu_torch.decoder import BeamSearchCTCDecoder
from tone_tpu_torch.decoding.kenlm_binary import write_kenlm_binary
from tone_tpu_torch.dev import push_hf
from tone_tpu_torch.dev.beam_quality_sweep import corpus_lm
from tone_tpu_torch.dev.local_hub import HUB_VARIABLES, LocalHub, hub_env
from tone_tpu_torch.interop import save_torch_checkpoint
from tone_tpu_torch.pipeline import StreamingCTCPipeline

REPO = Path(__file__).resolve().parent.parent
T_ONE = hub.TONE_REPO
BF16_TOL = 0.05
UTTERANCE = 24000   # the first 3 s of the short example
DEPARTURES = {"tone_tpu_checkpoint/": "tone_tpu_torch_checkpoint/",
              "stablehlo/": "torch_export/"}


def _env(**overrides) -> dict:
    """This process's environment without any Hub setting, plus ``overrides``
    (``xet`` off: huggingface_hub would offer it to the endpoint)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(HUB_VARIABLES)}
    return {**env, "HF_HUB_DISABLE_XET": "1", "JAX_PLATFORMS": "cpu",
            **{k: str(v) for k, v in overrides.items()}}


def _jax(code: str, *args, **env) -> dict:
    """``code`` run with ``args`` in a fresh interpreter with the JAX
    package; the JSON object of its last line."""
    proc = subprocess.run([sys.executable, "-c", code, *map(str, args)], cwd=REPO,
                          env=_env(**env), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def cache_tree(home: Path) -> dict:
    """The Hub cache under ``home``: relative path -> the symlink's target,
    the file's sha256 or "dir" (the lock files aside)."""
    root = home / "hub"
    tree = {}
    for p in sorted(root.rglob("*")):
        rel = p.relative_to(root).as_posix()
        if rel.split("/")[0] == ".locks":
            continue
        tree[rel] = (os.readlink(p) if p.is_symlink() else "dir" if p.is_dir()
                     else hashlib.sha256(p.read_bytes()).hexdigest())
    return tree


def _chunks(cfg) -> np.ndarray:
    """The utterance padded as the pipeline pads it, in (n, chunk) rows."""
    x = np.pad(read_example_audio()[:UTTERANCE], (cfg.padding, cfg.padding))
    x = np.pad(x, (0, -len(x) % cfg.audio_chunk_samples))
    return x.reshape(-1, cfg.audio_chunk_samples).astype(np.int32)


JAX_DOWNLOADS = """
import json, sys
import numpy as np
import tone_tpu.__main__ as cli
from tone_tpu.acoustic import StreamingCTCModel
from tone_tpu.decoder import BeamSearchCTCDecoder
from tone_tpu.pipeline import StreamingCTCPipeline

full, acoustic, chunks, out = sys.argv[1:5]
paths = {"model": StreamingCTCModel.download_from_hugging_face(),
         "lm": BeamSearchCTCDecoder.download_from_hugging_face()}
for argv in (["download", full], ["download", acoustic, "--only-acoustic"]):
    sys.argv = ["tone_tpu", *argv]
    cli.main()
model = StreamingCTCPipeline.from_hugging_face().model
state, lps = None, []
for chunk in np.load(chunks):
    lp, state = model.forward_native(chunk[None], state)
    lps.append(np.asarray(lp))
np.save(out, np.concatenate(lps, axis=1))
print(json.dumps(paths))
"""

JAX_FETCH = """
import json, sys
from tone_tpu.acoustic import StreamingCTCModel
from tone_tpu.decoder import BeamSearchCTCDecoder

paths = {"model": StreamingCTCModel.download_from_hugging_face()}
if "lm" in sys.argv[1:]:
    paths["lm"] = BeamSearchCTCDecoder.download_from_hugging_face()
print(json.dumps(paths))
"""


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """The released artifacts (full-width seed-0 weights, a KenLM binary of
    the recipes' bigram LM) on a local endpoint, fetched by both packages:
    JAX's downloads, its ``download`` CLI and its pipeline's logprobs (in
    one interpreter), the port's downloads and ``download`` CLI."""
    tmp = tmp_path_factory.mktemp("released")
    cfg = ToneConfig()
    save_torch_checkpoint(tmp / "model.safetensors",
                          init_model_params(torch.Generator().manual_seed(0), cfg), cfg)
    write_kenlm_binary(corpus_lm(), tmp / "kenlm.bin")
    files = {name: (tmp / name).read_bytes() for name in ("model.safetensors", "kenlm.bin")}
    np.save(tmp / "chunks.npy", _chunks(cfg))
    run = {"files": files, "tmp": tmp, "cfg": cfg}
    with LocalHub({T_ONE: files}) as local:
        run["url"] = local.url
        run["jax"] = _jax(JAX_DOWNLOADS, tmp / "jax_full", tmp / "jax_ac", tmp / "chunks.npy",
                          tmp / "jax_lp.npy", HF_ENDPOINT=local.url,
                          HF_HOME=tmp / "jax_home")
        with hub_env(HF_ENDPOINT=local.url, HF_HOME=tmp / "port_home"):
            run["port"] = {"model": StreamingCTCModel.download_from_hugging_face(),
                           "lm": BeamSearchCTCDecoder.download_from_hugging_face()}
            port_cli(["download", str(tmp / "port_full")])
            port_cli(["download", str(tmp / "port_ac"), "--only-acoustic"])
        run["requests"] = list(local.requests)
        yield run


@pytest.mark.parametrize("name", ["model", "lm"])
def test_download_matches_huggingface_hub(released, name):
    """Both packages' ``download_from_hugging_face`` give the served bytes,
    at the same path inside each one's cache."""
    jax_path, port_path = Path(released["jax"][name]), Path(released["port"][name])
    served = released["files"]["model.safetensors" if name == "model" else "kenlm.bin"]
    assert jax_path.read_bytes() == port_path.read_bytes() == served
    assert (jax_path.relative_to(released["tmp"] / "jax_home")
            == port_path.relative_to(released["tmp"] / "port_home"))


def test_cache_tree_matches_huggingface_hub(released):
    """The same paths and links: blobs/<etag>, refs/main (the commit) and
    snapshots/<commit>/<file> -> ../../blobs/<etag>."""
    tree = cache_tree(released["tmp"] / "port_home")
    assert tree == cache_tree(released["tmp"] / "jax_home")
    storage = "models--t-tech--T-one"
    commit = (released["tmp"] / "port_home" / "hub" / storage / "refs" / "main").read_text()
    for name, data in released["files"].items():
        assert tree[f"{storage}/snapshots/{commit}/{name}"] == (
            f"../../blobs/{hashlib.sha256(data).hexdigest()}")


@pytest.mark.parametrize("only_acoustic", [False, True])
def test_download_cli_matches_jax(released, only_acoustic):
    """``download DIR [--only-acoustic]`` writes the JAX CLI's files."""
    suffix = "ac" if only_acoustic else "full"
    jax_dir, port_dir = (released["tmp"] / f"{pkg}_{suffix}" for pkg in ("jax", "port"))
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == (["model.safetensors"] if only_acoustic
                     else ["kenlm.bin", "model.safetensors"])
    assert sorted(p.name for p in port_dir.iterdir()) == names
    for name in names:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()


def test_port_reads_huggingface_hub_cache_offline(released):
    """A cache that huggingface_hub filled serves the port with
    ``HF_HUB_OFFLINE=1``, and with the endpoint unreachable."""
    home = released["tmp"] / "jax_home"
    for settings in ({"HF_HUB_OFFLINE": "1", "HF_ENDPOINT": released["url"]},
                     {"HF_ENDPOINT": dead_endpoint()}):
        with hub_env(HF_HOME=home, **settings):
            assert StreamingCTCModel.download_from_hugging_face() == released["jax"]["model"]
            assert BeamSearchCTCDecoder.download_from_hugging_face() == released["jax"]["lm"]


def test_huggingface_hub_reads_port_cache_offline(released):
    """A cache that the port filled serves huggingface_hub with
    ``HF_HUB_OFFLINE=1``."""
    paths = _jax(JAX_FETCH, "lm", HF_HUB_OFFLINE="1", HF_ENDPOINT=dead_endpoint(),
                 HF_HOME=released["tmp"] / "port_home")
    assert paths == released["port"]


def test_onnx_fallback_matches_huggingface_hub(tmp_path):
    """Without model.safetensors both fetch model.onnx, into the same cache
    (with huggingface_hub's ``.no_exist`` marker of the missing file)."""
    onnx = np.random.default_rng(0).bytes(3000)
    with LocalHub({T_ONE: {"model.onnx": onnx}}) as local:
        jax_paths = _jax(JAX_FETCH, HF_ENDPOINT=local.url,
                         HF_HOME=tmp_path / "jax_home")
        with hub_env(HF_ENDPOINT=local.url, HF_HOME=tmp_path / "port_home"):
            port_path = StreamingCTCModel.download_from_hugging_face()
    assert Path(port_path).name == "model.onnx" and Path(port_path).read_bytes() == onnx
    assert (Path(jax_paths["model"]).relative_to(tmp_path / "jax_home")
            == Path(port_path).relative_to(tmp_path / "port_home"))
    tree = cache_tree(tmp_path / "port_home")
    assert tree == cache_tree(tmp_path / "jax_home")
    assert any(k.endswith("/model.safetensors") and "/.no_exist/" in k for k in tree)


def test_renamed_repo_is_followed_as_huggingface_hub_follows_it(tmp_path):
    """A renamed repo answers its former name with a relative redirect:
    both clients follow it to the files (the LFS storage redirect behind
    it, and a regular file) and cache them alike under the name asked for."""
    rng = np.random.default_rng(3)
    files = {"model.safetensors": rng.bytes(3000), "kenlm.bin": rng.bytes(2000),
             "README.md": b"# T-one\n"}
    with LocalHub({"t-tech/T-one-v2": files}, renamed={T_ONE: "t-tech/T-one-v2"}) as local:
        jax_paths = _jax(JAX_FETCH, "lm", HF_ENDPOINT=local.url, HF_HOME=tmp_path / "jax_home")
        with hub_env(HF_ENDPOINT=local.url, HF_HOME=tmp_path / "port_home"):
            port_paths = {"model": StreamingCTCModel.download_from_hugging_face(),
                          "lm": BeamSearchCTCDecoder.download_from_hugging_face()}
            tree = cache_tree(tmp_path / "port_home")
            readme = hub.hf_hub_download(T_ONE, "README.md")
    for name, served in (("model", "model.safetensors"), ("lm", "kenlm.bin")):
        assert Path(port_paths[name]).read_bytes() == files[served]
        assert (Path(jax_paths[name]).relative_to(tmp_path / "jax_home")
                == Path(port_paths[name]).relative_to(tmp_path / "port_home"))
    assert tree == cache_tree(tmp_path / "jax_home")
    assert any(k.startswith("models--t-tech--T-one/snapshots/") for k in tree)
    assert Path(readme).read_bytes() == files["README.md"]
    assert [r["method"] for r in local.requests if r["path"].endswith("/README.md")] == [
        "HEAD", "HEAD", "GET"]


def test_pipeline_from_hugging_face_matches_jax_and_from_local(released):
    """``from_hugging_face(device="cpu")`` at the default bf16 config: step
    logprobs within 0.05 of JAX's ``from_hugging_face()`` model, and to the
    bit those of ``from_local`` on the downloaded folder, whose beam texts
    (kenlm.bin) it gives."""
    with hub_env(HF_ENDPOINT=released["url"], HF_HOME=released["tmp"] / "port_home"):
        pipe = StreamingCTCPipeline.from_hugging_face(device="cpu")
    local = StreamingCTCPipeline.from_local(released["tmp"] / "port_full", device="cpu")
    assert pipe.model.config == ToneConfig() and pipe.model.device.type == "cpu"
    assert type(pipe.decoder) is BeamSearchCTCDecoder and pipe.decoder._lm is not None
    lps = {}
    for name, p in (("hub", pipe), ("local", local)):
        state, out = None, []
        for chunk in np.load(released["tmp"] / "chunks.npy"):
            lp, state = p.model.forward_native(chunk[None], state)
            out.append(lp)
        lps[name] = torch.cat(out, dim=1)
    torch.testing.assert_close(lps["hub"], lps["local"], rtol=0, atol=0)
    jax_lp = np.load(released["tmp"] / "jax_lp.npy")
    np.testing.assert_allclose(lps["hub"].numpy(), jax_lp, atol=BF16_TOL, rtol=0)
    utterance = read_example_audio()[:UTTERANCE]
    texts = [[ph.text for ph in p.forward_offline(utterance)] for p in (pipe, local)]
    assert texts[0] == texts[1]


# -- the client alone --------------------------------------------------------


def test_unreachable_endpoint_without_cache_names_endpoint_and_file(tmp_path):
    dead = dead_endpoint()
    with hub_env(HF_ENDPOINT=dead, HF_HOME=tmp_path), pytest.raises(hub.HubError) as err:
        hub.hf_hub_download(T_ONE, "kenlm.bin")
    assert dead in str(err.value) and f"{T_ONE}/kenlm.bin" in str(err.value)


def test_offline_sends_no_request(tmp_path):
    """``HF_HUB_OFFLINE=1`` with nothing cached raises without a request."""
    with LocalHub({T_ONE: {"kenlm.bin": b"lm"}}) as local, \
            hub_env(HF_ENDPOINT=local.url, HF_HOME=tmp_path, HF_HUB_OFFLINE="1"), \
            pytest.raises(hub.HubError, match="HF_HUB_OFFLINE"):
        hub.hf_hub_download(T_ONE, "kenlm.bin")
    assert local.requests == []


def test_cached_file_costs_a_head_and_its_commit_nothing(tmp_path):
    """A cached file is fetched once: again at ``main`` it costs one HEAD,
    at its commit no request."""
    with LocalHub({T_ONE: {"kenlm.bin": b"lm" * 10}}) as local, \
            hub_env(HF_ENDPOINT=local.url, HF_HUB_CACHE=tmp_path / "cache"):
        first = hub.hf_hub_download(T_ONE, "kenlm.bin")
        assert hub.hf_hub_download(T_ONE, "kenlm.bin") == first
        commit = Path(first).parent.name
        assert hub.hf_hub_download(T_ONE, "kenlm.bin", revision=commit) == first
    assert [r["method"] for r in local.requests] == ["HEAD", "GET", "HEAD"]
    assert Path(first).is_relative_to(tmp_path / "cache")


def test_token_from_the_environment_or_the_token_file(tmp_path):
    (tmp_path / "token").write_text("  from-file\n")
    with hub_env(HF_HOME=tmp_path):
        assert hub.get_token() == "from-file"
    with hub_env(HF_HOME=tmp_path, HF_TOKEN="from-env"):
        assert hub.get_token() == "from-env"
    with hub_env(HF_HOME=tmp_path / "nowhere"), pytest.raises(hub.HubError, match="HF_TOKEN"):
        hub.HubApi(dead_endpoint()).create_repo("me/x")


def test_upload_of_bytes_round_trips():
    """Bytes committed as an LFS object (one PUT, then its verify) and as a
    regular file arrive whole; an existing repo is an error but with
    ``exist_ok``."""
    data = np.random.default_rng(1).bytes(3500)
    with LocalHub() as local:
        api = hub.HubApi(local.url, token="tok")
        assert api.create_repo("me/x") == f"{local.url}/me/x"
        with pytest.raises(hub.HubError) as err:
            api.create_repo("me/x")
        assert err.value.status == 409
        assert api.create_repo("me/x", exist_ok=True) == f"{local.url}/me/x"
        for path, content in (("w.bin", data), ("notes.txt", b"plain")):
            url = api.upload_file(path_or_fileobj=content, path_in_repo=path, repo_id="me/x")
            assert url.startswith(f"{local.url}/me/x/commit/")
        assert local.files("me/x") == {"w.bin": data, "notes.txt": b"plain"}
    oid = hashlib.sha256(data).hexdigest()
    assert [(r["method"], r["path"]) for r in local.requests if r["path"].startswith("/lfs/")] == [
        ("PUT", f"/lfs/{oid}"), ("POST", f"/lfs/{oid}/verify")]


# -- push_hf -------------------------------------------------------------------

JAX_PUSH = """
import contextlib, io, json, sys
sys.path.insert(0, "dev")
import push_hf

args, out = sys.argv[1:], {}
for key, extra in (("dry_run", ["--dry-run"]), ("push", [])):
    sys.argv = ["push_hf.py", *args, *extra]
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        push_hf.main()
    out[key] = printed.getvalue().splitlines()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def pushed(tmp_path_factory):
    """Both packages' push_hf (``--lm --nemo --vad`` and an export folder,
    dry and real) of the same tiny weights, each against a fresh endpoint."""
    tmp = tmp_path_factory.mktemp("pushed")
    jc, tc = tiny_configs("float32")
    jv, tv = tiny_variables(jc, tc, seed=5)
    JC.save_checkpoint(tmp / "jax_model", jv, jc)
    TC.save_checkpoint(tmp / "port_model", tv, tc)
    rng = np.random.default_rng(2)
    (tmp / "lm.arpa").write_text("\\data\\\nngram 1=1\n\n\\1-grams:\n-1.0\t<unk>\n\n\\end\\\n")
    (tmp / "silero_vad.onnx").write_bytes(rng.bytes(4096))
    for rel, data in (("meta.json", b'{"batch_sizes": [1]}'), ("b1/step.pt2", rng.bytes(2000)),
                      (".git/HEAD", b"ref: refs/heads/main\n")):
        (tmp / "exported" / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp / "exported" / rel).write_bytes(data)
    common = ["--repo", "me/tone", "--lm", tmp / "lm.arpa", "--nemo", "--vad",
              tmp / "silero_vad.onnx"]
    out = {"tmp": tmp}
    with LocalHub() as local:
        out["jax"] = _jax(JAX_PUSH, *common, "--checkpoint", tmp / "jax_model", "--stablehlo",
                          tmp / "exported", HF_ENDPOINT=local.url, HF_TOKEN="tok-jax")
        out["jax"].update(files=local.files("me/tone"), requests=local.requests)
    with LocalHub() as local, hub_env(HF_ENDPOINT=local.url, HF_TOKEN="tok-port"):
        argv = [*map(str, common), "--checkpoint", str(tmp / "port_model"), "--exported",
                str(tmp / "exported")]
        out["port"] = {"url": local.url}
        for key, extra in (("dry_run", ["--dry-run"]), ("push", [])):
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                push_hf.main(argv + extra)
            out["port"][key] = printed.getvalue().splitlines()
        out["port"].update(files=local.files("me/tone"), requests=local.requests)
    return out


def _departed(path: str) -> str:
    """A JAX repo path as the port names it."""
    for jax_name, port_name in DEPARTURES.items():
        if path.startswith(jax_name):
            return port_name + path[len(jax_name):]
    return path


def test_push_hf_repo_paths_match_jax(pushed):
    """The same paths but the checkpoint folder's (each package's own
    format) and the export folder's name; git's metadata left out."""
    ckpt = DEPARTURES["tone_tpu_checkpoint/"]
    jax_paths = {_departed(p) for p in pushed["jax"]["files"]}
    port_paths = set(pushed["port"]["files"])
    assert {p for p in jax_paths if not p.startswith(ckpt)} == {
        p for p in port_paths if not p.startswith(ckpt)} == {
        "model.safetensors", "lm.arpa", "model.nemo", "onnx/silero_vad.onnx",
        "torch_export/meta.json", "torch_export/b1/step.pt2"}
    assert {p for p in port_paths if p.startswith(ckpt)} == {
        ckpt + "config.json", ckpt + "variables.safetensors"}
    assert ckpt + "config.json" in jax_paths


def _nemo(data: bytes) -> tuple[dict, dict]:
    from tone_tpu_torch.interop import load_yaml

    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        cfg = load_yaml(tar.extractfile("./model_config.yaml").read().decode())
        weights = torch.load(io.BytesIO(tar.extractfile("./model_weights.ckpt").read()),
                             weights_only=True)
    return cfg, weights


def _assert_same_tensors(port: dict, jax: dict) -> None:
    assert port.keys() == jax.keys()
    for key, want in jax.items():
        got = port[key]
        if key.endswith("num_batches_tracked"):
            # torch's 0-d counter; JAX's writer (np.ascontiguousarray) makes it (1,)
            assert got.shape == () and want.shape == (1,), key
            got = got.reshape(1)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_push_hf_files_match_jax(pushed, tmp_path):
    """The LM, the VAD and the export folder byte-equal; model.safetensors
    and the .nemo hold equal tensors; the checkpoint folder is the port's."""
    jax_files = {_departed(p): v for p, v in pushed["jax"]["files"].items()}
    port_files = pushed["port"]["files"]
    for path in ("lm.arpa", "onnx/silero_vad.onnx", "torch_export/meta.json",
                 "torch_export/b1/step.pt2"):
        assert port_files[path] == jax_files[path], path
    tensors = []
    for name, files in (("jax", jax_files), ("port", port_files)):
        (tmp_path / name).write_bytes(files["model.safetensors"])
        tensors.append(TC.read_safetensors(tmp_path / name))
    _assert_same_tensors(tensors[1], tensors[0])
    (jax_cfg, jax_w), (port_cfg, port_w) = _nemo(jax_files["model.nemo"]), _nemo(
        port_files["model.nemo"])
    assert port_cfg == jax_cfg
    _assert_same_tensors(port_w, jax_w)
    assert port_files["tone_tpu_torch_checkpoint/variables.safetensors"] == (
        pushed["tmp"] / "port_model" / "variables.safetensors").read_bytes()


def test_push_hf_dry_run_matches_jax(pushed):
    """The same ``would upload`` lines but the two departures (temporary
    paths and each package's checkpoint directory aside)."""
    tmp = pushed["tmp"]

    def normal(lines: list[str], model: Path) -> list[str]:
        return [re.sub(r"upload \S+/(model\.(safetensors|nemo)) ", r"upload <tmp>/\1 ",
                       line.replace(str(model), "<checkpoint>")) for line in lines]

    jax_lines = normal(pushed["jax"]["dry_run"], tmp / "jax_model")
    for jax_name, port_name in DEPARTURES.items():
        jax_lines = [line.replace(f":{jax_name}", f":{port_name}") for line in jax_lines]
    assert normal(pushed["port"]["dry_run"], tmp / "port_model") == jax_lines
    assert len(jax_lines) == 6
    assert pushed["port"]["push"] == [f"published to {pushed['port']['url']}/me/tone"]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_push_hf_sends_the_token_as_bearer(pushed, package):
    """Every API call carries ``Authorization: Bearer <token>``; the LFS
    object itself goes to its storage URL without it; huggingface_hub
    offers ``basic`` and ``multipart`` (``xet`` disabled), the port
    ``basic`` only."""
    requests = pushed[package]["requests"]
    api = [r for r in requests if r["method"] == "POST"]
    assert {r["authorization"] for r in api} == {f"Bearer tok-{package}"}
    kinds = {re.sub(r"/[0-9a-f]{64}", "/<oid>", r["path"]).replace("/me/tone", "/<repo>")
             for r in api}
    assert kinds == {"/api/repos/create", "/api/models/<repo>/preupload/main",
                     "/<repo>.git/info/lfs/objects/batch", "/lfs/<oid>/verify",
                     "/api/models/<repo>/commit/main"}
    assert {r["authorization"] for r in requests if r["method"] == "PUT"} == {None}
    offered = {"jax": ["basic", "multipart"], "port": ["basic"]}[package]
    transfers = [r["transfers"] for r in requests if "transfers" in r]
    assert transfers and all(t == offered for t in transfers)
