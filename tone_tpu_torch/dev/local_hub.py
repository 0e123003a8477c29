"""A Hugging Face Hub endpoint on ``127.0.0.1`` for tests: it serves the
files of its model repos (``resolve``; an LFS file, as on the Hub, through
a redirect to its storage URL; a renamed repo's, as on the Hub, through a
relative redirect to its new name) and takes the upload calls of
``huggingface_hub`` and of ``tone_tpu_torch.hub`` (repo creation,
``preupload``, the LFS batch with the ``basic`` transfer, the upload and
its verify, the NDJSON commit), recording every request.

    with LocalHub({"t-tech/T-one": {"model.safetensors": data}}) as hub:
        os.environ["HF_ENDPOINT"] = hub.url
        ...
        hub.files("t-tech/T-one")        # path -> bytes after the uploads

It is test tooling: it keeps everything in memory and checks no token.
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import PurePosixPath
from urllib.parse import quote, unquote, urlparse

# the files the Hub stores in LFS: its default .gitattributes' binary types
LFS_SUFFIXES = {".bin", ".safetensors", ".onnx", ".nemo", ".pt", ".pth", ".ckpt", ".gz",
                ".zip", ".tar", ".npy", ".npz", ".pb", ".h5", ".msgpack", ".arpa", ".plan",
                ".so", ".wav", ".flac"}
LFS_MIN_BYTES = 10 << 20
# the prefixes of every environment variable that huggingface_hub or
# tone_tpu_torch.hub reads: what hub_env clears before it sets its own
HUB_VARIABLES = ("HF_", "HUGGING", "TRANSFORMERS_")


@contextlib.contextmanager
def hub_env(**values):
    """The Hub settings ``values`` (``tone_tpu_torch.hub`` reads them on
    every call), and no other, for the duration of the block."""
    saved = {k: v for k, v in os.environ.items() if k.startswith(HUB_VARIABLES)}
    try:
        for k in saved:
            del os.environ[k]
        os.environ.update({k: str(v) for k, v in values.items()})
        yield
    finally:
        for k in [k for k in os.environ if k.startswith(HUB_VARIABLES)]:
            del os.environ[k]
        os.environ.update(saved)


def _is_lfs(path: str, size: int) -> bool:
    return PurePosixPath(path).suffix in LFS_SUFFIXES or size >= LFS_MIN_BYTES


def _commit_of(files: dict[str, bytes], parent: str = "") -> str:
    digest = hashlib.sha1(parent.encode())
    for path in sorted(files):
        digest.update(path.encode() + b"\0" + hashlib.sha256(files[path]).digest())
    return digest.hexdigest()


class LocalHub:
    """The endpoint's state (repos, LFS objects, the request log) and its
    server thread."""

    def __init__(self, repos: dict[str, dict[str, bytes]] | None = None,
                 renamed: dict[str, str] | None = None) -> None:
        """``repos``: repo id -> path -> bytes; ``renamed``: a former repo
        id -> the id it now has."""
        self.renamed = dict(renamed or {})
        self.repos = {r: {"files": dict(f), "commit": _commit_of(f)}
                      for r, f in (repos or {}).items()}
        self.objects: dict[str, bytes] = {
            hashlib.sha256(data).hexdigest(): data
            for files in (repos or {}).values() for data in files.values()}
        self.requests: list[dict] = []
        self.lock = threading.Lock()
        self.server: ThreadingHTTPServer | None = None
        self.thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def files(self, repo_id: str) -> dict[str, bytes]:
        with self.lock:
            return dict(self.repos[repo_id]["files"])

    def start(self) -> "LocalHub":
        hub = self

        class Handler(_Handler):
            state = hub

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        return self

    def stop(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(timeout=10)
            self.server = None

    def __enter__(self) -> "LocalHub":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    state: LocalHub

    def log_message(self, *args) -> None:
        pass

    # -- plumbing ----------------------------------------------------------

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length") or 0))

    def _send(self, status: int, body: bytes = b"", headers: dict | None = None) -> None:
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _json(self, obj, status: int = 200) -> None:
        self._send(status, json.dumps(obj).encode(), {"Content-Type": "application/json"})

    def _fail(self, status: int, code: str, message: str, headers: dict | None = None,
              **body) -> None:
        self._send(status, json.dumps({"error": message, **body}).encode(),
                   {"X-Error-Code": code, "X-Error-Message": message,
                    "Content-Type": "application/json", **(headers or {})})

    def _record(self) -> dict:
        entry = {"method": self.command, "path": urlparse(self.path).path,
                 "authorization": self.headers.get("Authorization")}
        with self.state.lock:
            self.state.requests.append(entry)
        return entry

    def _base(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    # -- downloads ---------------------------------------------------------

    def do_HEAD(self) -> None:
        self.do_GET()

    def do_GET(self) -> None:
        self._record()
        path = unquote(urlparse(self.path).path)
        if m := re.fullmatch(r"/lfs/([0-9a-f]{64})", path):
            data = self.state.objects.get(m.group(1))
            if data is None:
                return self._fail(404, "ObjectNotFound", f"no object {m.group(1)}")
            return self._send(200, data, {"Content-Type": "application/octet-stream"})
        m = re.fullmatch(r"/(.+?)/resolve/([^/]+)/(.+)", path)
        if m is None:
            return self._fail(404, "NotFound", f"no route {path}")
        repo_id, revision, filename = m.groups()
        if repo_id in self.state.renamed:
            new = self.state.renamed[repo_id]
            return self._send(307, headers={
                "Location": quote(f"/{new}/resolve/{revision}/{filename}")})
        with self.state.lock:
            repo = self.state.repos.get(repo_id)
            if repo is None:
                return self._fail(404, "RepoNotFound", f"no repo {repo_id}")
            commit, data = repo["commit"], repo["files"].get(filename)
        if revision not in ("main", commit):
            return self._fail(404, "RevisionNotFound", f"no revision {revision}")
        if data is None:
            return self._fail(404, "EntryNotFound", f"no file {filename} in {repo_id}",
                              {"X-Repo-Commit": commit})
        oid = hashlib.sha256(data).hexdigest()
        if _is_lfs(filename, len(data)):
            # as the Hub: the storage URL, the object's ETag and size in X-Linked-*
            return self._send(302, headers={
                "Location": f"{self._base()}/lfs/{oid}", "X-Repo-Commit": commit,
                "X-Linked-Etag": f'"{oid}"', "X-Linked-Size": str(len(data)),
                "ETag": f'"{hashlib.sha1(data).hexdigest()}"'})
        self._send(200, data, {"ETag": f'"{hashlib.sha1(data).hexdigest()}"',
                               "X-Repo-Commit": commit,
                               "Content-Type": "application/octet-stream"})

    # -- uploads -----------------------------------------------------------

    def do_POST(self) -> None:
        entry = self._record()
        path, body = unquote(urlparse(self.path).path), self._body()
        if path == "/api/repos/create":
            return self._create(json.loads(body))
        if m := re.fullmatch(r"/api/models/(.+)/preupload/([^/]+)", path):
            return self._preupload(m.group(1), json.loads(body))
        if m := re.fullmatch(r"/api/models/(.+)/commit/([^/]+)", path):
            return self._commit(m.group(1), body)
        if m := re.fullmatch(r"/(.+)\.git/info/lfs/objects/batch", path):
            return self._batch(m.group(1), json.loads(body), entry)
        if m := re.fullmatch(r"/lfs/([0-9a-f]{64})/verify", path):
            return self._verify(m.group(1), json.loads(body))
        self._fail(404, "NotFound", f"no route {path}")

    def do_PUT(self) -> None:
        self._record()
        path, body = urlparse(self.path).path, self._body()
        if m := re.fullmatch(r"/lfs/([0-9a-f]{64})", path):
            return self._store(m.group(1), body)
        self._fail(404, "NotFound", f"no route {path}")

    def _create(self, req: dict) -> None:
        repo_id = "/".join(p for p in (req.get("organization"), req["name"]) if p)
        with self.state.lock:
            if repo_id in self.state.repos:
                # the Hub's conflict names the repo's URL, which huggingface_hub reads
                return self._fail(409, "RepoExists", f"{repo_id} exists",
                                  url=f"{self._base()}/{repo_id}")
            self.state.repos[repo_id] = {"files": {}, "commit": _commit_of({}),
                                         "private": bool(req.get("private"))}
        self._json({"url": f"{self._base()}/{repo_id}", "name": repo_id})

    def _preupload(self, repo_id: str, req: dict) -> None:
        if repo_id not in self.state.repos:
            return self._fail(404, "RepoNotFound", f"no repo {repo_id}")
        self._json({"files": [{
            "path": f["path"], "shouldIgnore": False,
            "uploadMode": "lfs" if _is_lfs(f["path"], f["size"]) else "regular"}
            for f in req["files"]]})

    def _batch(self, repo_id: str, req: dict, entry: dict) -> None:
        entry["transfers"] = req["transfers"]
        if repo_id not in self.state.repos:
            return self._fail(404, "RepoNotFound", f"no repo {repo_id}")
        if "basic" not in req["transfers"]:
            return self._fail(400, "BadTransfer", "this endpoint takes the basic transfer only")
        objects = []
        for obj in req["objects"]:
            oid = obj["oid"]
            answer = {"oid": oid, "size": obj["size"], "authenticated": True}
            if oid not in self.state.objects:
                answer["actions"] = {"upload": {"href": f"{self._base()}/lfs/{oid}"},
                                     "verify": {"href": f"{self._base()}/lfs/{oid}/verify"}}
            objects.append(answer)
        self._json({"transfer": "basic", "objects": objects})

    def _store(self, oid: str, data: bytes) -> None:
        if hashlib.sha256(data).hexdigest() != oid:
            return self._fail(400, "BadObject", f"the bytes of {oid} hash otherwise")
        with self.state.lock:
            self.state.objects[oid] = data
        self._send(200)

    def _verify(self, oid: str, req: dict) -> None:
        data = self.state.objects.get(oid)
        if data is None or len(data) != req["size"]:
            return self._fail(404, "ObjectNotFound", f"no object {oid} of {req['size']} bytes")
        self._json({"success": True})

    def _commit(self, repo_id: str, body: bytes) -> None:
        lines = [json.loads(line) for line in body.splitlines() if line.strip()]
        with self.state.lock:
            repo = self.state.repos.get(repo_id)
            if repo is None:
                return self._fail(404, "RepoNotFound", f"no repo {repo_id}")
            files = dict(repo["files"])
            for line in lines:
                value = line["value"]
                if line["key"] == "file":
                    files[value["path"]] = base64.b64decode(value["content"])
                elif line["key"] == "lfsFile":
                    if value["oid"] not in self.state.objects:
                        return self._fail(400, "MissingObject", f"no object {value['oid']}")
                    files[value["path"]] = self.state.objects[value["oid"]]
            repo["files"], repo["commit"] = files, _commit_of(files, repo["commit"])
            commit = repo["commit"]
        self._json({"success": True, "commitOid": commit,
                    "commitUrl": f"{self._base()}/{repo_id}/commit/{commit}"})
