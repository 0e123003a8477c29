"""A Hugging Face Hub client on the standard library (the calls the JAX
package makes through ``huggingface_hub``).

* :func:`hf_hub_download` fetches one file of a model repo into the Hub
  cache, in ``huggingface_hub``'s layout::

      <cache>/models--<org>--<name>/blobs/<etag>
      <cache>/models--<org>--<name>/snapshots/<commit>/<file> -> ../../blobs/<etag>
      <cache>/models--<org>--<name>/refs/<revision>            (the commit)

  so a file fetched by either client is found offline by the other.  Where
  the endpoint cannot be reached, or ``HF_HUB_OFFLINE`` is set, the cached
  snapshot of the revision stands in; with nothing cached the error names
  the endpoint and the file.
* :class:`HubApi` creates a model repo and uploads files and folders:
  ``preupload`` (regular or LFS), the LFS batch (the ``basic`` transfer
  only: one PUT per object), the upload and its verify, then the NDJSON
  commit.

The environment is read on every call, with ``huggingface_hub``'s names:
``HF_ENDPOINT`` (default ``https://huggingface.co``), ``HF_HOME``,
``HF_HUB_CACHE``, ``HF_HUB_OFFLINE``, and ``HF_TOKEN`` or the file
``HF_TOKEN_PATH`` (default ``$HF_HOME/token``).
"""

from __future__ import annotations

import base64
import fcntl
import hashlib
import json
import os
import re
import shutil
from dataclasses import dataclass
from fnmatch import fnmatch
from pathlib import Path
from urllib.error import HTTPError, URLError
from urllib.parse import quote, urlparse
from urllib.request import HTTPRedirectHandler, Request, build_opener

from tone_tpu_torch.version import VERSION

TONE_REPO = "t-tech/T-one"   # the reference's released model and LM
DEFAULT_ENDPOINT = "https://huggingface.co"
DEFAULT_REVISION = "main"    # the branch that downloads read and uploads commit to
METADATA_TIMEOUT = 10.0    # seconds for the HEAD of a file (huggingface_hub's etag timeout)
REQUEST_TIMEOUT = 60.0     # seconds without data on any other request
COPY_BLOCK = 1 << 20
MAX_REDIRECTS = 10       # relative redirects followed by a HEAD (renamed repos)
SAMPLE_BYTES = 512         # the head of a file that ``preupload`` reads
PREUPLOAD_CHUNK = 256      # files per preupload and per LFS batch call
LFS_HEADERS = {"Accept": "application/vnd.git-lfs+json",
               "Content-Type": "application/vnd.git-lfs+json"}
# upload_folder leaves out git and huggingface_hub's own metadata
IGNORE_PATTERNS = (".git", ".git/*", "*/.git", "**/.git/**", ".cache/huggingface",
                   ".cache/huggingface/*", "*/.cache/huggingface", "**/.cache/huggingface/**")
_COMMIT_HASH = re.compile(r"^[0-9a-f]{40}$")
_TRUE = {"1", "ON", "YES", "TRUE"}


class HubError(OSError):
    """A Hub request failed (and, for a download, the cache cannot stand in);
    ``status`` is the HTTP status where the endpoint answered."""

    status: int | None = None


class EntryNotFoundError(HubError):
    """The repo exists but holds no such file at that revision."""


# -- the environment -------------------------------------------------------


def _path_env(name: str, default: str | Path) -> Path:
    return Path(os.path.expandvars(os.path.expanduser(os.environ.get(name) or str(default))))


def hf_home() -> Path:
    xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join("~", ".cache")
    return _path_env("HF_HOME", os.path.join(xdg, "huggingface"))


def hub_cache() -> Path:
    return _path_env("HF_HUB_CACHE", os.environ.get("HUGGINGFACE_HUB_CACHE")
                     or hf_home() / "hub")


def endpoint() -> str:
    return (os.environ.get("HF_ENDPOINT") or DEFAULT_ENDPOINT).rstrip("/")


def offline() -> bool:
    value = os.environ.get("HF_HUB_OFFLINE") or os.environ.get("TRANSFORMERS_OFFLINE") or ""
    return value.upper() in _TRUE


def get_token() -> str | None:
    """``HF_TOKEN`` (or ``HUGGING_FACE_HUB_TOKEN``), else the token file."""
    token = os.environ.get("HF_TOKEN") or os.environ.get("HUGGING_FACE_HUB_TOKEN")
    if token is None:
        try:
            token = _path_env("HF_TOKEN_PATH", hf_home() / "token").read_text()
        except FileNotFoundError:
            return None
    return token.replace("\r", "").replace("\n", "").strip() or None


def _headers(token: str | None) -> dict[str, str]:
    headers = {"User-Agent": f"tone_tpu_torch/{VERSION}"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    return headers


def repo_folder_name(repo_id: str) -> str:
    return "--".join(["models", *repo_id.split("/")])


# -- HTTP ------------------------------------------------------------------


class _NoRedirect(HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None  # a 3xx comes back as an HTTPError whose Location is read


_plain = build_opener()
_no_redirect = build_opener(_NoRedirect)


def _error(err: HTTPError, what: str) -> HubError:
    code = err.headers.get("X-Error-Code")
    words = [f"HTTP {err.code}", code, err.headers.get("X-Error-Message") or err.reason]
    cls = EntryNotFoundError if code == "EntryNotFound" else HubError
    error = cls(f"{what}: " + " ".join(w for w in words if w))
    error.status = err.code
    return error


def _request(method: str, url: str, headers: dict[str, str], data=None, *,
             timeout: float = REQUEST_TIMEOUT, what: str):
    """The open response of a request that succeeded; HubError otherwise."""
    try:
        return _plain.open(Request(url, data=data, headers=headers, method=method),
                           timeout=timeout)
    except HTTPError as e:
        raise _error(e, what) from None
    except (URLError, OSError) as e:
        raise HubError(f"{what}: {e}") from None


def _json(method: str, url: str, headers: dict[str, str], payload, *, what: str,
          content_type: str = "application/json"):
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    with _request(method, url, {**headers, "Content-Type": content_type}, body,
                  what=what) as resp:
        text = resp.read()
    return json.loads(text) if text else None


# -- downloads -------------------------------------------------------------


@dataclass(frozen=True)
class FileMetadata:
    commit: str
    etag: str
    size: int
    location: str


def file_metadata(url: str, headers: dict[str, str]) -> FileMetadata:
    """HEAD of a ``resolve`` URL: the commit, the ETag and the size.  A
    relative redirect (a renamed repo) is followed, as ``huggingface_hub``
    does; an LFS file answers with an absolute redirect to its storage
    (``Location``), naming its ETag and size in ``X-Linked-Etag`` and
    ``X-Linked-Size``."""
    for _ in range(MAX_REDIRECTS):
        try:
            resp = _no_redirect.open(Request(url, headers={**headers, "Accept-Encoding": "identity"},
                                             method="HEAD"), timeout=METADATA_TIMEOUT)
            resp.close()
            location = url
        except HTTPError as e:
            if not 300 <= e.code < 400:
                raise
            target = urlparse(e.headers["Location"])
            if not target.netloc:
                url = urlparse(url)._replace(path=target.path).geturl()
                continue
            resp, location = e, target.geturl()
        h = resp.headers
        commit, etag = h.get("X-Repo-Commit"), h.get("X-Linked-Etag") or h.get("ETag")
        size = h.get("X-Linked-Size") or h.get("Content-Length")
        if commit is None or etag is None or size is None:
            raise HubError(f"{url} answered without X-Repo-Commit, ETag or size: "
                           "not a Hub endpoint")
        etag = etag[2:] if etag.startswith("W/") else etag
        return FileMetadata(commit, etag.strip('"'), int(size), location)
    raise HubError(f"{url}: more than {MAX_REDIRECTS} relative redirects")


def _write_ref(storage: Path, revision: str, commit: str) -> None:
    if revision != commit:
        ref = storage / "refs" / revision
        ref.parent.mkdir(parents=True, exist_ok=True)
        if not ref.exists() or ref.read_text() != commit:
            ref.write_text(commit)


def _cached(storage: Path, revision: str, filename: str) -> Path | None:
    commit = revision if _COMMIT_HASH.match(revision) else None
    ref = storage / "refs" / revision
    if commit is None and ref.is_file():
        commit = ref.read_text()
    if commit is None:
        return None
    pointer = storage / "snapshots" / commit / filename
    return pointer if pointer.exists() else None


def _link(blob: Path, pointer: Path) -> None:
    pointer.parent.mkdir(parents=True, exist_ok=True)
    pointer.unlink(missing_ok=True)
    try:
        os.symlink(os.path.relpath(blob, pointer.parent), pointer)
    except OSError:  # no symlinks on this file system
        shutil.copyfile(blob, pointer)


def _fetch(url: str, headers: dict[str, str], blob: Path, size: int, what: str) -> None:
    """GET ``url`` into ``<blob>.incomplete``, check its size, rename it."""
    incomplete = blob.with_name(blob.name + ".incomplete")
    with _request("GET", url, {**headers, "Accept-Encoding": "identity"}, what=what) as resp, \
            open(incomplete, "wb") as f:
        shutil.copyfileobj(resp, f, COPY_BLOCK)
    got = incomplete.stat().st_size
    if got != size:
        incomplete.unlink()
        raise HubError(f"{what}: received {got} bytes of {size}")
    os.replace(incomplete, blob)


def hf_hub_download(repo_id: str, filename: str, *, revision: str = DEFAULT_REVISION,
                    cache_dir: str | Path | None = None, token: str | None = None) -> str:
    """The cached path of ``filename`` in model repo ``repo_id`` at
    ``revision`` (``huggingface_hub.hf_hub_download``'s layout), fetched
    from the endpoint when it is not cached at the revision's commit."""
    base = endpoint()
    cache = Path(cache_dir) if cache_dir is not None else hub_cache()
    storage = cache / repo_folder_name(repo_id)
    what = f"{repo_id}/{filename} at {revision} from {base}"
    if _COMMIT_HASH.match(revision) and (hit := _cached(storage, revision, filename)):
        return str(hit)
    headers = _headers(token or get_token())
    url = f"{base}/{repo_id}/resolve/{quote(revision, safe='')}/{quote(filename)}"
    if offline():
        reason = "HF_HUB_OFFLINE is set"
    else:
        try:
            meta = file_metadata(url, headers)
            reason = None
        except HTTPError as e:
            code = e.headers.get("X-Error-Code", "")
            if code == "EntryNotFound" and (commit := e.headers.get("X-Repo-Commit")):
                # remembered as huggingface_hub does: .no_exist/<commit>/<file>
                marker = storage / ".no_exist" / commit / filename
                marker.parent.mkdir(parents=True, exist_ok=True)
                marker.touch()
                _write_ref(storage, revision, commit)
            if code in ("EntryNotFound", "RevisionNotFound", "RepoNotFound",
                        "GatedRepo") or e.code == 401:
                raise _error(e, what) from None
            reason = f"HTTP {e.code} {e.reason}"
        except (URLError, OSError) as e:   # HubError included: no metadata
            reason = str(getattr(e, "reason", e))
    if reason is not None:
        if hit := _cached(storage, revision, filename):
            return str(hit)
        raise HubError(f"cannot fetch {what} ({reason}), and {storage} holds no "
                       f"snapshot of it")

    blob = storage / "blobs" / meta.etag
    pointer = storage / "snapshots" / meta.commit / filename
    blob.parent.mkdir(parents=True, exist_ok=True)
    _write_ref(storage, revision, meta.commit)
    if pointer.exists():
        return str(pointer)
    if urlparse(meta.location).netloc != urlparse(url).netloc:
        headers.pop("Authorization", None)  # a signed CDN URL: the token stays home
    lock = cache / ".locks" / storage.name / f"{meta.etag}.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)   # one writer per blob across processes
        if not blob.exists():
            _fetch(meta.location, headers, blob, meta.size, what)
        if not pointer.exists():
            _link(blob, pointer)
    return str(pointer)


# -- uploads ---------------------------------------------------------------


@dataclass
class _Addition:
    path_in_repo: str
    source: bytes | Path
    size: int
    sha256: str
    sample: bytes
    mode: str = "regular"

    @classmethod
    def of(cls, path_in_repo: str, source: bytes | str | Path) -> "_Addition":
        if isinstance(source, (bytes, bytearray)):
            data = bytes(source)
            return cls(path_in_repo, data, len(data), hashlib.sha256(data).hexdigest(),
                       data[:SAMPLE_BYTES])
        path = Path(source)
        digest = hashlib.sha256()
        with open(path, "rb") as f:
            sample = f.read(SAMPLE_BYTES)
            digest.update(sample)
            while block := f.read(COPY_BLOCK):
                digest.update(block)
        return cls(path_in_repo, path, path.stat().st_size, digest.hexdigest(), sample)

    def read(self) -> bytes:
        return self.source if isinstance(self.source, bytes) else self.source.read_bytes()


class HubApi:
    """The Hub's write calls (``huggingface_hub.HfApi``'s ``create_repo``,
    ``upload_file`` and ``upload_folder``) for model repos."""

    def __init__(self, endpoint_url: str | None = None, token: str | None = None) -> None:
        self.endpoint = (endpoint_url or endpoint()).rstrip("/")
        self.token = token

    def _headers(self) -> dict[str, str]:
        token = self.token or get_token()
        if not token:
            raise HubError("writing to the Hub needs a token: set HF_TOKEN or "
                           f"write it to {hf_home() / 'token'}")
        return _headers(token)

    def create_repo(self, repo_id: str, *, exist_ok: bool = False,
                    private: bool | None = None) -> str:
        """Create model repo ``repo_id``; its URL."""
        organization, name = repo_id.split("/") if "/" in repo_id else (None, repo_id)
        payload = {"name": name, "organization": organization}
        if private is not None:
            payload["private"] = private
        try:
            reply = _json("POST", f"{self.endpoint}/api/repos/create", self._headers(), payload,
                          what=f"creating {repo_id} on {self.endpoint}")
        except HubError as e:
            if exist_ok and e.status == 409:
                return f"{self.endpoint}/{repo_id}"
            raise
        return reply["url"]

    def upload_file(self, *, path_or_fileobj: str | Path | bytes, path_in_repo: str,
                    repo_id: str) -> str:
        """Commit one file (a path or its bytes) to ``main``; the commit's URL."""
        return self._commit(repo_id, [_Addition.of(path_in_repo, path_or_fileobj)],
                            f"Upload {path_in_repo} with tone_tpu_torch")

    def upload_folder(self, *, repo_id: str, folder_path: str | Path,
                      path_in_repo: str | None = None) -> str:
        """Commit every file under ``folder_path`` (but git's and the Hub
        cache's metadata) under ``path_in_repo`` to ``main``; the commit's URL."""
        folder = Path(folder_path).expanduser().resolve()
        if not folder.is_dir():
            raise ValueError(f"{folder} is not a directory")
        prefix = f"{path_in_repo.strip('/')}/" if path_in_repo else ""
        files = [(p.relative_to(folder).as_posix(), p) for p in sorted(folder.glob("**/*"))
                 if p.is_file()]
        additions = [_Addition.of(prefix + rel, p) for rel, p in files
                     if not any(fnmatch(rel, pat) for pat in IGNORE_PATTERNS)]
        return self._commit(repo_id, additions, "Upload folder using tone_tpu_torch")

    def _commit(self, repo_id: str, additions: list[_Addition], commit_message: str) -> str:
        headers = self._headers()
        api = f"{self.endpoint}/api/models/{repo_id}"
        for k in range(0, len(additions), PREUPLOAD_CHUNK):
            chunk = additions[k:k + PREUPLOAD_CHUNK]
            reply = _json("POST", f"{api}/preupload/{DEFAULT_REVISION}", headers, {"files": [
                {"path": a.path_in_repo, "sample": base64.b64encode(a.sample).decode("ascii"),
                 "size": a.size} for a in chunk]}, what=f"preupload to {repo_id}")
            modes = {f["path"]: f["uploadMode"] for f in reply["files"]}
            for a in chunk:
                # empty files cannot be LFS objects
                a.mode = modes[a.path_in_repo] if a.size else "regular"
        lfs = [a for a in additions if a.mode == "lfs"]
        for k in range(0, len(lfs), PREUPLOAD_CHUNK):
            self._upload_lfs(repo_id, lfs[k:k + PREUPLOAD_CHUNK], headers)

        lines = [{"key": "header", "value": {"summary": commit_message, "description": ""}}]
        for a in additions:
            if a.mode == "lfs":
                lines.append({"key": "lfsFile", "value": {
                    "path": a.path_in_repo, "algo": "sha256", "oid": a.sha256, "size": a.size}})
            else:
                lines.append({"key": "file", "value": {
                    "content": base64.b64encode(a.read()).decode(), "path": a.path_in_repo,
                    "encoding": "base64"}})
        body = b"".join(json.dumps(line).encode() + b"\n" for line in lines)
        reply = _json("POST", f"{api}/commit/{DEFAULT_REVISION}", headers, body,
                      content_type="application/x-ndjson", what=f"commit to {repo_id}")
        return reply["commitUrl"]

    def _upload_lfs(self, repo_id: str, additions: list[_Addition],
                    headers: dict[str, str]) -> None:
        """The LFS batch of ``additions``, then each object the endpoint
        lacks: uploaded (one PUT) and verified."""
        reply = _json("POST", f"{self.endpoint}/{repo_id}.git/info/lfs/objects/batch",
                      {**headers, **LFS_HEADERS},
                      {"operation": "upload", "transfers": ["basic"],
                       "objects": [{"oid": a.sha256, "size": a.size} for a in additions],
                       "hash_algo": "sha256", "ref": {"name": DEFAULT_REVISION}},
                      content_type=LFS_HEADERS["Content-Type"], what=f"LFS batch of {repo_id}")
        by_oid = {a.sha256: a for a in additions}
        errors = [o for o in reply["objects"] if "error" in o]
        if errors:
            raise HubError(f"LFS batch of {repo_id}: " + "; ".join(
                f"{o['oid']}: {o['error'].get('message')}" for o in errors))
        for obj in reply["objects"]:
            actions = obj.get("actions")
            if not actions:
                continue  # the endpoint holds this object already
            a = by_oid[obj["oid"]]
            # a storage URL, often signed: sent without the token
            _request("PUT", actions["upload"]["href"], {}, a.read(),
                     what=f"uploading {a.path_in_repo} to {repo_id}").close()
            if verify := actions.get("verify"):
                _json("POST", verify["href"], {**headers, **(verify.get("header") or {})},
                      {"oid": a.sha256, "size": a.size}, what=f"verifying {a.path_in_repo}")
