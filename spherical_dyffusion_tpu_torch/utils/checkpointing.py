"""Checkpoint path resolution and distribution channels.

Counterpart of ``spherical_dyffusion_tpu/utils/checkpointing.py``:
``resolve_checkpoint_path`` takes local files, directories (their newest
``*.ckpt``), ``hf:org/repo/filename`` (the HuggingFace Hub) and
``wandb:entity/project/run[:best|last|EPOCH]`` (a wandb run's files through
``utils/wandb_client.py``); ``CheckpointMirror`` mirrors training
checkpoints to S3 (``utils/s3.py``).

The ``hf:`` leg speaks the hub's resolve protocol over ``urllib`` (the
card's machine has no ``huggingface_hub``): a HEAD of
``{HF_ENDPOINT}/{repo}/resolve/main/{filename}`` for the commit and the
ETag (a redirect's own headers, as the hub answers for files in LFS, are
read without following it), then a GET of the file (the redirect's target
where there is one), stored in ``huggingface_hub``'s cache layout:
``models--{org}--{repo}/blobs/{etag}``, ``snapshots/{commit}/{filename}``
linking to it, and ``refs/main`` holding the commit. ``HF_TOKEN``, where
set, goes along as a bearer token.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from .s3 import S3Client

__all__ = ["resolve_checkpoint_path", "download_from_hf", "find_checkpoint_in_dir",
           "S3Client", "CheckpointMirror"]

HF_PREFIX = "hf:"
WANDB_PREFIX = "wandb:"
DEFAULT_CACHE = os.path.expanduser("~/.cache/spherical_dyffusion_tpu")
HF_DEFAULT_ENDPOINT = "https://huggingface.co"
HF_REVISION = "main"  # the branch hf_hub_download resolves by default
HF_TIMEOUT_S = 60.0


def resolve_checkpoint_path(path: str, cache_dir: Optional[str] = None) -> str:
    """A checkpoint spec -> a local file path: the file itself, the newest
    ``*.ckpt`` under a directory, a HuggingFace Hub file (``hf:``) or a wandb
    run's checkpoint (``wandb:``; ``:0`` is epoch 0, no suffix ``best``),
    downloaded into ``cache_dir`` (default under ``~/.cache``)."""
    if path.startswith(HF_PREFIX):
        return download_from_hf(path[len(HF_PREFIX):], cache_dir=cache_dir)
    if path.startswith(WANDB_PREFIX):
        from .wandb_client import restore_checkpoint_from_wandb

        run_path, _, epoch_s = path[len(WANDB_PREFIX):].partition(":")
        epoch = int(epoch_s) if epoch_s.isdigit() else (epoch_s if epoch_s else "best")
        dest = cache_dir or os.path.join(DEFAULT_CACHE, "wandb")
        os.makedirs(dest, exist_ok=True)
        return restore_checkpoint_from_wandb(run_path, dest_dir=dest, epoch=epoch)
    if os.path.isdir(path):
        found = find_checkpoint_in_dir(path)
        if found is None:
            raise FileNotFoundError(f"No *.ckpt under {path}")
        return found
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def find_checkpoint_in_dir(d: str, pattern: str = "*.ckpt") -> Optional[str]:
    """The most recently modified file matching ``pattern`` under ``d``."""
    cands = sorted(glob.glob(os.path.join(d, "**", pattern), recursive=True),
                   key=os.path.getmtime)
    return cands[-1] if cands else None


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


def _hf_headers():
    token = os.environ.get("HF_TOKEN")
    return {"Authorization": f"Bearer {token}"} if token else {}


def download_from_hf(spec: str, cache_dir: Optional[str] = None,
                     endpoint: Optional[str] = None) -> str:
    """``org/repo/filename`` -> the local path of the file in the hub
    cache under ``cache_dir``, downloaded from ``endpoint`` (else
    ``HF_ENDPOINT``, else the public hub) unless the snapshot holds it."""
    parts = spec.split("/")
    if len(parts) < 3:
        raise ValueError(f"hf spec must be org/repo/filename, got {spec!r}")
    repo_id, filename = "/".join(parts[:2]), "/".join(parts[2:])
    cache_dir = cache_dir or os.path.join(DEFAULT_CACHE, "hf")
    endpoint = (endpoint or os.environ.get("HF_ENDPOINT") or HF_DEFAULT_ENDPOINT).rstrip("/")
    url = f"{endpoint}/{repo_id}/resolve/{HF_REVISION}/{urllib.parse.quote(filename)}"
    head = urllib.request.Request(url, method="HEAD",
                                  headers={"Accept-Encoding": "identity", **_hf_headers()})
    try:
        with urllib.request.build_opener(_NoRedirect).open(head, timeout=HF_TIMEOUT_S) as r:
            headers, location = r.headers, None
    except urllib.error.HTTPError as e:
        if e.code not in (301, 302, 303, 307, 308):
            raise
        headers, location = e.headers, urllib.parse.urljoin(url, e.headers["Location"])
    commit = headers.get("X-Repo-Commit")
    etag = headers.get("X-Linked-Etag") or headers.get("ETag")
    if not commit or not etag:
        raise RuntimeError(f"{url}: the hub's answer lacks X-Repo-Commit or ETag")
    etag = etag.removeprefix("W/").strip('"')
    repo_dir = os.path.join(cache_dir, "models--" + repo_id.replace("/", "--"))
    snapshot = os.path.join(repo_dir, "snapshots", commit, filename)
    blob = os.path.join(repo_dir, "blobs", etag)
    if not os.path.exists(snapshot):
        if not os.path.exists(blob):
            os.makedirs(os.path.dirname(blob), exist_ok=True)
            get = urllib.request.Request(location or url, headers=_hf_headers())
            fd, tmp = tempfile.mkstemp(prefix=etag + ".", suffix=".incomplete",
                                       dir=os.path.dirname(blob))
            try:
                with os.fdopen(fd, "wb") as f:
                    with urllib.request.urlopen(get, timeout=HF_TIMEOUT_S) as r:
                        shutil.copyfileobj(r, f, 1 << 20)
                os.replace(tmp, blob)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        os.makedirs(os.path.dirname(snapshot), exist_ok=True)
        try:
            os.symlink(os.path.relpath(blob, os.path.dirname(snapshot)), snapshot)
        except OSError:
            shutil.copyfile(blob, snapshot)
    os.makedirs(os.path.join(repo_dir, "refs"), exist_ok=True)
    with open(os.path.join(repo_dir, "refs", HF_REVISION), "w") as f:
        f.write(commit)
    return snapshot


class CheckpointMirror:
    """Mirror training checkpoints to ``s3://bucket/prefix`` with content-hash
    dedup, as the JAX package's: an in-process cache skips an unchanged
    re-save, and a ``<key>.sha256`` sidecar object lets a resumed run skip
    it too. ``endpoint_url`` (or ``S3_ENDPOINT_URL``) names the endpoint."""

    def __init__(self, url: str, endpoint_url: Optional[str] = None,
                 region: str = "us-east-1"):
        if not url.startswith("s3://"):
            raise ValueError(f"ckpt_mirror must be an s3:// URL, got {url!r}")
        bucket, _, prefix = url[len("s3://"):].partition("/")
        if not bucket:
            raise ValueError(f"no bucket in ckpt_mirror URL {url!r}")
        self.client = S3Client(bucket, endpoint_url=endpoint_url, region=region)
        self.prefix = prefix.strip("/")
        self._uploaded: dict = {}  # full key -> sha256 hex

    def _key(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    @staticmethod
    def _file_sha256(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    def mirror(self, local_path: str, name: Optional[str] = None) -> bool:
        """Upload ``local_path`` unless its content is already mirrored;
        True when it uploaded. A failed upload is printed and the file stays
        local: training does not stop because the endpoint is down."""
        key = self._key(name or os.path.basename(local_path))
        sha = self._file_sha256(local_path)
        if self._uploaded.get(key) == sha:
            return False
        try:
            if key not in self._uploaded:
                try:
                    remote = self.client.get_bytes(key + ".sha256").decode()
                except Exception:
                    remote = None
                if remote == sha:
                    self._uploaded[key] = sha
                    return False
            self.client.upload(local_path, key)
            self.client.put_bytes(key + ".sha256", sha.encode())
            self._uploaded[key] = sha
            return True
        except Exception as e:
            print(f"[ckpt-mirror] upload of {key} failed (kept local): {e}")
            return False
