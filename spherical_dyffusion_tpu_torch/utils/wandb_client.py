"""Native wandb cloud client: GraphQL over urllib, no wandb SDK.

A copy of ``spherical_dyffusion_tpu/utils/wandb_client.py`` (the standard
library and the port's own ``utils/config.py`` and ``utils/code_snapshot.py``;
the port imports nothing of the JAX package). It speaks the wandb wire
protocol directly: ``POST {base}/graphql`` with Basic ``api:<key>`` auth,
JSON-string config and summary payloads, MongoDB-style run filters,
per-file download URLs, signed-URL uploads and the file-stream endpoint for
metric rows. ``WANDB_BASE_URL`` names the endpoint (a loopback server in
the tests), ``WANDB_API_KEY`` the key. Runs logged offline are read through
``utils/runs_api.py``.
"""

from __future__ import annotations

import json
import os
import re
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Union

__all__ = [
    "WandbClient",
    "NativeWandbRun",
    "get_wandb_ckpt_name",
    "restore_checkpoint_from_wandb",
    "load_config_from_wandb",
]

DEFAULT_BASE_URL = "https://api.wandb.ai"

_RUN_FIELDS = """
  id
  name
  displayName
  state
  config
  summaryMetrics
"""

_RUN_QUERY = """
query Run($entity: String!, $project: String!, $name: String!) {
  project(name: $project, entityName: $entity) {
    run(name: $name) { %s }
  }
}
""" % _RUN_FIELDS

_RUNS_QUERY = """
query Runs($entity: String!, $project: String!, $filters: JSONString, $first: Int) {
  project(name: $project, entityName: $entity) {
    runs(filters: $filters, first: $first) {
      edges { node { %s } }
    }
  }
}
""" % _RUN_FIELDS

_FILES_QUERY = """
query RunFiles($entity: String!, $project: String!, $name: String!, $names: [String]) {
  project(name: $project, entityName: $entity) {
    run(name: $name) {
      files(names: $names) {
        edges { node { name md5 sizeBytes directUrl } }
      }
    }
  }
}
"""

_HISTORY_QUERY = """
query RunHistory($entity: String!, $project: String!, $name: String!, $samples: Int) {
  project(name: $project, entityName: $entity) {
    run(name: $name) { history(samples: $samples) }
  }
}
"""

# per-file signed upload URLs — the query the wandb SDK issues for
# wandb.save()/log_code(): the backend registers the filenames on the run and
# returns a signed PUT URL per file (url(upload: true)) plus any storage
# headers the PUT must carry
_UPLOAD_URLS_QUERY = """
query RunUploadUrls($name: String!, $files: [String]!, $entity: String, $run: String!) {
  model(name: $name, entityName: $entity) {
    bucket(name: $run) {
      id
      files(names: $files) {
        uploadHeaders
        edges { node { name url(upload: true) } }
      }
    }
  }
}
"""

# run creation/update — the mutation the wandb SDK issues at wandb.init()
_UPSERT_RUN_MUTATION = """
mutation UpsertBucket($entity: String, $project: String, $name: String,
                      $displayName: String, $config: JSONString) {
  upsertBucket(input: {entityName: $entity, modelName: $project,
                       name: $name, displayName: $displayName,
                       config: $config}) {
    bucket { id name displayName }
  }
}
"""


def _split_run_path(run_path: str):
    parts = run_path.split("/")
    if len(parts) != 3:
        raise ValueError(f"run_path must be ENTITY/PROJECT/RUN_ID, got {run_path!r}")
    return parts[0], parts[1], parts[2]


class WandbClient:
    """Minimal wandb-protocol API client (query + file restore)."""

    def __init__(self, base_url: Optional[str] = None,
                 api_key: Optional[str] = None, timeout: float = 30.0):
        self.base_url = (base_url or os.environ.get("WANDB_BASE_URL")
                         or DEFAULT_BASE_URL).rstrip("/")
        self.api_key = api_key or os.environ.get("WANDB_API_KEY", "")
        self.timeout = timeout

    # -- transport ---------------------------------------------------------
    def _auth_header(self) -> Dict[str, str]:
        if not self.api_key:
            return {}
        import base64

        tok = base64.b64encode(f"api:{self.api_key}".encode()).decode()
        return {"Authorization": f"Basic {tok}"}

    def graphql(self, query: str, variables: Dict[str, Any]) -> Dict[str, Any]:
        body = json.dumps({"query": query, "variables": variables}).encode()
        req = urllib.request.Request(
            f"{self.base_url}/graphql", data=body, method="POST",
            headers={"Content-Type": "application/json", **self._auth_header()},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            payload = json.loads(r.read().decode())
        if payload.get("errors"):
            raise RuntimeError(f"wandb graphql error: {payload['errors']}")
        return payload["data"]

    # -- queries -----------------------------------------------------------
    def run(self, run_path: str) -> Dict[str, Any]:
        """Fetch one run node (config/summary decoded from their JSON-string
        wire form, the shape the wandb backend uses)."""
        entity, project, name = _split_run_path(run_path)
        data = self.graphql(_RUN_QUERY, {"entity": entity, "project": project,
                                         "name": name})
        node = (data.get("project") or {}).get("run")
        if node is None:
            raise KeyError(f"run not found: {run_path}")
        return _decode_run(node)

    def runs(self, entity: str, project: str,
             filters: Optional[Dict[str, Any]] = None,
             first: int = 50) -> List[Dict[str, Any]]:
        """Query project runs with MongoDB-style ``filters`` (the reference
        passes e.g. ``{"$and": [{"state": "finished"}]}``, wandb_api.py:85-150)."""
        data = self.graphql(_RUNS_QUERY, {
            "entity": entity, "project": project,
            "filters": json.dumps(filters) if filters else None, "first": first,
        })
        edges = (((data.get("project") or {}).get("runs") or {}).get("edges")) or []
        return [_decode_run(e["node"]) for e in edges]

    def run_files(self, run_path: str,
                  names: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
        entity, project, name = _split_run_path(run_path)
        data = self.graphql(_FILES_QUERY, {
            "entity": entity, "project": project, "name": name,
            "names": list(names) if names else None,
        })
        run = (data.get("project") or {}).get("run") or {}
        edges = ((run.get("files") or {}).get("edges")) or []
        return [e["node"] for e in edges]

    def history(self, run_path: str, samples: int = 500) -> List[Dict[str, Any]]:
        """Sampled metric history: the wire form is a list of JSON-encoded
        row strings (how the wandb backend ships history)."""
        entity, project, name = _split_run_path(run_path)
        data = self.graphql(_HISTORY_QUERY, {
            "entity": entity, "project": project, "name": name,
            "samples": samples,
        })
        rows = ((data.get("project") or {}).get("run") or {}).get("history") or []
        return [json.loads(r) if isinstance(r, str) else r for r in rows]

    # -- writes (the ingestion half of the protocol) -------------------------
    def upsert_run(self, entity: str, project: str, name: str,
                   display_name: Optional[str] = None,
                   config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Create or update a run — the ``upsertBucket`` mutation the wandb
        SDK issues at ``wandb.init()``; config ships in the backend's
        ``{key: {value: ...}}`` envelope form."""
        wrapped = {k: {"value": v} for k, v in (config or {}).items()}
        data = self.graphql(_UPSERT_RUN_MUTATION, {
            "entity": entity, "project": project, "name": name,
            "displayName": display_name or name,
            "config": json.dumps(wrapped),
        })
        return data["upsertBucket"]["bucket"]

    def log_history(self, run_path: str, rows: Sequence[Dict[str, Any]],
                    offset: int = 0) -> int:
        """Append metric rows to a run's history through the file-stream
        endpoint (``POST /files/{entity}/{project}/{run}/file_stream`` with
        JSONL lines under ``wandb-history.jsonl`` — the SDK's metric-upload
        wire format). Returns the next offset."""
        lines = [json.dumps(r) for r in rows]
        self._file_stream(run_path, {"files": {"wandb-history.jsonl": {
            "offset": offset, "content": lines}}})
        return offset + len(lines)

    def mark_finished(self, run_path: str, exitcode: int = 0) -> None:
        """Mark a run finished — the SDK's final file-stream POST carries
        ``{"complete": true, "exitcode": N}``; without it the run stays in
        state 'running' forever and state-filtered queries never match it."""
        self._file_stream(run_path, {"complete": True, "exitcode": exitcode})

    def _file_stream(self, run_path: str, payload: Dict[str, Any]) -> None:
        entity, project, name = _split_run_path(run_path)
        req = urllib.request.Request(
            f"{self.base_url}/files/{entity}/{project}/{name}/file_stream",
            data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json", **self._auth_header()},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            r.read()

    def upload_urls(self, run_path: str,
                    names: Sequence[str]) -> Dict[str, Any]:
        """Resolve signed upload URLs for run files (the SDK's RunUploadUrls
        query). Returns ``{"headers": {...}, "urls": {name: url}}``."""
        entity, project, run = _split_run_path(run_path)
        data = self.graphql(_UPLOAD_URLS_QUERY, {
            "name": project, "entity": entity, "run": run,
            "files": list(names),
        })
        bucket = (data.get("model") or {}).get("bucket")
        if bucket is None:
            raise KeyError(f"run not found: {run_path}")
        files = bucket.get("files") or {}
        headers = {}
        for h in files.get("uploadHeaders") or []:
            k, _, v = h.partition(":")
            headers[k.strip()] = v.strip()
        urls = {e["node"]["name"]: e["node"].get("url")
                for e in files.get("edges") or []}
        return {"headers": headers, "urls": urls}

    def upload_file(self, run_path: str, local_path: str,
                    name: Optional[str] = None) -> Dict[str, Any]:
        """Upload one file into the run's files (the wire behind
        ``wandb.save()`` — the mechanism MyWandbLogger uses to push
        checkpoints to the cloud, reference wandb_callbacks.py:215-219):
        resolve a signed PUT URL, then PUT the bytes with the backend's
        storage headers. Returns ``{"name", "size"}``."""
        name = name or os.path.basename(local_path)
        resolved = self.upload_urls(run_path, [name])
        url = resolved["urls"].get(name)
        if not url:
            raise RuntimeError(
                f"backend returned no upload URL for {name!r} on {run_path}")
        with open(local_path, "rb") as f:
            body = f.read()
        req = urllib.request.Request(
            url, data=body, method="PUT",
            headers={"Content-Type": "application/octet-stream",
                     **resolved["headers"]},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            r.read()
        return {"name": name, "size": len(body)}

    def download_file(self, run_path: str, filename: str, dest: str) -> str:
        """Download one run file via its directUrl to ``dest``."""
        files = self.run_files(run_path, names=[filename])
        match = [f for f in files if f["name"] == filename]
        if not match:
            raise FileNotFoundError(f"{filename} not in run {run_path}")
        url = match[0]["directUrl"]
        req = urllib.request.Request(url, headers=self._auth_header())
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        with urllib.request.urlopen(req, timeout=self.timeout) as r, \
                open(dest, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        return dest


class NativeWandbRun:
    """A live run backed by the native client: the logger-facing subset of
    the SDK's ``wandb.Run`` (init/config/log/finish), buffered so one
    file-stream POST carries many metric rows.

    Used by :class:`~.loggers.WandbLogger` as the SDK-free mirror when
    ``WANDB_BASE_URL``/``WANDB_API_KEY`` point at a wandb-protocol server."""

    # consecutive transport failures before the mirror disables itself
    MAX_FAILURES = 5

    def __init__(self, entity: str, project: str, name: str,
                 client: Optional[WandbClient] = None,
                 config: Optional[Dict[str, Any]] = None,
                 flush_every: int = 32):
        self.client = client or WandbClient()
        self.entity, self.project, self.name = entity, project, name
        self.run_path = f"{entity}/{project}/{name}"
        self.flush_every = flush_every
        self._buffer: List[Dict[str, Any]] = []
        self._offset = 0
        self._failures = 0
        # init failures raise (the caller decides whether to disable the
        # mirror); post-init transport failures are best-effort — training
        # must never die because the metrics endpoint flapped
        self.client.upsert_run(entity, project, name, config=config or {})

    def _best_effort(self, what: str, fn) -> None:
        if self._failures >= self.MAX_FAILURES:
            return
        try:
            fn()
            self._failures = 0
        except Exception as e:
            self._failures += 1
            suffix = (" — mirror disabled" if
                      self._failures >= self.MAX_FAILURES else "")
            print(f"[wandb-mirror] {what} failed ({e}){suffix}")

    def update_config(self, config: Dict[str, Any]):
        self._best_effort("config update", lambda: self.client.upsert_run(
            self.entity, self.project, self.name, config=config))

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        row = dict(metrics)
        if step is not None:
            row["_step"] = step
        self._buffer.append(row)
        if len(self._buffer) >= self.flush_every:
            self.flush()

    def flush(self):
        if not self._buffer:
            return

        def _send():
            self._offset = self.client.log_history(
                self.run_path, self._buffer, offset=self._offset)
            self._buffer = []

        self._best_effort("history flush", _send)

    def save(self, local_path: str, name: Optional[str] = None):
        """Upload a file into the run's cloud files (the SDK's
        ``wandb.save``; reference MyWandbLogger.save_last/save_best push
        checkpoints through it, wandb_callbacks.py:215-219,253-260).
        Content-hash deduplicated like the reference's
        ``_hash_of_best_ckpts`` guard: re-saving unchanged bytes is a no-op."""
        import hashlib

        name = name or os.path.basename(local_path)
        with open(local_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if getattr(self, "_file_hashes", {}).get(name) == digest:
            return
        self._best_effort(f"file upload {name}", lambda: self.client.
                          upload_file(self.run_path, local_path, name=name))
        if self._failures == 0:
            self.__dict__.setdefault("_file_hashes", {})[name] = digest

    def log_code(self, root: str, name: str = "code.tar.gz"):
        """Snapshot the source tree into the run's files (the SDK's
        ``log_code``; reference MyWandbLogger uploads ``src/`` python files,
        wandb_callbacks.py:118-133): one tar.gz of the tree's .py/.yaml
        files, uploaded like any run file."""
        import tempfile

        from .code_snapshot import snapshot_code

        with tempfile.TemporaryDirectory() as td:
            path = snapshot_code(os.path.join(td, name), roots=[root])
            self.save(path, name=name)

    def finish(self):
        self.flush()
        self._best_effort("finish", lambda: self.client.mark_finished(
            self.run_path))


def _decode_run(node: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(node)
    for key in ("config", "summaryMetrics"):
        v = out.get(key)
        if isinstance(v, str):
            out[key] = json.loads(v) if v else {}
    return out


# -- reference-parity helpers ------------------------------------------------


def get_wandb_ckpt_name(client: WandbClient, run_path: str,
                        epoch: Union[str, int] = "best") -> str:
    """Select the checkpoint filename for a run: ``best``/``last`` prefer the
    literal best.ckpt/last.ckpt, otherwise fall back to epochNNN parsing —
    the reference's exact selection ladder (wandb_api.py:198-244)."""
    if epoch not in ("best", "last") and not isinstance(epoch, int):
        raise ValueError(f"epoch must be 'best', 'last' or an int, got {epoch!r}")
    ckpt_files = [f["name"] for f in client.run_files(run_path)
                  if f["name"].endswith(".ckpt")]
    if epoch == "best":
        if "best.ckpt" in ckpt_files:
            return "best.ckpt"
        raise ValueError(f"Could not find best.ckpt in {ckpt_files}")
    if epoch == "last" and "last.ckpt" in ckpt_files:
        return "last.ckpt"
    if not ckpt_files:
        raise ValueError(f"run {run_path} has no .ckpt files in the cloud")
    if len(ckpt_files) >= 2:
        # parse only the digits immediately after 'epoch' (the reference's
        # int(name.replace('epoch','')[:3]) — 'epoch004-v1.ckpt' is epoch 4,
        # not 41); names without the prefix never match a numeric request
        def _epoch_of(name: str) -> int:
            m = re.search(r"epoch(\d+)", name)
            return int(m.group(1)) if m else -1

        epochs = [_epoch_of(name) for name in ckpt_files]
        if epoch == "last":
            target = max(epochs)
        else:
            target = int(epoch)
            if target not in epochs:
                raise ValueError(f"no ckpt for epoch={epoch}; have {epochs}")
        return ckpt_files[epochs.index(target)]
    return ckpt_files[0]


def restore_checkpoint_from_wandb(
    run_path: str,
    dest_dir: Optional[str] = None,
    ckpt_filename: Optional[str] = None,
    epoch: Union[str, int] = "best",
    client: Optional[WandbClient] = None,
) -> str:
    """Restore a run's checkpoint to the local filesystem
    (restore_model_from_wandb_cloud, wandb_api.py:246-311): resolve the
    filename (unless given), download, and prefix the local name with the
    run id to avoid cross-run collisions — the reference's rename step."""
    client = client or WandbClient()
    dest_dir = dest_dir or os.getcwd()
    if ckpt_filename is None:
        ckpt_filename = get_wandb_ckpt_name(client, run_path, epoch=epoch)
        ckpt_filename = ckpt_filename.split("/")[-1]
    run_id = _split_run_path(run_path)[2]
    local_name = ckpt_filename if run_id in ckpt_filename \
        else f"{run_id}-{ckpt_filename}"
    dest = os.path.join(dest_dir, local_name)
    if os.path.exists(dest):
        return dest
    return client.download_file(run_path, ckpt_filename, dest)


def load_config_from_wandb(
    run_path: str,
    overrides: Optional[Dict[str, Any]] = None,
    client: Optional[WandbClient] = None,
) -> Dict[str, Any]:
    """Reload a run's training config from the cloud with local overrides
    deep-merged on top (load_hydra_config_from_wandb, wandb_api.py:311-427).
    The wandb wire config wraps every top-level entry as ``{"value": ...}``
    (plus ``_wandb`` bookkeeping) — unwrap to the plain mapping."""
    from .config import deep_update

    client = client or WandbClient()
    raw = client.run(run_path)["config"]
    # the SDK's envelope is {'value': ..., 'desc': ...} — unwrap on key
    # presence like the SDK does, not dict equality
    cfg = {k: (v["value"] if isinstance(v, dict) and "value" in v else v)
           for k, v in raw.items() if k != "_wandb"}
    if overrides:
        cfg = deep_update(cfg, dict(overrides))
    return cfg
