"""The port's network clients against the JAX package's, over loopback
servers on the CPU: S3 (SigV4 or anonymous), the wandb wire protocol, the
HuggingFace Hub's resolve protocol, and the trainer's checkpoint mirror and
wandb upload.

The S3 and wandb servers are those of ``tests/test_s3.py`` and
``tests/test_wandb_client.py`` (imported; the S3 one wrapped to log each
request); the hub server answers HEAD with the commit and ETag (directly, or
by a redirect whose target serves the file, as the hub does for files in
LFS) and GET with the bytes, as in ``tests/test_metrics.py``. Nothing leaves
127.0.0.1. Copies of JAX modules are pinned by their code (docstrings
aside); files, requests and cache layouts are compared exactly.
"""

import ast
import collections
import http.server
import inspect
import os
import threading

import pytest
import torch

import spherical_dyffusion_tpu.utils.s3 as js3
import spherical_dyffusion_tpu.utils.wandb_client as jwandb_client
import test_s3
import test_wandb_client as twc
from spherical_dyffusion_tpu_torch.utils import s3, wandb_client
from spherical_dyffusion_tpu_torch.utils.checkpointing import (CheckpointMirror,
                                                              resolve_checkpoint_path)
from spherical_dyffusion_tpu_torch.utils.loggers import WandbLogger, make_logger
from spherical_dyffusion_tpu_torch.utils.wandb_client import (NativeWandbRun, WandbClient,
                                                              get_wandb_ckpt_name,
                                                              load_config_from_wandb,
                                                              restore_checkpoint_from_wandb)

torch.set_num_threads(2)
RUN1 = f"{twc.ENTITY}/{twc.PROJECT}/run1"


def _code(module) -> str:
    tree = ast.parse(inspect.getsource(module))
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("mod,jmod", [(s3, js3), (wandb_client, jwandb_client)])
def test_client_copies_are_pinned(mod, jmod):
    assert _code(mod) == _code(jmod)


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


# ------------------------------------------------------------------- S3

class _LoggedS3(test_s3._Handler):
    """tests/test_s3.py's handler, each request logged as (method, key)."""

    def _log(self):
        self.server.log.append((self.command, self._key()))

    def do_GET(self):
        self._log()
        super().do_GET()

    def do_PUT(self):
        self._log()
        super().do_PUT()

    def do_DELETE(self):
        self._log()
        super().do_DELETE()


def _s3_server(require_auth):
    srv = test_s3._S3Server(require_auth)
    srv.RequestHandlerClass, srv.log = _LoggedS3, []
    return _serve(srv)


@pytest.fixture(params=[False, True], ids=["anonymous", "sigv4"])
def s3srv(request, monkeypatch):
    srv = _s3_server(request.param)
    if request.param:
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", test_s3.ACCESS)
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", test_s3.SECRET)
    else:
        monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
        monkeypatch.delenv("AWS_SECRET_ACCESS_KEY", raising=False)
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def test_s3_round_trip_listing_and_download(s3srv, tmp_path):
    srv, url = s3srv
    client = s3.S3Client(test_s3.BUCKET, endpoint_url=url)
    (tmp_path / "ckpt.bin").write_bytes(b"\x00weights\xff")
    client.upload(str(tmp_path / "ckpt.bin"), "runs/a/ckpt.bin")
    client.download("runs/a/ckpt.bin", str(tmp_path / "out" / "ckpt.bin"))
    assert (tmp_path / "out" / "ckpt.bin").read_bytes() == b"\x00weights\xff"
    client.delete("runs/a/ckpt.bin")
    assert "runs/a/ckpt.bin" not in srv.objects
    srv.objects = {f"exp/run{i}/last.ckpt": b"x" for i in range(5)}
    srv.objects.update({"exp/run0/best.ckpt": b"y", "d/a.nc": b"A", "d/sub/b.nc": b"B"})
    jclient = js3.S3Client(test_s3.BUCKET, endpoint_url=url)
    srv.log.clear()
    got = s3.get_s3_objects(client, "exp/*/last.ckpt")
    port_log = list(srv.log)
    srv.log.clear()
    assert got == js3.get_s3_objects(jclient, "exp/*/last.ckpt") and len(got) == 5
    assert port_log == srv.log and len(port_log) == 3  # pages of 2
    done = s3.download_s3_path(client, "d/", str(tmp_path))
    assert sorted(done) == [str(tmp_path / "d/a.nc"), str(tmp_path / "d/sub/b.nc")]
    (tmp_path / "d/a.nc").write_bytes(b"LOCAL")
    s3.download_s3_path(client, "d/", str(tmp_path))
    assert (tmp_path / "d/a.nc").read_bytes() == b"LOCAL"
    if srv.require_auth:
        client.secret_key = "wrong"
        with pytest.raises(Exception):
            client.get_bytes("d/a.nc")


def test_checkpoint_mirror_dedups_as_jax(s3srv, tmp_path):
    """Upload, an unchanged re-save skipped, a changed one uploaded, a new
    mirror skipping by the sidecar, a dead endpoint not raising: the same
    answers and the same requests as JAX's mirror."""
    from spherical_dyffusion_tpu.utils.checkpointing import CheckpointMirror as JMirror

    srv, url = s3srv
    logs, answers = [], []
    for cls, prefix in ((CheckpointMirror, "port"), (JMirror, "jax")):
        srv.log.clear()
        f = tmp_path / f"{prefix}.ckpt"
        f.write_bytes(b"weights-v1")
        m = cls(f"s3://{test_s3.BUCKET}/runs/{prefix}", endpoint_url=url)
        got = [m.mirror(str(f), name="last.ckpt"), m.mirror(str(f), name="last.ckpt")]
        f.write_bytes(b"weights-v2")
        got.append(m.mirror(str(f), name="last.ckpt"))
        got.append(cls(f"s3://{test_s3.BUCKET}/runs/{prefix}", endpoint_url=url).mirror(
            str(f), name="last.ckpt"))
        got.append(cls(f"s3://{test_s3.BUCKET}/runs/{prefix}",
                       endpoint_url="http://127.0.0.1:9").mirror(str(f), name="last.ckpt"))
        assert srv.objects[f"runs/{prefix}/last.ckpt"] == b"weights-v2"
        answers.append(got)
        logs.append([(m_, k.replace(prefix, "P")) for m_, k in srv.log])
    assert answers[0] == answers[1] == [True, False, True, False, False]
    assert logs[0] == logs[1]


# ----------------------------------------------------------------- wandb

@pytest.fixture(scope="module")
def wandb_srv():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), twc._Handler)
    srv.ingested, srv.upserted, srv.finished = {}, {}, {}
    srv.uploaded, srv.upload_counts = {}, {}
    _serve(srv)
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


@pytest.fixture
def client(wandb_srv):
    return WandbClient(base_url=wandb_srv[1], api_key=twc.API_KEY)


def test_wandb_queries_match_jax(client, wandb_srv):
    jclient = jwandb_client.WandbClient(base_url=wandb_srv[1], api_key=twc.API_KEY)
    assert client.run(RUN1) == jclient.run(RUN1)
    filt = {"$and": [{"state": "finished"}]}
    assert client.runs(twc.ENTITY, twc.PROJECT, filters=filt) == \
        jclient.runs(twc.ENTITY, twc.PROJECT, filters=filt)
    assert client.history(RUN1) == jclient.history(RUN1) and len(client.history(RUN1)) == 5
    assert load_config_from_wandb(RUN1, overrides={"lr": 1.0}, client=client) == \
        jwandb_client.load_config_from_wandb(RUN1, overrides={"lr": 1.0}, client=jclient)
    for run, epoch in [("run1", "best"), ("run1", "last"), ("run2", "last"), ("run2", 23)]:
        rp = f"{twc.ENTITY}/{twc.PROJECT}/{run}"
        assert get_wandb_ckpt_name(client, rp, epoch) == \
            jwandb_client.get_wandb_ckpt_name(jclient, rp, epoch)
    with pytest.raises(RuntimeError, match="unauthorized"):
        WandbClient(base_url=wandb_srv[1], api_key="wrong").run(RUN1)


def test_wandb_restore_and_prefix(client, wandb_srv, tmp_path, monkeypatch):
    p = restore_checkpoint_from_wandb(RUN1, dest_dir=str(tmp_path), epoch="last", client=client)
    assert os.path.basename(p) == "run1-last.ckpt" and open(p, "rb").read() == twc.CKPT_BYTES
    monkeypatch.setenv("WANDB_BASE_URL", wandb_srv[1])
    monkeypatch.setenv("WANDB_API_KEY", twc.API_KEY)
    got = resolve_checkpoint_path(f"wandb:{RUN1}:best", cache_dir=str(tmp_path / "c"))
    assert got.endswith("run1-best.ckpt") and open(got, "rb").read() == twc.CKPT_BYTES
    # ':0' is epoch 0, never 'best'
    twc.RUNS["run4"] = dict(twc.RUNS["run2"], name="run4", files=[
        {"name": "epoch000.ckpt", "md5": "a", "sizeBytes": len(twc.CKPT_BYTES)},
        {"name": "epoch003.ckpt", "md5": "b", "sizeBytes": len(twc.CKPT_BYTES)}])
    try:
        got = resolve_checkpoint_path(f"wandb:{twc.ENTITY}/{twc.PROJECT}/run4:0",
                                      cache_dir=str(tmp_path / "c"))
    finally:
        del twc.RUNS["run4"]
    assert os.path.basename(got) == "run4-epoch000.ckpt"


def test_native_run_ingests_uploads_and_survives_failures(client, wandb_srv, tmp_path):
    srv = wandb_srv[0]
    run = NativeWandbRun(twc.ENTITY, twc.PROJECT, "port-ingest", client=client,
                         config={"embed_dim": 64}, flush_every=3)
    for i in range(7):
        run.log({"loss": 1.0 / (i + 1)}, step=i)
    f = tmp_path / "last.ckpt"
    f.write_bytes(b"v1")
    run.save(str(f))
    run.save(str(f))
    run.finish()
    assert srv.upserted["port-ingest"][0]["embed_dim"] == {"value": 64}
    assert [r["_step"] for r in srv.ingested["port-ingest"]] == list(range(7))
    assert srv.finished["port-ingest"] == 0
    assert srv.upload_counts[("port-ingest", "last.ckpt")] == 1
    src = tmp_path / "pkg"
    src.mkdir()
    (src / "a.py").write_text("x = 1\n")
    run.log_code(str(src))
    assert "code.tar.gz" in srv.uploaded["port-ingest"]
    run.client = WandbClient(base_url="http://127.0.0.1:9", api_key="x", timeout=0.2)
    for i in range(NativeWandbRun.MAX_FAILURES + 2):
        run.log({"loss": 1.0}, step=i)
        run.flush()
    run.finish()
    assert run._failures >= NativeWandbRun.MAX_FAILURES


def test_wandb_logger_mirrors_through_the_native_run(wandb_srv, tmp_path, monkeypatch):
    srv, url = wandb_srv
    assert WandbLogger(project=twc.PROJECT)._native is None  # no WANDB_BASE_URL: a no-op
    monkeypatch.setenv("WANDB_BASE_URL", url)
    monkeypatch.setenv("WANDB_API_KEY", twc.API_KEY)
    monkeypatch.setenv("WANDB_ENTITY", twc.ENTITY)
    lg = make_logger({"name": "port-mirror1", "logger": {"wandb": {"project": twc.PROJECT}}},
                     str(tmp_path))
    lg.log_hyperparams({"lr": 0.001})
    lg.log({"train/loss": 0.5}, step=0)
    lg.log({"train/loss": 0.25}, step=1)
    lg.finish()
    assert srv.upserted["port-mirror1"][-1]["lr"] == {"value": 0.001}
    assert [r["train/loss"] for r in srv.ingested["port-mirror1"]] == [0.5, 0.25]
    assert (tmp_path / "port-mirror1" / "metrics.jsonl").exists()


# --------------------------------------------------- the trainer's uploads

def test_trainer_mirrors_and_uploads_as_jax(wandb_srv, tmp_path, monkeypatch):
    """``ckpt_mirror`` and ``save_to_wandb`` with ``ckpt_monitor``: over
    three epochs whose validation improves, regresses and improves, the
    port's trainer makes the S3 requests JAX's makes (last.ckpt every epoch,
    best.ckpt on improvement, the code snapshot once) and uploads the same
    files into its wandb run; the mirrored bytes are the files on disk."""
    from spherical_dyffusion_tpu.data import DebugDataModule as JDebugDataModule
    from spherical_dyffusion_tpu.models import SFNO as JSFNO
    from spherical_dyffusion_tpu.models import SFNOConfig as JSFNOConfig
    from spherical_dyffusion_tpu.training import ExperimentConfig as JExperimentConfig
    from spherical_dyffusion_tpu.training import InterpolationExperiment as JInterp
    from spherical_dyffusion_tpu.training import Trainer as JTrainer
    from spherical_dyffusion_tpu.training import TrainerConfig as JTrainerConfig
    from spherical_dyffusion_tpu.utils.loggers import WandbLogger as JWandbLogger
    from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
    from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
    from spherical_dyffusion_tpu_torch.training.experiments import (ExperimentConfig,
                                                                    InterpolationExperiment)
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig

    wsrv, url = wandb_srv
    s3srv = _s3_server(True)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", test_s3.ACCESS)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", test_s3.SECRET)
    monkeypatch.setenv("S3_ENDPOINT_URL", f"http://127.0.0.1:{s3srv.server_address[1]}")
    monkeypatch.setenv("WANDB_BASE_URL", url)
    monkeypatch.setenv("WANDB_API_KEY", twc.API_KEY)
    monkeypatch.setenv("WANDB_ENTITY", twc.ENTITY)
    dm_kw = dict(channels=2, height=8, width=16, horizon=3, n_forcing=1, batch_size=4,
                 n_timesteps=16)
    net_kw = dict(img_shape=(8, 16), in_chans=5, out_chans=2, embed_dim=8, num_layers=1,
                  with_time_emb=True, min_time=1, max_time=2)
    tr_kw = dict(epochs=3, steps_per_epoch=2, warmup_steps=1, use_ema=False,
                 ckpt_monitor="val/mse", save_to_wandb=True)
    logs = {}
    try:
        for side in ("port", "jax"):
            d = tmp_path / side
            if side == "port":
                dm = DebugDataModule(**dm_kw)
                net = SFNO(SFNOConfig(**net_kw))
                net.init_weights(torch.Generator().manual_seed(0))
                exp = InterpolationExperiment(net, ExperimentConfig(horizon=3), dm.in_packer,
                                              dm.out_packer, dm.normalizer)
                tr = Trainer(exp, dm, TrainerConfig(
                    **tr_kw, ckpt_dir=str(d), ckpt_mirror=f"s3://{test_s3.BUCKET}/runs/{side}"))
                lg = WandbLogger(project=twc.PROJECT, name=f"{side}-train")
            else:
                dm = JDebugDataModule(**dm_kw)
                exp = JInterp(JSFNO(JSFNOConfig(**net_kw)), JExperimentConfig(horizon=3),
                              dm.in_packer, dm.out_packer, dm.normalizer)
                tr = JTrainer(exp, dm, JTrainerConfig(
                    **tr_kw, ckpt_dir=str(d), ckpt_mirror=f"s3://{test_s3.BUCKET}/runs/{side}"))
                lg = JWandbLogger(project=twc.PROJECT, name=f"{side}-train")
            vals = iter([1.0, 2.0, 0.5])
            tr.validate = lambda state, *a, **k: {"val/mse": next(vals)}
            s3srv.log.clear()
            tr.fit(verbose=False, val_every=1, logger=lg)
            lg.finish()
            logs[side] = [(m, k.replace(f"runs/{side}/", "")) for m, k in s3srv.log]
            for name in ("last.ckpt", "best.ckpt", "code.tar.gz"):
                on_disk = (d / name).read_bytes()
                assert s3srv.objects[f"runs/{side}/{name}"] == on_disk, (side, name)
                assert wsrv.uploaded[f"{side}-train"][name] == on_disk, (side, name)
    finally:
        s3srv.shutdown()
    assert logs["port"] == logs["jax"]
    assert [k for m, k in logs["port"] if m == "PUT"].count("best.ckpt") == 2
    counts = {side: sorted((n, c) for (r, n), c in wsrv.upload_counts.items()
                           if r == f"{side}-train") for side in ("port", "jax")}
    assert counts["port"] == counts["jax"]


# ------------------------------------------------------------------ hub

HubFile = collections.namedtuple("HubFile", "payload commit etag redirect")


class _Hub(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _meta(self, code, f, extra=()):
        self.send_response(code)
        self.send_header("X-Repo-Commit", f.commit)
        self.send_header("X-Linked-Etag" if f.redirect else "ETag", f'"{f.etag}"')
        self.send_header("Content-Length", str(len(f.payload)))
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()

    def _answer(self, body):
        f = self.server.file
        self.server.log.append((self.command, self.path))
        if self.path == "/org/repo/resolve/main/model.ckpt":
            if f.redirect:
                host, port = self.server.server_address
                return self._meta(302, f, [("Location", f"http://{host}:{port}/cdn/blob")])
            self._meta(200, f)
        elif self.path == "/cdn/blob" and f.redirect:
            self.send_response(200)
            self.send_header("Content-Length", str(len(f.payload)))
            self.end_headers()
        else:
            self.send_response(404)
            self.end_headers()
            return
        if body:
            self.wfile.write(f.payload)

    def do_HEAD(self):
        self._answer(False)

    def do_GET(self):
        self._answer(True)


@pytest.mark.parametrize("redirect", [False, True])
def test_hf_download_fills_the_hub_cache_as_huggingface_hub(tmp_path, monkeypatch, redirect):
    """``hf:org/repo/model.ckpt`` over the resolve protocol: the same file,
    path and cache layout (blobs, snapshots, refs) as ``huggingface_hub``'s
    ``hf_hub_download``, which the JAX package calls; a second resolve reads
    the cache."""
    from spherical_dyffusion_tpu.utils.checkpointing import \
        resolve_checkpoint_path as jresolve

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Hub)
    srv.file = HubFile(b"reference-lightning-checkpoint" * 7, "a" * 40, "e1e2e3", redirect)
    srv.log = []
    _serve(srv)
    monkeypatch.setenv("HF_ENDPOINT", f"http://127.0.0.1:{srv.server_address[1]}")
    monkeypatch.delenv("HF_TOKEN", raising=False)
    try:
        got = resolve_checkpoint_path("hf:org/repo/model.ckpt", cache_dir=str(tmp_path / "p"))
        port_log = list(srv.log)
        want = jresolve("hf:org/repo/model.ckpt", cache_dir=str(tmp_path / "j"))
        again = resolve_checkpoint_path("hf:org/repo/model.ckpt", cache_dir=str(tmp_path / "p"))
    finally:
        srv.shutdown()
    assert os.path.relpath(got, tmp_path / "p") == os.path.relpath(want, tmp_path / "j")
    assert again == got and open(got, "rb").read() == srv.file.payload
    assert [m for m, _ in port_log] == ["HEAD", "GET"] and srv.log[-1][0] == "HEAD"

    def layout(root):
        return sorted((os.path.relpath(os.path.join(d, n), root),
                       os.path.islink(os.path.join(d, n)))
                      for d, _, names in os.walk(root) for n in names
                      if not n.endswith(".lock") and ".locks" not in d)

    assert layout(tmp_path / "p") == layout(tmp_path / "j")
    refs = "models--org--repo/refs/main"
    assert (tmp_path / "p" / refs).read_text() == (tmp_path / "j" / refs).read_text()
