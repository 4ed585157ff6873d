"""The port's HTTP daemon (`avsync_torch.serving.AvsyncServer`) on the CPU,
against the JAX package's daemon on the same tiny checkpoints (a reference
LipNet `.pth` and a detector `.pth` written by `avsync.compat`), both on
port 0 in this process. Mirrors tests/test_serving.py's TestHTTPServer and
TestGracefulDrain: responses equal the JAX daemon's (`latency_ms` aside;
sync probabilities within 1e-5), the status codes, the drain.

Every client socket has a timeout, every join and shutdown a bound.
"""

import io
import json
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from avsync.compat import save_detector_pth, save_lipnet_pth
from avsync.config import AudioConfig as JaxAudioConfig
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import DetectorConfig as JaxDetectorConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.models import LipNet as JaxLipNet
from avsync.models import MisalignmentDetector as JaxDetector
from avsync_torch.config import AudioConfig, AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.serving import AvsyncServer, DynamicBatcher, ServingStats

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 30.0
DATA = dict(img_height=16, img_width=32, max_video_length=8)
MODEL = dict(hidden_dim=8, conv_channels=(2, 3, 4))
S = 8000
JAX_CFG = JaxConfig(data=JaxDataConfig(**DATA), model=JaxModelConfig(**MODEL),
                    audio=JaxAudioConfig(max_audio_samples=S),
                    detector=JaxDetectorConfig(hidden_dim=16))
CFG = AvsyncConfig(data=DataConfig(**DATA),
                   model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True, **MODEL),
                   audio=AudioConfig(max_audio_samples=S, use_pallas=True))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_http")
    params = JaxLipNet(JAX_CFG.model).init({"params": jax.random.PRNGKey(0)},
                                           jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(0)
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.3, np.shape(p))).astype(
        np.float32), params)
    lip = str(root / "lipnet.pth")
    save_lipnet_pth(params, lip, conv_shape=(4, 2, 4))
    feat_dim = 2 * 4 * 2 * 4 + 40
    det_params = JaxDetector(hidden_dim=16).init({"params": jax.random.PRNGKey(1)},
                                                 jnp.zeros((1, feat_dim)))["params"]
    det = str(root / "detector.pth")
    save_detector_pth(jax.device_get(det_params), det, feat_dim, 16,
                      {"sample_rate": 16000, "n_mfcc": 20, "max_shift_frames": 10},
                      conv_shape=(4, 2, 4), n_audio_feats=40)
    cfg_path = str(root / "cfg.json")
    Path(cfg_path).write_text(CFG.to_json())
    return {"lipnet": lip, "detector": det, "root": root, "config": cfg_path}


def _post(url, data, ctype):
    req = urllib.request.Request(url, data=data, method="POST", headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _url(srv):
    return f"http://{srv.address[0]}:{srv.address[1]}"


def _no_latency(out):
    return {k: v for k, v in out.items() if k != "latency_ms"}


@pytest.fixture(scope="module")
def servers(checkpoints):
    """The port's daemon and the JAX package's, on the same weights."""
    from avsync.predictor import LipReader as JaxLipReader
    from avsync.predictor import MisalignmentScorer as JaxScorer
    from avsync.serving import AvsyncServer as JaxServer
    from avsync.serving import SyncScoreService as JaxSyncService
    from avsync.serving import TranscribeService as JaxTranscribeService
    from avsync_torch.predictor import LipReader, MisalignmentScorer
    from avsync_torch.serving import SyncScoreService, TranscribeService

    reader = LipReader(checkpoint=checkpoints["lipnet"], config=CFG, device="cpu")
    ours = AvsyncServer(
        TranscribeService(reader, max_batch=4, max_wait_ms=100.0),
        SyncScoreService(MisalignmentScorer(checkpoints["detector"], checkpoints["lipnet"],
                                            config=CFG, device="cpu"), max_batch=4),
        port=0)
    theirs = JaxServer(
        JaxTranscribeService(JaxLipReader(checkpoints["lipnet"], JAX_CFG), max_batch=4,
                             max_wait_ms=5.0),
        JaxSyncService(JaxScorer(checkpoints["detector"], checkpoints["lipnet"], JAX_CFG),
                       max_batch=4),
        port=0)
    ours.start()
    theirs.start()
    yield {"url": _url(ours), "jax_url": _url(theirs), "server": ours, "reader": reader}
    ours.shutdown(drain_timeout=5.0)
    theirs.shutdown(drain_timeout=5.0)


def test_healthz(servers):
    assert _get(servers["url"] + "/healthz") == {"status": "ok"}


@pytest.mark.parametrize("shape", [(8, 16, 32), (6, 40, 48)], ids=["crop", "native"])
def test_transcribe_npy_equals_the_jax_daemon(servers, shape):
    """Pre-cropped frames and native ones (the heuristic mouth crop)."""
    frames = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    got = _post(servers["url"] + "/v1/transcribe", _npy(frames), "application/x-npy")
    want = _post(servers["jax_url"] + "/v1/transcribe", _npy(frames), "application/x-npy")
    assert _no_latency(got) == _no_latency(want)
    assert got["transcript"] == servers["reader"].predict_frames(frames)
    assert got["latency_ms"] >= 0


def test_transcribe_by_path_equals_the_jax_daemon(servers, tmp_path):
    frames = np.random.default_rng(1).integers(0, 256, (8, 16, 32), np.uint8)
    path = str(tmp_path / "clip.npy")
    np.save(path, frames)
    body = json.dumps({"video_path": path}).encode()
    got = _post(servers["url"] + "/v1/transcribe", body, "application/json")
    want = _post(servers["jax_url"] + "/v1/transcribe", body, "application/json")
    assert _no_latency(got) == _no_latency(want)


def test_sync_score_npz_and_path_match_the_jax_daemon(servers, tmp_path):
    """npz {frames, audio, fps, shifts} and JSON {video_path, shifts} (the
    clip's sibling .wav): probabilities within 1e-5 of the JAX daemon's."""
    from avsync_torch.data.video import save_wav

    r = np.random.default_rng(3)
    frames = r.integers(0, 256, (8, 16, 32), np.uint8)
    audio = (np.sin(np.linspace(0, 200, 5000)) * 0.5).astype(np.float32)
    body = _npz(frames=frames, audio=audio, fps=25.0, shifts=np.array([-2, 0, 5]))
    clip = str(tmp_path / "clip.npy")
    np.save(clip, frames)
    save_wav(str(tmp_path / "clip.wav"), audio, 16000)
    path_body = json.dumps({"video_path": clip, "shifts": [0, 3]}).encode()
    for req, ctype in ((body, "application/x-npz"), (path_body, "application/json")):
        got = _post(servers["url"] + "/v1/sync_score", req, ctype)
        want = _post(servers["jax_url"] + "/v1/sync_score", req, ctype)
        assert set(got) == set(want) and got["shifts"] == want["shifts"]
        np.testing.assert_allclose(got["sync_probs"], want["sync_probs"], atol=1e-5)


def test_concurrent_clients_batch_on_the_server(servers):
    frames = np.random.default_rng(2).integers(0, 256, (8, 16, 32), np.uint8)
    direct = servers["reader"].predict_frames(frames)
    body = _npy(frames)
    results, errors = [], []

    def client():
        try:
            results.append(_post(servers["url"] + "/v1/transcribe", body,
                                 "application/x-npy")["transcript"])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and results == [direct] * 4
    stats = _get(servers["url"] + "/v1/stats")
    assert stats["transcribe"]["requests"] >= 4 and stats["transcribe"]["max_batch"] == 4
    assert any(int(k) > 1 for k in stats["transcribe"]["batches"])
    assert set(stats) == set(_get(servers["jax_url"] + "/v1/stats"))


def test_bad_request_is_400_and_unknown_path_404(servers):
    for url in (servers["url"], servers["jax_url"]):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/v1/transcribe", b"{}", "application/json")
        assert ei.value.code == 400 and "video_path" in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/v1/sync_score", _npz(frames=np.zeros(3)), "application/x-npz")
        assert ei.value.code == 400 and "audio" in json.loads(ei.value.read())["error"]
        for call in (lambda: _get(url + "/nope"), lambda: _post(url + "/nope", b"", "x/y")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                call()
            assert ei.value.code == 404


@pytest.mark.parametrize("size", [4096, 8 << 20], ids=["small", "past_socket_buffers"])
def test_oversized_body_rejected_413_before_read(servers, size):
    """A 4 KB and an 8 MB body against a small limit: 413 before the body
    is read, readable by the client (the bounded lingering drain), and the
    server answers afterwards."""
    srv = AvsyncServer(servers["server"].transcriber, None, port=0,
                       max_body_bytes=1024 if size == 4096 else 1 << 20)
    srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(_url(srv) + "/v1/transcribe", b"x" * size, "application/x-npy")
        assert ei.value.code == 413
        assert "limit" in json.loads(ei.value.read())["error"]
        assert _get(_url(srv) + "/healthz") == {"status": "ok"}
    finally:
        srv._httpd.shutdown()
        srv._httpd.server_close()


def test_malformed_content_length_rejected(servers):
    import http.client

    host, port = servers["server"].address
    conn = http.client.HTTPConnection(host, port, timeout=TIMEOUT)
    try:
        conn.putrequest("POST", "/v1/transcribe", skip_accept_encoding=True)
        conn.putheader("Content-Type", "application/x-npy")
        conn.putheader("Content-Length", "not-a-number")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400  # not 413: a client would split its payload for nothing
        assert "malformed" in json.loads(resp.read())["error"]
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------


class _SlowService:
    """A transcriber-shaped service whose inference takes `delay` seconds."""

    def __init__(self, delay: float):
        self.stats = ServingStats()
        self.delay = delay
        self.batcher = DynamicBatcher(self._infer, max_batch=8, max_wait_ms=50.0,
                                      stats=self.stats)

    def _infer(self, rows):
        time.sleep(self.delay)
        return [f"ok{i}" for i in range(rows.shape[0])]

    def transcribe_frames(self, frames, timeout=None):
        return self.batcher.infer(np.asarray(frames)[None], timeout=TIMEOUT)

    def close(self):
        self.batcher.close()


def _slow_server(delay):
    srv = AvsyncServer(_SlowService(delay), port=0)
    srv.start()
    return srv, _url(srv)


def _wait_inflight(srv, n):
    deadline = time.time() + 5.0
    while srv._inflight < n and time.time() < deadline:
        time.sleep(0.01)
    assert srv._inflight == n


def _post_zeros(url, out, errors=None):
    try:
        out.append(_post(url + "/v1/transcribe", _npy(np.zeros((8, 16, 32), np.uint8)),
                         "application/x-npy"))
    except Exception as e:  # noqa: BLE001 — asserted by the caller
        if errors is None:
            raise
        errors.append(e)


def test_many_clients_connecting_at_once_are_all_answered():
    """48 clients connect at the same moment: none overflows the listen
    backlog (socketserver's default of 5 reset some of them, and made others
    wait ~1 s for a second SYN)."""
    import http.client

    srv, _ = _slow_server(0.0)
    assert srv._httpd.request_queue_size >= 48
    n, codes = 48, []
    go = threading.Barrier(n)

    def client():
        go.wait(timeout=30)
        conn = http.client.HTTPConnection(*srv.address, timeout=TIMEOUT)
        try:
            conn.request("GET", "/healthz")
            codes.append(conn.getresponse().status)
        except OSError as e:
            codes.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert codes == [200] * n
    finally:
        srv.shutdown(drain_timeout=5.0)


def test_inflight_requests_complete_then_no_new_accepts():
    srv, url = _slow_server(1.0)
    results, errors = [], []
    threads = [threading.Thread(target=_post_zeros, args=(url, results, errors))
               for _ in range(4)]
    for t in threads:
        t.start()
    _wait_inflight(srv, 4)
    t0 = time.time()
    srv.shutdown(drain_timeout=30.0)
    drain_wall = time.time() - t0
    for t in threads:
        t.join(timeout=10.0)
    assert not errors, errors
    assert sorted(r["transcript"] for r in results) == [f"ok{i}" for i in range(4)]
    assert drain_wall >= 0.5  # it waited for the batch in flight
    with pytest.raises(urllib.error.URLError):
        _get(url + "/healthz")


def test_drain_timeout_bounds_shutdown():
    srv, url = _slow_server(4.0)
    t = threading.Thread(target=_post_zeros, args=(url, [], []))
    t.start()
    _wait_inflight(srv, 1)
    t0 = time.time()
    # the HTTP drain gives up after 0.2 s; the rest is the batcher's own
    # close, which joins the batch in flight (4 s), not a full 30 s drain
    srv.shutdown(drain_timeout=0.2)
    assert time.time() - t0 < 8.0
    t.join(timeout=15.0)
    assert not t.is_alive()


@pytest.mark.parametrize("what", ["post", "healthz", "large_unread_body"])
def test_draining_answers_503(what):
    """While draining, a kept-alive connection's new POST gets 503 (also
    with megabytes of body unread: flushed and drained, not reset), and
    /healthz reports {"status": "draining"} with 503."""
    import http.client

    srv, url = _slow_server(0.05)
    try:
        conn = http.client.HTTPConnection(*srv.address, timeout=TIMEOUT)
        conn.request("POST", "/v1/transcribe", _npy(np.zeros((8, 16, 32), np.uint8)),
                     {"Content-Type": "application/x-npy"})
        first = conn.getresponse()
        assert first.status == 200
        first.read()
        with srv._inflight_cv:
            srv._draining = True
        if what == "healthz":
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            assert resp.status == 503 and json.loads(resp.read()) == {"status": "draining"}
        else:
            shape = (64, 160, 320) if what == "large_unread_body" else (8, 16, 32)
            conn.request("POST", "/v1/transcribe", _npy(np.zeros(shape, np.uint8)),
                         {"Content-Type": "application/x-npy"})
            resp = conn.getresponse()
            assert resp.status == 503 and "draining" in json.loads(resp.read())["error"]
        conn.close()
    finally:
        with srv._inflight_cv:
            srv._draining = False
        srv.shutdown(drain_timeout=5.0)


def test_new_connections_refused_mid_drain():
    srv, url = _slow_server(1.5)
    ok: list = []
    t = threading.Thread(target=_post_zeros, args=(url, ok, []))
    t.start()
    _wait_inflight(srv, 1)
    down = threading.Thread(target=lambda: srv.shutdown(drain_timeout=30.0))
    t0 = time.time()
    down.start()
    while not srv._draining and time.time() - t0 < 5.0:
        time.sleep(0.01)
    t1 = time.time()
    with pytest.raises(urllib.error.URLError):
        _get(url + "/healthz")
    assert time.time() - t1 < 1.0  # refused at once, not after the batch in flight
    down.join(timeout=15.0)
    t.join(timeout=15.0)
    assert ok and ok[0]["transcript"] == "ok0"


# ---------------------------------------------------------------------------
# the serve command
# ---------------------------------------------------------------------------


def test_serve_parser_wiring_and_unported_flags(checkpoints):
    from avsync_torch.cli import build_parser, cmd_serve

    p = build_parser()
    args = p.parse_args(["serve", "--checkpoint", "x.pth", "--detector_checkpoint", "d.pth",
                         "--port", "0", "--warmup", "--max_batch", "8", "--transport", "f32",
                         "--max_body_mb", "4", "--device", "cpu"])
    assert args.func is cmd_serve and args.port == 0 and args.warmup and args.max_batch == 8
    assert args.transport == "f32" and args.max_body_mb == 4 and args.artifact is None
    base = ["serve", "--checkpoint", checkpoints["lipnet"], "--device", "cpu"]
    # --dp is ported: above the host's device count (one CPU) it exits naming it
    with pytest.raises(SystemExit, match="1 device"):
        cmd_serve(p.parse_args(base + ["--dp", "2"]))
    # int8 serving is ported (tests/test_torch_quant.py serves it): the flags
    # parse, and a scales file of another model family is refused at load,
    # before the daemon binds its port
    args = p.parse_args(base + ["--quantize", "int8", "--qscales", "q.npz"])
    assert args.quantize == "int8" and args.qscales == "q.npz"
    bad = str(checkpoints["root"] / "tf_scales.npz")
    np.savez(bad, input_scales=np.ones(3, np.float32), family="tf")
    with pytest.raises(ValueError, match="family"):
        cmd_serve(p.parse_args(base + ["--config", checkpoints["config"], "--quantize", "int8",
                                       "--qscales", bad]))
    with pytest.raises(SystemExit, match="--checkpoint"):
        cmd_serve(p.parse_args(["serve"]))


def test_serve_subprocess_answers_then_sigterm_drains(checkpoints):
    """`serve --port 0` prints the port the OS chose, answers, and exits 0
    on SIGTERM through the graceful drain."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "avsync_torch.cli", "serve", "--checkpoint",
         checkpoints["lipnet"], "--detector_checkpoint", checkpoints["detector"], "--config",
         checkpoints["config"], "--device", "cpu", "--port", "0", "--warmup", "--max_batch",
         "2"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url, lines = None, []
        deadline = time.time() + 120
        while url is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if " on http://" in line:
                url = line.split(" on ")[1].split()[0]
        assert url and not url.endswith(":0"), lines
        frames = np.random.default_rng(5).integers(0, 256, (8, 16, 32), np.uint8)
        from avsync_torch.predictor import LipReader

        want = LipReader(checkpoint=checkpoints["lipnet"], config=CFG,
                         device="cpu").predict_frames(frames)
        assert _post(url + "/v1/transcribe", _npy(frames), "application/x-npy")[
            "transcript"] == want
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "shutting down" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
            proc.stdout.close()
