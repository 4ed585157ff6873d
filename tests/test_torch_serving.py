"""The slice end to end on the CPU: the port's LipReader and TranscribeService
against the JAX package's LipReader on the same reference `.pth`, and the
port's own copy of the dynamic batcher."""

import threading
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync.compat import save_lipnet_pth
from avsync.config import (AvsyncConfig as JaxConfig, DataConfig as JaxDataConfig,
                           ModelConfig as JaxModelConfig)
from avsync.models import LipNet as JaxLipNet
from avsync.predictor import LipReader as JaxLipReader
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.predictor import LipReader
from avsync_torch.serving import DynamicBatcher, ServingStats, TranscribeService, _bucket


def _save_params(cfg, shape, path, conv_shape, seed):
    params = JaxLipNet(cfg).init({"params": jax.random.PRNGKey(seed)},
                                 jnp.zeros(shape, jnp.float32))["params"]
    r = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: (np.asarray(p) + r.normal(0.0, 0.02, np.shape(p))).astype(np.float32),
        params)
    save_lipnet_pth(params, path, conv_shape=conv_shape)
    return params


@pytest.fixture(scope="module")
def full_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_serving") / "lipnet.pth")
    _save_params(JaxModelConfig(), (1, 15, 50, 100, 1), path, (96, 6, 12), seed=0)
    return path


TINY = AvsyncConfig(data=DataConfig(img_height=16, img_width=32, max_video_length=8),
                    model=ModelConfig(hidden_dim=8, conv_channels=(2, 3, 4),
                                      use_pallas_gru=True, fused_conv_pool=True))


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_serving_tiny") / "lipnet.pth")
    params = _save_params(JaxModelConfig(hidden_dim=8, conv_channels=(2, 3, 4)),
                          (1, 8, 16, 32, 1), path, (4, 2, 4), seed=1)
    return path, params


@pytest.fixture(scope="module")
def tiny_reader(tiny_ckpt):
    return LipReader(checkpoint=tiny_ckpt[0], config=TINY, device="cpu")


def test_reader_from_jax_params_equals_reader_from_checkpoint(tiny_ckpt, tiny_reader):
    """params= takes the JAX package's nested param dict through the bridge."""
    reader = LipReader(params=tiny_ckpt[1], config=TINY, device="cpu")
    x = tiny_reader.preprocess_device(
        np.random.default_rng(8).integers(0, 256, (2, 8, 16, 32), dtype=np.uint8))
    torch.testing.assert_close(reader._logprobs(x), tiny_reader._logprobs(x), rtol=0, atol=0)


def test_cli_infer_on_cpu(tiny_ckpt, tiny_reader, tmp_path, capsys):
    from avsync_torch.cli import main

    clip = np.random.default_rng(9).integers(0, 256, (8, 16, 32), dtype=np.uint8)
    np.save(tmp_path / "clip.npy", clip)
    (tmp_path / "clip.align").write_text("0 1 sil\n1 2 bin\n2 3 blue\n")
    (tmp_path / "cfg.json").write_text(TINY.to_json())
    assert main(["infer", str(tmp_path / "clip.npy"), "--checkpoint", tiny_ckpt[0],
                 "--config", str(tmp_path / "cfg.json"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"Predicted: {tiny_reader.predict_frames(clip)}\n" in out
    assert "Ground truth: bin blue" in out


def test_predict_batch_matches_the_jax_reader(full_ckpt, tmp_path):
    """Native 120x160 uint8 frames (heuristic crop) and a pre-cropped clip,
    max_video_length=15: same transcripts, log-probs within 5e-5."""
    r = np.random.default_rng(3)
    clips = [r.integers(0, 256, (12, 120, 160), dtype=np.uint8),
             r.integers(0, 256, (15, 120, 160), dtype=np.uint8)]
    paths = []
    for i, c in enumerate(clips):
        paths.append(str(tmp_path / f"clip{i}.npy"))
        np.save(paths[-1], c)
    jreader = JaxLipReader(full_ckpt, config=JaxConfig(data=JaxDataConfig(max_video_length=15)))
    reader = LipReader(checkpoint=full_ckpt,
                       config=AvsyncConfig(data=DataConfig(max_video_length=15)), device="cpu")
    assert reader.predict_batch(paths) == jreader.predict_batch(paths)

    rows = np.concatenate([reader.prepare_raw(c)[0] for c in clips])
    ref = np.asarray(jreader._logprobs(jreader.preprocess_device(rows)))
    got = reader._logprobs(reader.preprocess_device(rows)).numpy()
    assert got.shape == (2, 15, 39)
    np.testing.assert_allclose(got, ref, atol=5e-5)

    crop = r.integers(0, 256, (15, 50, 100), dtype=np.uint8)
    assert reader.predict_frames(crop) == jreader.predict_frames(crop)


@pytest.mark.parametrize("transport", ["raw", "f32"])
def test_service_answers_concurrent_requests(tiny_reader, transport):
    """16 requests from 8 threads, native and pre-cropped frames mixed; each
    answer equals predict_frames for its own clip."""
    r = np.random.default_rng(4)
    clips = [r.integers(0, 256, (8, 40, 48) if i % 2 else (6, 16, 32), dtype=np.uint8)
             for i in range(16)]
    svc = TranscribeService(tiny_reader, max_batch=4, max_wait_ms=20.0, transport=transport)
    answers = {}

    def client(t):
        for i in range(t, 16, 8):
            answers[i] = svc.transcribe_frames(clips[i], timeout=60)

    try:
        svc.warmup()
        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.close()
    assert answers == {i: tiny_reader.predict_frames(c) for i, c in enumerate(clips)}
    snap = svc.stats.snapshot()
    assert snap["requests"] == 16 and snap["errors"] == 0
    assert set(snap["batches"]) <= {1, 2, 4}


def test_predict_reads_float_npy_as_uint8(tiny_reader, tmp_path):
    """A [0, 1] float .npy clip is rescaled to uint8 0..255, as the JAX package does."""
    clip = np.random.default_rng(6).random((5, 16, 32)).astype(np.float32)
    path = str(tmp_path / "c.npy")
    np.save(path, clip)
    as_u8 = np.clip(clip * 255.0, 0, 255).astype(np.uint8)
    assert tiny_reader.predict(path) == tiny_reader.predict_frames(as_u8)


# ---------------------------------------------------------------------------
# the batcher copy (cases of tests/test_serving.py that hold without JAX)
# ---------------------------------------------------------------------------


def test_bucket_sizes():
    assert [_bucket(n, 8) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    assert _bucket(5, 6) == 6
    assert _bucket(3, 3) == 3


def test_pads_to_power_of_two_buckets():
    sizes = []

    def infer(rows):
        sizes.append(rows.shape[0])
        return list(range(rows.shape[0]))

    b = DynamicBatcher(infer, max_batch=8, max_wait_ms=150.0)
    try:
        for f in [b.submit(np.zeros((1, 2))) for _ in range(3)]:
            f.result(timeout=10.0)
        assert all(s in (1, 2, 4, 8) for s in sizes), sizes
    finally:
        b.close()


def test_close_drains_queued_requests():
    def infer(rows):
        time.sleep(0.02)
        return (rows[:, 0] * 2).tolist()

    b = DynamicBatcher(infer, max_batch=2, max_wait_ms=1.0)
    futs = [b.submit(np.array([[float(i)]])) for i in range(7)]
    b.close()
    assert [f.result(timeout=10.0) for f in futs] == [2.0 * i for i in range(7)]


def test_submit_after_close_raises():
    b = DynamicBatcher(lambda rows: rows[:, 0].tolist(), max_batch=2, max_wait_ms=1.0)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((1, 1)))


def test_concurrent_requests_coalesce_and_route():
    seen = []

    def infer(rows):
        seen.append(rows.shape[0])
        time.sleep(0.01)
        return (rows[:, 0] * 10).tolist()

    b = DynamicBatcher(infer, max_batch=8, max_wait_ms=200.0)
    results = {}

    def client(i):
        results[i] = b.infer(np.array([[float(i)]]), timeout=10.0)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert results == {i: pytest.approx(10.0 * i) for i in range(6)}
        assert max(seen) > 1 and b.stats.requests == 6
    finally:
        b.close()


def test_error_fans_out_and_batcher_survives():
    calls = {"n": 0}

    def infer(rows):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return rows[:, 0].tolist()

    b = DynamicBatcher(infer, max_batch=4, max_wait_ms=5.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.infer(np.array([[1.0]]), timeout=10.0)
        assert b.stats.errors == 1
        assert b.infer(np.array([[7.0]]), timeout=10.0) == 7.0
    finally:
        b.close()


def test_mixed_geometry_and_dtype_split_into_groups():
    seen = []

    def infer(rows):
        seen.append((rows.shape[1:], rows.dtype))
        return [float(rows.shape[1])] * rows.shape[0]

    b = DynamicBatcher(infer, max_batch=8, max_wait_ms=200.0)
    try:
        futs = [b.submit(np.zeros((1, w), dt)) for w, dt in
                ((3, np.uint8), (5, np.uint8), (3, np.float32), (5, np.uint8))]
        assert [f.result(timeout=10.0) for f in futs] == [3, 5, 3, 5]
        assert all(dt in (np.uint8, np.float32) for _, dt in seen)
    finally:
        b.close()


def test_warm_buckets_run_on_the_worker_thread():
    """Warm-up runs where inference runs (per-thread cuBLAS/cuDNN handles);
    an error in it reaches the caller and the worker survives."""
    seen = []
    b = DynamicBatcher(lambda rows: rows[:, 0].tolist(), max_batch=6, max_wait_ms=1.0)
    try:
        b.warm_buckets(lambda n: seen.append((n, threading.current_thread().name)))
        assert seen == [(n, "avsync-torch-batcher") for n in (1, 2, 4, 6)]
        with pytest.raises(ZeroDivisionError):
            b.call_on_worker(lambda: 1 / 0, timeout=10.0)
        assert b.infer(np.array([[3.0]]), timeout=10.0) == 3.0
        assert b.stats.requests == 1  # warm-up batches are not requests
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.call_on_worker(lambda: None)


def test_stats_snapshot_shape():
    s = ServingStats()
    s.record_batch(2, 4, [0.010, 0.020])
    s.record_error()
    snap = s.snapshot()
    assert snap["requests"] == 2 and snap["errors"] == 1
    assert snap["batches"] == {4: 1}
    assert snap["latency_ms"]["p50"] >= 10.0
