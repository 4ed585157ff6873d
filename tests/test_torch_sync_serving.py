"""The detector's serving path on the CPU: the port's MisalignmentScorer
against the JAX package's on the same tiny checkpoints (a reference LipNet
`.pth` and a detector `.pth`, both written by `avsync.compat`), and the
port's SyncScoreService under concurrent requests.

Tolerance: sync probabilities within atol 1e-5 of the JAX scorer's (fp32
conv stack, MFCC and detector in two frameworks); the service's answers
within atol 1e-6 of the scorer's for the same request (the same function at
another batch size).
"""

import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from avsync import compat as jcompat
from avsync.config import AudioConfig as JaxAudioConfig
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.models import LipNet as JaxLipNet
from avsync.models import MisalignmentDetector as JaxDetector
from avsync.predictor import MisalignmentScorer as JaxScorer
from avsync_torch.config import AudioConfig, AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.data.video import save_wav
from avsync_torch.ops.cuda import convpool, mfcc
from avsync_torch.predictor import MisalignmentScorer
from avsync_torch.serving import SyncScoreService

TINY = dict(hidden_dim=4, conv_channels=(2, 2, 3))
CONV_SHAPE = (3, 2, 4)
DATA = dict(img_height=16, img_width=32, max_video_length=8)
S = 4000
SHIFTS = (-3, 0, 4)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("sync_serving")
    lip = JaxLipNet(JaxModelConfig(**TINY)).init({"params": jax.random.PRNGKey(4)},
                                                jnp.zeros((1, 8, 16, 32, 1)))["params"]
    lip = jax.tree.map(np.asarray, lip)
    dim = 2 * 24 + 40
    det = JaxDetector(hidden_dim=16).init({"params": jax.random.PRNGKey(5)},
                                          jnp.zeros((1, dim)))["params"]
    det = jax.tree.map(np.asarray, det)
    lip_path, det_path = str(d / "lipnet.pth"), str(d / "detector.pth")
    jcompat.save_lipnet_pth(lip, lip_path, conv_shape=CONV_SHAPE)
    jcompat.save_detector_pth(det, det_path, dim, 16, {"n_mfcc": 20}, conv_shape=CONV_SHAPE)
    return lip_path, det_path, lip, det


def _cfgs():
    jcfg = JaxConfig(data=JaxDataConfig(**DATA), model=JaxModelConfig(**TINY),
                     audio=JaxAudioConfig(max_audio_samples=S))
    cfg = AvsyncConfig(data=DataConfig(**DATA),
                       model=ModelConfig(fused_conv_pool=True, **TINY),
                       audio=AudioConfig(max_audio_samples=S, use_pallas=True))
    return jcfg, cfg


@pytest.fixture(scope="module")
def scorer(ckpts):
    return MisalignmentScorer(ckpts[1], ckpts[0], config=_cfgs()[1], device="cpu")


def _request(i, rng):
    shape = (8, 40, 48) if i % 2 else (6, 16, 32)  # native frames (heuristic crop) or crops
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    n = (0, 1500, 3000, 5000)[i % 4]  # empty, partial, longer than max_audio_samples
    audio = (0.3 * rng.standard_normal(n)).astype(np.float32)
    return frames, audio, (25.0, 29.97)[i % 2]


def test_score_arrays_matches_the_jax_scorer(ckpts, scorer):
    jscorer = JaxScorer(ckpts[1], ckpts[0], config=_cfgs()[0])
    rng = np.random.default_rng(0)
    for i in range(4):
        frames, audio, fps = _request(i, rng)
        want = np.asarray(jscorer.score_arrays(frames, audio, fps, SHIFTS))
        got = scorer.score_arrays(frames, audio, fps, SHIFTS)
        assert got.shape == (3,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_score_reads_npy_and_sibling_wav_like_the_jax_scorer(ckpts, scorer, tmp_path):
    rng = np.random.default_rng(1)
    np.save(tmp_path / "clip.npy", rng.integers(0, 256, (8, 16, 32), dtype=np.uint8))
    save_wav(str(tmp_path / "clip.wav"), 0.4 * np.sin(np.arange(3200) / 9.0), 16000)
    jscorer = JaxScorer(ckpts[1], ckpts[0], config=_cfgs()[0])
    path = str(tmp_path / "clip.npy")
    for shift in (0, 5):
        assert scorer.score(path, shift) == pytest.approx(jscorer.score(path, shift), abs=1e-5)


def test_scorer_from_jax_params_equals_scorer_from_checkpoints(ckpts, scorer):
    lip_path, det_path, lip, det = ckpts
    bridged = MisalignmentScorer(config=_cfgs()[1], device="cpu", detector_params=det,
                                 lipnet_params=lip)
    frames, audio, fps = _request(2, np.random.default_rng(2))
    np.testing.assert_array_equal(bridged.score_arrays(frames, audio, fps, SHIFTS),
                                  scorer.score_arrays(frames, audio, fps, SHIFTS))
    with pytest.raises(ValueError, match="exactly one"):
        MisalignmentScorer(det_path, config=_cfgs()[1], device="cpu", detector_params=det,
                           lipnet_params=lip)


def test_service_answers_concurrent_requests_as_the_scorer(scorer):
    """12 requests from 6 threads, two frame geometries, audio lengths from 0
    to past the buffer; the batcher pads rows with audio length 0."""
    rng = np.random.default_rng(3)
    reqs = [_request(i, rng) for i in range(12)]
    svc = SyncScoreService(scorer, max_batch=4, max_wait_ms=20.0)
    answers = {}

    def client(t):
        for i in range(t, 12, 6):
            answers[i] = svc.score_arrays(*reqs[i], shifts=SHIFTS, timeout=60)

    k1, k5 = convpool.launches, mfcc.launches
    try:
        svc.warmup(SHIFTS)
        threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.close()
    assert (convpool.launches, mfcc.launches) == (k1, k5)  # CPU: the plain versions
    for i, r in enumerate(reqs):
        np.testing.assert_allclose(answers[i], scorer.score_arrays(*r, SHIFTS), atol=1e-6)
    snap = svc.stats.snapshot()
    assert snap["requests"] == 12 and snap["errors"] == 0 and set(snap["batches"]) <= {1, 2, 4}


def test_padded_rows_give_finite_probabilities(scorer):
    """A batch with rows of zeros (what the batcher pads with): audio
    length 0 and fps 0."""
    frames, audio, fps = _request(1, np.random.default_rng(4))
    row = scorer.prepare_raw(frames, audio, fps, SHIFTS)
    batch = tuple(np.concatenate([p, np.zeros_like(p)], axis=0) for p in row)
    out = scorer.score_payload_batch(batch)
    assert len(out) == 2 and all(np.isfinite(o).all() and o.shape == (3,) for o in out)


def test_score_path_reads_a_npy_clip(scorer, tmp_path):
    rng = np.random.default_rng(5)
    np.save(tmp_path / "c.npy", rng.integers(0, 256, (8, 16, 32), dtype=np.uint8))
    svc = SyncScoreService(scorer, max_batch=2, max_wait_ms=1.0)
    try:
        with pytest.warns(UserWarning, match="silence"):
            got = svc.score_path(str(tmp_path / "c.npy"), shifts=(0, 2))
    finally:
        svc.close()
    assert got.shape == (2,) and np.isfinite(got).all()
