"""The port's libav ingest (`avsync_torch/ingest`) and the container routes
of `avsync_torch/data/video.py`, against the JAX package's
(`avsync.ingest.native`, `avsync.data.video`) on the same files: a cv2 MJPG
`.avi` (as tests/test_ingest.py writes it) and an `.mp4` with AAC audio
through the port's own `mux_mp4`. Same source, same libav: frames and audio
equal bit for bit, fps equal."""

import os
import sys
import warnings

import numpy as np
import pytest

from avsync.data import video as jax_video
from avsync.ingest import native as jax_native
from avsync_torch.data import video
from avsync_torch.ingest import native

T, H, W, SR = 12, 48, 64, 16000


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("torch_ingest")
    rng = np.random.default_rng(0)
    base = rng.random((H, W)).astype(np.float32)
    frames = np.stack([np.clip(base * 150 + t * 5, 0, 255).astype(np.uint8) for t in range(T)])
    avi = str(root / "clip.avi")
    vw = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (W, H))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    vw.release()
    mp4 = str(root / "clip.mp4")
    audio = (0.3 * np.sin(np.arange(T * SR // 25) * 0.05)).astype(np.float32)
    native.mux_mp4(mp4, np.repeat(frames[..., None], 3, axis=-1), 25.0, audio, SR)
    return {"avi": avi, "mp4": mp4, "frames": frames, "root": root}


def _equal(got, want):
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.uint8
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].dtype == want[2].dtype == np.float32
    assert got[3] == want[3]


def test_the_library_builds_outside_the_package():
    assert native.available() and native.why_unavailable() is None
    info = native.build_info()
    assert info["libavformat"].count(".") == 2 and info["seconds"] >= 0.0
    built = list(native.BUILD_DIR.glob("libavsingest-*.so"))
    assert built and native.BUILD_DIR.parts[-2:] == ("build", "avsync_torch_ingest")
    assert not list(native.SOURCE.parent.glob("*.so"))


@pytest.mark.parametrize("kind", ["avi", "mp4"])
@pytest.mark.parametrize("max_frames,target_sr", [(0, 0), (5, 8000)])
def test_decode_equals_the_jax_ingest(clips, kind, max_frames, target_sr):
    got = native.decode(clips[kind], max_frames, target_sr)
    _equal(got, jax_native.decode(clips[kind], max_frames, target_sr))
    assert got[0].shape == ((max_frames or T), H, W) and got[1] == 25.0
    if kind == "mp4":
        assert got[3] == (target_sr or SR) and got[2].size > 0
        assert np.abs(got[0].astype(int) - clips["frames"].astype(int)[:len(got[0])]).mean() < 4


def test_decode_batch_and_its_empty_row_equal_the_jax_ingest(clips):
    paths = [clips["mp4"], str(clips["root"] / "missing.mp4"), clips["avi"]]
    got = native.decode_batch(paths, max_frames=8, target_sr=8000, n_threads=2)
    want = jax_native.decode_batch(paths, max_frames=8, target_sr=8000, n_threads=2)
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[1][0].shape == (0, 0, 0) and got[1][1:] == (0.0, got[1][2], 0)


def test_decode_batch_roi_equals_the_jax_ingest(clips):
    paths = [clips["avi"], clips["mp4"]]
    crop, out_hw = (0.5, 1.0, 0.25, 0.75), (12, 20)
    got = native.decode_batch_roi(paths, crop, out_hw, max_frames=6)
    for g, w in zip(got, jax_native.decode_batch_roi(paths, crop, out_hw, max_frames=6)):
        _equal(g, w)
        assert g[0].shape == (6, 12, 20)


@pytest.mark.parametrize("kind", ["avi", "mp4"])
def test_fps_and_audio_equal_the_jax_ingest(clips, kind):
    assert native.get_fps(clips[kind]) == jax_native.get_fps(clips[kind]) == 25.0
    for sr in (0, 22050):
        got, want = native.decode_audio(clips[kind], sr), jax_native.decode_audio(clips[kind], sr)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    np.testing.assert_array_equal(native.decode_video_gray(clips[kind], 3),
                                  jax_native.decode_video_gray(clips[kind], 3))


def test_a_missing_file_raises(clips):
    with pytest.raises(RuntimeError, match="missing.mpg"):
        native.decode(str(clips["root"] / "missing.mpg"))
    with pytest.raises(RuntimeError):
        video.decode_video_gray(str(clips["root"] / "missing.mpg"))
    with pytest.raises(ValueError, match="BGR"):
        native.mux_mp4(str(clips["root"] / "x.mp4"), np.zeros((2, 8, 8), np.uint8), 25.0)


@pytest.mark.parametrize("kind", ["avi", "mp4"])
def test_container_routes_equal_the_jax_package(clips, kind):
    path = clips[kind]
    np.testing.assert_array_equal(video.decode_video_gray(path),
                                  jax_video.decode_video_gray(path))
    np.testing.assert_array_equal(video.decode_video_gray(path, 4),
                                  jax_video.decode_video_gray(path, 4))
    assert video.get_video_fps(path) == jax_video.get_video_fps(path) == 25.0


def test_npy_route_equals_the_jax_package(tmp_path):
    r = np.random.default_rng(1)
    for name, arr in (("u8", r.integers(0, 256, (6, 10, 12), dtype=np.uint8)),
                      ("unit", r.random((6, 10, 12)).astype(np.float32)),
                      ("f255", (r.random((6, 10, 12)) * 300).astype(np.float32))):
        p = str(tmp_path / f"{name}.npy")
        np.save(p, arr)
        got = video.decode_video_gray(p, 4)
        np.testing.assert_array_equal(got, jax_video.decode_video_gray(p, 4))
        assert got.dtype == np.uint8 and got.shape == (4, 10, 12)
        assert video.get_video_fps(p, 30.0) == jax_video.get_video_fps(p, 30.0) == 30.0


def test_audio_routes_wav_then_container_then_silence(clips, tmp_path):
    # the container's own stream
    got, want = video.load_audio_for_video(clips["mp4"]), jax_video.load_audio_for_video(
        clips["mp4"])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == SR and got[0].size > 0
    # a sibling .wav comes first
    mp4 = str(tmp_path / "clip.mp4")
    with open(clips["mp4"], "rb") as src, open(mp4, "wb") as dst:
        dst.write(src.read())
    video.save_wav(str(tmp_path / "clip.wav"), np.full(800, 0.25, np.float32), 8000)
    got = video.load_audio_for_video(mp4)
    assert got[1] == 8000 and got[0].shape == (800,)
    np.testing.assert_array_equal(got[0], jax_video.load_audio_for_video(mp4)[0])
    # a .npy clip without a .wav, and a video-only container: silence, warned
    np.save(tmp_path / "c.npy", np.zeros((2, 4, 4), np.uint8))
    with pytest.warns(UserWarning, match="returning silence"):
        audio, sr = video.load_audio_for_video(str(tmp_path / "c.npy"), 16000)
    assert audio.size == 0 and sr == 16000
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = video.load_audio_for_video(clips["avi"], 16000)
        want = jax_video.load_audio_for_video(clips["avi"], 16000)
    assert got[0].size == want[0].size and got[1] == want[1]


def test_decode_av_resamples_a_container_s_audio(clips):
    from avsync_torch.config import AudioConfig, AvsyncConfig, DataConfig

    cfg = AvsyncConfig(data=DataConfig(max_video_length=10), audio=AudioConfig(sample_rate=8000))
    frames, audio, fps = video.decode_av(clips["mp4"], cfg)
    assert frames.shape == (10, H, W) and fps == 25.0
    full, sr = native.decode_audio(clips["mp4"])
    assert sr == SR and abs(audio.size - full.size // 2) <= 2


def test_a_failed_build_keeps_its_reason_and_cv2_takes_over(clips, monkeypatch):
    """Where the library cannot be built, `available()` is False and
    `why_unavailable()` holds pkg-config's message; containers then decode
    through cv2 (within the bound tests/test_ingest.py holds cv2 to), and
    without cv2 they raise naming both."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_why", None)
    monkeypatch.setattr(native, "PKGS", native.PKGS + ("libavsync-absent",))
    assert not native.available()
    assert "libavsync-absent" in native.why_unavailable()
    assert native.build_info() == {}
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode(clips["avi"])
    via_cv2 = video.decode_video_gray(clips["avi"])
    ref = jax_native.decode(clips["avi"])[0]
    assert via_cv2.shape == ref.shape
    assert np.abs(via_cv2.astype(int) - ref.astype(int)).max() <= 2
    assert video.get_video_fps(clips["avi"]) == pytest.approx(25.0)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="(?s)native ingest is unavailable.*cv2 does not import"):
        video.decode_video_gray(clips["avi"])
    assert os.path.exists(clips["avi"])
