"""The port's demo export (`avsync_torch.demo`) and `misalign-demo` command
against the JAX package's, on the CPU.

cv2's `putText` and its writers may differ between versions, so the frames
are compared with the JAX function's in this process, never with stored
bytes. `misalign-demo` runs through both command lines on one synthetic
corpus with the same `.pth` files and seed: the same speakers, clips and
shifts, scores within 1e-5 (the sync-serving bound), the same file names.
"""

import dataclasses
import os
import wave

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import avsync.demo as jdemo
from avsync import compat as jcompat
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import synthetic
from avsync.models import LipNet as JaxLipNet
from avsync_torch import demo
from avsync_torch.cli import main
from avsync_torch.compat import save_detector_pth
from avsync_torch.config import AudioConfig, AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.ops.audio_ref import shift_audio

TINY = dict(hidden_dim=4, conv_channels=(2, 2, 3))
SR = 16000


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("shape", [(4, 16, 32), (3, 20, 40, 3)], ids=["gray", "bgr"])
@pytest.mark.parametrize("scale", [1, 2])
def test_annotate_frames_equals_the_jax_function(shape, scale):
    frames = _frames(shape)
    text = "misaligned (shift -3) score=0.125"
    got = demo.annotate_frames(frames, text, scale)
    want = jdemo.annotate_frames(frames, text, scale)
    assert got.shape == (shape[0], shape[1] * scale, shape[2] * scale, 3)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, demo.annotate_frames(frames, "", scale))  # text drawn


def _count_frames(path):
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def _pcm16(path):
    with wave.open(path, "rb") as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _as_pcm16(y):
    return (np.clip(np.asarray(y, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")


@pytest.mark.parametrize("shift", [3, -2])
def test_export_demo_without_the_native_ingest(tmp_path, monkeypatch, shift):
    """The cv2 path (no native ingest): two videos of the clip's frame count
    and two `.wav` files, the misaligned one `shift_audio` of the clip's;
    the same names and audio as the JAX function's."""
    monkeypatch.setattr("avsync_torch.ingest.native.available", lambda: False)
    monkeypatch.setattr("avsync.ingest.native.available", lambda: False)
    frames = _frames((10, 16, 32), 1)
    audio = (np.random.default_rng(2).normal(0, 0.2, SR // 2)).astype(np.float32)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    p = demo.export_demo(frames, audio, SR, 25.0, shift, 0.9, 0.1, ours, scale=2)
    q = jdemo.export_demo(frames, audio, SR, 25.0, shift, 0.9, 0.1, theirs, scale=2)
    assert [os.path.basename(x) for x in p] == [os.path.basename(x) for x in q]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == sorted(
        [os.path.basename(p[0]), os.path.basename(p[1]), "aligned_demo.wav",
         "misaligned_demo.wav"])
    for path in p:
        assert _count_frames(path) == len(frames)
    for name, want in (("aligned_demo.wav", audio),
                       ("misaligned_demo.wav", shift_audio(audio, shift, 25.0, SR))):
        sr, got = _pcm16(os.path.join(ours, name))
        assert sr == SR
        np.testing.assert_array_equal(got, _as_pcm16(want))
        np.testing.assert_array_equal(got, _pcm16(os.path.join(theirs, name))[1])


def test_export_demo_muxes_through_the_native_ingest(tmp_path):
    """With the native ingest built: one `.mp4` per copy with the clip's
    frame count and its audio track, no `.wav` beside."""
    from avsync_torch.ingest import native

    assert native.available(), native.why_unavailable()
    frames = _frames((10, 16, 32), 3)
    audio = (np.random.default_rng(4).normal(0, 0.2, SR // 2)).astype(np.float32)
    p = demo.export_demo(frames, audio, SR, 25.0, 4, 0.8, 0.3, str(tmp_path))
    assert [os.path.basename(x) for x in p] == ["aligned_demo.mp4", "misaligned_demo.mp4"]
    assert sorted(os.listdir(tmp_path)) == ["aligned_demo.mp4", "misaligned_demo.mp4"]
    for path in p:
        assert native.decode_video_gray(path).shape[0] == len(frames)
        a, sr = native.decode_audio(path)
        assert sr == SR and abs(len(a) - len(audio)) <= 2048  # AAC frames pad the tail


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo_cli")
    root = str(d / "grid")
    synthetic.write_corpus(root, n_speakers=3, clips_per_speaker=3, n_frames=8, height=16,
                           width=32, seed=5)
    params = JaxLipNet(JaxModelConfig(**TINY)).init({"params": jax.random.PRNGKey(8)},
                                                   jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(8)
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.3, np.shape(p))).astype(
        np.float32), params)
    lip = str(d / "lipnet.pth")
    jcompat.save_lipnet_pth(params, lip, conv_shape=(3, 2, 4))
    from avsync_torch.models.detector import MisalignmentDetector

    det = MisalignmentDetector(88, 8, generator=torch.Generator().manual_seed(3))
    det_path = str(d / "detector.pth")
    save_detector_pth(det.state_dict(), det_path, 88, 8, {"sample_rate": SR, "n_mfcc": 20})
    cfg = AvsyncConfig(
        data=DataConfig(img_height=16, img_width=32, max_video_length=8, batch_size=4),
        model=ModelConfig(fused_conv_pool=True, **TINY),
        audio=AudioConfig(max_audio_samples=4000, use_pallas=True), train=TrainConfig(seed=1))
    port_cfg, jax_cfg = str(d / "port.json"), str(d / "jax.json")
    open(port_cfg, "w").write(cfg.to_json())
    # the JAX command takes its kernels' XLA path (Pallas needs a TPU or interpret mode)
    open(jax_cfg, "w").write(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, fused_conv_pool=False),
        audio=dataclasses.replace(cfg.audio, use_pallas=False)).to_json())
    return d, root, lip, det_path, port_cfg, jax_cfg


def _recorded(monkeypatch, target):
    """Wrap `target`'s export_demo: each call's (out_dir, shift, scores)."""
    calls = []
    real = getattr(target, "export_demo")

    def export_demo(frames, audio, sr, fps, shift, s_aligned, s_mis, out_dir, scale=1):
        calls.append((os.path.basename(out_dir), len(frames), shift, s_aligned, s_mis))
        return real(frames, audio, sr, fps, shift, s_aligned, s_mis, out_dir, scale=scale)

    monkeypatch.setattr(target, "export_demo", export_demo)
    return calls


def _speaker_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("s") and "shift=" in ln]


@pytest.mark.parametrize("seed", [0, 11])
def test_misalign_demo_through_both_clis(corpus, tmp_path, monkeypatch, capsys, seed):
    from avsync.cli import main as jax_main

    d, root, lip, det, port_cfg, jax_cfg = corpus
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    common = ["--data_path", root, "--checkpoint", lip, "--detector_checkpoint", det,
              "--seed", str(seed), "--min_shift", "1", "--max_shift", "6", "--scale", "2"]
    calls = _recorded(monkeypatch, demo)
    assert main(["misalign-demo", *common, "--config", port_cfg, "--output_dir", ours,
                 "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    jcalls = _recorded(monkeypatch, jdemo)
    assert jax_main(["misalign-demo", *common, "--config", jax_cfg, "--output_dir",
                     theirs]) == 0
    jax_out = capsys.readouterr().out
    assert "failed" not in port_out and "failed" not in jax_out
    assert len(calls) == len(jcalls) == 3
    for (sp, n, shift, a, m), (jsp, jn, jshift, ja, jm) in zip(calls, jcalls):
        assert (sp, n, shift) == (jsp, jn, jshift) and n == 8 and 1 <= abs(shift) <= 6
        assert abs(a - ja) <= 1e-5 and abs(m - jm) <= 1e-5
    # the same clips (named in the printed lines) and the same files
    def clip_and_shift(line):
        return line.split(" aligned=")[0]

    assert [clip_and_shift(x) for x in _speaker_lines(port_out)] == [
        clip_and_shift(x) for x in _speaker_lines(jax_out)]
    for sp in ("s1", "s2", "s3"):
        assert sorted(os.listdir(os.path.join(ours, sp))) == sorted(
            os.listdir(os.path.join(theirs, sp)))
        for name in os.listdir(os.path.join(ours, sp)):
            if name.endswith(".mp4"):
                from avsync_torch.ingest import native

                assert native.decode_video_gray(os.path.join(ours, sp, name)).shape[0] == 8


def test_misalign_demo_reports_a_failed_speaker_and_goes_on(corpus, tmp_path, monkeypatch,
                                                            capsys):
    d, root, lip, det, port_cfg, _ = corpus
    real = demo.export_demo

    def flaky(frames, audio, sr, fps, shift, a, m, out_dir, scale=1):
        if out_dir.endswith("s2"):
            raise RuntimeError("disk full")
        return real(frames, audio, sr, fps, shift, a, m, out_dir, scale=scale)

    monkeypatch.setattr(demo, "export_demo", flaky)
    assert main(["misalign-demo", "--data_path", root, "--checkpoint", lip,
                 "--detector_checkpoint", det, "--config", port_cfg, "--seed", "3",
                 "--output_dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "s2: demo generation failed: disk full" in out
    assert len(_speaker_lines(out)) == 2 and sorted(os.listdir(tmp_path)) == ["s1", "s3"]
