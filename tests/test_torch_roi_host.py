"""`DataConfig.roi_host` in the port: native-size frames are cropped on the
host by the ROI program and the crops rounded to uint8, as the JAX batcher
does (avsync/data/pipeline.py:239-280), in streamed and cached epochs;
pre-cropped clips (no crop in either package) and serving (the JAX
predictor never reads the flag) are unchanged. The configs come from the
JAX package's JSON.
"""

import dataclasses

import numpy as np
import pytest
import torch

from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.data import synthetic
from avsync.data.grid import GridDataSource as JaxSource
from avsync.data.pipeline import LipNetBatcher as JaxBatcher
from avsync.ops.image import variance_mouth_boxes as jax_variance_boxes
from avsync_torch.ops.image import variance_mouth_boxes
from avsync_torch.config import AvsyncConfig
from avsync_torch.data.grid import GridDataSource
from avsync_torch.data.pipeline import LipNetBatcher
from avsync_torch.predictor import preprocess


def _corpus(tmp_path, preprocessed):
    root = str(tmp_path / "grid")
    synthetic.write_corpus(root, n_speakers=1, clips_per_speaker=3, n_frames=4, height=12,
                           width=20, seed=7, with_audio=False, preprocessed=preprocessed)
    return root


def _jax_cfg(root, roi_host, device_cache, roi_mode="heuristic"):
    return JaxConfig(data=JaxDataConfig(data_path=root, img_height=12, img_width=20,
                                        max_video_length=4, batch_size=2, roi_mode=roi_mode,
                                        roi_host=roi_host, device_cache=device_cache))


def _cfg(root, roi_host, device_cache, roi_mode="heuristic"):
    """The port's config read from the JAX package's JSON."""
    cfg = AvsyncConfig.from_json(_jax_cfg(root, roi_host, device_cache, roi_mode).to_json())
    assert cfg.data.roi_host is roi_host
    return cfg


def _epoch(root, cfg):
    batcher = LipNetBatcher(GridDataSource(root), cfg, device="cpu")
    return [b["video"].numpy() for b in batcher.epoch(shuffle=False, drop_last=False)]


@pytest.mark.parametrize("device_cache", ["off", "on"])
def test_roi_host_on_native_frames_raises(tmp_path, device_cache):
    """Native 48x80 frames under roi_host and the variance ROI: each epoch's
    crops within one uint8 step of the JAX batcher's host crop (its own
    bound, tests/test_data.py TestHostRoi), from equal boxes; the device
    cache holds the uint8 crops."""
    root = _corpus(tmp_path, preprocessed=False)
    cfg = _cfg(root, True, device_cache, "variance")
    batcher = LipNetBatcher(GridDataSource(root), cfg, device="cpu")
    jax_batcher = JaxBatcher(JaxSource(root), _jax_cfg(root, True, device_cache, "variance"))
    for _ in range(2):  # under 'on' both epochs come from the cache
        got = [b["video"].numpy() for b in batcher.epoch(shuffle=False, drop_last=False)]
        want = [np.asarray(b["video"])
                for b in jax_batcher.epoch(shuffle=False, drop_last=False)]
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.shape == b.shape == (2, 4, 12, 20, 1)
            np.testing.assert_allclose(a, b, rtol=0, atol=1.0 / 255 + 1e-6)
            np.testing.assert_allclose(a * 255, np.round(a * 255), atol=1e-4)  # uint8 crops
    raws = np.stack([batcher._decode_clip(s.video_path) for s in batcher.source.samples])
    np.testing.assert_array_equal(variance_mouth_boxes(torch.from_numpy(raws)).numpy(),
                                  np.asarray(jax_variance_boxes(raws.astype(np.float32))))
    if device_cache == "on":
        cache = batcher._device_cache
        assert cache["u8"] and cache["video"].dtype == torch.uint8
        assert cache["clip_shape"] == (4, 12, 20, 1)
    assert len(_epoch(root, _cfg(root, False, device_cache))) == 2


@pytest.mark.parametrize("device_cache", ["off", "on"])
def test_roi_host_on_precropped_clips_changes_nothing(tmp_path, device_cache):
    root = _corpus(tmp_path, preprocessed=True)
    got = _epoch(root, _cfg(root, True, device_cache))
    want = _epoch(root, _cfg(root, False, device_cache))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_serving_preprocess_ignores_roi_host(tmp_path):
    """The predictor's preprocess (serving, export, infer) crops native
    frames on the device whatever the flag, as the JAX predictor does."""
    cfg = _cfg(str(tmp_path), True, "off")
    frames = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 4, 48, 80),
                                                                dtype=np.uint8))
    off = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, roi_host=False))
    got = preprocess(frames, cfg)
    assert got.shape == (2, 4, 12, 20, 1)
    assert torch.equal(got, preprocess(frames, off))
