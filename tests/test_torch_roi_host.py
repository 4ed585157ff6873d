"""`DataConfig.roi_host` in the port: the JAX package crops native-size
frames on the host and rounds the crops to uint8 under it
(avsync/data/pipeline.py:239-280), which the port does not do. The port's
LipNetBatcher raises for it on native frames, so no corpus is silently
trained or banked on other values; pre-cropped clips (no crop in either
package) and serving (the JAX predictor never reads the flag) are unchanged.
The configs come from the JAX package's JSON.
"""

import dataclasses

import numpy as np
import pytest
import torch

from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.data import synthetic
from avsync_torch.config import AvsyncConfig
from avsync_torch.data.grid import GridDataSource
from avsync_torch.data.pipeline import LipNetBatcher
from avsync_torch.predictor import preprocess


def _corpus(tmp_path, preprocessed):
    root = str(tmp_path / "grid")
    synthetic.write_corpus(root, n_speakers=1, clips_per_speaker=3, n_frames=4, height=12,
                           width=20, seed=7, with_audio=False, preprocessed=preprocessed)
    return root


def _cfg(root, roi_host, device_cache):
    """The port's config read from the JAX package's JSON."""
    jax_cfg = JaxConfig(data=JaxDataConfig(data_path=root, img_height=12, img_width=20,
                                           max_video_length=4, batch_size=2,
                                           roi_host=roi_host, device_cache=device_cache))
    cfg = AvsyncConfig.from_json(jax_cfg.to_json())
    assert cfg.data.roi_host is roi_host
    return cfg


def _epoch(root, cfg):
    batcher = LipNetBatcher(GridDataSource(root), cfg, device="cpu")
    return [b["video"].numpy() for b in batcher.epoch(shuffle=False, drop_last=False)]


@pytest.mark.parametrize("device_cache", ["off", "on"])
def test_roi_host_on_native_frames_raises(tmp_path, device_cache):
    root = _corpus(tmp_path, preprocessed=False)
    with pytest.raises(NotImplementedError, match=r"roi_host=True.*ROADMAP §1 item 6"):
        _epoch(root, _cfg(root, True, device_cache))
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
