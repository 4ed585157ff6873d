"""`python -m avsync_torch.cli misalign-train` / `misalign-eval --device cpu`
on a tiny synthetic GRID corpus (`avsync.data.synthetic`, with audio): the
detector checkpoints, the bank cache, and the sweep's AUROCs against the JAX
package's `misalign-eval` on the same checkpoints.

The AUROCs may differ by at most one swapped (positive, negative) pair,
1 / (n_pos * n_neg): the two packages score in fp32 with sums in another
order, so two near-equal probabilities can change places.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from avsync import compat as jcompat
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import synthetic
from avsync.models import LipNet as JaxLipNet
from avsync_torch.cli import main
from avsync_torch.compat import load_detector_pth
from avsync_torch.config import (AudioConfig, AvsyncConfig, DataConfig, DetectorConfig,
                                 ModelConfig, TrainConfig)

TINY = dict(hidden_dim=4, conv_channels=(2, 2, 3))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("misalign_cli")
    root = str(d / "grid")
    synthetic.write_corpus(root, n_speakers=2, clips_per_speaker=5, n_frames=8, height=16,
                           width=32, seed=3)
    params = JaxLipNet(JaxModelConfig(**TINY)).init({"params": jax.random.PRNGKey(6)},
                                                   jnp.zeros((1, 8, 16, 32, 1)))["params"]
    lip = str(d / "lipnet.pth")
    jcompat.save_lipnet_pth(jax.tree.map(np.asarray, params), lip, conv_shape=(3, 2, 4))
    cfg = AvsyncConfig(
        data=DataConfig(img_height=16, img_width=32, max_video_length=8, batch_size=4),
        model=ModelConfig(fused_conv_pool=True, **TINY),
        audio=AudioConfig(max_audio_samples=4000, use_pallas=True),
        detector=DetectorConfig(hidden_dim=8, batch_size=8, epochs=2),
        train=TrainConfig(seed=42))
    port_cfg, jax_cfg = str(d / "port.json"), str(d / "jax.json")
    open(port_cfg, "w").write(cfg.to_json())
    # the JAX package runs its Pallas kernels only on a TPU or in interpret
    # mode: its command gets the same function through the XLA path
    open(jax_cfg, "w").write(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, fused_conv_pool=False),
        audio=dataclasses.replace(cfg.audio, use_pallas=False)).to_json())
    return d, root, lip, port_cfg, jax_cfg


def test_misalign_train_then_eval_against_the_jax_sweep(setup, monkeypatch, capsys):
    from avsync.cli import main as jax_main

    d, root, lip, port_cfg, jax_cfg = setup
    det, logs, cache = str(d / "detector.pth"), str(d / "logs"), str(d / "banks")
    common = ["--data_path", root, "--checkpoint", lip, "--detector_checkpoint", det,
              "--bank_cache", cache, "--seed", "42"]
    assert main(["misalign-train", *common, "--config", port_cfg, "--log_dir", logs,
                 "--save_every", "1", "--device", "cpu"]) == 0
    assert "Done. Best val AUC" in capsys.readouterr().out
    (run,) = os.listdir(logs)
    assert {"training.log", "checkpoint_epoch_1.pth", "checkpoint_epoch_2.pth",
            "detector.pth"} <= set(os.listdir(os.path.join(logs, run)))
    assert len(os.listdir(cache)) == 3  # train / val / test banks (7 / 1 / 2 clips)
    state, meta = load_detector_pth(det)
    assert meta["input_dim"] == 2 * 24 + 40 and meta["hidden_dim"] == 8
    assert state["classifier.0.weight"].shape == (8, 88)

    # a second run over the unchanged corpus takes every bank from the cache
    def no_build(*a, **k):
        raise AssertionError("the bank cache missed")

    monkeypatch.setattr("avsync_torch.features.build_feature_bank", no_build)
    assert main(["misalign-train", *common, "--config", port_cfg, "--log_dir", logs,
                 "--device", "cpu", "--epochs", "1"]) == 0
    monkeypatch.undo()

    out_port, out_jax = str(d / "port_eval.json"), str(d / "jax_eval.json")
    sweep = ["--min_shift", "1", "--max_shift", "3"]
    assert main(["misalign-eval", *common[:6], "--seed", "42", "--config", port_cfg, *sweep,
                 "--output", out_port, "--device", "cpu"]) == 0
    assert jax_main(["misalign-eval", *common[:6], "--seed", "42", "--config", jax_cfg, *sweep,
                     "--output", out_jax]) == 0
    ours, theirs = json.load(open(out_port)), json.load(open(out_jax))
    n = ours["num_clips"]
    assert n == theirs["num_clips"] == 10
    assert set(ours["auroc_by_shift"]) == set(theirs["auroc_by_shift"]) == {"1", "2", "3"}
    for s, a in ours["auroc_by_shift"].items():
        assert abs(a - theirs["auroc_by_shift"][s]) <= 1.0 / (n * n) + 1e-12, s
    assert abs(ours["overall_auroc"] - theirs["overall_auroc"]) <= 1.0 / (n * 3 * n) + 1e-12


def test_misalign_eval_chunks_the_clip_axis(setup, monkeypatch):
    """The sweep in chunks of 3 clips gives the same scores as in one chunk."""
    import avsync_torch.cli as cli

    d, root, lip, port_cfg, _ = setup
    det = str(d / "detector_chunks.pth")
    assert main(["misalign-train", "--data_path", root, "--checkpoint", lip,
                 "--detector_checkpoint", det, "--config", port_cfg, "--log_dir",
                 str(d / "logs_chunks"), "--epochs", "1", "--device", "cpu"]) == 0
    args = ["misalign-eval", "--data_path", root, "--checkpoint", lip, "--detector_checkpoint",
            det, "--config", port_cfg, "--min_shift", "2", "--max_shift", "4", "--device", "cpu"]
    one, three = str(d / "one.json"), str(d / "three.json")
    assert main([*args, "--output", one]) == 0
    monkeypatch.setattr(cli, "_SWEEP_CLIP_CHUNK", 3)
    assert main([*args, "--output", three]) == 0
    a, b = json.load(open(one)), json.load(open(three))
    assert a["num_clips"] == b["num_clips"] == 10
    for s in a["auroc_by_shift"]:
        assert a["auroc_by_shift"][s] == pytest.approx(b["auroc_by_shift"][s], abs=1e-12)


def test_misalign_train_needs_a_device_choice_without_a_gpu(setup, monkeypatch):
    import torch

    d, root, lip, port_cfg, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["misalign-train", "--data_path", root, "--checkpoint", lip, "--config", port_cfg,
              "--log_dir", str(d / "logs_nogpu")])
