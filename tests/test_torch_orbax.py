"""JAX package checkpoints (Orbax directories) into the port through
`scripts/orbax_to_torch.py`, on the CPU, for both LipNet families.

Each family's Orbax directory comes from two JAX train steps on a tiny
corpus (`avsync.cli train`, one step per epoch). Converted, it gives the
JAX CLI's `test` JSON and `infer` transcript through the port's commands,
and one more epoch (one step) resumed from it in each package agrees within
the train-step bounds (PERF.md section 2): the loss to rtol 1e-4, every
parameter within 6 lr, the median within 1e-6. Also the port manager's
`max_to_keep`.
"""

import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from avsync.cli import main as jax_main
from avsync.data import synthetic
from avsync_torch import cli
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.utils.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import orbax_to_torch  # noqa: E402

LR = 1e-3
FAMILIES = {
    "pytorch": (dict(hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0), {}),
    "tf": (dict(family="tf", hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0),
           dict(standardize_clips=True)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the corpus, the port's and the JAX package's configs, the
    Orbax directory of two JAX steps, and its conversion."""
    root = tmp_path_factory.mktemp("orbax")
    data = str(root / "grid")
    synthetic.write_corpus(data, n_speakers=3, clips_per_speaker=2, n_frames=8, height=16,
                           width=32, seed=31, with_audio=False)
    out = {}
    for family, (model, extra) in FAMILIES.items():
        d = root / family
        d.mkdir()
        cfg = AvsyncConfig(
            data=DataConfig(img_height=16, img_width=32, max_video_length=8, batch_size=4,
                            max_label_length=6, device_cache="off", **extra),
            model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True, **model),
            train=TrainConfig(learning_rate=LR, log_dir=str(d / "logs")))
        paths = {"port": str(d / "port.json"), "jax": str(d / "jax.json")}
        open(paths["port"], "w").write(cfg.to_json())
        open(paths["jax"], "w").write(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, use_pallas_gru=False, fused_conv_pool=False)).to_json())
        orbax = str(d / "orbax")
        with redirect_stdout(io.StringIO()):
            assert jax_main(["train", "--data_path", data, "--config", paths["jax"],
                             "--epochs", "2", "--checkpoint_dir", orbax]) == 0
        converted = str(d / "converted")
        orbax_to_torch.convert(orbax, converted)
        out[family] = dict(dir=d, cfg=paths, orbax=orbax, converted=converted)
    return data, out


def test_conversion_carries_params_moments_and_metadata(runs):
    data, out = runs
    for family, r in out.items():
        mgr = CheckpointManager(r["converted"])
        assert mgr.all_steps() == [3]  # the JAX trainer's final snapshot: epochs + 1
        payload, meta = mgr.restore()
        assert payload["step"] == 2 and meta["metrics"]["epochs_completed"] == 2
        assert meta["config"]["model"]["family"] == family
        opt = payload["optimizer_state_dict"]
        assert len(opt["state"]) == len(payload["model_state_dict"])
        for st in opt["state"].values():
            assert float(st["step"]) == 2.0 and torch.all(st["exp_avg_sq"] >= 0)


def _printed(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert fn(argv) == 0
    return [ln for ln in buf.getvalue().splitlines() if ln.startswith("Predicted")]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_test_and_infer_on_the_conversion_equal_the_jax_cli(runs, tmp_path, family):
    data, out = runs
    r = out[family]
    flags = ["--data_path", data, "--model_family", family]
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    assert cli.main(["test", *flags, "--config", r["cfg"]["port"], "--checkpoint",
                     r["converted"], "--output", ours, "--device", "cpu"]) == 0
    assert jax_main(["test", *flags, "--config", r["cfg"]["jax"], "--checkpoint", r["orbax"],
                     "--output", theirs]) == 0
    got, want = json.load(open(ours)), json.load(open(theirs))
    assert got == want and got["num_samples"] == 2
    clip = sorted(os.path.join(dp, n) for dp, _, ns in os.walk(data) for n in ns
                  if n.endswith(".npy"))[0]
    port_lines = _printed(cli.main, ["infer", clip, "--model_family", family, "--config",
                                     r["cfg"]["port"], "--checkpoint", r["converted"],
                                     "--device", "cpu"])
    jax_lines = _printed(jax_main, ["infer", clip, "--model_family", family, "--config",
                                    r["cfg"]["jax"], "--checkpoint", r["orbax"]])
    assert port_lines == jax_lines and len(port_lines) == 1


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_step_resumed_from_the_conversion_matches_the_jax_resume(runs, tmp_path, family):
    """Each package trains epoch 3 (one step) from its own copy of the same
    snapshot with `--resume auto`: the epoch's loss to rtol 1e-4, and the
    snapshots they write (the JAX one converted) within 6 lr, median 1e-6."""
    data, out = runs
    r = out[family]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    shutil.copytree(r["converted"], ours)
    shutil.copytree(r["orbax"], theirs)
    flags = ["--data_path", data, "--model_family", family, "--epochs", "3", "--resume",
             "auto"]
    with redirect_stdout(io.StringIO()):
        assert cli.main(["train", *flags, "--config", r["cfg"]["port"], "--checkpoint_dir",
                         ours, "--device", "cpu"]) == 0
        assert jax_main(["train", *flags, "--config", r["cfg"]["jax"], "--checkpoint_dir",
                         theirs]) == 0
    loss = json.load(open(os.path.join(ours, "history.json")))["loss"][-1]
    jloss = json.load(open(os.path.join(theirs, "history.json")))["loss"][-1]
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    got = CheckpointManager(ours).restore(4)[0]
    assert got["step"] == 3
    orbax_to_torch.convert(theirs, str(tmp_path / "theirs_converted"), step=4)
    want = CheckpointManager(str(tmp_path / "theirs_converted")).restore(4)[0]
    diffs = np.concatenate([
        (got["model_state_dict"][k] - v).abs().numpy().ravel()
        for k, v in want["model_state_dict"].items()])
    assert diffs.max() <= 6 * LR and np.median(diffs) <= 1e-6


def test_script_converts_a_chosen_step_from_the_command_line(runs, tmp_path):
    _, out = runs
    r = out["pytorch"]
    dst = str(tmp_path / "dst")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "orbax_to_torch.py"),
                           r["orbax"], dst, "--step", "3"], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"wrote {os.path.join(dst, 'epoch_3.pth')}" in proc.stdout
    a = CheckpointManager(dst).restore()[0]["model_state_dict"]
    b = CheckpointManager(r["converted"]).restore()[0]["model_state_dict"]
    assert all(torch.equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("keep", [None, 1, 2])
def test_max_to_keep_deletes_the_oldest_snapshots(tmp_path, keep):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=keep)
    for step in (1, 2, 5, 3):
        mgr.save(step, {"w": torch.full((2,), float(step))})
    want = {None: [1, 2, 3, 5], 1: [5], 2: [3, 5]}[keep]
    assert mgr.all_steps() == want
    assert float(mgr.restore()[0]["model_state_dict"]["w"][0]) == 5.0
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(str(tmp_path), max_to_keep=0)
