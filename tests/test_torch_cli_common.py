"""The JAX parser's common flags on every command of the port's CLI
(`avsync/cli.py:1253-1310`): --roi_mode and --roi_host reach the config of
each command, the perf flags are on every command and win over a config
file, and the values the port does not run yet raise naming their ROADMAP
item. `infer --roi_mode variance` on a container clip against the JAX
LipReader, and `train --roi_mode variance --roi_host` on native frames."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from avsync.compat import save_lipnet_pth
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import synthetic
from avsync.models import LipNet as JaxLipNet
from avsync.predictor import LipReader as JaxLipReader
from avsync_torch import cli
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.ingest import native

# each command with its required arguments, and the function that makes its config
COMMANDS = {
    "train": ([], cli._config_from_args),
    "test": (["--checkpoint", "c.pth"], cli._config_from_args),
    "quantize": (["--checkpoint", "c.pth"], cli._config_from_args),
    "infer": (["clip.mpg", "--checkpoint", "c.pth"],
              lambda a: cli._with_common_flags(cli._config(a.config), a)),
    "export": (["--checkpoint", "c.pth"], cli._serving_config),
    "serve": (["--checkpoint", "c.pth"], cli._serving_config),
    "misalign-train": ([], cli._detector_config_from_args),
    "misalign-eval": ([], cli._detector_config_from_args),
}
COMMON = ["--roi_mode", "variance", "--roi_host", "--model_family", "pytorch",
          "--compute_dtype", "float32", "--packed_conv", "--remat"]


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_every_command_takes_the_common_flags(command):
    extra, to_config = COMMANDS[command]
    args = cli.build_parser().parse_args([command, *extra, *COMMON])
    assert (args.roi_mode, args.roi_host, args.model_family, args.distributed,
            args.compute_dtype, args.packed_conv, args.remat) == (
        "variance", True, "pytorch", False, "float32", True, True)
    cfg = to_config(args)
    assert (cfg.data.roi_mode, cfg.data.roi_host, cfg.model.compute_dtype,
            cfg.model.packed_conv, cfg.train.remat) == ("variance", True, "float32", True, True)
    # unset flags keep the defaults
    cfg = to_config(cli.build_parser().parse_args([command, *extra]))
    assert (cfg.data.roi_mode, cfg.data.roi_host, cfg.train.remat) == ("heuristic", False, False)


@pytest.mark.parametrize("command", ["test", "serve", "misalign-eval", "infer"])
def test_explicit_flags_win_over_the_config_file(command, tmp_path):
    extra, to_config = COMMANDS[command]
    path = tmp_path / "cfg.json"
    path.write_text(AvsyncConfig(data=DataConfig(roi_mode="model", roi_host=True)).to_json())
    p = cli.build_parser()
    cfg = to_config(p.parse_args([command, *extra, "--config", str(path)]))
    assert (cfg.data.roi_mode, cfg.data.roi_host) == ("model", True)
    cfg = to_config(p.parse_args([command, *extra, "--config", str(path), "--roi_mode",
                                  "detector", "--no-roi_host"]))
    assert (cfg.data.roi_mode, cfg.data.roi_host) == ("detector", False)


def test_unported_values_raise_naming_their_item(tmp_path, capsys):
    # --distributed is ported for `train`: on another command it exits 2 with
    # the JAX package's message (avsync/cli.py:1520-1531)
    for command in ("test", "serve", "misalign-train"):
        extra, _ = COMMANDS[command]
        argv = [command, *extra, "--data_path", str(tmp_path), "--device", "cpu",
                "--distributed"]
        assert cli.main(argv) == 2
        assert "--distributed supports the 'train' subcommand only" in capsys.readouterr().err


def test_int8_under_bf16_is_no_longer_refused(tmp_path):
    """`--quantize int8` with `--compute_dtype bfloat16` (ROADMAP §1 item 14
    is ported): each command's config keeps both, its int8 forward builds in
    bf16, and the command gets past its flags to the missing checkpoint."""
    from avsync_torch.ops.quant import make_int8_forward

    for command in ("test", "serve"):
        extra, to_config = COMMANDS[command]
        argv = [command, *extra, "--data_path", str(tmp_path), "--device", "cpu",
                "--compute_dtype", "bfloat16", "--quantize", "int8"]
        args = cli.build_parser().parse_args(argv)
        assert args.quantize == "int8"
        cfg = to_config(args)
        assert cfg.model.compute_dtype == "bfloat16"
        assert callable(make_int8_forward(cfg.model))
        with pytest.raises((FileNotFoundError, OSError)):
            cli.main(argv)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_common")
    model = dict(hidden_dim=8, conv_channels=(2, 3, 4))
    params = JaxLipNet(JaxModelConfig(**model)).init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(3)
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.3, np.shape(p))).astype(
        np.float32), params)
    ckpt = str(root / "lipnet.pth")
    save_lipnet_pth(params, ckpt, conv_shape=(4, 2, 4))
    data = dict(img_height=16, img_width=32, max_video_length=8)
    cfg_path = root / "cfg.json"
    cfg_path.write_text(AvsyncConfig(data=DataConfig(**data), model=ModelConfig(**model)).to_json())
    jcfg = JaxConfig(data=JaxDataConfig(**data, roi_mode="variance"), model=JaxModelConfig(**model))
    return {"root": root, "ckpt": ckpt, "cfg": str(cfg_path), "jcfg": jcfg}


def test_infer_variance_on_a_container_clip(tiny, capsys):
    r = np.random.default_rng(4)
    clip = synthetic.make_clip(r, n_frames=8, height=64, width=96, mouth_center=(0.7, 0.45))[0]
    path = str(tiny["root"] / "s1_clip.mp4")
    native.mux_mp4(path, np.repeat(clip[..., None], 3, axis=-1), 25.0)
    (tiny["root"] / "s1_clip.align").write_text("0 1 sil\n1 2 bin\n2 3 blue\n")
    assert cli.main(["infer", path, "--checkpoint", tiny["ckpt"], "--config", tiny["cfg"],
                     "--roi_mode", "variance", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    want = JaxLipReader(tiny["ckpt"], config=tiny["jcfg"]).predict(path)
    assert f"Predicted: {want}\n" in out and "Ground truth: bin blue" in out


def test_train_variance_roi_host_on_native_frames(tiny, tmp_path):
    """One epoch through the CLI over native 64x128 frames, cropped on the
    host (variance box) with the device cache on; a finite loss in the
    history (tests/test_torch_roi_host.py holds the crops and the cache)."""
    root = str(tmp_path / "grid")
    synthetic.write_corpus(root, n_speakers=3, clips_per_speaker=2, n_frames=8, height=16,
                           width=32, seed=5, with_audio=False, preprocessed=False)
    cfg = json.loads(open(tiny["cfg"]).read())
    cfg["data"].update(max_label_length=6, batch_size=2)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    assert cli.main(["train", "--data_path", root, "--config", str(cfg_path), "--epochs", "1",
                     "--checkpoint_dir", str(tmp_path / "ck"), "--roi_mode", "variance",
                     "--roi_host", "--device_cache", "on", "--device", "cpu",
                     "--log_dir", str(tmp_path / "logs")]) == 0
    with open(tmp_path / "ck" / "history.json") as f:
        loss = json.load(f)["loss"]
    assert len(loss) == 1 and np.isfinite(loss[0])
