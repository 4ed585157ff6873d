"""The port's command line over several devices on the CPU: `train` over two
gloo ranks it starts itself (a config `mesh_shape` of (2, 1) with
`--device cpu`) against the JAX package's `train` on a (2, 1) mesh of its
virtual CPU devices, `test` over two ranks (f32 and int8) against the one
process and the JAX `test` on a (2, 1) mesh, `--distributed` refused
outside `train`, and `serve --dp` (two CPU replicas) against the JAX reader
on a (2, 1) mesh."""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync import compat as jcompat
from avsync.config import AvsyncConfig as JaxConfig
from avsync.data import synthetic
from avsync.parallel import make_mesh as jax_make_mesh
from avsync.predictor import LipReader as JaxReader
from avsync.train import LipNetTrainer as JaxTrainer
from avsync.train.lipnet_trainer import TrainState as JaxState
from avsync_torch import cli
from avsync_torch import compat
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.models import make_lipnet

DATA = dict(img_height=16, img_width=32, max_video_length=8, batch_size=4,
            max_label_length=6, device_cache="off")
MODEL = dict(hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0)
CONV_SHAPE = (4, 2, 4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_parallel"))
    synthetic.write_corpus(root, n_speakers=4, clips_per_speaker=4, n_frames=8, height=16,
                           width=32, seed=21, with_audio=False)
    return root


def _cfg(root, tmp, kernels=True):
    return AvsyncConfig(
        data=DataConfig(data_path=root, **DATA),
        model=ModelConfig(use_pallas_gru=kernels, fused_conv_pool=kernels, **MODEL),
        train=TrainConfig(learning_rate=1e-3, mesh_shape=(2, 1), checkpoint_every=100,
                          log_dir=str(tmp / "logs")))


def test_cli_train_over_two_ranks_matches_the_jax_cli(corpus, tmp_path, monkeypatch):
    """Both CLIs train 2 epochs on a (2, 1) mesh from the same weights (the
    port draws them from its seed; the JAX trainer's init is handed the same
    through the bridge), same shuffles, dropout 0: the loss history agrees to
    1e-4 relative. The port's run writes rank 0's whole-model snapshot, which
    a single-process `test` reads."""
    from avsync.cli import main as jax_main

    cfg = _cfg(corpus, tmp_path)
    port_cfg = str(tmp_path / "port.json")
    open(port_cfg, "w").write(cfg.to_json())
    jcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_pallas_gru=False, fused_conv_pool=False))
    jax_cfg = str(tmp_path / "jax.json")
    open(jax_cfg, "w").write(jcfg.to_json())

    ck = str(tmp_path / "ck")
    assert cli.main(["train", "--data_path", corpus, "--config", port_cfg, "--epochs", "2",
                     "--checkpoint_dir", ck, "--device", "cpu"]) == 0
    hist = json.load(open(os.path.join(ck, "history.json")))
    assert os.path.exists(os.path.join(ck, "epoch_3.pth"))

    weights = make_lipnet(cfg.model, (16, 32), generator=torch.Generator().manual_seed(
        cfg.train.seed)).state_dict()
    params = compat.lipnet_params_to_jax(weights, conv_shape=CONV_SHAPE)

    def same_init(self, sample_batch):
        p = jax.tree.map(jnp.asarray, params)
        return self.shard_state(JaxState(p, self.optimizer.init(p), jnp.zeros((), jnp.int32)))

    monkeypatch.setattr(JaxTrainer, "init_state", same_init)
    jck = str(tmp_path / "jck")
    assert jax_main(["train", "--data_path", corpus, "--config", jax_cfg, "--epochs", "2",
                     "--checkpoint_dir", jck]) == 0
    jhist = json.load(open(os.path.join(jck, "history.json")))
    assert len(hist["loss"]) == len(jhist["loss"]) == 2
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    np.testing.assert_allclose(hist["val_loss"], jhist["val_loss"], rtol=1e-4)

    out = str(tmp_path / "results.json")
    single = str(tmp_path / "single.json")
    open(single, "w").write(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, mesh_shape=(-1, 1))).to_json())
    assert cli.main(["test", "--data_path", corpus, "--config", single, "--checkpoint", ck,
                     "--output", out, "--device", "cpu"]) == 0
    assert json.load(open(out))["num_samples"] > 0


@pytest.fixture(scope="module")
def test_split(tmp_path_factory):
    """A corpus whose test speaker has 7 clips (batches of 4: one whole, one
    padded), perturbed JAX weights as a reference `.pth`, and configs with
    a (2, 1) mesh (the port's, with its kernels; the JAX package's, on its
    XLA path) and without."""
    root = tmp_path_factory.mktemp("test_ranks")
    data = str(root / "grid")
    synthetic.write_corpus(data, n_speakers=3, clips_per_speaker=7, n_frames=8, height=16,
                           width=32, seed=23, with_audio=False)
    from avsync.config import ModelConfig as JaxModelConfig
    from avsync.models import LipNet as JaxLipNet

    params = JaxLipNet(JaxModelConfig(**MODEL)).init({"params": jax.random.PRNGKey(5)},
                                                     jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(5)
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.3, np.shape(p))).astype(
        np.float32), params)
    pth = str(root / "lipnet.pth")
    jcompat.save_lipnet_pth(params, pth, conv_shape=CONV_SHAPE)
    cfg = _cfg(data, root)
    paths = {}
    for name, c in (("port2", cfg),
                    ("port1", dataclasses.replace(cfg, train=dataclasses.replace(
                        cfg.train, mesh_shape=(-1, 1)))),
                    ("jax2", dataclasses.replace(cfg, model=dataclasses.replace(
                        cfg.model, use_pallas_gru=False, fused_conv_pool=False)))):
        paths[name] = str(root / f"{name}.json")
        open(paths[name], "w").write(c.to_json())
    return data, pth, paths


@pytest.mark.parametrize("quantize", [[], ["--quantize", "int8"]], ids=["f32", "int8"])
def test_test_over_two_ranks_equals_one_process_and_the_jax_mesh(test_split, tmp_path,
                                                                 quantize, capsys):
    """`test --device cpu` with a (2, 1) mesh starts two gloo ranks; rank 0
    writes the JSON, equal to the one-process command's and to the JAX
    `test` on a (2, 1) mesh of its virtual devices (int8: every rank
    calibrated on the whole first batch)."""
    from avsync.cli import main as jax_main

    data, pth, cfgs = test_split
    out = {k: str(tmp_path / f"{k}.json") for k in cfgs}
    for name in ("port2", "port1"):
        assert cli.main(["test", "--data_path", data, "--config", cfgs[name], "--checkpoint",
                         pth, "--output", out[name], "--device", "cpu", *quantize]) == 0
        started = "starting 2 ranks (cpu, gloo)" in capsys.readouterr().out
        assert started == (name == "port2")
    assert jax_main(["test", "--data_path", data, "--config", cfgs["jax2"], "--checkpoint",
                     pth, "--output", out["jax2"], *quantize]) == 0
    got = {k: json.load(open(v)) for k, v in out.items()}
    assert got["port2"] == got["port1"] == got["jax2"]
    assert got["port2"]["num_samples"] == 7 and got["port2"]["cer"] < 1.0


def test_test_distributed_is_refused_as_the_jax_cli_refuses_it(tmp_path, capsys):
    from avsync.cli import main as jax_main

    argv = ["test", "--checkpoint", "c.pth", "--data_path", str(tmp_path), "--distributed"]
    assert cli.main([*argv, "--device", "cpu"]) == 2
    ours = capsys.readouterr().err
    assert jax_main(argv) == 2
    theirs = capsys.readouterr().err
    head = "ERROR: --distributed supports the 'train' subcommand only"
    assert ours.startswith(head) and theirs.startswith(head)


@pytest.mark.parametrize("command", ["test", "serve", "misalign-train", "infer"])
def test_distributed_outside_train_exits_2(command, tmp_path, capsys):
    extra = {"test": ["--checkpoint", "c.pth"], "serve": ["--checkpoint", "c.pth"],
             "misalign-train": [], "infer": ["clip.mpg", "--checkpoint", "c.pth"]}[command]
    assert cli.main([command, *extra, "--data_path", str(tmp_path), "--device", "cpu",
                     "--distributed"]) == 2
    assert cli.DISTRIBUTED_TRAIN_ONLY in capsys.readouterr().err


def test_distributed_train_without_a_launcher_says_so(tmp_path, monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(["train", "--data_path", str(tmp_path), "--device", "cpu", "--distributed"])


@pytest.fixture(scope="module")
def reader_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_serve")
    from avsync.models import LipNet as JaxLipNet
    from avsync.config import ModelConfig as JaxModelConfig

    jmodel = JaxModelConfig(hidden_dim=8, conv_channels=(2, 3, 4))
    params = JaxLipNet(jmodel).init({"params": jax.random.PRNGKey(2)},
                                    jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(0)
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.3, np.shape(p))).astype(
        np.float32), params)
    pth = str(root / "lipnet.pth")
    jcompat.save_lipnet_pth(params, pth, conv_shape=CONV_SHAPE)
    cfg = AvsyncConfig(data=DataConfig(img_height=16, img_width=32, max_video_length=8),
                       model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True,
                                         hidden_dim=8, conv_channels=(2, 3, 4)))
    path = str(root / "cfg.json")
    open(path, "w").write(cfg.to_json())
    clips = np.random.default_rng(3).integers(0, 256, (5, 8, 16, 32), np.uint8)
    return pth, path, cfg, clips


def _serve_args(pth, cfg_path, dp, quantize=None):
    return argparse.Namespace(checkpoint=pth, config=cfg_path, dp=dp, device="cpu",
                              quantize=quantize, qscales=None, model_family=None,
                              roi_mode=None, roi_host=None, compute_dtype=None,
                              packed_conv=None, remat=None)


def test_serve_dp_two_cpu_replicas_match_the_jax_reader_on_a_mesh(reader_inputs, monkeypatch):
    """`serve --dp 2`'s reader (two CPU replicas; the host's device list
    stubbed to two CPUs) on 5 clips: the rows split 3 + 2 over the replicas
    and come back in order; log-probs within 5e-5 of the JAX reader on a
    (2, 1) mesh, transcripts equal."""
    pth, cfg_path, cfg, clips = reader_inputs
    monkeypatch.setattr(cli, "dp_devices", lambda args: ["cpu", "cpu"])
    reader = cli.serving_reader(_serve_args(pth, cfg_path, 2), cli._serving_config(
        _serve_args(pth, cfg_path, 2)))
    assert len(reader.replicas) == 2
    assert reader.replicas[1][1] is not reader.model
    x = torch.cat([reader._prepare(c) for c in clips])
    ours = reader._logprobs(x)
    jcfg = JaxConfig.from_json(cfg.to_json())
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, use_pallas_gru=False,
                                                               fused_conv_pool=False))
    jreader = JaxReader(pth, jcfg, mesh=jax_make_mesh((2, 1), devices=jax.devices()[:2]))
    want = np.asarray(jreader._logprobs(jnp.concatenate([jreader._prepare(c) for c in clips])))
    np.testing.assert_allclose(ours.numpy(), want, atol=5e-5)
    # each replica's block is what one reader gives those rows, in order
    single = cli.serving_reader(_serve_args(pth, cfg_path, 1), cfg)
    assert torch.equal(torch.cat([single._logprobs(x[:3]), single._logprobs(x[3:])]), ours)
    from avsync.text import decode_batch as jax_decode

    assert reader._decode(ours) == jax_decode(want)


def test_serve_dp_int8_replicas_share_the_scales(reader_inputs, monkeypatch):
    pth, cfg_path, cfg, clips = reader_inputs
    monkeypatch.setattr(cli, "dp_devices", lambda args: ["cpu", "cpu"])
    args = _serve_args(pth, cfg_path, 0, quantize="int8")
    reader = cli.serving_reader(args, cli._serving_config(args))
    single = cli.serving_reader(_serve_args(pth, cfg_path, 1, quantize="int8"),
                                cli._serving_config(args))
    x = torch.cat([reader._prepare(c) for c in clips])
    got = reader._logprobs(x)
    single._logprobs(x)  # calibrated on the same batch as the replicas
    want = torch.cat([single._logprobs(x[:3]), single._logprobs(x[3:])])
    assert torch.equal(got, want)
    assert [float(c.x_scale) for c in reader._replica_qparams[1].convs] == \
        [float(c.x_scale) for c in reader._qparams.convs]


def test_serve_dp_above_the_device_count_names_it(reader_inputs, monkeypatch):
    pth, cfg_path, cfg, _ = reader_inputs
    monkeypatch.setattr(cli, "dp_devices", lambda args: ["cpu", "cpu"])
    with pytest.raises(SystemExit, match="2 device"):
        cli.serving_reader(_serve_args(pth, cfg_path, 3), cfg)


def test_misalign_train_over_two_cpu_ranks(tmp_path):
    """`misalign-train --device cpu` with a config mesh of (2, 1) starts two
    gloo ranks: each builds the banks and trains on its rows; rank 0 alone
    writes the one log folder and the detector, which loads."""
    from avsync.config import ModelConfig as JaxModelConfig
    from avsync.models import LipNet as JaxLipNet
    from avsync_torch.compat import load_detector_pth
    from avsync_torch.config import AudioConfig, DetectorConfig

    tiny = dict(hidden_dim=4, conv_channels=(2, 2, 3))
    root = str(tmp_path / "grid")
    synthetic.write_corpus(root, n_speakers=2, clips_per_speaker=5, n_frames=8, height=16,
                           width=32, seed=3)
    params = JaxLipNet(JaxModelConfig(**tiny)).init({"params": jax.random.PRNGKey(6)},
                                                   jnp.zeros((1, 8, 16, 32, 1)))["params"]
    lip = str(tmp_path / "lipnet.pth")
    jcompat.save_lipnet_pth(jax.tree.map(np.asarray, params), lip, conv_shape=(3, 2, 4))
    cfg = AvsyncConfig(
        data=DataConfig(img_height=16, img_width=32, max_video_length=8, batch_size=4),
        model=ModelConfig(fused_conv_pool=True, **tiny),
        audio=AudioConfig(max_audio_samples=4000, use_pallas=True),
        detector=DetectorConfig(hidden_dim=8, batch_size=8, epochs=2),
        train=TrainConfig(seed=42, mesh_shape=(2, 1)))
    path = str(tmp_path / "cfg.json")
    open(path, "w").write(cfg.to_json())
    det, logs = str(tmp_path / "detector.pth"), str(tmp_path / "logs")
    assert cli.main(["misalign-train", "--data_path", root, "--checkpoint", lip,
                     "--detector_checkpoint", det, "--config", path, "--log_dir", logs,
                     "--save_every", "1", "--device", "cpu"]) == 0
    (run,) = os.listdir(logs)
    assert {"training.log", "checkpoint_epoch_1.pth", "checkpoint_epoch_2.pth",
            "detector.pth"} <= set(os.listdir(os.path.join(logs, run)))
    state, meta = load_detector_pth(det)
    assert meta["input_dim"] == 2 * 24 + 40 and state["classifier.0.weight"].shape == (8, 88)
    log = open(os.path.join(logs, run, "training.log")).read()
    assert log.count("Misalignment Detection Training") == 1 and "Test AUC" in log
