"""The port's training loop, batcher and train/test commands against the JAX
package's, on a synthetic GRID corpus (`avsync.data.synthetic`): 8-frame
16x32 clips, three speakers of two clips (train / val / test split), a
tiny LipNet. Everything runs on the CPU (`device="cpu"`), where the kernel
flags take the kernels' plain versions.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import synthetic
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.data.grid import GridDataSource, split_speakers
from avsync_torch.data.pipeline import LipNetBatcher
from avsync_torch.train.lipnet_trainer import LipNetTrainer, keras_lr_schedule
from avsync_torch.utils.checkpoint import CheckpointManager
from avsync_torch.utils.logging import Logger

DATA = dict(img_height=16, img_width=32, max_video_length=8, batch_size=2,
            max_label_length=6, device_cache="off")
MODEL = dict(hidden_dim=8, conv_channels=(2, 3, 4))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("grid"))
    speakers = synthetic.write_corpus(root, n_speakers=3, clips_per_speaker=2, n_frames=8,
                                      height=16, width=32, seed=17, with_audio=False)
    return root, speakers


def _cfg(root, tmp_path, dropout=0.0, **train):
    return AvsyncConfig(
        data=DataConfig(data_path=root, **DATA),
        model=ModelConfig(dropout_rate=dropout, use_pallas_gru=True, fused_conv_pool=True,
                          **MODEL),
        train=TrainConfig(learning_rate=1e-3, checkpoint_dir=str(tmp_path / "ckpt"),
                          log_dir=str(tmp_path / "logs"), **train))


@pytest.mark.parametrize("drop_last,shuffle", [(True, True), (False, False)],
                         ids=["train_order", "eval_order_padded"])
def test_batcher_matches_jax(corpus, drop_last, shuffle):
    """Same order, labels, lengths, `valid` and video values as the JAX
    package's streamed LipNetBatcher, over all six clips in batches of 4."""
    from avsync.data import GridDataSource as JaxSource
    from avsync.data import LipNetBatcher as JaxBatcher

    root, speakers = corpus
    jcfg = JaxConfig(data=JaxDataConfig(data_path=root, **DATA))
    cfg = AvsyncConfig(data=DataConfig(data_path=root, **DATA))
    jb = JaxBatcher(JaxSource(root, speakers), jcfg)
    tb = LipNetBatcher(GridDataSource(root, speakers), cfg, device="cpu")
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last)
    got, want = list(tb.epoch(**kw)), list(jb.epoch(**kw))
    assert len(got) == len(want) == (1 if drop_last else 2)
    for g, w in zip(got, want):
        assert g["valid"] == w["valid"]
        np.testing.assert_array_equal(g["labels"], np.asarray(w["labels"]))
        np.testing.assert_array_equal(g["label_lengths"], np.asarray(w["label_lengths"]))
        assert g["video"].shape == (4, 8, 16, 32, 1) and g["video"].dtype == torch.float32
        np.testing.assert_allclose(g["video"].numpy(), np.asarray(w["video"]), atol=0, rtol=0)


def test_first_batch_is_the_unshuffled_head(corpus):
    root, speakers = corpus
    cfg = AvsyncConfig(data=DataConfig(data_path=root, **DATA))
    src = GridDataSource(root, speakers)
    b = LipNetBatcher(src, cfg, device="cpu").first_batch()
    labels, _ = src.labels_batch([0, 1], DATA["max_label_length"])
    np.testing.assert_array_equal(b["labels"], labels)


def _loaders(root, cfg, split, seed0=1):
    train_sp, val_sp, _ = split
    tb = LipNetBatcher(GridDataSource(root, train_sp), cfg, device="cpu")
    vb = LipNetBatcher(GridDataSource(root, val_sp), cfg, device="cpu")
    seeds = iter(range(seed0, 1000))
    return (lambda: tb.epoch(shuffle=True, seed=next(seeds)),
            lambda: vb.epoch(shuffle=False))


def test_train_writes_history_checkpoints_and_resumes(corpus, tmp_path):
    root, speakers = corpus
    cfg = _cfg(root, tmp_path, checkpoint_every=2)
    split = split_speakers(speakers)
    history = str(tmp_path / "history.json")
    quiet = Logger(None, console=False)
    trainer = LipNetTrainer(cfg, device="cpu", log=quiet)
    state = trainer.train(*_loaders(root, cfg, split), epochs=3, history_path=history)
    h = json.load(open(history))
    assert set(h) == {"loss", "val_loss", "lr", "epoch_seconds"}
    assert [len(v) for v in h.values()] == [3, 3, 3, 3]
    ckpt = CheckpointManager(cfg.train.checkpoint_dir)
    assert ckpt.all_steps() == [2, 4]  # every 2 epochs, and the final one as epochs + 1
    payload, meta = ckpt.restore()
    assert meta["metrics"] == {"epochs_completed": 3}
    assert AvsyncConfig.from_dict(meta["config"]) == cfg
    assert payload["step"] == state.step == 6  # two 2-clip train batches per epoch
    assert payload["losses"]["train"] == h["loss"]
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(payload["model_state_dict"][k], v, rtol=0, atol=0)

    # a relaunch with the same budget credits the completed epochs: nothing to train
    again = LipNetTrainer(cfg, device="cpu", log=quiet)
    again.train(*_loaders(root, cfg, split), epochs=3, history_path=history, start_epoch=3)
    assert ckpt.all_steps() == [2, 4] and json.load(open(history))["loss"] == h["loss"]

    # a larger budget resumes at epoch 4 and keeps the earlier history
    more = LipNetTrainer(cfg, device="cpu", log=quiet)
    resumed = more.init_state()
    resumed.model.load_state_dict(payload["model_state_dict"])
    resumed.optimizer.load_state_dict(payload["optimizer_state_dict"])
    resumed.step = payload["step"]
    more.train(*_loaders(root, cfg, split, seed0=4), epochs=4, state=resumed,
               history_path=history, start_epoch=3)
    h4 = json.load(open(history))
    assert len(h4["loss"]) == 4 and h4["loss"][:3] == h["loss"]
    assert ckpt.latest_step() == 5 and resumed.step == 8


def test_keras_schedule_fast_forwards_on_resume(corpus, tmp_path):
    root, speakers = corpus
    cfg = _cfg(root, tmp_path)
    trainer = LipNetTrainer(cfg, device="cpu", log=Logger(None, console=False))
    trainer.train(*_loaders(root, cfg, split_speakers(speakers)), epochs=62,
                  lr_schedule=keras_lr_schedule, start_epoch=61)
    lr = 1e-3
    for e in range(62):
        lr = keras_lr_schedule(e, lr)
    assert trainer.lr_history == [lr]


def test_early_stopping_restores_the_best_weights(corpus, tmp_path):
    root, speakers = corpus
    cfg = _cfg(root, tmp_path)
    trainer = LipNetTrainer(cfg, device="cpu", log=Logger(None, console=False))
    vals = iter([1.0, 2.0, 3.0, 0.5])
    seen = []

    def validate(state, loader):
        seen.append({k: v.clone() for k, v in state.model.state_dict().items()})
        return next(vals)

    trainer.validate = validate
    state = trainer.train(*_loaders(root, cfg, split_speakers(speakers)), epochs=4,
                          early_stopping_patience=2)
    assert trainer.val_losses == [1.0, 2.0, 3.0]  # stopped after two epochs without gain
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, seen[0][k], rtol=0, atol=0)
    _, meta = CheckpointManager(cfg.train.checkpoint_dir).restore()
    assert meta["metrics"] == {"epochs_completed": 3, "early_stopped": True}


def test_first_epoch_loss_matches_jax_trainer(corpus, tmp_path):
    """Both trainers from the same weights (state=), same corpus, same
    shuffle seed, dropout 0: the epoch's mean train loss agrees to 1e-4
    relative (fp32 sums in another order, over 3 steps of Adam). The JAX
    side runs its XLA path; the port runs with both kernel flags on (their
    plain versions on the CPU): the same function."""
    import jax
    import jax.numpy as jnp

    from avsync.data import GridDataSource as JaxSource
    from avsync.data import LipNetBatcher as JaxBatcher
    from avsync.models import LipNet as JaxLipNet
    from avsync.parallel import make_mesh
    from avsync.train import LipNetTrainer as JaxTrainer
    from avsync.train.lipnet_trainer import TrainState as JaxState
    from avsync.utils.logging import Logger as JaxLogger
    from avsync_torch.compat import lipnet_params_from_jax

    root, speakers = corpus
    train_sp, val_sp, _ = split_speakers(speakers)
    jcfg = JaxConfig(data=JaxDataConfig(data_path=root, **DATA),
                     model=JaxModelConfig(dropout_rate=0.0, **MODEL))
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, learning_rate=1e-3, checkpoint_every=100))
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    jt = JaxTrainer(jcfg, mesh=mesh, log=JaxLogger(None, console=False))
    params = jax.tree.map(np.array, JaxLipNet(jcfg.model).init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 8, 16, 32, 1)))["params"])
    jstate = jt.shard_state(JaxState(params, jt.optimizer.init(params),
                                     jnp.zeros((), jnp.int32)))
    jtrain = JaxBatcher(JaxSource(root, train_sp), jcfg)
    jval = JaxBatcher(JaxSource(root, val_sp), jcfg)
    jt.train(lambda: jtrain.epoch(shuffle=True, seed=1), lambda: jval.epoch(shuffle=False),
             epochs=1, state=jstate, checkpoint_dir=str(tmp_path / "jax_ckpt"))

    cfg = _cfg(root, tmp_path)
    trainer = LipNetTrainer(cfg, device="cpu", log=Logger(None, console=False))
    state = trainer.init_state()
    state.model.load_state_dict(lipnet_params_from_jax(params, conv_shape=(4, 2, 4)))
    trainer.train(*_loaders(root, cfg, (train_sp, val_sp, None)), epochs=1, state=state)
    np.testing.assert_allclose(trainer.train_losses[0], jt.train_losses[0], rtol=1e-4)
    np.testing.assert_allclose(trainer.val_losses[0], jt.val_losses[0], rtol=1e-4)


def test_cli_train_then_both_test_commands_agree(corpus, tmp_path, capsys):
    """`avsync_torch.cli train --device cpu` for one epoch exports a `.pth`;
    the JAX package's `test` and the port's `test --device cpu` on it write
    the same CER/WER JSON."""
    from avsync.cli import main as jax_main
    from avsync_torch.cli import main

    root, _ = corpus
    cfg = _cfg(root, tmp_path)
    port_cfg, jax_cfg = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    open(port_cfg, "w").write(cfg.to_json())
    # the JAX package runs its Pallas GRU only on a TPU or in interpret mode:
    # its test command gets the same model with the kernel flags off
    open(jax_cfg, "w").write(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_pallas_gru=False, fused_conv_pool=False)).to_json())
    pth, ck = str(tmp_path / "lipnet.pth"), str(tmp_path / "ck")
    assert main(["train", "--data_path", root, "--config", port_cfg, "--epochs", "1",
                 "--checkpoint_dir", ck, "--export_pth", pth, "--device", "cpu"]) == 0
    assert {"history.json", "test_results.json", "epoch_2.pth"} <= set(os.listdir(ck))
    out_port, out_jax = str(tmp_path / "port_results.json"), str(tmp_path / "jax_results.json")
    assert main(["test", "--data_path", root, "--config", port_cfg, "--checkpoint", pth,
                 "--output", out_port, "--device", "cpu"]) == 0
    assert jax_main(["test", "--data_path", root, "--config", jax_cfg, "--checkpoint", pth,
                     "--output", out_jax]) == 0
    port_res, jax_res = json.load(open(out_port)), json.load(open(out_jax))
    assert port_res == jax_res and port_res["num_samples"] == 2
    # the port's test also reads its own checkpoint directory (latest snapshot)
    assert main(["test", "--data_path", root, "--config", port_cfg, "--checkpoint", ck,
                 "--output", out_port, "--device", "cpu"]) == 0
    assert json.load(open(out_port)) == jax_res
    assert "Predicted text:" in capsys.readouterr().out


def test_cli_test_refuses_beam_search(corpus, tmp_path):
    """Beam search is ported now: `test --beam 4` no longer refuses the flag
    and goes on to read the checkpoint (tests/test_torch_beam.py holds its
    results against the JAX package's `test --beam 4`)."""
    from avsync_torch.cli import main

    cfg = str(tmp_path / "port.json")
    open(cfg, "w").write(_cfg(corpus[0], tmp_path).to_json())
    with pytest.raises(FileNotFoundError):
        main(["test", "--data_path", corpus[0], "--config", cfg,
              "--checkpoint", str(tmp_path / "missing.pth"), "--beam", "4", "--device", "cpu"])


def test_unported_training_options_raise(corpus, tmp_path):
    # a (2, 1) mesh is ported: over two gloo ranks on the CPU each builds a
    # trainer whose mesh is (2, 1) (tests/test_torch_parallel.py trains on it)
    import sys

    from avsync_torch.parallel import multihost

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_parallel_worker as worker

    multihost.spawn(worker.build_trainers, 2, (str(tmp_path),), device="cpu")
    for r in range(2):
        got = torch.load(str(tmp_path / f"build_{r}.pt"))
        assert got["lipnet"] == (2, 1)
    # the TF vocabulary is ported: its labels equal the JAX package's
    from avsync.data import GridDataSource as JaxSource

    for max_len in (4, 40):
        got = GridDataSource(*corpus).labels_batch([0, 3, 5], max_len, vocab="tf")
        want = JaxSource(*corpus).labels_batch([0, 3, 5], max_len, vocab="tf")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_tensorboard_scalars_per_epoch(corpus, tmp_path):
    from avsync_torch.utils.tb import read_scalars

    root, speakers = corpus
    cfg = _cfg(root, tmp_path, tensorboard=True)
    trainer = LipNetTrainer(cfg, device="cpu", log=Logger(None, console=False))
    trainer.train(*_loaders(root, cfg, split_speakers(speakers)), epochs=2)
    (run,) = os.listdir(cfg.train.log_dir)
    scalars = {}
    for sub in ("train", "validation"):
        (events,) = os.listdir(os.path.join(cfg.train.log_dir, run, sub))
        scalars[sub] = [(e["tag"], e["step"]) for e in
                        read_scalars(os.path.join(cfg.train.log_dir, run, sub, events))
                        if "tag" in e]
    assert scalars["train"] == [("epoch_loss", 1), ("epoch_lr", 1), ("epoch_loss", 2),
                                ("epoch_lr", 2)]
    assert scalars["validation"] == [("epoch_loss", 1), ("epoch_loss", 2)]


def test_sigterm_stops_at_a_batch_boundary_and_snapshots(corpus, tmp_path):
    """A SIGTERM mid-epoch sets a flag only; the loop stops at its next poll,
    skips validation, and the final snapshot says `preempted` and credits
    no epoch."""
    import signal

    root, speakers = corpus
    cfg = _cfg(root, tmp_path)
    trainer = LipNetTrainer(cfg, device="cpu", log=Logger(None, console=False))
    trainer.PREEMPT_CHECK_EVERY = 1
    train_fn, val_fn = _loaders(root, cfg, split_speakers(speakers))

    def preempted_epoch():
        for i, batch in enumerate(train_fn()):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    prev = signal.getsignal(signal.SIGTERM)
    state = trainer.train(preempted_epoch, val_fn, epochs=3)
    assert signal.getsignal(signal.SIGTERM) is prev  # the handler is restored
    assert state.step == 1 and trainer.val_losses == [] and len(trainer.train_losses) == 1
    payload, meta = CheckpointManager(cfg.train.checkpoint_dir).restore()
    assert payload["epoch"] == 2 and meta["metrics"] == {"epochs_completed": 0,
                                                         "preempted": True}
