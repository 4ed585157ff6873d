"""The port's misalignment detector, features, metrics and trainer against the
JAX package's, on the same numpy inputs and weights (tiny LipNet conv stack
on 16x32 crops, so the visual statistics are 2 * 3*2*4 = 48 wide).

The JAX package orders the visual statistics (H, W, C), the port (C, H, W):
banks are compared through that permutation, and detector weights cross the
bridge (`compat.detector_params_from_jax`), which permutes fc1's columns.
Tolerances are stated at each test.
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync import compat as jcompat
from avsync.config import AudioConfig as JaxAudioConfig
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DetectorConfig as JaxDetectorConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.config import TrainConfig as JaxTrainConfig
from avsync.eval import auroc as jauroc
from avsync.eval import binary_accuracy as jaccuracy
from avsync.eval import roc_curve as jroc_curve
from avsync.features import build_feature_bank as jax_build_bank
from avsync.features import sample_shift_labels as jax_sample
from avsync.features import visual_stats_fn
from avsync.models import LipNet as JaxLipNet
from avsync.models import MisalignmentDetector as JaxDetector
from avsync.train.detector_trainer import DetectorTrainer as JaxTrainer
from avsync.utils.logging import Logger as JaxLogger
from avsync_torch import compat
from avsync_torch.config import (AudioConfig, AvsyncConfig, DataConfig, DetectorConfig,
                                 ModelConfig, TrainConfig)
from avsync_torch.eval import auroc, binary_accuracy, roc_curve
from avsync_torch.features import (FeatureBank, build_feature_bank, gather_features,
                                   load_feature_bank, sample_shift_labels, save_feature_bank,
                                   visual_stats)
from avsync_torch.models import LipNet, MisalignmentDetector
from avsync_torch.ops import audio_ref
from avsync_torch.train.detector_trainer import DetectorTrainer, detector_train_step
from avsync_torch.utils.logging import Logger

TINY = dict(hidden_dim=4, conv_channels=(2, 2, 3))
CONV_SHAPE = (3, 2, 4)  # (C, H, W) after three pools of 16x32
VIS = 2 * 24
QUIET = Logger(None, console=False)


def _jax_cols(conv_shape):
    """p with jax_cols = port_cols[p] over [mean | std | audio]."""
    return compat._detector_column_perm(conv_shape, 40)


def _port_visual(jax_visual, conv_shape=CONV_SHAPE):
    vis = 2 * int(np.prod(conv_shape))
    return np.asarray(jax_visual)[:, np.argsort(_jax_cols(conv_shape)[:vis])]


@pytest.fixture(scope="module")
def tiny_lipnets():
    """JAX TINY LipNet params and the port's LipNet holding the same weights."""
    params = JaxLipNet(JaxModelConfig(**TINY)).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 6, 16, 32, 1)))["params"]
    params = jax.tree.map(np.asarray, params)
    model = LipNet(ModelConfig(fused_conv_pool=True, **TINY), img_hw=(16, 32))
    model.load_state_dict(compat.lipnet_params_from_jax(params, conv_shape=CONV_SHAPE))
    return params, model.eval()


def _audio_list(n):
    return [(np.sin(np.linspace(0, 50 + 10 * i, 3200)) * 0.5).astype(np.float32)
            for i in range(n)]


@pytest.fixture(scope="module")
def banks(tiny_lipnets):
    """The same six clips' bank from both packages (JAX XLA audio path)."""
    params, model = tiny_lipnets
    clips = np.random.default_rng(1).random((6, 6, 16, 32, 1)).astype(np.float32)
    jcfg = JaxConfig(model=JaxModelConfig(**TINY), audio=JaxAudioConfig(max_audio_samples=4000))
    jbank = jax_build_bank(JaxLipNet(jcfg.model), params,
                           [jnp.asarray(clips[i:i + 3]) for i in (0, 3)], _audio_list(6),
                           [25.0] * 6, jcfg)
    cfg = AvsyncConfig(model=ModelConfig(fused_conv_pool=True, **TINY),
                       audio=AudioConfig(max_audio_samples=4000, use_pallas=True))
    bank = build_feature_bank(model, [torch.from_numpy(clips[i:i + 4]) for i in (0, 4)],
                              _audio_list(6), [25.0] * 6, cfg)
    return jbank, bank, cfg


# ---------------------------------------------------------------------------
# model and weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conv_shape,hidden", [(CONV_SHAPE, 16), ((96, 6, 12), 256)],
                         ids=["tiny", "full_width"])
def test_logits_match_jax_through_the_bridge(conv_shape, hidden):
    """fp32 dot products of up to 13,864 terms: atol 1e-5, rtol 1e-5."""
    dim = 2 * int(np.prod(conv_shape)) + 40
    det = JaxDetector(hidden_dim=hidden)
    params = jax.tree.map(np.asarray, det.init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, dim)))["params"])
    x_jax = np.random.default_rng(0).standard_normal((5, dim)).astype(np.float32)
    want = np.asarray(det.apply({"params": params}, jnp.asarray(x_jax)))
    model = MisalignmentDetector(dim, hidden)
    model.load_state_dict(compat.detector_params_from_jax(params, conv_shape))
    x_port = torch.from_numpy(x_jax[:, np.argsort(_jax_cols(conv_shape))])
    with torch.no_grad():
        got = model(x_port).numpy()
    assert got.shape == (5,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert set(model.state_dict()) == {"classifier.0.weight", "classifier.0.bias",
                                       "classifier.3.weight", "classifier.3.bias"}


def test_pth_round_trips_both_ways_with_the_jax_package(tmp_path):
    det = JaxDetector(hidden_dim=16)
    params = jax.tree.map(np.asarray, det.init({"params": jax.random.PRNGKey(2)},
                                               jnp.zeros((1, VIS + 40)))["params"])
    cfg = {"sample_rate": 16000, "n_mfcc": 20, "max_shift_frames": 15}
    jax_path, port_path = str(tmp_path / "jax.pth"), str(tmp_path / "port.pth")
    jcompat.save_detector_pth(params, jax_path, VIS + 40, 16, cfg, conv_shape=CONV_SHAPE)
    state, meta = compat.load_detector_pth(jax_path)
    assert meta == {"input_dim": VIS + 40, "hidden_dim": 16, "config": cfg}
    bridged = compat.detector_params_from_jax(params, CONV_SHAPE)
    flax_to_torch = jcompat.detector_flax_to_torch(params, CONV_SHAPE)
    for k, v in bridged.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
        np.testing.assert_array_equal(v.numpy(), flax_to_torch[k])
    compat.save_detector_pth(state, port_path, VIS + 40, 16, cfg)
    back, back_meta = jcompat.load_detector_pth(port_path, conv_shape=CONV_SHAPE)
    assert back_meta == meta
    to_jax = compat.detector_params_to_jax(state, CONV_SHAPE)
    for layer in ("fc1", "fc2"):
        for name in ("kernel", "bias"):
            np.testing.assert_array_equal(back[layer][name], params[layer][name])
            np.testing.assert_array_equal(to_jax[layer][name], params[layer][name])


def test_dropout_draws_from_the_generator_it_is_given():
    model = MisalignmentDetector(10, 8, dropout=0.5, generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 10)
    a = model(x, train=True, generator=torch.Generator().manual_seed(3))
    b = model(x, train=True, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def test_visual_stats_match_jax(tiny_lipnets):
    """atol 1e-5, rtol 1e-4, as tests/test_misalignment.py:46."""
    params, model = tiny_lipnets
    clips = np.random.default_rng(0).random((2, 6, 16, 32, 1)).astype(np.float32)
    want = np.asarray(visual_stats_fn(JaxLipNet(JaxModelConfig(**TINY)))(params,
                                                                         jnp.asarray(clips)))
    with torch.no_grad():
        got = visual_stats(model, torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(got, _port_visual(want), atol=1e-5, rtol=1e-4)
    emb = model.conv_features(torch.from_numpy(clips)).detach()
    ref = torch.cat([emb.mean(dim=1), emb.std(dim=1)], dim=-1)  # torch's own N-1 std
    torch.testing.assert_close(torch.from_numpy(got), ref, atol=1e-5, rtol=1e-4)


def test_banks_agree_with_the_jax_package(banks):
    jbank, bank, _ = banks
    np.testing.assert_allclose(bank.visual.numpy(), _port_visual(jbank.visual), atol=1e-5,
                               rtol=1e-4)
    for name in ("audio", "audio_lengths", "fps"):
        np.testing.assert_array_equal(getattr(bank, name).numpy(),
                                      np.asarray(getattr(jbank, name)))


def test_gather_at_shift_zero_matches_the_oracle(banks):
    """rtol 5e-5, atol 5e-4, as tests/test_misalignment.py:117."""
    _, bank, cfg = banks
    feats = gather_features(bank, torch.tensor([2]), torch.tensor([0]), cfg.audio)[0].numpy()
    n = int(bank.audio_lengths[2])
    ref = audio_ref.audio_stats(bank.audio[2, :n].numpy().astype(np.float64), 16000, 20)
    np.testing.assert_allclose(feats[-40:], ref, rtol=5e-5, atol=5e-4)
    np.testing.assert_array_equal(feats[:VIS], bank.visual[2].numpy())


def test_gather_matches_jax_at_any_shift(banks):
    """Same (clip, shift) pairs: audio statistics rtol 1e-5 / atol 1e-4."""
    jbank, bank, cfg = banks
    from avsync.features import gather_features as jax_gather

    vi, sh = np.array([0, 0, 3, 5], np.int32), np.array([0, 5, -5, 15], np.int32)
    want = np.asarray(jax_gather(jbank, jnp.asarray(vi), jnp.asarray(sh),
                                 JaxAudioConfig(max_audio_samples=4000)))
    got = gather_features(bank, torch.from_numpy(vi), torch.from_numpy(sh), cfg.audio).numpy()
    np.testing.assert_allclose(got[:, VIS:], want[:, VIS:], rtol=1e-5, atol=1e-4)
    assert not np.allclose(got[0, VIS:], got[1, VIS:])


def test_bank_save_load_round_trip(banks, tmp_path):
    _, bank, _ = banks
    path = str(tmp_path / "bank.npz")
    save_feature_bank(path, bank, "key-1")
    back = load_feature_bank(path, "key-1")
    for a, b in zip(back, bank):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert load_feature_bank(path, "key-2") is None
    open(path, "wb").write(b"not a zip")
    assert load_feature_bank(path, "key-1") is None


@pytest.mark.parametrize("args", [(10, 15, 1, False), (10, 15, 1, True), (8, 10, 2, True)])
def test_sample_shift_labels_are_the_jax_packages(args):
    n, max_shift, negs, shuffle = args
    got = sample_shift_labels(n, max_shift, negs, np.random.default_rng(5), shuffle=shuffle)
    want = jax_sample(n, max_shift, negs, np.random.default_rng(5), shuffle=shuffle)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_match_jax_with_ties():
    rng = np.random.default_rng(0)
    labels = (rng.random(200) > 0.4).astype(np.float32)
    scores = np.round(rng.random(200) * 8) / 8  # heavy ties, and scores of exactly 0.5
    assert auroc(labels, scores) == pytest.approx(
        float(jauroc(jnp.asarray(labels), jnp.asarray(scores))), abs=1e-6)
    assert binary_accuracy(labels, scores) == pytest.approx(
        float(jaccuracy(jnp.asarray(labels), jnp.asarray(scores))), abs=1e-6)
    assert np.isnan(auroc(np.ones(5), scores[:5])) and np.isnan(float(jauroc(
        jnp.ones(5), jnp.asarray(scores[:5]))))
    for g, w in zip(roc_curve(labels, scores), jroc_curve(labels, scores)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _trainer_cfgs(**det):
    det = {**dict(hidden_dim=16, dropout=0.0, batch_size=4, max_shift_frames=5), **det}
    jcfg = JaxConfig(model=JaxModelConfig(**TINY), audio=JaxAudioConfig(max_audio_samples=4000),
                     detector=JaxDetectorConfig(**det), train=JaxTrainConfig(seed=0))
    cfg = AvsyncConfig(data=DataConfig(img_height=16, img_width=32, max_video_length=6),
                       model=ModelConfig(fused_conv_pool=True, **TINY),
                       audio=AudioConfig(max_audio_samples=4000, use_pallas=True),
                       detector=DetectorConfig(**det), train=TrainConfig(seed=0))
    return jcfg, cfg


def test_train_steps_match_jax_from_the_same_weights(banks):
    """Dropout 0, three Adam+L2 steps on the same batches: per-step loss
    rtol 1e-5; parameters after 3 steps within 6*lr (Adam moves an element
    whose gradient is at rounding level by up to 2*lr a step); the eval
    epoch after them: loss rtol 1e-5, probabilities atol 1e-5."""
    jbank, _, _ = banks
    bank = FeatureBank(torch.from_numpy(_port_visual(jbank.visual)),
                       *(torch.from_numpy(np.asarray(t)) for t in jbank[1:]))
    jcfg, cfg = _trainer_cfgs()
    jt = JaxTrainer(jcfg, log=JaxLogger(None, console=False))
    dim = VIS + 40
    jstate = jt.init_state(dim)
    params0 = jax.tree.map(np.array, jax.device_get(jstate.params))
    tr = DetectorTrainer(cfg, device="cpu", log=QUIET)
    state = tr.init_state(dim, params=params0)
    vi, sh, lb = sample_shift_labels(6, 5, 1, np.random.default_rng(3))
    w = np.ones(4, np.float32)
    lr = cfg.detector.lr
    for i in range(0, 12, 4):
        jstate, jloss, jprobs = jt.steps["train"](jstate, jbank, *(jnp.asarray(a[i:i + 4]) for a in
                                                                   (vi, sh, lb)),
                                                  jnp.asarray(w), jt.rng)
        loss, probs = detector_train_step(state.model, state.optimizer, bank,
                                          *(torch.from_numpy(a[i:i + 4]) for a in (vi, sh, lb)),
                                          torch.from_numpy(w), cfg.audio)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
    jparams = jax.device_get(jstate.params)
    ours = compat.detector_params_to_jax(state.model.state_dict(), CONV_SHAPE)
    for layer in ("fc1", "fc2"):
        for name in ("kernel", "bias"):
            diff = np.abs(ours[layer][name] - np.asarray(jparams[layer][name])).max()
            assert diff <= 6 * lr, (layer, name, diff)
    state = tr.init_state(dim, params=jax.tree.map(np.asarray, jparams))
    _, ours_m = tr.run_epoch(state, bank, 6, seed=7, train=False)
    _, jax_m = jt.run_epoch(jstate, jbank, 6, seed=7, train=False)
    np.testing.assert_allclose(ours_m["loss"], jax_m["loss"], rtol=1e-5)
    np.testing.assert_allclose(ours_m["probs"], jax_m["probs"], atol=1e-5)
    np.testing.assert_array_equal(ours_m["labels"], jax_m["labels"])


def test_run_epoch_takes_the_ragged_tail_and_counts_steps(banks):
    _, bank, _ = banks
    _, cfg = _trainer_cfgs(batch_size=5)
    tr = DetectorTrainer(cfg, device="cpu", log=QUIET)
    state, m = tr.run_epoch(tr.init_state(VIS + 40), bank, 6, seed=3)
    assert state.step == 3 and len(m["probs"]) == len(m["labels"]) == 12  # 5 + 5 + 2
    assert np.isfinite(m["loss"]) and 0.0 <= m["acc"] <= 1.0


def _scripted(trainer, calls, signal_at=None):
    def run_epoch(state, bank, n_videos, seed, train=True, batch_size=None):
        if train:
            calls["train"] += 1
            with torch.no_grad():  # a distinguishable weight per epoch
                for p in state.model.parameters():
                    p.fill_(calls["train"])
            if calls["train"] == signal_at:
                os.kill(os.getpid(), signal.SIGTERM)
        else:
            calls["val"] += 1
        return state, {"loss": 0.0, "acc": 1.0, "auc": 1.0, "labels": np.ones(2),
                       "probs": np.ones(2)}
    trainer.run_epoch = run_epoch


def test_val_auc_ties_select_the_latest_epoch():
    """Saturated val AUC every epoch: the restored weights are epoch 4's."""
    _, cfg = _trainer_cfgs()
    trainer = DetectorTrainer(cfg, device="cpu", log=QUIET)
    calls = {"train": 0, "val": 0}
    _scripted(trainer, calls)
    bank = FeatureBank(torch.zeros(2, 2), torch.zeros(2, 1), torch.zeros(2), torch.zeros(2))
    state, summary = trainer.train(bank, 2, bank, 2, epochs=4)
    assert float(next(state.model.parameters()).flatten()[0]) == 4.0
    assert summary["best_val_auc"] == 1.0


def test_sigterm_snapshots_and_stops():
    """A SIGTERM during epoch 2's training pass: no validation for it, a
    snapshot through save_fn, the previous handler restored."""
    _, cfg = _trainer_cfgs()
    trainer = DetectorTrainer(cfg, device="cpu", log=QUIET)
    calls = {"train": 0, "val": 0}
    _scripted(trainer, calls, signal_at=2)
    before = signal.getsignal(signal.SIGTERM)
    bank = FeatureBank(torch.zeros(2, 2), torch.zeros(2, 1), torch.zeros(2), torch.zeros(2))
    saves = []
    trainer.train(bank, 2, bank, 2, epochs=30, save_fn=lambda st, ep: saves.append(ep))
    assert calls == {"train": 2, "val": 1} and saves == [2]
    assert signal.getsignal(signal.SIGTERM) == before


def test_a_mesh_raises(tmp_path):
    """A (2, 1) mesh no longer raises: over two gloo ranks on the CPU each
    rank's detector trainer takes the mesh, its data index and a gradient
    reducer (tests/test_torch_parallel.py trains it against the JAX
    trainer)."""
    import sys

    from avsync_torch.parallel import multihost

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_parallel_worker as worker

    multihost.spawn(worker.build_trainers, 2, (str(tmp_path),), device="cpu")
    for r in range(2):
        got = torch.load(str(tmp_path / f"build_{r}.pt"))
        assert got["detector"] == (2, 1) and got["data_index"] == r and got["reducer"]


def test_training_learns_synthetic_misalignment(tmp_path):
    """As tests/test_misalignment.py:192-246 on the port: a bank from the
    random-init frozen conv stack + the synthetic corpus's correlated audio;
    the detector reaches val AUROC > 0.8 on held-out clips."""
    from avsync.data import synthetic
    from avsync_torch.data.grid import GridDataSource
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.data.video import get_video_fps, load_audio_for_video

    root = str(tmp_path / "grid")
    synthetic.write_corpus(root, n_speakers=2, clips_per_speaker=10, n_frames=12, height=16,
                           width=32, seed=7)
    cfg = AvsyncConfig(
        data=DataConfig(data_path=root, img_height=16, img_width=32, max_video_length=12,
                        batch_size=4),
        model=ModelConfig(fused_conv_pool=True, **TINY),
        audio=AudioConfig(max_audio_samples=8000, use_pallas=True),
        detector=DetectorConfig(hidden_dim=16, max_shift_frames=8, batch_size=8, epochs=12),
        train=TrainConfig(seed=0))
    src = GridDataSource(root)
    assert len(src) == 20
    model = LipNet(cfg.model, img_hw=(16, 32), generator=torch.Generator().manual_seed(3)).eval()
    audio_list, fps_list = [], []
    for s in src.samples:
        a, sr = load_audio_for_video(s.video_path)
        assert sr == 16000 and len(a) > 0
        audio_list.append(a)
        fps_list.append(get_video_fps(s.video_path))
    bank = build_feature_bank(model, LipNetBatcher(src, cfg, device="cpu").epoch(
        shuffle=False, drop_last=False), audio_list, fps_list, cfg)
    train_bank = FeatureBank(*(t[:14] for t in bank))
    val_bank = FeatureBank(*(t[14:] for t in bank))
    trainer = DetectorTrainer(cfg, device="cpu", log=QUIET)
    state, summary = trainer.train(train_bank, 14, val_bank, 6)
    assert summary["best_val_auc"] > 0.8, summary
    assert state.step == 12 * 4  # 28 plan entries a epoch in batches of 8
