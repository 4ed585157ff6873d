"""The trainers' whole-epoch programs (`LipNetTrainer.train_epoch_scanned`,
the detector's train and eval epoch programs) against the JAX package's
scans and against the port's own per-step loops, on the CPU at a tiny width
(hidden 8, conv channels (2, 2, 3), 16x32 crops, T=8).

On the CPU a program runs the same step as an eager loop (on the card it is
replayed from a CUDA graph: chip_smoke.py holds the two against each other
there). Tolerances: against the JAX package, epoch and step losses rtol 1e-4
(tests/test_torch_trainer.py's epoch-loss bound), detector losses rtol 1e-5
and probabilities atol 1e-5 (tests/test_torch_detector.py's); against the
port's own loop, and remat against no remat, equal bits.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import GridDataSource as JaxSource
from avsync.data import LipNetBatcher as JaxBatcher
from avsync.data import synthetic
from avsync.models import LipNet as JaxLipNet
from avsync.train import LipNetTrainer as JaxTrainer
from avsync.train.detector_trainer import DetectorTrainer as JaxDetectorTrainer
from avsync.train.lipnet_trainer import TrainState as JaxState
from avsync.utils.logging import Logger as JaxLogger
from avsync_torch import compat
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.data.grid import GridDataSource
from avsync_torch.data.pipeline import LipNetBatcher
from avsync_torch.features import FeatureBank
from avsync_torch.train.detector_trainer import DetectorTrainer
from avsync_torch.train.lipnet_trainer import LipNetTrainer
from avsync_torch.utils.logging import Logger
from test_torch_detector import CONV_SHAPE as DET_CONV_SHAPE
from test_torch_detector import VIS, _port_visual, _trainer_cfgs, banks, tiny_lipnets  # noqa: F401

QUIET = Logger(None, console=False)
DATA = dict(img_height=16, img_width=32, max_video_length=8, batch_size=2,
            max_label_length=6, device_cache="on")
MODEL = dict(hidden_dim=8, conv_channels=(2, 2, 3))
CONV_SHAPE = (3, 2, 4)  # (C, H, W) after three pools of 16x32


class Steps:
    """A metrics writer that keeps (step, loss, grad_norm) in memory."""

    def __init__(self):
        self.rows = []

    def write(self, step, **m):
        self.rows.append((step, m["loss"], m["grad_norm"]))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("grid"))
    synthetic.write_corpus(root, n_speakers=1, clips_per_speaker=6, n_frames=8, height=16,
                           width=32, seed=17, with_audio=False)
    return root


def _cfg(root, dropout=0.0, remat=False):
    return AvsyncConfig(data=DataConfig(data_path=root, **DATA),
                        model=ModelConfig(dropout_rate=dropout, use_pallas_gru=True,
                                          fused_conv_pool=True, **MODEL),
                        train=TrainConfig(learning_rate=1e-3, seed=7, remat=remat))


def _train(root, cfg, scanned, epochs=2, state_dict=None):
    """`epochs` epochs over the cached corpus, shuffled with seeds 1, 2, ...:
    through the epoch program (`scanned`) or the per-batch loop."""
    batcher = LipNetBatcher(GridDataSource(root), cfg, device="cpu")
    trainer = LipNetTrainer(cfg, device="cpu", log=QUIET)
    state = trainer.init_state()
    if state_dict is not None:
        state.model.load_state_dict(state_dict)
    steps, means = Steps(), []
    for e in range(1, epochs + 1):
        if scanned:
            plan = batcher.scan_plan(shuffle=True, seed=e)
            assert plan is not None
            state, loss = trainer.train_epoch_scanned(state, plan, metrics_writer=steps)
        else:
            state, loss = trainer.train_epoch(state, batcher.epoch(shuffle=True, seed=e),
                                              metrics_writer=steps)
        means.append(loss)
    return state, means, steps.rows


def _assert_same_params(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name


def test_scanned_lipnet_epoch_matches_the_jax_scan(corpus):
    """Same weights (through the bridge), same cache, same plans, dropout 0:
    the JAX package's `train_epoch_scanned` (XLA path) and the port's (both
    kernel flags on: their plain versions here), two epochs."""
    from avsync.parallel import make_mesh

    jcfg = JaxConfig(data=JaxDataConfig(data_path=corpus, **DATA),
                     model=JaxModelConfig(dropout_rate=0.0, **MODEL))
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, learning_rate=1e-3, seed=7, mesh_shape=(1, 1)))
    jt = JaxTrainer(jcfg, mesh=make_mesh((1, 1), devices=jax.devices()[:1]),
                    log=JaxLogger(None, console=False))
    params = jax.tree.map(np.array, JaxLipNet(jcfg.model).init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 8, 16, 32, 1)))["params"])
    jstate = jt.shard_state(JaxState(params, jt.optimizer.init(params),
                                     jnp.zeros((), jnp.int32)))
    jb = JaxBatcher(JaxSource(corpus), jcfg)
    jsteps, jmeans = Steps(), []
    for e in (1, 2):
        jstate, loss = jt.train_epoch_scanned(jstate, jb.scan_plan(shuffle=True, seed=e),
                                              metrics_writer=jsteps)
        jmeans.append(loss)
    state, means, steps = _train(corpus, _cfg(corpus), True,
                                 state_dict=compat.lipnet_params_from_jax(
                                     params, conv_shape=CONV_SHAPE))
    assert [r[0] for r in steps] == [r[0] for r in jsteps.rows] == list(range(1, 7))
    np.testing.assert_allclose(means, jmeans, rtol=1e-4)
    np.testing.assert_allclose([r[1] for r in steps], [r[1] for r in jsteps.rows], rtol=1e-4)
    np.testing.assert_allclose([r[2] for r in steps], [r[2] for r in jsteps.rows], rtol=1e-4)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_scanned_lipnet_epoch_equals_its_own_loop(corpus, dropout):
    """The epoch program and the per-batch loop over the same cached
    batches: equal parameters, step losses, gradient norms and epoch means
    (the counterpart of tests/test_data.py's scan-vs-loop check)."""
    cfg = _cfg(corpus, dropout)
    a, means_a, steps_a = _train(corpus, cfg, True)
    b, means_b, steps_b = _train(corpus, cfg, False)
    assert a.step == b.step == 6
    _assert_same_params(a, b)
    assert steps_a == steps_b and means_a == means_b


@pytest.mark.parametrize("scanned", [True, False], ids=["program", "loop"])
def test_remat_equals_no_remat(corpus, scanned):
    """Dropout 0.5: recomputing the blocks in the backward draws no new
    mask and changes no bit."""
    a, means_a, steps_a = _train(corpus, _cfg(corpus, 0.5, remat=True), scanned)
    b, means_b, steps_b = _train(corpus, _cfg(corpus, 0.5), scanned)
    _assert_same_params(a, b)
    assert steps_a == steps_b and means_a == means_b


def test_train_runs_plans_and_a_resume_continues_them(corpus, tmp_path):
    """`train()` takes a plan from its loader fn; a run of 2 epochs resumed
    for a third equals 3 epochs in one go."""
    from avsync_torch.utils.checkpoint import CheckpointManager

    cfg = _cfg(corpus, 0.5)

    def run(epochs, ckdir, state=None, start=0):
        batcher = LipNetBatcher(GridDataSource(corpus), cfg, device="cpu")
        trainer = LipNetTrainer(cfg, device="cpu", log=QUIET)
        seeds = iter(range(start + 1, 10))
        plans = []

        def source():
            plans.append(batcher.scan_plan(shuffle=True, seed=next(seeds)))
            return plans[-1]

        state = trainer.train(source, lambda: batcher.epoch(shuffle=False, drop_last=False),
                              epochs=epochs, checkpoint_dir=ckdir, state=state,
                              start_epoch=start)
        assert all(p is not None for p in plans)
        return trainer, state

    _, whole = run(3, str(tmp_path / "a"))
    run(2, str(tmp_path / "b"))
    payload, _ = CheckpointManager(str(tmp_path / "b")).restore()
    trainer = LipNetTrainer(cfg, device="cpu", log=QUIET)
    state = trainer.init_state()
    state.model.load_state_dict(payload["model_state_dict"])
    state.optimizer.load_state_dict(payload["optimizer_state_dict"])
    state.step = payload["step"]
    _, resumed = run(3, str(tmp_path / "b"), state=state, start=2)
    assert resumed.step == whole.step == 9
    _assert_same_params(resumed, whole)


# ---------------------------------------------------------------------------
# the detector's train and eval epoch programs
# ---------------------------------------------------------------------------

def _detector_run(bank, cfg, force_loop, epochs=2):
    tr = DetectorTrainer(cfg, device="cpu", log=QUIET)
    tr._force_loop = force_loop
    state = tr.init_state(VIS + 40)
    metrics = []
    for epoch in range(epochs):
        state, m = tr.run_epoch(state, bank, 6, seed=epoch)
        metrics.append(m)
    _, ev = tr.run_epoch(state, bank, 6, seed=99, train=False)
    return state, metrics, ev


@pytest.mark.parametrize("batch_size", [4, 5], ids=["whole_batches", "ragged_tail"])
def test_detector_programs_equal_the_step_loop(banks, batch_size):  # noqa: F811
    """Dropout 0.3, plan of 12: 3 batches of 4, or 2 of 5 and a tail of 2."""
    _, bank, _ = banks
    _, cfg = _trainer_cfgs(batch_size=batch_size, dropout=0.3)
    s_prog, m_prog, e_prog = _detector_run(bank, cfg, False)
    s_loop, m_loop, e_loop = _detector_run(bank, cfg, True)
    assert s_prog.step == s_loop.step == 2 * -(-12 // batch_size)
    _assert_same_params(s_prog, s_loop)
    for a, b in zip(m_prog + [e_prog], m_loop + [e_loop]):
        assert a["loss"] == b["loss"]
        np.testing.assert_array_equal(a["probs"], b["probs"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


@pytest.mark.parametrize("batch_size", [4, 5], ids=["whole_batches", "ragged_tail"])
def test_detector_programs_match_the_jax_scans(banks, batch_size):  # noqa: F811
    """Same weights through the bridge, dropout 0: a train epoch (the JAX
    `train_epoch_scan` plus its tail step) and an eval epoch, losses rtol
    1e-5, probabilities atol 1e-5, parameters within 6 * lr."""
    jbank, _, _ = banks
    bank = FeatureBank(torch.from_numpy(_port_visual(jbank.visual)),
                       *(torch.from_numpy(np.asarray(t)) for t in jbank[1:]))
    jcfg, cfg = _trainer_cfgs(batch_size=batch_size)
    jt = JaxDetectorTrainer(jcfg, log=JaxLogger(None, console=False))
    jstate = jt.init_state(VIS + 40)
    tr = DetectorTrainer(cfg, device="cpu", log=QUIET)
    state = tr.init_state(VIS + 40, params=jax.tree.map(np.array,
                                                        jax.device_get(jstate.params)))
    for train, seed in ((True, 3), (False, 8)):
        jstate, jm = jt.run_epoch(jstate, jbank, 6, seed=seed, train=train)
        state, m = tr.run_epoch(state, bank, 6, seed=seed, train=train)
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["probs"], jm["probs"], atol=1e-5)
        np.testing.assert_array_equal(m["labels"], jm["labels"])
    assert state.step == int(jstate.step) == -(-12 // batch_size)
    ours = compat.detector_params_to_jax(state.model.state_dict(), DET_CONV_SHAPE)
    jparams = jax.device_get(jstate.params)
    for layer in ("fc1", "fc2"):
        for name in ("kernel", "bias"):
            diff = np.abs(ours[layer][name] - np.asarray(jparams[layer][name])).max()
            assert diff <= 6 * cfg.detector.lr, (layer, name, diff)


def test_a_resumed_optimizer_changes_the_fingerprint():
    """A graph bakes in the addresses of the optimizer's state: loading a
    state dict (a resume, an early-stopping restore) gives new tensors, so
    the program captures again."""
    from avsync_torch.train.epoch_program import fingerprint
    from avsync_torch.train.lipnet_trainer import make_optimizer

    w = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([w], 1e-3)
    w.grad = torch.ones(3)
    opt.step()
    before = fingerprint(opt)
    assert before == fingerprint(opt)
    opt.load_state_dict(opt.state_dict())  # the same tensors: the graph still holds
    assert fingerprint(opt) == before
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))  # as a checkpoint restores it
    assert fingerprint(opt) != before
