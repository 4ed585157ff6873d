"""Data- and tensor-parallel training of the port over gloo ranks on the CPU,
against the JAX package's trainers on its 8 virtual CPU devices.

The ranks run in groups that `avsync_torch.parallel.multihost.spawn` starts
(tests/_torch_parallel_worker.py): one two-rank group (DP (2, 1) steps, the
DP epoch program against the DP loop, the detector under DP with a ragged
tail) and one four-rank group (DP (4, 1), TP (2, 2) and (1, 4), the
hierarchical (2, 2, 1), the TF family at (4, 1) and (2, 2)). The inputs are
the tiny LipNet of tests/test_train_parallel.py (hidden 8, conv 2/3/4, 12 x
16 x 32 clips) at dropout 0, its weights drawn by the JAX trainer and carried
over by the weight bridge. Bounds: losses rtol 1e-4 (1e-5 for the detector),
step-1 gradients atol 1e-4 / rtol 1e-3, parameters after 3 steps within
6 * lr (PERF.md §2); replicas and program vs loop bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from avsync.config import AudioConfig as JaxAudioConfig
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DetectorConfig as JaxDetectorConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.config import TrainConfig as JaxTrainConfig
from avsync.models import LipNet as JaxLipNet
from avsync.models.lipnet_tf import TFLipNet as JaxTFLipNet
from avsync.models.lipnet_tf import TFModelConfig as JaxTFModelConfig
from avsync.ops.ctc import ctc_loss_mean as jax_ctc_loss_mean
from avsync.parallel import lipnet_param_spec as jax_param_spec
from avsync.parallel import make_mesh as jax_make_mesh
from avsync.train import LipNetTrainer as JaxTrainer
from avsync.train.detector_trainer import DetectorTrainer as JaxDetectorTrainer
from avsync.utils.logging import Logger as JaxLogger
from avsync_torch import compat
from avsync_torch.config import (AudioConfig, AvsyncConfig, DataConfig, DetectorConfig,
                                 ModelConfig, TrainConfig)
from avsync_torch.models import LipNet, TFLipNet
from avsync_torch.models.lipnet_tf import TFModelConfig
from avsync_torch.ops.conv import fp32_step, train_scope
from avsync_torch.parallel import lipnet_param_spec, multihost
from avsync_torch.train.lipnet_trainer import make_optimizer, train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_worker as worker  # noqa: E402

LR = worker.LR
CONV_SHAPE = (4, 2, 4)  # (C, H, W) after three pools of 16 x 32
JAX_TINY = JaxModelConfig(vocab_size=39, hidden_dim=8, conv_channels=(2, 3, 4),
                          conv_kernels=((3, 5, 5), (3, 5, 5), (3, 3, 3)), dropout_rate=0.0)
QUIET = JaxLogger(None, console=False)
DET_TINY = dict(hidden_dim=4, conv_channels=(2, 2, 3))
DET_CONV_SHAPE = (3, 2, 4)
DET = dict(hidden_dim=16, dropout=0.0, max_shift_frames=5)
# (n_videos, seed, batch size): B=5 pads each batch to 6 rows over the two
# ranks (the per-step path); B=4 runs the program, then a tail of 2
DET_EPOCHS = ((6, 3, 5), (7, 4, 4))


def _jax_cfg(**train):
    return JaxConfig(model=JAX_TINY, train=JaxTrainConfig(learning_rate=LR, seed=7, **train))


def _jax_step_losses(mesh, batch, steps):
    """The JAX trainer's train steps on `mesh`: losses, the initial and the
    final params (numpy)."""
    jt = JaxTrainer(_jax_cfg(), mesh=mesh, log=QUIET)
    state = jt.init_state(batch)
    p0 = jax.tree.map(np.asarray, jax.device_get(state.params))
    losses = []
    for _ in range(steps):
        state, m = jt.compiled["train"](state, jt._device_batch(batch), jt.rng, np.float32(LR))
        losses.append(float(m["loss"]))
    return losses, p0, jax.tree.map(np.asarray, jax.device_get(state.params))


def _jax_grads(params, batch):
    def loss_fn(p):
        lp = JaxLipNet(JAX_TINY).apply({"params": p}, jnp.asarray(batch["video"]), train=False)
        return jax_ctc_loss_mean(lp, jnp.asarray(batch["labels"]),
                                 jnp.asarray(batch["label_lengths"]))
    return jax.tree.map(np.asarray, jax.grad(loss_fn)(params))


def _port(params):
    return compat.lipnet_params_from_jax(params, conv_shape=CONV_SHAPE)


@pytest.fixture(scope="module")
def jax_dp():
    """The JAX (2, 1) run the port's DP run is held to, and its inputs."""
    batch = worker.synth_batch(1)
    losses, p0, p3 = _jax_step_losses(jax_make_mesh((2, 1), devices=jax.devices()[:2]),
                                      batch, 3)
    return {"batch": batch, "losses": losses, "p0": p0, "p3": p3,
            "grads": _jax_grads(p0, batch)}


def _det_cfgs():
    jcfg = JaxConfig(model=JaxModelConfig(**DET_TINY), audio=JaxAudioConfig(max_audio_samples=4000),
                     detector=JaxDetectorConfig(**DET), train=JaxTrainConfig(seed=0))
    cfg = AvsyncConfig(data=DataConfig(img_height=16, img_width=32, max_video_length=6),
                       model=ModelConfig(fused_conv_pool=True, **DET_TINY),
                       audio=AudioConfig(max_audio_samples=4000, use_pallas=True),
                       detector=DetectorConfig(**DET), train=TrainConfig(seed=0))
    return jcfg, cfg


def _det_bank(n=7):
    """A bank of random features, in each package's column order."""
    from avsync.features import FeatureBank as JaxBank

    r = np.random.default_rng(2)
    vis = 2 * int(np.prod(DET_CONV_SHAPE))
    visual = r.normal(size=(n, vis)).astype(np.float32)
    audio = (r.normal(size=(n, 4000)) * 0.3).astype(np.float32)
    lengths = np.full(n, 4000, np.int32)
    fps = np.full(n, 25.0, np.float32)
    perm = compat._detector_column_perm(DET_CONV_SHAPE, 40)
    port_visual = visual[:, np.argsort(perm[:vis])]
    jbank = JaxBank(*(jnp.asarray(a) for a in (visual, audio, lengths, fps)))
    return jbank, (port_visual, audio, lengths, fps)


@pytest.fixture(scope="module")
def jax_detector():
    jcfg, cfg = _det_cfgs()
    jbank, port_bank = _det_bank()
    jt = JaxDetectorTrainer(jcfg, log=QUIET, mesh=jax_make_mesh((2, 1), devices=jax.devices()[:2]))
    state = jt.init_state(int(jbank.visual.shape[1]) + 40)
    params0 = jax.tree.map(np.array, jax.device_get(state.params))
    epochs, params = [], []
    for n, seed, B in DET_EPOCHS:
        state, m = jt.run_epoch(state, jbank, n, seed=seed, batch_size=B)
        epochs.append(m)
        params.append(jax.tree.map(np.asarray, jax.device_get(state.params)))
    return {"params0": params0, "epochs": epochs, "params": params, "port_bank": port_bank,
            "cfg": cfg}


def _load_all(out, name, world):
    return [torch.load(os.path.join(out, f"{name}_{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_dp, jax_detector):
    out = str(tmp_path_factory.mktemp("world2"))
    det = (jax_detector["params0"], jax_detector["port_bank"], jax_detector["cfg"].to_json(),
           DET_EPOCHS)
    multihost.spawn(worker.world2, 2, (out, {"weights": _port(jax_dp["p0"]),
                                             "batch": jax_dp["batch"], "detector": det}),
                    device="cpu")
    return {name: _load_all(out, name, 2) for name in ("dp2", "program", "detector")}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("world4"))
    batch = worker.synth_batch(3)
    weights = LipNet(ModelConfig(**worker.TINY), img_hw=(16, 32),
                     generator=torch.Generator().manual_seed(4)).state_dict()
    tf_cfg = worker.lipnet_config("tf").model
    from avsync_torch.models import make_lipnet

    tf_weights = make_lipnet(tf_cfg, (16, 32), generator=torch.Generator().manual_seed(5)
                             ).state_dict()
    tf_batch = worker.synth_batch(4, vocab=31)
    multihost.spawn(worker.world4, 4, (out, {"weights": weights, "batch": batch,
                                             "tf_weights": tf_weights, "tf_batch": tf_batch}),
                    device="cpu")
    names = ["4x1", "2x2", "1x4", "2x2x1", "tf4x1", "tf2x2"]
    return {name: _load_all(out, name, 4) for name in names}


# ---------------------------------------------------------------------------
# mesh and sharding rules
# ---------------------------------------------------------------------------

def test_mesh_shapes_and_axis_names(world4):
    for name, shape, axes in (("4x1", (4, 1), ("data", "model")),
                              ("2x2", (2, 2), ("data", "model")),
                              ("1x4", (1, 4), ("data", "model")),
                              ("2x2x1", (2, 2, 1), ("slice", "data", "model"))):
        for rank, res in enumerate(world4[name]):
            m = res["mesh"]
            assert m["shape"] == shape and m["axes"] == axes
            model = shape[-1]
            assert (m["data_index"], m["model_index"]) == divmod(rank, model)


def _jax_to_port_names(family):
    """JAX leaf path -> the port's parameter name."""
    rnn = "gru" if family == "pytorch" else "lstm"
    out = {}
    n_rnn = 2 if family == "pytorch" else 3
    for i in range(1, 4):
        out[f"conv{i}/kernel"] = f"conv{i}.weight"
        out[f"conv{i}/bias"] = f"conv{i}.bias"
    for i in range(1, n_rnn + 1):
        for jname, tname in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            out[f"{rnn}{i}/{jname}_fwd"] = f"{rnn}{i}.{tname}_l0"
            out[f"{rnn}{i}/{jname}_bwd"] = f"{rnn}{i}.{tname}_l0_reverse"
    heads = ("fc",) if family == "pytorch" else ("dense1", "dense2", "head")
    for h in heads:
        out[f"{h}/kernel"] = f"{h}.weight"
        out[f"{h}/bias"] = f"{h}.bias"
    return out


@pytest.mark.parametrize("family", ["pytorch", "tf"])
@pytest.mark.parametrize("m", [0, 1, 2, 4])
def test_param_spec_follows_the_jax_rules_in_torch_layout(family, m):
    """Leaf by leaf: a JAX column shard (P(None, 'model') of a (D, 3H)
    kernel, P('model') of a bias) is the port's row shard (dim 0) of the
    same tensor in torch layout; P() is replicated. The one exception is the
    TF head, which the JAX rule names as 'fc' only and so replicates: the
    port shards its 32 rows at m = 2 and 4."""
    if family == "pytorch":
        jmodel = JaxLipNet(JAX_TINY)
        model = LipNet(ModelConfig(**worker.TINY), img_hw=(16, 32))
    else:
        jmodel = JaxTFLipNet(JaxTFModelConfig(hidden_dim=8, conv_channels=(2, 3, 4)))
        model = TFLipNet(TFModelConfig(hidden_dim=8, conv_channels=(2, 3, 4)), img_hw=(16, 32))
    params = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 4, 16, 32, 1))))["params"]
    jspec = jax_param_spec(params, model_axis_size=m)
    spec = lipnet_param_spec(list(model.named_parameters()), m)
    names = _jax_to_port_names(family)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(
                jspec, is_leaf=lambda x: isinstance(x, P))[0]}
    assert set(names) == set(flat) and set(names.values()) == set(spec)
    for jname, jpart in flat.items():
        ours = spec[names[jname]]
        want = 0 if jpart in (P(None, "model"), P("model")) else None
        if family == "tf" and jname.startswith("head/") and m in (0, 2, 4):
            assert jpart == P() and ours == 0, (jname, jpart, ours)
            continue
        assert ours == want, (jname, jpart, ours)
    if family == "pytorch" and m in (2, 4):  # vocab 39: the head stays whole
        assert spec["fc.weight"] is None and spec["gru1.weight_ih_l0"] == 0


# ---------------------------------------------------------------------------
# DP (2, 1) against the JAX trainer
# ---------------------------------------------------------------------------

def test_dp_step_matches_jax(world2, jax_dp):
    a, b = world2["dp2"]
    assert a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses"], jax_dp["losses"], rtol=1e-4)
    want = _port(jax_dp["grads"])
    for name, g in a["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    want = _port(jax_dp["p3"])
    for name, p in a["full"].items():
        diff = (p - want[name]).abs().max().item()
        assert diff <= 6 * LR, (name, diff)


def test_dp_replicas_stay_bit_identical(world2):
    a, b = world2["dp2"]
    assert len(a["per_step"]) == 3
    for pa, pb in zip(a["per_step"], b["per_step"]):
        for name in pa:
            assert torch.equal(pa[name], pb[name]), name


def test_dp_epoch_program_equals_the_dp_loop(world2):
    for res in world2["program"]:
        loop, prog = res["loop"], res["program"]
        assert loop["mean"] == prog["mean"] and loop["step"] == prog["step"] == 4
        for name in loop["params"]:
            assert torch.equal(loop["params"][name], prog["params"][name]), name
            for k in loop["adam"][name]:
                assert torch.equal(loop["adam"][name][k], prog["adam"][name][k]), (name, k)
    a, b = world2["program"]
    for name in a["program"]["params"]:
        assert torch.equal(a["program"]["params"][name], b["program"]["params"][name])


# ---------------------------------------------------------------------------
# DP / TP / hierarchical against each other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["2x2", "1x4", "2x2x1"])
def test_dp_tp_and_hierarchical_meshes_agree(world4, name):
    base = world4["4x1"][0]
    got = world4[name][0]
    np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-4)
    for k, v in base["full"].items():
        diff = (got["full"][k] - v).abs().max().item()
        assert diff <= 6 * LR, (name, k, diff)


def test_tf_family_tensor_parallel_agrees_with_dp(world4):
    base, got = world4["tf4x1"][0], world4["tf2x2"][0]
    assert got["spec"]["head.weight"] == 0 and got["spec"]["lstm1.weight_hh_l0"] == 0
    assert got["spec"]["dense1.weight"] is None
    np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-4)
    for k, v in base["full"].items():
        assert (got["full"][k] - v).abs().max().item() <= 6 * LR, k


@pytest.mark.parametrize("name", ["2x2", "1x4", "tf2x2"])
def test_adam_moments_follow_param_sharding(world4, name):
    """The moments of a sharded leaf have the shard's rows; gathered for a
    checkpoint, the whole tensor's."""
    m = int(name[-1])
    res = world4[name][0]
    names = list(res["moments"])
    sharded = [n for n in names if res["spec"][n] is not None]
    assert sharded
    for i, n in enumerate(names):
        whole = tuple(res["full"][n].shape)
        local = res["moments"][n]
        if res["spec"][n] is None:
            assert local == whole, n
        else:
            assert local == (whole[0] // m, *whole[1:]), n
        assert res["full_moments"][i] == whole, n


@pytest.mark.parametrize("name", ["4x1", "2x2", "1x4", "2x2x1", "tf2x2"])
def test_replicas_bit_identical_after_each_step(world4, name):
    """Every rank of a data group holds the same shard bits after each step,
    and every rank the same replicated leaves."""
    ranks = world4[name]
    spec = ranks[0]["spec"]
    for step in range(2):
        for n in spec:
            for r in ranks[1:]:
                same_shard = r["mesh"]["model_index"] == ranks[0]["mesh"]["model_index"]
                if spec[n] is None or same_shard:
                    assert torch.equal(r["per_step"][step][n], ranks[0]["per_step"][step][n]), \
                        (name, step, n)


# ---------------------------------------------------------------------------
# the detector under DP, ragged tail included
# ---------------------------------------------------------------------------

def test_detector_dp_matches_jax(world2, jax_detector):
    a, b = world2["detector"]
    assert a["step"] == b["step"] == 7
    for ours, theirs in zip(a["epochs"], jax_detector["epochs"]):
        np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-5)
        np.testing.assert_allclose(ours["probs"], theirs["probs"], atol=1e-5)
        np.testing.assert_array_equal(ours["labels"], theirs["labels"])
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    jparams = jax_detector["params"][-1]
    ours = compat.detector_params_to_jax(a["state"], DET_CONV_SHAPE)
    for layer in ("fc1", "fc2"):
        for name in ("kernel", "bias"):
            diff = np.abs(ours[layer][name] - np.asarray(jparams[layer][name])).max()
            # seven Adam steps, each up to 2 lr apart on a rounding-level gradient
            assert diff <= 14 * jax_detector["cfg"].detector.lr, (layer, name, diff)


# ---------------------------------------------------------------------------
# the step scope (deterministic conv backward)
# ---------------------------------------------------------------------------

def test_train_step_sets_the_deterministic_flag_and_restores_it():
    """A train step's backward sees cudnn.deterministic on and benchmark off
    whatever the caller set; both come back after. `fp32_step` alone (the
    serving and export scope) leaves them as they were."""
    model = LipNet(ModelConfig(**worker.TINY), img_hw=(16, 32))
    seen = []

    def hook(mod, inp, out):
        out.register_hook(lambda g: seen.append((torch.backends.cudnn.deterministic,
                                                 torch.backends.cudnn.benchmark)))

    model.conv2.register_forward_hook(hook)
    b = worker.synth_batch(0, B=2)
    batch = {"video": torch.from_numpy(b["video"]), "labels": torch.from_numpy(b["labels"]).long(),
             "label_lengths": torch.from_numpy(b["label_lengths"]).long()}
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        train_step(model, make_optimizer(model.parameters()), batch, 1e-4)
        assert seen == [(True, False)]
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
        with fp32_step():
            assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
        with train_scope():
            assert (cudnn.deterministic, cudnn.benchmark) == (True, False)
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
