"""The port's TF-family LipNet under bf16 compute against the JAX package's
TFLipNet with `compute_dtype="bfloat16"`, on the CPU at small widths.

Inputs are numpy draws from a seed handed to both packages; weights cross
through `tflipnet_params_from_jax`. Dropout is 0. Bounds, as
tests/test_torch_bf16.py sets them out: the LSTM in float32 rounding (the
same roundings in the same places); the model's log-probs and gradients no
farther from the JAX bf16 result than twice its own distance from the JAX
float32 result (L2 over each tensor, a gradient leaf's floored at the tree's
relative distance), and nearer the JAX bf16 result than the float32 one;
the loss within the log-probs' elementwise bound carried through the CTC
(the TF loss is the per-sequence NLL, not divided by the label length);
parameters after 3 steps within 6 * lr.

Both packages' `make_lipnet` build the TF stack without the config's compute
dtype (`avsync/models/__init__.py:16-29`, `avsync_torch/models/lipnet_tf.
tf_model_config`), so the TF commands compute in float32 whatever
`--compute_dtype` says; the TFLipNet class computes in bf16 when its own
TFModelConfig asks (`lipnet_tf.py:75-102`). The model tests build the class
in bf16 in both packages. The command tests run the TF commands under
`--compute_dtype bfloat16` in both packages on the fixture's weights as
drawn, and hold them to the float32 bounds: log-probs within 5e-5, the same
JSON and transcripts; `train` with the device cache (bf16 clips in both
packages, read by the float32 model) to the JAX losses within 1e-4
relative over two epochs.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import avsync.cli as jax_cli
from avsync.data import synthetic
from avsync.models.lipnet_tf import TFLipNet as JaxTFLipNet
from avsync.models.lipnet_tf import TFModelConfig as JaxTFModelConfig
from avsync.models.lipnet_tf import tf_ctc_loss as jax_tf_ctc_loss
from avsync.data.pipeline import LipNetBatcher as JaxBatcher
from avsync.ops.lstm import LSTMParams, lstm_scan as jax_lstm_scan
from avsync.train.lipnet_trainer import LipNetTrainer as JaxTrainer
from avsync.train.lipnet_trainer import TrainState as JaxTrainState
from avsync.train.lipnet_trainer import make_optimizer as jax_make_optimizer
from avsync.train.lipnet_trainer import make_train_step
from avsync_torch import cli
from avsync_torch.compat import tflipnet_params_from_jax, tflipnet_params_to_jax
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.data.pipeline import LipNetBatcher
from avsync_torch.models import TFLipNet, make_lipnet
from avsync_torch.models.lipnet_tf import TFModelConfig, tf_ctc_loss
from avsync_torch.ops.lstm import LSTMWeights, bilstm
from avsync_torch.train.lipnet_trainer import make_optimizer, train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_bf16 import _elementwise_bound, _nearer_bf16, _within_twice  # noqa: E402

BF16 = torch.bfloat16
TINY = dict(family="tf", hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0)
CONV_SHAPE = (4, 2, 4)
LR = 1e-3


def test_bf16_bilstm_matches_jax():
    """bf16 x and weight_ih into a float32 projection, h and w_hh rounded in
    each step's product (`avsync/ops/lstm.py:57-75`)."""
    r = np.random.default_rng(0)
    D, H = 12, 6
    x = r.normal(size=(2, 7, D)).astype(np.float32)

    def direction():
        return LSTMParams(*(jnp.asarray((r.normal(size=s) * 0.3).astype(np.float32))
                            for s in ((D, 4 * H), (H, 4 * H), (4 * H,), (4 * H,))))

    pf, pb = direction(), direction()
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.concatenate([np.asarray(jax_lstm_scan(p, xj, reverse=rev,
                                                    compute_dtype=jnp.bfloat16))
                           for p, rev in ((pf, False), (pb, True))], -1)

    def port(p):
        return LSTMWeights(*(torch.from_numpy(np.array(a)) for a in
                             (np.asarray(p.w_ih).T, np.asarray(p.w_hh).T, p.b_ih, p.b_hh)))

    got = bilstm(port(pf), port(pb), torch.from_numpy(x).to(BF16), compute_dtype=BF16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(7)
    x = r.random((2, 6, 16, 32, 1)).astype(np.float32)
    labels = np.asarray([[3, 5, 7, 0], [4, 9, 9, 0]], np.int32)
    params = _jax_model("float32").init(
        {"params": jax.random.PRNGKey(8)}, jnp.asarray(x))["params"]
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.05, np.shape(p))).astype(
        np.float32), params)
    return x, labels, params


def _jax_model(dtype):
    return JaxTFLipNet(JaxTFModelConfig(hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0,
                                        compute_dtype=dtype))


def _port(params, dtype="bfloat16"):
    model = TFLipNet(TFModelConfig(hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0,
                                   compute_dtype=dtype), img_hw=(16, 32))
    model.load_state_dict(tflipnet_params_from_jax(params, CONV_SHAPE))
    return model


def test_bf16_tf_forward_matches_jax(case):
    x, _, params = case
    want16, want32 = (np.asarray(_jax_model(dt).apply({"params": params}, jnp.asarray(x)))
                      for dt in ("bfloat16", "float32"))
    model = _port(params).eval()
    assert isinstance(model, TFLipNet) and model.compute_dtype == BF16
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 6, 32)
    _within_twice(got.numpy(), want16, want32, "log-probs")
    _nearer_bf16(got.numpy(), want16, want32, "log-probs")


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_bf16_tf_train_step_and_three_steps_match_jax(case):
    x, labels, params = case
    batch = {"video": jnp.asarray(x), "labels": jnp.asarray(labels),
             "label_lengths": jnp.asarray((labels != 0).sum(1).astype(np.int32))}
    jopt = jax_make_optimizer(LR, 1.0)

    def jax_run(dtype, steps):
        jm = _jax_model(dtype)
        loss, grads = jax.value_and_grad(lambda p: jax_tf_ctc_loss(
            jm.apply({"params": p}, batch["video"]), batch["labels"]))(params)
        step_fn = jax.jit(make_train_step(jm, jopt,
                                          loss_fn_impl=lambda lp, lab, _: jax_tf_ctc_loss(lp, lab)))
        state = JaxTrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
        losses = []
        for _ in range(steps):
            state, m = step_fn(state, batch, jax.random.PRNGKey(1), jnp.float32(LR))
            losses.append(float(m["loss"]))
        return (float(loss), jax.tree.map(np.asarray, grads), losses,
                jax.tree.map(np.asarray, state.params),
                np.asarray(jm.apply({"params": params}, batch["video"])))

    loss16, g16, losses16, p16, lp16 = jax_run("bfloat16", 3)
    loss32, g32, _, _, lp32 = jax_run("float32", 0)
    model = _port(params)
    tb = {"video": torch.from_numpy(x), "labels": torch.from_numpy(labels).long(),
          "label_lengths": torch.from_numpy((labels != 0).sum(1)).long()}
    loss = tf_ctc_loss(model(tb["video"]), tb["labels"])
    loss.backward()
    # the per-sequence NLL moves at most T times the largest log-prob change
    assert abs(loss.item() - loss16) <= x.shape[1] * _elementwise_bound(lp16, lp32)
    grads = _leaves(tflipnet_params_to_jax({n: p.grad for n, p in model.named_parameters()},
                                           CONV_SHAPE))
    want16, want32 = _leaves(g16), _leaves(g32)
    assert set(grads) == set(want16)
    flat = [np.concatenate([d[k].ravel() for k in sorted(grads)]) for d in (grads, want16, want32)]
    _nearer_bf16(*flat, "gradients")
    rel = np.linalg.norm(flat[1] - flat[2]) / np.linalg.norm(flat[2])
    for name in grads:
        _within_twice(grads[name], want16[name], want32[name], name,
                      floor=rel * float(np.linalg.norm(want32[name])))

    model = _port(params)
    opt = make_optimizer(model.parameters(), LR)
    for i in range(3):
        step_loss, _ = train_step(model, opt, tb, LR)
        np.testing.assert_allclose(step_loss.item(), losses16[i], rtol=2e-2)
    after = _leaves(tflipnet_params_to_jax(model.state_dict(), CONV_SHAPE))
    for name, want in _leaves(p16).items():
        assert after[name].dtype == np.float32
        assert np.abs(after[name] - want).max() <= 6 * LR, name


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

DATA = dict(img_height=16, img_width=32, max_video_length=8, batch_size=2,
            standardize_clips=True, device_cache="off")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A corpus, a TF config file and TF weights as the JAX init draws them,
    as JAX params and as a port snapshot."""
    from avsync_torch.utils.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("tf_bf16_cli")
    data = str(root / "grid")
    synthetic.write_corpus(data, n_speakers=3, clips_per_speaker=2, n_frames=8, height=16,
                           width=32, seed=17, with_audio=False)
    cfg = AvsyncConfig(data=DataConfig(**DATA), model=ModelConfig(**TINY),
                       train=TrainConfig(learning_rate=1e-3))
    cfg_path = str(root / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    params = jax.tree.map(np.asarray, _jax_model("float32").init(
        {"params": jax.random.PRNGKey(4)}, jnp.zeros((1, 8, 16, 32, 1)))["params"])
    ck = str(root / "ck")
    CheckpointManager(ck).save(1, tflipnet_params_from_jax(params, CONV_SHAPE), config=cfg)
    clip = sorted(os.path.join(dp, n) for dp, _, ns in os.walk(data) for n in ns
                  if n.endswith(".npy"))[0]
    return {"root": root, "data": data, "cfg_path": cfg_path, "params": params, "ck": ck,
            "clip": clip}


@pytest.fixture
def jax_weights(tiny, monkeypatch):
    """The JAX package reads TF weights only from Orbax: its loader hands back
    the fixture's weights."""
    monkeypatch.setattr(jax_cli, "_load_lipnet_params",
                        lambda checkpoint, model, cfg=None: jax.tree.map(jnp.asarray,
                                                                         tiny["params"]))


def _common(tiny):
    return ["--data_path", tiny["data"], "--config", tiny["cfg_path"], "--model_family", "tf",
            "--compute_dtype", "bfloat16"]


def _decoded_log_probs(monkeypatch):
    """Wrap both packages' TF decode: the log-probs each command decodes, as
    float32 arrays, (port's, JAX's)."""
    import avsync.text as jax_text
    import avsync_torch.text as port_text

    seen = ([], [])
    for module, out in zip((port_text, jax_text), seen):
        def decode(log_probs, beam_width=0, real=module.tf_decode_batch, out=out):
            lp = log_probs.float().cpu().numpy() if torch.is_tensor(log_probs) else log_probs
            out.append(np.asarray(lp, np.float32))
            return real(log_probs, beam_width=beam_width)

        monkeypatch.setattr(module, "tf_decode_batch", decode)
    return seen


def _float32_bound(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for got, want in zip(ours, theirs):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_train_in_bf16_writes_a_tf_snapshot(tiny, tmp_path, monkeypatch):
    """`train --model_family tf --compute_dtype bfloat16 --device_cache on`,
    two epochs, in both packages from the same weights (the port's drawn from
    the seed, handed to the JAX trainer's init through the bridge): both cache
    bf16 clips that their float32 model reads, and the losses agree within
    1e-4 relative, epoch 2 included. The snapshot's config keeps bfloat16 and
    its weights are float32."""
    from avsync.cli import main as jax_main
    from avsync_torch.utils.checkpoint import CheckpointManager

    cache_dtypes = ([], [])
    for cls, out in zip((LipNetBatcher, JaxBatcher), cache_dtypes):
        def warm(self, real=cls.warm_device_cache, out=out):
            real(self)
            if self._device_cache is not None:
                out.append(self._device_cache["dtype"])

        monkeypatch.setattr(cls, "warm_device_cache", warm)
    argv = ["train", *_common(tiny), "--epochs", "2", "--device_cache", "on"]
    ck = str(tmp_path / "ck")
    assert cli.main([*argv, "--checkpoint_dir", ck, "--device", "cpu"]) == 0
    payload, meta = CheckpointManager(ck).restore()
    assert meta["config"]["model"]["compute_dtype"] == "bfloat16"
    assert all(v.dtype == torch.float32 for v in payload["model_state_dict"].values())
    hist = json.load(open(os.path.join(ck, "history.json")))

    cfg = cli._config_from_args(cli.build_parser().parse_args(argv))
    model = make_lipnet(cfg.model, (16, 32),
                        generator=torch.Generator().manual_seed(cfg.train.seed))
    assert model.compute_dtype is None
    params = tflipnet_params_to_jax(model.state_dict(), CONV_SHAPE)

    def same_init(self, sample_batch):
        p = jax.tree.map(jnp.asarray, params)
        return self.shard_state(JaxTrainState(p, self.optimizer.init(p),
                                              jnp.zeros((), jnp.int32)))

    monkeypatch.setattr(JaxTrainer, "init_state", same_init)
    jck = str(tmp_path / "jck")
    assert jax_main([*argv, "--checkpoint_dir", jck]) == 0
    jhist = json.load(open(os.path.join(jck, "history.json")))
    assert len(hist["loss"]) == len(jhist["loss"]) == 2
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    np.testing.assert_allclose(hist["val_loss"], jhist["val_loss"], rtol=1e-4)
    assert cache_dtypes[0] and set(cache_dtypes[0]) == set(cache_dtypes[1]) == {"bfloat16"}


def test_test_and_infer_in_bf16_equal_the_jax_package(tiny, jax_weights, tmp_path, capsys,
                                                      monkeypatch):
    ours_lp, theirs_lp = _decoded_log_probs(monkeypatch)
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    assert cli.main(["test", *_common(tiny), "--checkpoint", tiny["ck"], "--output", ours,
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["test", *_common(tiny), "--checkpoint", tiny["ck"],
                         "--output", theirs]) == 0
    with open(ours) as f, open(theirs) as g:
        assert json.load(f) == json.load(g)
    _float32_bound(ours_lp, theirs_lp)
    del ours_lp[:], theirs_lp[:]
    capsys.readouterr()
    assert cli.main(["infer", tiny["clip"], "--checkpoint", tiny["ck"], *_common(tiny)[2:],
                     "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert jax_cli.main(["infer", tiny["clip"], "--checkpoint", tiny["ck"],
                         *_common(tiny)[2:]]) == 0
    jax_out = capsys.readouterr().out
    pick = [ln for ln in port_out.splitlines() if ln.startswith("Predicted:")]
    assert pick and pick == [ln for ln in jax_out.splitlines() if ln.startswith("Predicted:")]
    _float32_bound(ours_lp, theirs_lp)


def test_export_in_bf16_equals_the_live_reader(tiny, jax_weights, tmp_path):
    """The artifact `export --compute_dtype bfloat16` writes for the TF family
    is the live reader's float32 function, and within the float32 bound of
    the JAX LipReader on the command line's config."""
    from avsync.predictor import LipReader as JaxLipReader
    from avsync_torch.export import load_exported
    from avsync_torch.predictor import LipReader

    out = str(tmp_path / "tf_bf16.zip")
    argv = ["export", "--checkpoint", tiny["ck"], *_common(tiny)[2:]]
    assert cli.main([*argv, "--device", "cpu", "--out", out]) == 0
    art = load_exported(out)
    cfg = cli._serving_config(cli.build_parser().parse_args(argv))
    assert cfg.model.compute_dtype == "bfloat16"
    reader = LipReader(tiny["ck"], config=cfg, device="cpu")
    assert reader.model.compute_dtype is None
    frames = np.random.default_rng(3).integers(0, 256, (3, 8, 16, 32), dtype=np.uint8)
    want = reader._logprobs(reader.preprocess_device(frames)).numpy()
    _, _, lp = art.call(frames)
    np.testing.assert_allclose(lp, want, rtol=0, atol=1e-6)
    jreader = JaxLipReader("weights", jax_cli._config_from_args(
        jax_cli.build_parser().parse_args(argv)))
    jlp = np.asarray(jreader._logprobs(jnp.concatenate([jreader._prepare(c) for c in frames])))
    _float32_bound([lp], [jlp])
    assert art.transcribe(frames) == jreader._decode(jlp)
