"""The port's TF-family LipNet (`avsync_torch/models/lipnet_tf.py`), its loss,
its vocabulary and decode, its weight bridge and its training step against
the JAX package's (`avsync/models/lipnet_tf.py`, `avsync/text.py`,
`avsync/train/lipnet_trainer.py`) on the same numpy weights and inputs, on
the CPU at small widths.

Bounds: log-probs atol 5e-5 (the serving bound, tests/test_model_parity.py);
the loss and its gradient rtol 1e-5 (tests/test_torch_ctc.py's bound); beam
prefixes equal and scores rtol 1e-12 (host numpy in both); three train steps
as tests/test_torch_train.py holds the PyTorch family: loss rtol 1e-4,
step-1 gradients atol 1e-4 / rtol 1e-3, parameters within 6 lr.

A sequence with no CTC alignment (more labels than frames) keeps its loss in
the TF family, of order 1e5 (optax's log(0) stand-in). Its float32 gradient
carries ~1e-3 of rounding in both packages (the loss's ulp is 0.0078), so
that gradient is held to the JAX package's in float64 (rtol 1e-5), and in
float32 to within twice the JAX package's own float32 error.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from avsync import text as jtext
from avsync.config import ModelConfig as JaxModelConfig
from avsync.models import make_lipnet as jax_make_lipnet
from avsync.models.lipnet_tf import TFLipNet as JaxTFLipNet
from avsync.models.lipnet_tf import TFModelConfig as JaxTFModelConfig
from avsync.models.lipnet_tf import tf_ctc_loss as jax_tf_ctc_loss
from avsync.ops import beam as jax_beam
from avsync.train.lipnet_trainer import TrainState as JaxTrainState
from avsync.train.lipnet_trainer import make_optimizer as jax_make_optimizer
from avsync.train.lipnet_trainer import make_train_step
from avsync_torch import text
from avsync_torch.compat import tflipnet_params_from_jax, tflipnet_params_to_jax
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.models import LipNet, TFLipNet, make_lipnet
from avsync_torch.models.lipnet_tf import TFModelConfig, tf_ctc_loss
from avsync_torch.ops import beam
from avsync_torch.ops.ctc import ctc_nll, optax_ctc_nll
from avsync_torch.ops.cuda import convpool
from avsync_torch.train.lipnet_trainer import (LipNetTrainer, eval_step, make_optimizer,
                                               train_step)

SMALL = dict(conv_channels=(2, 3, 4), hidden_dim=4, dense_dim=16)


def _conv_shape(hw, channels=(2, 3, 4)):
    h, w = hw
    for _ in channels:
        h, w = h // 2, w // 2
    return (channels[-1], h, w)


def _jax_params(model, x, seed):
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"]
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.05, np.shape(p))).astype(
        np.float32), params)


# ---------------------------------------------------------------------------
# forward and the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,B,T,fused", [((16, 32), 2, 6, False), ((18, 46), 3, 5, False),
                                           ((16, 32), 2, 6, True), ((18, 46), 3, 5, True)],
                         ids=["16x32", "18x46_odd", "16x32_fused", "18x46_odd_fused"])
def test_forward_matches_jax(hw, B, T, fused):
    """(C, H, W) against (H, W, C) flattening: conv shape (4, 2, 4) and
    (4, 2, 5), so the first LSTM's permuted rows matter. `fused`: conv1 on
    the fused kernels' plain versions (`fused_conv_pool`)."""
    x = np.random.default_rng(1).random((B, T, *hw, 1)).astype(np.float32)
    jmodel = JaxTFLipNet(JaxTFModelConfig(**SMALL))
    params = _jax_params(jmodel, x, 0)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = TFLipNet(TFModelConfig(**SMALL), img_hw=hw, fused_conv_pool=fused)
    model.load_state_dict(tflipnet_params_from_jax(params, _conv_shape(hw)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        train_mode = model(torch.from_numpy(x), train=True, generator=torch.Generator())
    assert got.shape == (B, T, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    # train mode draws dropout masks: it differs from eval only through them
    assert not torch.equal(train_mode, got)


def test_bridge_round_trips_bit_for_bit():
    x = np.zeros((1, 4, 18, 46, 1), np.float32)
    params = _jax_params(JaxTFLipNet(JaxTFModelConfig(**SMALL)), x, 2)
    sd = tflipnet_params_from_jax(params, (4, 2, 5))
    back = tflipnet_params_to_jax(sd, (4, 2, 5))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    again = tflipnet_params_from_jax(back, (4, 2, 5))
    assert all(torch.equal(again[k], v) for k, v in sd.items())
    assert set(sd) == set(TFLipNet(TFModelConfig(**SMALL), img_hw=(18, 46)).state_dict())


def test_make_lipnet_is_the_family_switch():
    tf = make_lipnet(ModelConfig(family="tf", hidden_dim=4), (46, 140))
    assert isinstance(tf, TFLipNet)
    assert tf.cfg.conv_channels == (128, 256, 64) and tf.conv_output_dim == 64 * 5 * 17
    assert tf.head.weight.shape == (32, 512) and tf.cfg.num_lstm_layers == 3
    # an explicit (32, 64, 96) TF stack stays representable
    explicit = make_lipnet(ModelConfig(family="tf", conv_channels=(32, 64, 96), hidden_dim=4),
                           (46, 140))
    assert isinstance(explicit, TFLipNet) and explicit.conv3.weight.shape[0] == 96
    assert isinstance(make_lipnet(ModelConfig(hidden_dim=4), (50, 100)), LipNet)
    # the TF stack computes in float32 whatever the config's dtype, as the JAX
    # switch builds it; the class computes in bf16 when asked
    # (tests/test_torch_bf16_tf.py)
    bf16 = make_lipnet(ModelConfig(family="tf", compute_dtype="bfloat16", hidden_dim=4),
                       (46, 140))
    assert bf16.cfg.compute_dtype == "float32" and bf16.compute_dtype is None
    cls = TFLipNet(TFModelConfig(hidden_dim=4, compute_dtype="bfloat16"), img_hw=(46, 140))
    assert cls.compute_dtype == torch.bfloat16
    # `fused_conv_pool` reaches the blocks; only conv1 (Cin = 1) can take it
    fused = make_lipnet(ModelConfig(family="tf", hidden_dim=4, fused_conv_pool=True), (46, 140))
    assert fused.conv1.fused and fused.conv2.fused and fused.conv3.fused
    assert not tf.conv1.fused
    takes = [convpool.fused_takes(torch.empty(2, cin, 3, h, w, device="meta"), blk.weight)
             for cin, h, w, blk in ((1, 46, 140, fused.conv1), (128, 23, 70, fused.conv2),
                                    (256, 11, 35, fused.conv3))]
    assert takes == [True, False, False]


WIDE = dict(conv_channels=(128, 4, 4), hidden_dim=4, dense_dim=16, dropout_rate=0.0)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_fused_conv1_matches_the_cudnn_route(monkeypatch, remat):
    """The TF stack's conv1 width (Cin 1, 128 channels, 3x3x3) with
    `fused_conv_pool` on and off from the same weights: the fused block
    (`Conv1Pool`, its forward and dW/db the kernels' plain versions on the
    CPU) against the plain conv block, the log-probs and every gradient
    within float32 tolerance (1e-5 of the log-probs, 1e-3 of each
    gradient's largest magnitude: sums in another order, and a window whose
    max or ReLU another order flips routes elsewhere). Only conv1 takes the
    fused block, once per forward (under remat once more, its recompute)."""
    from avsync_torch.models import lipnet as lipnet_mod

    calls = []
    real = lipnet_mod.conv1_pool_block
    monkeypatch.setattr(lipnet_mod, "conv1_pool_block",
                        lambda x, w, b: calls.append(tuple(w.shape)) or real(x, w, b))
    g = torch.Generator().manual_seed(3)
    fused = TFLipNet(TFModelConfig(**WIDE), img_hw=(18, 46), generator=g, fused_conv_pool=True)
    plain = TFLipNet(TFModelConfig(**WIDE), img_hw=(18, 46))
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 4, 18, 46, 1, generator=g)
    labels = torch.tensor([[3, 5, 7, 0], [9, 9, 2, 1]])
    out, grads = [], []
    for model in (fused, plain):
        lp = model(x, remat=remat)
        tf_ctc_loss(lp, labels).backward()
        out.append(lp.detach())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert calls == [(128, 1, 3, 3, 3)] * (2 if remat else 1)  # remat: again in the backward
    torch.testing.assert_close(out[0], out[1], atol=1e-5, rtol=0)
    for name, want in grads[1].items():
        got = grads[0][name]
        assert got is not None and torch.isfinite(got).all(), name
        assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item() + 1e-7, name


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _logits(seed, B, T, V=32):
    return np.random.default_rng(seed).normal(size=(B, T, V)).astype(np.float32)


FEASIBLE = {
    "plain": [[3, 5, 7, 0, 0, 0], [9, 9, 2, 0, 0, 0]],
    "oov": [[3, 0, 5, 0, 0, 0], [0, 4, 4, 0, 0, 0]],  # OOV ids drop out of the length
    "full": [[1, 2, 3, 4, 5, 6], [30, 1, 30, 1, 30, 1]],
}


def _jax_loss_and_grad(logits, labels):
    f = lambda lg: jax_tf_ctc_loss(jax.nn.log_softmax(lg, -1), jnp.asarray(labels))
    v, g = jax.value_and_grad(f)(jnp.asarray(logits))
    return float(v), np.asarray(g, np.float64)


def _port_loss_and_grad(logits, labels, dtype=torch.float32):
    x = torch.tensor(logits, dtype=dtype, requires_grad=True)
    loss = tf_ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(np.asarray(labels)).long())
    loss.backward()
    return loss.item(), x.grad.numpy().astype(np.float64)


@pytest.mark.parametrize("case", list(FEASIBLE))
def test_tf_ctc_loss_matches_jax(case):
    labels = np.asarray(FEASIBLE[case], np.int32)
    logits = _logits(3, 2, 12)
    want, want_g = _jax_loss_and_grad(logits, labels)
    got, got_g = _port_loss_and_grad(logits, labels)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(FEASIBLE))
def test_optax_recursion_equals_the_lattice_where_an_alignment_exists(case):
    labels = torch.tensor(FEASIBLE[case])
    lp = torch.log_softmax(torch.from_numpy(_logits(4, 2, 12)), -1)
    lens = (labels != 0).sum(1)
    torch.testing.assert_close(optax_ctc_nll(lp, labels, lens, 31),
                               ctc_nll(lp, labels, lens, blank_id=31), rtol=1e-6, atol=1e-5)


def test_tf_ctc_loss_keeps_an_infeasible_sequence_as_jax():
    """Sequence 1 has seven labels in six frames: no alignment. The batch
    mean keeps its ~1e5 NLL (not zeroed, not length-normalised)."""
    labels = np.asarray([[3, 0, 5, 0, 0, 0, 0, 0], [7, 8, 9, 10, 11, 12, 13, 0],
                         [1, 1, 1, 1, 2, 0, 0, 0]], np.int32)
    logits = _logits(5, 3, 6)
    want, want_g = _jax_loss_and_grad(logits, labels)
    got, got_g = _port_loss_and_grad(logits, labels)
    assert want > 1e4
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with jax.enable_x64():
        want64, want_g64 = _jax_loss_and_grad(logits.astype(np.float64), labels)
    got64, got_g64 = _port_loss_and_grad(logits, labels, torch.float64)
    np.testing.assert_allclose(got64, want64, rtol=1e-12)
    np.testing.assert_allclose(got_g64, want_g64, rtol=1e-5, atol=1e-9)
    jax_err = np.abs(want_g - want_g64).max()
    assert np.abs(got_g - want_g64).max() <= 2 * jax_err + 1e-6
    # the feasible sequence's gradient row is float32-exact in both
    np.testing.assert_allclose(got_g[0], want_g[0], rtol=1e-5, atol=1e-6)


def test_tf_ctc_loss_is_not_length_normalised():
    labels = torch.tensor([[1, 2, 3, 4, 0, 0]])
    lp = torch.log_softmax(torch.from_numpy(_logits(6, 1, 20)), -1)
    nll = ctc_nll(lp, labels, torch.tensor([4]), blank_id=31)
    torch.testing.assert_close(tf_ctc_loss(lp, labels), nll.mean(), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# vocabulary and decode
# ---------------------------------------------------------------------------

def test_vocabulary_constants_equal_the_jax_package():
    assert (text.TF_CHARACTERS, text.TF_VOCAB_SIZE, text.TF_BLANK_ID) == (
        jtext.TF_CHARACTERS, jtext.TF_VOCAB_SIZE, jtext.TF_BLANK_ID) == (
        "abcdefghijklmnopqrstuvwxyz'?! ", 31, 31)
    assert text.TF_CHAR_TO_IDX == jtext.TF_CHAR_TO_IDX
    assert text.TF_IDX_TO_CHAR == jtext.TF_IDX_TO_CHAR


@pytest.mark.parametrize("s", ["set green by b six again", "bin blue at f 2 now!",
                               "x" * 60, "", "what's up? 9"],
                         ids=["grid", "digit_oov", "past_cap", "empty", "punctuation"])
def test_text_to_indices_and_back_equal_the_jax_package(s):
    for cap in (40, 7):
        ids = text.tf_text_to_indices(s, cap)
        np.testing.assert_array_equal(ids, jtext.tf_text_to_indices(s, cap))
        assert ids.dtype == np.int32
        assert text.tf_indices_to_text(ids) == jtext.tf_indices_to_text(ids)


def _tf_log_probs(seed, B=4, T=30):
    logits = np.random.default_rng(seed).normal(size=(B, T, 32)) * 3.0
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("width", [0, 1, 4], ids=["greedy", "beam1", "beam4"])
def test_tf_decode_batch_equals_the_jax_package(width):
    lp = _tf_log_probs(width + 20)
    got = text.tf_decode_batch(lp, beam_width=width)
    assert got == jtext.tf_decode_batch(lp, beam_width=width)
    assert text.tf_decode_batch(torch.from_numpy(lp), beam_width=width) == got
    assert all(set(s) <= set(text.TF_CHARACTERS) for s in got)


def test_tf_decode_blank_is_the_last_unit():
    lp = np.full((1, 6, 32), -10.0, np.float32)
    for t, p in enumerate([1, 1, 31, 2, 31, 31]):  # a a blank b blank blank
        lp[0, t, p] = 0.0
    assert text.tf_decode_batch(lp) == ["ab"] == jtext.tf_decode_batch(lp)
    assert text.family_decoder("tf") is text.tf_decode_batch
    assert text.family_decoder("pytorch") is text.decode_batch


@pytest.mark.parametrize("width", [2, 8])
def test_beam_search_at_the_tf_blank_equals_the_jax_package(width):
    lp = _tf_log_probs(width)
    valid = range(1, text.TF_VOCAB_SIZE)
    for b in range(lp.shape[0]):
        ours, score = beam.ctc_beam_search(lp[b], width, text.TF_BLANK_ID, valid)
        theirs, jscore = jax_beam.ctc_beam_search(lp[b], width, jtext.TF_BLANK_ID, valid)
        assert ours == theirs
        np.testing.assert_allclose(score, jscore, rtol=1e-12)


def test_labels_batch_tf_equals_the_jax_package(tmp_path):
    from avsync.data import GridDataSource as JaxSource
    from avsync.data import synthetic
    from avsync_torch.data.grid import GridDataSource

    root = str(tmp_path)
    speakers = synthetic.write_corpus(root, n_speakers=2, clips_per_speaker=3, n_frames=4,
                                      height=8, width=16, seed=5, with_audio=False)
    src, jsrc = GridDataSource(root, speakers), JaxSource(root, speakers)
    src.samples[1].text = jsrc.samples[1].text = "place 9 red, at x"  # OOV characters
    for cap in (6, 40):
        for got, want in zip(src.labels_batch(range(6), cap, vocab="tf"),
                             jsrc.labels_batch(range(6), cap, vocab="tf")):
            np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TINY = dict(family="tf", hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0)
LR = 1e-3


@pytest.fixture(scope="module")
def tiny_batch():
    r = np.random.default_rng(7)
    x = r.random((2, 6, 16, 32, 1)).astype(np.float32)
    labels = np.asarray([[3, 5, 7, 0], [0, 9, 9, 0]], np.int32)  # an OOV id in the second
    lengths = np.asarray([3, 3], np.int32)
    jmodel = jax_make_lipnet(JaxModelConfig(**TINY))
    return x, labels, lengths, jmodel, _jax_params(jmodel, x, 8)


def _trainer(tmp_path, fused=False, **train):
    cfg = AvsyncConfig(data=DataConfig(img_height=16, img_width=32, max_video_length=6),
                       model=ModelConfig(**TINY, fused_conv_pool=fused),
                       train=TrainConfig(learning_rate=LR, checkpoint_dir=str(tmp_path / "ck"),
                                         **train))
    return LipNetTrainer(cfg, device="cpu")


def test_three_train_steps_match_jax(tiny_batch, tmp_path):
    """The TF-family LipNetTrainer's step against the JAX trainer's TF step
    (make_lipnet, tf_ctc_loss, clip, Adam), dropout 0."""
    _three_train_steps_match_jax(tiny_batch, tmp_path, fused=False)


def test_three_train_steps_with_fused_conv1_match_jax(tiny_batch, tmp_path):
    """The same with `fused_conv_pool`: conv1 forward and dW/db on the fused
    kernels' plain versions (`ops/cuda/convpool.Conv1Pool`)."""
    _three_train_steps_match_jax(tiny_batch, tmp_path, fused=True)


def _three_train_steps_match_jax(tiny_batch, tmp_path, fused):
    x, labels, lengths, jmodel, params = tiny_batch
    jopt = jax_make_optimizer(LR, 1.0)
    batch = {"video": jnp.asarray(x), "labels": jnp.asarray(labels),
             "label_lengths": jnp.asarray(lengths)}
    loss_fn = lambda lp, lab, lens: jax_tf_ctc_loss(lp, lab)  # the JAX trainer's TF loss
    step_fn = jax.jit(make_train_step(jmodel, jopt, loss_fn_impl=loss_fn))
    jgrads = jax.grad(lambda p: jax_tf_ctc_loss(
        jmodel.apply({"params": p}, batch["video"], train=True,
                     rngs={"dropout": jax.random.PRNGKey(1)}), batch["labels"]))(params)
    state = JaxTrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    jlosses = []
    for _ in range(3):
        state, m = step_fn(state, batch, jax.random.PRNGKey(1), jnp.float32(LR))
        jlosses.append(float(m["loss"]))
    jafter = jax.tree.map(np.asarray, state.params)

    trainer = _trainer(tmp_path, fused=fused)
    tstate = trainer.init_state()
    model = tstate.model
    assert isinstance(model, TFLipNet) and model.conv1.fused == fused
    model.load_state_dict(tflipnet_params_from_jax(params, (4, 2, 4)))
    tbatch = {"video": torch.from_numpy(x), "labels": torch.from_numpy(labels).long(),
              "label_lengths": torch.from_numpy(lengths).long()}
    tf_ctc_loss(model(tbatch["video"], train=True), tbatch["labels"]).backward()
    grads = tflipnet_params_to_jax({n: p.grad for n, p in model.named_parameters()},
                                   (4, 2, 4))
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        got = grads
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))
    opt = make_optimizer(model.parameters(), LR)
    for i in range(3):
        loss, _ = train_step(model, opt, tbatch, LR)
        np.testing.assert_allclose(loss.item(), jlosses[i], rtol=1e-4)
    after = tflipnet_params_to_jax(model.state_dict(), (4, 2, 4))
    for path, want in jax.tree_util.tree_leaves_with_path(jafter):
        got = after
        for k in path:
            got = got[k.key]
        assert np.abs(got - want).max() <= 3 * 2 * LR, jax.tree_util.keystr(path)
    # eval: the family's loss, with the batch's lengths unused
    loss, lp = eval_step(model, tbatch)
    torch.testing.assert_close(loss, tf_ctc_loss(lp, tbatch["labels"]))


def test_remat_equals_no_remat_bit_for_bit(tiny_batch, tmp_path):
    x, labels, lengths, _, params = tiny_batch
    tbatch = {"video": torch.from_numpy(x), "labels": torch.from_numpy(labels).long(),
              "label_lengths": torch.from_numpy(lengths).long()}
    runs = []
    for remat in (False, True):
        trainer = _trainer(tmp_path, remat=remat)
        trainer.config = dataclasses.replace(trainer.config, model=dataclasses.replace(
            trainer.config.model, dropout_rate=0.5))
        state = trainer.init_state()
        state.model.load_state_dict(tflipnet_params_from_jax(params, (4, 2, 4)))
        opt = make_optimizer(state.model.parameters(), LR)
        losses = [train_step(state.model, opt, tbatch, LR, trainer._step_generator(s),
                             remat=remat)[0].item() for s in range(2)]
        runs.append((losses, state.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], v) for k, v in runs[1][1].items())
