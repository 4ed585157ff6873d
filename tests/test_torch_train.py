"""The port's training step against the JAX package's, on the same weights
and batch: CTC loss, the optimizer, three train steps of a tiny LipNet with
both kernel flags on (the JAX package's Pallas kernels in interpret mode,
the port's plain versions of K1-K4), and TF32 kept out of the backward.

Inputs are numpy draws from a seed handed to both packages; weights cross
through `lipnet_params_from_jax`, gradients come back through
`lipnet_params_to_jax`.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from avsync.config import ModelConfig as JaxModelConfig
from avsync.models import LipNet as JaxLipNet
from avsync.ops.ctc import ctc_loss_mean as jax_ctc
from avsync.train.lipnet_trainer import TrainState as JaxTrainState
from avsync.train.lipnet_trainer import make_optimizer as jax_make_optimizer
from avsync.train.lipnet_trainer import make_train_step
from avsync_torch.compat import lipnet_params_from_jax, lipnet_params_to_jax
from avsync_torch.config import ModelConfig
from avsync_torch.models import LipNet
from avsync_torch.ops.ctc import ctc_loss_mean
from avsync_torch.train.lipnet_trainer import make_optimizer, train_step

TINY = dict(hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0,
            use_pallas_gru=True, fused_conv_pool=True)
CONV_SHAPE = (4, 2, 4)  # 16x32 frames after three (1,2,2) pools, 4 channels


def _log_probs(seed, B=3, T=8, V=6):
    r = np.random.default_rng(seed)
    logits = r.normal(size=(B, T, V)).astype(np.float32)
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


@pytest.mark.parametrize("labels,lengths", [
    ([[1, 2, 3, 0], [4, 4, 0, 0], [5, 1, 5, 2]], [3, 2, 4]),
    ([[1, 1, 1, 1], [2, 0, 0, 0], [3, 3, 3, 0]], [4, 1, 3]),
    ([[1, 2, 1, 2], [0, 0, 0, 0], [2, 2, 2, 2]], [4, 0, 4]),
], ids=["distinct", "repeated_labels", "empty_target"])
def test_ctc_loss_matches_jax(labels, lengths):
    lp = _log_probs(0)
    labels, lengths = np.asarray(labels, np.int32), np.asarray(lengths, np.int32)
    want = float(jax_ctc(jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(lengths)))
    got = ctc_loss_mean(torch.from_numpy(lp), torch.from_numpy(labels),
                        torch.from_numpy(lengths)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ctc_infeasible_sequence_counts_zero():
    """zero_infinity: a target that needs more frames than T (here 4 labels
    with a repeat in 4 frames) contributes 0 to the batch mean, in both."""
    lp = _log_probs(1, B=2, T=4)
    labels = np.asarray([[1, 1, 2, 3], [2, 3, 0, 0]], np.int32)
    lengths = np.asarray([4, 2], np.int32)
    want = float(jax_ctc(jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(lengths)))
    got = ctc_loss_mean(torch.from_numpy(lp), torch.from_numpy(labels),
                        torch.from_numpy(lengths)).item()
    alone = ctc_loss_mean(torch.from_numpy(lp[1:]), torch.from_numpy(labels[1:]),
                          torch.from_numpy(lengths[1:])).item()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, alone / 2, rtol=1e-6)


def test_optimizer_matches_jax_over_four_steps():
    """clip_grad_norm_(1.0) then Adam at a runtime lr, against the JAX
    package's clip -> scale_by_adam -> -lr (as tests/test_optimizer_parity.py)."""
    r = np.random.default_rng(0)
    p0 = r.normal(size=(7, 5)).astype(np.float32)
    grads = [r.normal(size=(7, 5)).astype(np.float32) * s for s in (0.5, 3.0, 0.1, 10.0)]
    lr = 1e-3
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([tp], lr)
    for g in grads:
        opt.zero_grad()
        tp.grad = torch.from_numpy(g.copy())
        torch.nn.utils.clip_grad_norm_([tp], 1.0)
        opt.step()
    jopt = jax_make_optimizer(lr, 1.0)
    params = {"w": jnp.asarray(p0)}
    state = jopt.init(params)
    for g in grads:
        updates, state = jopt.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, {"w": -lr * updates["w"]})
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(params["w"]),
                               atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def tiny_slice():
    """Same weights and batch in both packages: a tiny LipNet (hidden 8,
    conv (2,3,4), 16x32 frames, T=6, B=2, dropout 0, both kernel flags)."""
    from jax.experimental.pallas import tpu as pltpu

    r = np.random.default_rng(3)
    x = r.random((2, 6, 16, 32, 1)).astype(np.float32)
    labels = np.asarray([[3, 5, 7, 0], [9, 9, 0, 0]], np.int32)
    lengths = np.asarray([3, 2], np.int32)
    jcfg = JaxModelConfig(**TINY)
    with pltpu.force_tpu_interpret_mode():
        params = JaxLipNet(jcfg).init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda p: (np.asarray(p) + r.normal(0.0, 0.05, np.shape(p))).astype(np.float32), params)
    return x, labels, lengths, params


LR = 1e-3


def test_three_train_steps_match_jax(tiny_slice):
    from jax.experimental.pallas import tpu as pltpu

    x, labels, lengths, params = tiny_slice
    jcfg = JaxModelConfig(**TINY)
    jmodel = JaxLipNet(jcfg)
    jopt = jax_make_optimizer(LR, 1.0)
    batch = {"video": jnp.asarray(x), "labels": jnp.asarray(labels),
             "label_lengths": jnp.asarray(lengths)}
    step_fn = jax.jit(make_train_step(jmodel, jopt))

    def jloss(p):
        lp = jmodel.apply({"params": p}, batch["video"], train=True,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_ctc(lp, batch["labels"], batch["label_lengths"])

    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.jit(jax.grad(jloss))(params)
        state = JaxTrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
        jmetrics = []
        for _ in range(3):
            state, m = step_fn(state, batch, jax.random.PRNGKey(1), jnp.float32(LR))
            jmetrics.append({k: float(v) for k, v in m.items()})

    model = LipNet(ModelConfig(**TINY), img_hw=(16, 32), generator=torch.Generator())
    model.load_state_dict(lipnet_params_from_jax(params, conv_shape=CONV_SHAPE))
    assert model.conv1.fused and model.gru1.use_kernel
    tbatch = {"video": torch.from_numpy(x), "labels": torch.from_numpy(labels),
              "label_lengths": torch.from_numpy(lengths)}

    # step-1 gradients, back in the JAX layout
    ctc_loss_mean(model(tbatch["video"], train=True), tbatch["labels"],
                  tbatch["label_lengths"]).backward()
    grads = lipnet_params_to_jax({n: p.grad for n, p in model.named_parameters()},
                                 conv_shape=CONV_SHAPE)
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        got = grads
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))

    opt = make_optimizer(model.parameters(), LR)
    for i in range(3):
        loss, gnorm = train_step(model, opt, tbatch, LR)
        np.testing.assert_allclose(loss.item(), jmetrics[i]["loss"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gnorm.item(), jmetrics[i]["grad_norm"], rtol=1e-3)

    # After 3 Adam steps every parameter moved by about lr per step whatever
    # its gradient's size, so an element whose gradient sits at rounding
    # level can take the other sign in one package: up to 2*lr per step.
    # The bound is therefore 3 steps x 2*lr; the median element must agree
    # far closer (1e-6), which a wrong gradient would not.
    after = lipnet_params_to_jax(model.state_dict(), conv_shape=CONV_SHAPE)
    diffs = []
    for path, want in jax.tree_util.tree_leaves_with_path(state.params):
        got = after
        for k in path:
            got = got[k.key]
        diffs.append(np.abs(got - np.asarray(want)).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 3 * 2 * LR
    assert np.median(diffs) <= 1e-6


def test_tf32_is_off_inside_the_backward():
    """The process-wide flag is True by default; inside train_step's
    backward (where autograd runs conv2's backward) it must be False."""
    seen = []
    model = LipNet(ModelConfig(**TINY), img_hw=(16, 32), generator=torch.Generator().manual_seed(0))

    def on_conv2_output(mod, inp, out):
        out.register_hook(lambda g: seen.append((torch.backends.cudnn.allow_tf32,
                                                 torch.backends.cuda.matmul.allow_tf32)))

    model.conv2.register_forward_hook(on_conv2_output)
    r = np.random.default_rng(4)
    batch = {"video": torch.from_numpy(r.random((2, 6, 16, 32, 1)).astype(np.float32)),
             "labels": torch.tensor([[3, 5, 0], [7, 0, 0]]), "label_lengths": torch.tensor([2, 1])}
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        train_step(model, make_optimizer(model.parameters()), batch, 1e-4)
        after = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [(False, False)]
    assert after == (True, True)  # the step's scope restores the caller's flags


@pytest.mark.parametrize("deterministic", [False, True])
def test_cudnn_determinism_inside_the_backward_is_the_callers(deterministic):
    """train_step turns TF32 off and `cudnn.deterministic` on inside its
    backward whatever the caller set (on the card cuDNN's default algorithms
    for the conv backward sum in a run-dependent order; runs must repeat,
    and a data-parallel or graph step equal its loop bit for bit), and gives
    the caller's flag back after."""
    seen = []
    model = LipNet(ModelConfig(**TINY), img_hw=(16, 32), generator=torch.Generator().manual_seed(0))

    def on_conv2_output(mod, inp, out):
        out.register_hook(lambda g: seen.append(torch.backends.cudnn.deterministic))

    model.conv2.register_forward_hook(on_conv2_output)
    r = np.random.default_rng(4)
    batch = {"video": torch.from_numpy(r.random((2, 6, 16, 32, 1)).astype(np.float32)),
             "labels": torch.tensor([[3, 5, 0], [7, 0, 0]]), "label_lengths": torch.tensor([2, 1])}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        train_step(model, make_optimizer(model.parameters()), batch, 1e-4)
        after = torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic = prev
    assert seen == [True]
    assert after == deterministic


def test_dropout_masks_come_from_the_given_generator():
    cfg = dataclasses.replace(ModelConfig(**TINY), dropout_rate=0.5)
    model = LipNet(cfg, img_hw=(16, 32), generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 6, 16, 32, 1, generator=torch.Generator().manual_seed(1))
    a = model(x, train=True, generator=torch.Generator().manual_seed(5))
    torch.manual_seed(123)  # the global RNG plays no part
    b = model(x, train=True, generator=torch.Generator().manual_seed(5))
    c = model(x, train=True, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(model(x), model(x, train=False))
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)
