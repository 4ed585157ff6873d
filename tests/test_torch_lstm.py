"""The port's LSTM (`avsync_torch/ops/lstm.py`, the TF-family LipNet's
recurrence) against the JAX package's `avsync.ops.lstm` on the same numpy
weights and inputs, on the CPU: forward, reverse, bidirectional, and the
gradients through the step loop against `jax.grad` of `lstm_scan`.

Bounds: atol 1e-5, rtol 1e-4 (the JAX package's own LSTM bound,
tests/test_tf_stack.py:27-46), for the outputs and for the gradients.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from avsync.ops import lstm as jl
from avsync_torch.ops.lstm import LSTMWeights, bilstm, lstm_scan

TOL = dict(atol=1e-5, rtol=1e-4)
SHAPES = [(2, 7, 5, 4), (3, 11, 6, 8), (1, 5, 3, 16)]  # (B, T, D, H)
SHAPE_IDS = ["B2_T7_D5_H4", "B3_T11_D6_H8", "B1_T5_D3_H16"]


def _jax_params(seed, D, H):
    r = np.random.default_rng(seed)
    k = H ** -0.5
    return jl.LSTMParams(*(r.uniform(-k, k, s).astype(np.float32)
                           for s in ((D, 4 * H), (H, 4 * H), (4 * H,), (4 * H,))))


def _torch_weights(p, requires_grad=False) -> LSTMWeights:
    """JAX right-multiply layout (D, 4H) -> torch's (4H, D); biases as they are."""
    return LSTMWeights(*(torch.tensor(np.ascontiguousarray(a.T if a.ndim == 2 else a),
                                      requires_grad=requires_grad) for a in p))


def _x(seed, B, T, D):
    return np.random.default_rng(seed + 100).normal(size=(B, T, D)).astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_lstm_scan_matches_jax(shape, reverse):
    B, T, D, H = shape
    p, x = _jax_params(0, D, H), _x(0, B, T, D)
    want = np.asarray(jl.lstm_scan(p, jnp.asarray(x), reverse=reverse))
    got = lstm_scan(_torch_weights(p), torch.from_numpy(x), reverse=reverse)
    assert got.shape == (B, T, H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_bilstm_matches_jax(shape):
    B, T, D, H = shape
    pf, pb, x = _jax_params(1, D, H), _jax_params(2, D, H), _x(1, B, T, D)
    want = np.asarray(jl.bilstm(pf, pb, jnp.asarray(x)))
    got = bilstm(_torch_weights(pf), _torch_weights(pb), torch.from_numpy(x))
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bilstm_matches_torch_nn_lstm():
    """An independent check of the cell: torch's own bidirectional LSTM on
    the same weights."""
    B, T, D, H = 2, 9, 4, 6
    ref = torch.nn.LSTM(D, H, batch_first=True, bidirectional=True)
    x = torch.from_numpy(_x(3, B, T, D))
    with torch.no_grad():
        want, _ = ref(x)
        got = bilstm(*(LSTMWeights(*(getattr(ref, f"{n}_l0{s}") for n in
                                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))
                       for s in ("", "_reverse")), x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=SHAPE_IDS[:2])
def test_gradients_through_the_loop_match_jax_grad(shape, reverse):
    """d/d(x, w_ih, w_hh, b_ih, b_hh) of sum(out * cotangent): autograd
    through the step loop against `jax.grad` of `lstm_scan`."""
    B, T, D, H = shape
    p, x = _jax_params(4, D, H), _x(4, B, T, D)
    cot = np.random.default_rng(5).normal(size=(B, T, H)).astype(np.float32)

    def jloss(params, xx):
        return jnp.sum(jl.lstm_scan(params, xx, reverse=reverse) * cot)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    w = _torch_weights(p, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    (lstm_scan(w, tx, reverse=reverse) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **TOL)
    for name, got, want in zip(jl.LSTMParams._fields, w, jg_p):
        g = got.grad.numpy()
        np.testing.assert_allclose(g.T if g.ndim == 2 else g, np.asarray(want), **TOL,
                                   err_msg=name)


def test_bilstm_gradients_match_jax_grad():
    B, T, D, H = 2, 6, 5, 4
    pf, pb, x = _jax_params(6, D, H), _jax_params(7, D, H), _x(6, B, T, D)
    cot = np.random.default_rng(8).normal(size=(B, T, 2 * H)).astype(np.float32)

    def jloss(f, b, xx):
        return jnp.sum(jl.bilstm(f, b, xx) * cot)

    grads = jax.grad(jloss, argnums=(0, 1, 2))(jax.tree.map(jnp.asarray, pf),
                                                jax.tree.map(jnp.asarray, pb), jnp.asarray(x))
    wf, wb = _torch_weights(pf, True), _torch_weights(pb, True)
    tx = torch.tensor(x, requires_grad=True)
    (bilstm(wf, wb, tx) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(grads[2]), **TOL)
    for w, jg in ((wf, grads[0]), (wb, grads[1])):
        for got, want in zip(w, jg):
            g = got.grad.numpy()
            np.testing.assert_allclose(g.T if g.ndim == 2 else g, np.asarray(want), **TOL)
