"""The port's conv1 block weight gradient (plain version of
csrc/conv1_pool_bwd.cu) against the JAX package's Pallas `conv1_pool_bwd`
in interpret mode, and the model's NCDHW autograd Function against
`jax.grad` of the JAX package's differentiable block.

Inputs are numpy draws from a seed handed to both packages; the port's
wrappers run their plain versions on the CPU (the CUDA kernel is held
against that on the card). Tolerance atol 1e-3 / rtol 1e-4, the JAX
package's own (tests/test_pallas_convpool.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync.ops.conv import conv3d, max_pool3d
from avsync.ops.pallas.convpool import conv1_pool_block as jax_block
from avsync.ops.pallas.convpool import conv1_pool_bwd as jax_bwd
from avsync_torch.ops.cuda import convpool

ATOL, RTOL = 1e-3, 1e-4


def _case(seed, B=2, T=6, H=8, W=12, k=(3, 5, 5), C=4):
    r = np.random.default_rng(seed)
    x = r.random((B, T, H, W, 1)).astype(np.float32)
    w = (r.random((*k, 1, C)) - 0.5).astype(np.float32)
    b = r.random(C).astype(np.float32)
    g = r.normal(size=(B, T, H // 2, W // 2, C)).astype(np.float32)
    return x, w, b, g


def _jax(x, w, b, g, t_chunk):
    return [np.asarray(a) for a in jax_bwd(
        *map(jnp.asarray, (x, w, b, g)), t_chunk=t_chunk, out_dtype=jnp.float32,
        interpret=True)]


def _port(x, w, b, g):
    return [a.numpy() for a in convpool.conv1_pool_bwd(*map(torch.from_numpy, (x, w, b, g)))]


@pytest.mark.parametrize("shape", [(6, 8, 12, (3, 5, 5), 4, 3), (4, 6, 8, (3, 3, 3), 5, 2),
                                   (5, 10, 20, (3, 5, 5), 32, 5)],
                         ids=["k355", "k333", "production_channels"])
def test_bwd_matches_pallas_interpret(shape):
    T, H, W, k, C, t_chunk = shape
    x, w, b, g = _case(1, T=T, H=H, W=W, k=k, C=C)
    for name, got, want in zip(("dkernel", "dbias"), _port(x, w, b, g),
                               _jax(x, w, b, g, t_chunk)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=name)


def test_pool_tie_routes_to_the_first_window_position():
    """Constant input: every interior pool window is a 4-way tie, and the
    gradient goes to the first position (XLA's select_and_scatter order),
    as the JAX kernel routes it (tests/test_pallas_convpool.py:88-108)."""
    r = np.random.default_rng(0)
    x = np.ones((1, 3, 4, 4, 1), np.float32)
    w = (r.random((3, 3, 3, 1, 2)) - 0.2).astype(np.float32)
    b = r.random(2).astype(np.float32)

    def loss_ref(w):
        return (max_pool3d(jax.nn.relu(conv3d(jnp.asarray(x), w, jnp.asarray(b)))) ** 2).sum()

    want = np.asarray(jax.grad(loss_ref)(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    y = convpool.conv1_pool_block(xt, wt.permute(4, 3, 0, 1, 2), torch.from_numpy(b))
    (y ** 2).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, atol=1e-4, rtol=1e-4)
    # and the JAX-layout backward gives the Pallas kernel's dW on the tie case
    yj = convpool.conv1_pool_fused(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    gt = (2 * yj).numpy()
    np.testing.assert_allclose(_port(x, w, b, gt)[0], _jax(x, w, b, gt, 3)[0],
                               atol=1e-4, rtol=1e-4)


def test_ncdhw_function_matches_jax_grad():
    """d/d(x, w, b) of sum(block(x)^2) through the port's Conv1Pool (forward
    K1, dW/db K4, dx from autograd of the plain composition) against jax.grad
    through the JAX package's custom_vjp block."""
    x, w, b, _ = _case(2)

    def loss(x, w, b):
        return (jax_block(x, w, b, (3, "float32", True)) ** 2).sum()

    want = [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w, b)))]
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = convpool.conv1_pool_block(xt.permute(0, 4, 1, 2, 3), wt, bt)
    assert y.shape == (2, 4, 6, 4, 6)
    (y ** 2).sum().backward()
    got = [xt.grad.numpy(), wt.grad.numpy().transpose(2, 3, 4, 1, 0), bt.grad.numpy()]
    for name, o, r in zip(("dx", "dkernel", "dbias"), got, want):
        np.testing.assert_allclose(o, r, atol=ATOL, rtol=RTOL, err_msg=name)


def test_input_gradient_is_skipped_when_x_needs_none():
    """conv1 is the model's input layer: its backward computes dW/db only."""
    x, w, b, _ = _case(3)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))).requires_grad_()
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    y = convpool.conv1_pool_block(xt, wt, torch.from_numpy(b))
    assert y.grad_fn is not None
    (dw,) = torch.autograd.grad(y.sum(), wt)
    assert torch.isfinite(dw).all() and dw.abs().sum() > 0


def test_cpu_backward_does_not_count_as_a_kernel_launch():
    x, w, b, g = _case(4)
    before = convpool.bwd_launches
    _port(x, w, b, g)
    assert convpool.bwd_launches == before
