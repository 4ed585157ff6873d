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


def test_plain_sums_in_float64_on_the_same_routing():
    """`sum_dtype=float64` keeps the fp32 routing and takes the sums in
    float64 (the card's check of the fp32 sums at B=128); summed chunk by
    chunk of clips it gives the whole batch's sums."""
    x, w, b, g = (torch.from_numpy(a) for a in _case(3, B=4, T=5, H=10, W=14))
    fp32 = convpool.conv1_pool_bwd_ref(x, w, b, g)
    f64 = convpool.conv1_pool_bwd_ref(x, w, b, g, sum_dtype=torch.float64)
    halves = [convpool.conv1_pool_bwd_ref(x[i:i + 2], w, b, g[i:i + 2], sum_dtype=torch.float64)
              for i in (0, 2)]
    for i, (a, r) in enumerate(zip(fp32, f64)):
        assert r.dtype == torch.float64
        torch.testing.assert_close(a.double(), r, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(halves[0][i] + halves[1][i], r, atol=1e-9, rtol=1e-12)


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


@pytest.mark.parametrize("B,T,H2,W2", [(8, 75, 25, 50), (2, 5, 27, 51), (7, 11, 25, 50),
                                       (1, 2, 10, 100), (3, 7, 5, 9), (1, 1, 1, 1)])
def test_bwd_grid_covers_every_pooled_position(B, T, H2, W2):
    """K4's grid (`bwd_grid`, chosen in Python, run on the card) at 32
    channels: tiles of at most BWD_THREADS positions cover the pooled frame,
    the LipNet frame (25 x 50) with no dead position, one channel group, and
    the chunks split the B*T frames within the CTA target."""
    rows, cols, tiles, chunks, groups = convpool.bwd_grid(B, T, H2, W2, 32)
    assert 1 <= rows * cols <= convpool.BWD_THREADS and groups == 1
    assert tiles == -(-H2 // rows) * -(-W2 // cols)
    assert rows * -(-H2 // rows) >= H2 and cols * -(-W2 // cols) >= W2
    assert 1 <= chunks <= B * T and (tiles * chunks <= convpool.BWD_TARGET_CTAS or chunks == 1)
    if (H2, W2) == (25, 50):
        assert (rows, cols) == (5, 50) and tiles * rows * cols == H2 * W2
        assert tiles * chunks > convpool.BWD_TARGET_CTAS - tiles  # the card is filled


@pytest.mark.parametrize("B", [1, 8, 32, 128])
def test_grids_keep_lipnet_conv1(B):
    """LipNet's conv1 (25 x 50 pooled, 32 channels, 3x5x5) keeps its grids:
    K1 and K4 a 5 x 50 tile, 5 tiles, min(B*T, 52) chunks, and K4 one
    channel group, so its partials, and dW's bits, are unchanged."""
    chunks = min(B * 75, convpool.BWD_TARGET_CTAS // 5)
    assert convpool.bwd_grid(B, 75, 25, 50, 32) == (5, 50, 5, chunks, 1)
    assert convpool.fwd_grid(B, 75, 25, 50, 3, 5, 5, 32) == (5, 50, 5, chunks)


@pytest.mark.parametrize("B,T,H2,W2,C", [(8, 75, 23, 70, 128), (2, 5, 25, 69, 100),
                                         (1, 2, 10, 100, 33), (128, 75, 23, 70, 128),
                                         (1, 1, 1, 1, 64)],
                         ids=["tf_conv1", "ragged", "33ch", "tf_b128", "one_position"])
def test_bwd_grid_shares_the_ctas_over_channel_groups(B, T, H2, W2, C):
    """More than 32 channels take ceil(C / 32) groups, and the CTA target is
    shared out over tiles x groups x chunks. The TF stack's 23 x 70 takes
    7 x 35 (8 tiles, 18% dead, against 48% for the full-width 4 x 64), and
    K1 the same tile."""
    rows, cols, tiles, chunks, groups = convpool.bwd_grid(B, T, H2, W2, C)
    assert groups == -(-C // 32) and 1 <= rows * cols <= convpool.BWD_THREADS
    assert tiles == -(-H2 // rows) * -(-W2 // cols)
    assert 1 <= chunks <= B * T
    assert tiles * groups * chunks <= convpool.BWD_TARGET_CTAS or chunks == 1
    if (H2, W2) == (23, 70):
        assert (rows, cols, tiles, groups) == (7, 35, 8, 4)
        assert chunks == 8
        assert convpool.fwd_grid(B, T, H2, W2, 3, 3, 3, C)[:3] == (7, 35, 8)
