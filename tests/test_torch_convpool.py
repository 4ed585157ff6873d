"""The port's fused conv1+ReLU+pool (plain version of csrc/conv1_pool.cu)
against the JAX package's Pallas kernel in interpret mode, and the port's
conv3d/max_pool3d against the JAX ones.

Inputs are drawn with numpy from a seed and handed to both packages. The
CUDA kernel is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py). Tolerances are the JAX
package's own for this op (tests/test_pallas_convpool.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync.ops.conv import conv3d as jax_conv3d, max_pool3d as jax_max_pool3d
from avsync.ops.pallas.convpool import conv1_pool_fused as jax_conv1_pool_fused
from avsync_torch.ops.conv import conv_relu_pool
from avsync_torch.ops.cuda.convpool import conv1_pool_block, conv1_pool_fused

ATOL, RTOL = 1e-4, 1e-4


def _case(seed, B=2, T=6, H=8, W=12, k=(3, 5, 5), C=4):
    r = np.random.default_rng(seed)
    x = r.random((B, T, H, W, 1)).astype(np.float32)
    w = (r.random((*k, 1, C)) - 0.5).astype(np.float32)
    b = (r.random(C) - 0.5).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("k", [(3, 5, 5), (3, 3, 3)], ids=["k355", "k333"])
@pytest.mark.parametrize("C,T,H,W,t_chunk", [(4, 6, 8, 12, 3), (32, 5, 10, 20, 5)],
                         ids=["C4", "C32"])
def test_fused_matches_pallas_interpret(k, C, T, H, W, t_chunk):
    x, w, b = _case(1, T=T, H=H, W=W, k=k, C=C)
    ref = np.asarray(jax_conv1_pool_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                          t_chunk=t_chunk, out_dtype=jnp.float32,
                                          interpret=True))
    got = conv1_pool_fused(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.shape == (x.shape[0], T, H // 2, W // 2, C)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_ncdhw_block_is_the_same_function():
    x, w, b = _case(2, T=5, H=10, W=14, C=32)
    want = conv1_pool_fused(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    got = conv1_pool_block(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                           torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous(),
                           torch.from_numpy(b))
    assert got.shape == (2, 32, 5, 5, 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cin,cout,k", [(1, 4, (3, 5, 5)), (3, 5, (3, 3, 3))],
                         ids=["conv1_like", "conv3_like"])
def test_conv_relu_pool_matches_jax(cin, cout, k):
    r = np.random.default_rng(3)
    x = r.random((2, 4, 8, 12, cin)).astype(np.float32)
    w = (r.random((*k, cin, cout)) - 0.5).astype(np.float32)
    b = (r.random(cout) - 0.5).astype(np.float32)
    ref = np.asarray(jax_max_pool3d(jax.nn.relu(
        jax_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))))
    got = conv_relu_pool(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                         torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous(),
                         torch.from_numpy(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref,
                               atol=ATOL, rtol=RTOL)


def test_rejects_what_the_kernel_does_not_take():
    x, w, b = _case(4, H=9)
    with pytest.raises(ValueError, match="even H and W"):
        conv1_pool_fused(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    x, w, b = _case(4, k=(2, 5, 5))
    with pytest.raises(ValueError, match="odd kernel"):
        conv1_pool_fused(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))


def test_only_cpu_tensors_take_the_plain_version():
    """Any other device goes to the kernel or raises; it never falls back."""
    x, w, b = (torch.empty(s, device="meta") for s in ((1, 3, 4, 4, 1), (3, 3, 3, 1, 2), (2,)))
    with pytest.raises(ValueError, match="unsupported device"):
        conv1_pool_fused(x, w, b)


@pytest.mark.parametrize("B,T,H2,W2,k,C", [
    (8, 75, 25, 50, (3, 5, 5), 32), (1, 75, 25, 50, (3, 5, 5), 32),
    (2, 5, 27, 51, (3, 5, 5), 32), (7, 11, 25, 50, (3, 5, 5), 32),
    (1, 2, 10, 100, (3, 5, 5), 9), (3, 7, 5, 9, (3, 3, 3), 5), (1, 1, 1, 1, (3, 5, 5), 32),
    (1, 3, 25, 50, (7, 7, 7), 96)])
def test_fwd_grid_covers_every_pooled_position_once(B, T, H2, W2, k, C):
    """K1's grid (`fwd_grid`, chosen in Python, run on the card): the tiles
    cover every pooled position exactly once, the LipNet frame (25 x 50)
    with no dead position, the chunks split the B*T frames, and the CTA's
    shared memory fits (a large kernel takes fewer rows)."""
    from avsync_torch.ops.cuda import convpool

    rows, cols, tiles, chunks = convpool.fwd_grid(B, T, H2, W2, *k, C)
    assert 1 <= rows * cols <= convpool.BWD_THREADS
    tiles_w = -(-W2 // cols)
    assert tiles == -(-H2 // rows) * tiles_w
    hits = np.zeros((H2, W2), int)
    for tile in range(tiles):
        h0, w0 = (tile // tiles_w) * rows, (tile % tiles_w) * cols
        hits[h0:h0 + rows, w0:w0 + cols] += 1  # positions past the frame are dead
    assert (hits == 1).all()
    assert 1 <= chunks <= B * T and (tiles * chunks <= convpool.BWD_TARGET_CTAS or chunks == 1)
    cpad = -(-C // 16) * 16
    smem = (4 * (k[0] * k[1] * k[2] * cpad + cpad)
            + 16 * k[0] * (2 * rows + k[1] - 1) * (2 * cols + k[2] - 1))
    assert smem <= convpool.MAX_SMEM
    if (H2, W2, k, C) == (25, 50, (3, 5, 5), 32):
        assert (rows, cols) == (5, 50) and tiles * rows * cols == H2 * W2
