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


@pytest.mark.parametrize("x_shape,dtype,w_shape,takes", [
    ((2, 1, 3, 46, 140), torch.float32, (128, 1, 3, 3, 3), True),  # the TF stack's conv1
    ((2, 1, 3, 46, 140), torch.bfloat16, (128, 1, 3, 3, 3), False),  # K4-bf16: 32 at most
    ((2, 1, 3, 50, 100), torch.float32, (32, 1, 3, 5, 5), True),  # LipNet's
    ((2, 1, 3, 50, 100), torch.bfloat16, (32, 1, 3, 5, 5), True),
    ((2, 1, 3, 50, 100), torch.float32, (512, 1, 3, 5, 5), True),
    ((2, 1, 3, 50, 100), torch.float32, (4096, 1, 3, 5, 5), False),  # K1's weights past 227 KB
    ((2, 1, 3, 50, 99), torch.float32, (32, 1, 3, 5, 5), False),  # odd W
    ((2, 1, 3, 50, 100), torch.float32, (32, 1, 3, 4, 5), False),  # even kernel
    ((2, 1, 3, 50, 100), torch.float32, (32, 1, 9, 5, 5), False),  # 225 taps
    ((2, 2, 3, 50, 100), torch.float32, (32, 2, 3, 5, 5), False),  # two input channels
    ((2, 1, 3, 50, 100), torch.float64, (32, 1, 3, 5, 5), False)],
    ids=["tf_f32", "tf_bf16", "lipnet_f32", "lipnet_bf16", "c512", "c4096", "odd_w",
         "even_kernel", "taps", "cin2", "float64"])
def test_fused_takes_what_the_kernels_take(x_shape, dtype, w_shape, takes):
    """The model's one gate (`fused_takes`), from the input's shape and dtype
    and the weight's shape: float32 any channel count whose K1 CTA fits (128
    and more; no TPU lane rule), bf16 at most 32."""
    from avsync_torch.ops.cuda import convpool

    x = torch.empty(x_shape, dtype=dtype, device="meta")
    assert convpool.fused_takes(x, torch.empty(w_shape, device="meta")) == takes


# ---------------------------------------------------------------------------
# the bf16 kernels' host-side pieces (csrc/conv1_mma.cuh)
# ---------------------------------------------------------------------------

K_SHAPES = [(3, 5, 5), (3, 3, 3), (1, 3, 5), (7, 7, 7), (1, 1, 1)]


@pytest.mark.parametrize("k", K_SHAPES, ids=lambda k: "x".join(map(str, k)))
def test_k_order_holds_each_tap_once(k):
    """The tap table: every tap exactly once, each kernel row padded to an
    even length kw + 1 (its last entry a pad), the length a multiple of 16,
    nothing but pads past K."""
    from avsync_torch.ops.cuda import convpool

    kt, kh, kw = k
    order = convpool.k_order(kt, kh, kw)
    K = kt * kh * (kw + 1)
    assert len(order) % 16 == 0 and K <= len(order) < K + 16
    real = [t for t in order if t >= 0]
    assert sorted(real) == list(range(kt * kh * kw))
    for i, tap in enumerate(order):
        row, dw = divmod(i, kw + 1)
        if i >= K or dw == kw:
            assert tap == -1
        else:
            assert tap == row * kw + dw
    # a 32-bit A register holds k = 2p, 2p + 1: one kernel row's taps dw, dw + 1
    for p in range(K // 2):
        a, b = order[2 * p], order[2 * p + 1]
        assert a >= 0 and (b == -1 or (b == a + 1 and a // kw == b // kw))


@pytest.mark.parametrize("k,C", [((3, 5, 5), 32), ((3, 3, 3), 5), ((1, 3, 5), 40)])
def test_pack_weights_in_the_k_order_zero_padded(k, C):
    """The weight packer: row c, column k of the (npad, Kpad) B matrix is the
    weight of tap k_order[k] and channel c; zero at the pad taps, past K and
    past C; `fold_dw` maps it back to the (kt, kh, kw, 1, C) weights."""
    from avsync_torch.ops.cuda import convpool

    w = torch.from_numpy(_case(5, k=k, C=C)[1])
    packed = convpool.pack_weights(w)
    order = convpool.k_order(*k)
    g = convpool.mma_geometry(*k, C, 5, 50)
    assert packed.shape == (g["npad"], g["Kpad"]) and g["npad"] % 32 == 0
    flat = w.reshape(-1, C)
    for i, tap in enumerate(order):
        if tap < 0:
            assert (packed[:, i] == 0).all()
        else:
            assert torch.equal(packed[:C, i], flat[tap])
    assert (packed[C:] == 0).all()
    assert torch.equal(convpool.fold_dw(packed, *k, C), w)


@pytest.mark.parametrize("k,C", [((3, 5, 5), 32), ((3, 3, 3), 5), ((1, 3, 5), 9)])
def test_fold_dw_reads_only_real_taps(k, C):
    """The fold of K4-bf16's dW layout: (>= C, Kpad) in the K order ->
    (kt, kh, kw, 1, C); whatever the pad columns and rows past C hold is
    dropped."""
    from avsync_torch.ops.cuda import convpool

    kt, kh, kw = k
    g = convpool.mma_geometry(*k, C, 5, 50)
    dwk = torch.randn(g["mpad"], g["Kpad"], dtype=torch.float64,
                      generator=torch.Generator().manual_seed(7))
    folded = convpool.fold_dw(dwk, kt, kh, kw, C)
    assert folded.shape == (kt, kh, kw, 1, C)
    for i, tap in enumerate(convpool.k_order(kt, kh, kw)):
        if tap >= 0:
            dt, rem = divmod(tap, kh * kw)
            dh, dw = divmod(rem, kw)
            assert torch.equal(folded[dt, dh, dw, 0], dwk[:C, i])


@pytest.mark.parametrize("k,C,TR,TC", [((3, 5, 5), 32, 5, 50), ((3, 5, 5), 32, 5, 25),
                                       ((3, 3, 3), 5, 5, 9), ((1, 3, 5), 7, 3, 35),
                                       ((7, 7, 7), 96, 2, 64)])
def test_mma_geometry_keeps_pairs_aligned_and_rows_in_the_halo(k, C, TR, TC):
    """The shared-memory layout: a copy's rows hold every column the A and
    dW B loads read (the pad tap's one past the conv's halo, from a column
    up to 3 left of the halo), 8-byte aligned slots for the cp.async
    copies, the row stride and copy O's offset off the banks of
    neighbouring rows (RW % 32 in [10, 24], OP % 32 == 28)."""
    from avsync_torch.ops.cuda import convpool

    kt, kh, kw = k
    g = convpool.mma_geometry(*k, C, TR, TC)
    assert g["LE"] % 4 == 0 and g["LE"] >= 3 + 2 * TC + kw + 1
    assert g["RW"] >= g["RWu"] == g["LE"] // 2 and g["RW"] % 2 == 0
    assert 10 <= g["RW"] % 32 <= 24
    assert g["OP"] >= g["IH"] * g["RW"] and g["OP"] % 32 == 28
    assert g["slot_words"] == g["OP"] + g["IH"] * g["RW"] and g["slot_words"] % 2 == 0
    assert g["IH"] == 2 * TR + kh - 1 and g["R"] == kt + 1
    assert g["wrow"] % 8 == 4 and g["Kpad"] == len(convpool.k_order(*k))


GRID_SHAPES = [(8, 75, 25, 50, (3, 5, 5), 32), (1, 75, 25, 50, (3, 5, 5), 32),
               (2, 5, 27, 51, (3, 5, 5), 32), (7, 11, 25, 50, (3, 5, 5), 32),
               (1, 2, 10, 100, (3, 5, 5), 9), (3, 7, 5, 9, (3, 3, 3), 5),
               (1, 1, 1, 1, (3, 5, 5), 32), (1, 3, 25, 50, (7, 7, 7), 96),
               (128, 75, 25, 50, (3, 5, 5), 32)]


# K4-bf16 takes at most 32 channels (`CHANNEL_GROUP`)
@pytest.mark.parametrize("B,T,H2,W2,k,C,bwd", [
    (*shape, bwd) for shape in GRID_SHAPES for bwd in (False, True) if not bwd or shape[-1] <= 32])
def test_mma_grid_covers_every_pooled_position_once(B, T, H2, W2, k, C, bwd):
    """The bf16 kernels' grid (`mma_grid`): the tiles cover every pooled
    position exactly once (K1's at most 256 positions, K4's 128), the runs
    cover every frame of a clip once, the CTA's shared memory fits, and
    LipNet's 25 x 50 frame has no dead position (K1 5 x 50, K4 5 x 25)."""
    from avsync_torch.ops.cuda import convpool

    rows, cols, tiles, runs = convpool.mma_grid(B, T, H2, W2, *k, C, bwd=bwd)
    assert 1 <= rows * cols <= (convpool.MMA_BWD_MAX_POS if bwd else convpool.BWD_THREADS)
    tiles_w = -(-W2 // cols)
    assert tiles == -(-H2 // rows) * tiles_w
    hits = np.zeros((H2, W2), int)
    for tile in range(tiles):
        h0, w0 = (tile // tiles_w) * rows, (tile % tiles_w) * cols
        hits[h0:h0 + rows, w0:w0 + cols] += 1  # positions past the frame are dead
    assert (hits == 1).all()
    frames = -(-T // runs)
    assert 1 <= runs <= T and -(-T // frames) == runs
    covered = np.zeros(T, int)
    for r in range(runs):
        covered[r * frames:min(T, (r + 1) * frames)] += 1
    assert (covered == 1).all()
    assert convpool.mma_smem_bytes(*k, C, rows, cols, bwd) <= convpool.MAX_SMEM
    if (H2, W2, k, C) == (25, 50, (3, 5, 5), 32):
        assert (rows, cols) == ((5, 25) if bwd else (5, 50))
        assert tiles * rows * cols == H2 * W2
