"""The port's bf16 compute mode (`ModelConfig.compute_dtype="bfloat16"`)
against the JAX package's, on the CPU.

Inputs are numpy draws from a seed handed to both packages; weights cross
through `lipnet_params_from_jax`. The JAX package's Pallas kernels run in
interpret mode, the port's CUDA kernels as their plain versions (the card
holds each kernel to its plain version). Dropout is 0: JAX keys cannot be
reproduced.

Tolerances, each where it is used:
  * K1-bf16's plain version against `conv1_pool_fused(out_dtype=bf16)`:
    within one bf16 ulp, equal on >= 99% of elements (both sum bf16 products
    exactly in float32 and round once; only the order of the sums differs);
  * K4-bf16's plain version: its float32 sums against the JAX kernel's on
    the same (bf16-valued) inputs at K4's float32 tolerance, and its one
    rounding against the JAX bf16 result within the roundings the JAX fold
    adds (`K4_BF16_ROUNDINGS`, below);
  * the bf16 conv block, the input projection and the BiGRU: float32
    rounding (the same roundings in the same places);
  * the model: log-probs and each gradient no farther from the JAX bf16
    result than twice the JAX bf16 result's own distance from the JAX
    float32 result on the same inputs, in the L2 norm over the tensor
    (`_within_twice`). The elementwise maximum is no measure here: where
    float32 sums in another order cross a bf16 rounding boundary the two
    packages differ by a whole ulp, against at most half an ulp of
    rounding, so one such flip in a small tensor (a 4-channel bias) can
    exceed twice the largest rounding error; over a tensor the flips are
    rare and the rounding errors everywhere. A gradient leaf's own JAX
    distance is floored at the tree's relative distance times the leaf's
    norm (a 4-element bias gives a noisy estimate of its rounding). Both
    the log-probs and the gradient tree must also lie nearer the JAX bf16
    result than the JAX float32 one (a float32 port would not). The loss:
    the log-probs' elementwise bound carried through the CTC (the NLL of
    a sequence moves at most the sum over its frames of each frame's
    largest log-prob change, then divided by its label length and averaged).
    Greedy argmax equal wherever the JAX float32 top-2 margin exceeds the
    log-probs' elementwise bound (twice the largest JAX bf16 - f32
    difference). Parameters after 3 steps within 6 * lr (Adam moves ~lr a
    step whatever the gradient's size, so a rounding-level gradient may take
    the other sign).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from avsync.config import ModelConfig as JaxModelConfig
from avsync.models import LipNet as JaxLipNet
from avsync.ops.conv import conv3d as jax_conv3d
from avsync.ops.conv import max_pool3d as jax_max_pool3d
from avsync.ops.ctc import ctc_loss_mean as jax_ctc
from avsync.ops.gru import GRUParams, gru_scan, gru_scan_fused
from avsync.ops.pallas.convpool import conv1_pool_bwd as jax_bwd
from avsync.ops.pallas.convpool import conv1_pool_fused as jax_fused
from avsync.train.lipnet_trainer import TrainState as JaxTrainState
from avsync.train.lipnet_trainer import make_optimizer as jax_make_optimizer
from avsync.train.lipnet_trainer import make_train_step
from avsync_torch.compat import lipnet_params_from_jax, lipnet_params_to_jax
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.data.grid import GridDataSource
from avsync_torch.data.pipeline import LipNetBatcher
from avsync_torch.models import LipNet
from avsync_torch.ops.conv import conv_relu_pool
from avsync_torch.ops.ctc import ctc_loss_mean
from avsync_torch.ops.cuda import convpool
from avsync_torch.ops.gru import GRUWeights, bigru, input_projection
from avsync_torch.train.lipnet_trainer import make_optimizer, train_step

BF16 = torch.bfloat16
TINY = dict(hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0)
CONV_SHAPE = (4, 2, 4)  # 16x32 frames after three (1,2,2) pools, 4 channels
LR = 1e-3
# The JAX bf16 K4 rounds each of the four pack4 blocks' float32 sums to bf16
# and adds them in bf16 (three roundings of partial sums): at most 7 half
# ulps of a magnitude no larger than the sum of |x * g| over the routed
# positions, which with x in [0, 1] is at most A = sum of |g| over them (dbias
# of |g|); the port's one rounding adds one more. A half ulp of bf16 is 2^-9.
K4_BF16_ROUNDINGS = 8


def _ulp(v):
    """One bf16 ulp at |v| (the spacing of bf16 values there)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


# ---------------------------------------------------------------------------
# K1 and K4 in bf16
# ---------------------------------------------------------------------------

def _k_case(seed, B=2, T=5, H=16, W=24, k=(3, 5, 5), C=8):
    r = np.random.default_rng(seed)
    x = r.random((B, T, H, W, 1)).astype(np.float32)
    w = (r.normal(size=(*k, 1, C)) * 0.2).astype(np.float32)
    b = (r.normal(size=(C,)) * 0.1).astype(np.float32)
    g = r.normal(size=(B, T, H // 2, W // 2, C)).astype(np.float32)
    return x, w, b, g


def _bf16_np(a):
    """numpy float32 of a rounded to bf16 (the values both packages see)."""
    return torch.from_numpy(a).to(BF16).float().numpy()


K_SHAPES = [(5, 16, 24, (3, 5, 5), 8, 5), (3, 8, 12, (3, 3, 3), 5, 3),
            (5, 10, 20, (3, 5, 5), 32, 5)]
K_IDS = ["k355", "k333", "production_channels"]


@pytest.mark.parametrize("shape", K_SHAPES, ids=K_IDS)
def test_k1_bf16_plain_matches_pallas(shape):
    T, H, W, k, C, t_chunk = shape
    x, w, b, _ = _k_case(1, T=T, H=H, W=W, k=k, C=C)
    want = np.asarray(jax_fused(jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(b),
                                t_chunk=t_chunk, out_dtype=jnp.bfloat16,
                                interpret=True).astype(jnp.float32))
    got = convpool.conv1_pool_fused(torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16),
                                    torch.from_numpy(b))
    assert got.dtype == BF16
    got = got.float().numpy()
    assert (np.abs(got - want) <= _ulp(want)).all()
    assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("shape", K_SHAPES, ids=K_IDS)
def test_k4_bf16_plain_matches_pallas(shape):
    T, H, W, k, C, t_chunk = shape
    x, w, b, g = _k_case(2, T=T, H=H, W=W, k=k, C=C)
    xb, wb, gb = (torch.from_numpy(a).to(BF16) for a in (x, w, g))
    dk, db = convpool.conv1_pool_bwd(xb, wb, torch.from_numpy(b), gb)
    assert dk.dtype == db.dtype == torch.float32
    # the float32 sums: the JAX kernel on the same bf16 values, in float32
    f32 = [np.asarray(a) for a in jax_bwd(*map(jnp.asarray, (_bf16_np(x), _bf16_np(w), b,
                                                             _bf16_np(g))),
                                          t_chunk=t_chunk, out_dtype=jnp.float32,
                                          interpret=True)]
    np.testing.assert_allclose(dk.numpy(), f32[0], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(db.numpy(), f32[1], atol=1e-3, rtol=1e-4)
    # the bf16 contract: dk rounded once, db float32
    jdk, jdb = jax_bwd(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w)), jnp.asarray(b),
                       jnp.asarray(g).astype(jnp.bfloat16), t_chunk=t_chunk,
                       out_dtype=jnp.bfloat16, interpret=True)
    _, routed_abs = convpool.conv1_pool_bwd(xb, wb, torch.from_numpy(b), gb.abs())
    bound = K4_BF16_ROUNDINGS * 2.0 ** -9 * routed_abs.numpy()  # per channel
    diff = np.abs(dk.to(BF16).float().numpy() - np.asarray(jdk.astype(jnp.float32)))
    assert (diff <= bound).all(), (diff / bound).max()
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), atol=1e-3, rtol=1e-4)


def test_conv1pool_rounds_dw_once_and_keeps_db_float32():
    """The autograd Function under bf16: dW is K4's float32 sum rounded to
    bf16 once, handed to the float32 weight; db is the float32 sum."""
    x, w, b, g = _k_case(3, T=3, H=8, W=12, C=4)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(BF16)
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = convpool.conv1_pool_block(xt, wt, bt)
    assert y.dtype == BF16
    gt = torch.from_numpy(g).permute(0, 4, 1, 2, 3).to(BF16)
    y.backward(gt)
    dw, db = convpool.conv1_pool_block_bwd(xt, wt.detach().to(BF16), bt.detach(), gt)
    assert wt.grad.dtype == torch.float32 and torch.equal(wt.grad, dw.to(BF16).float())
    assert torch.equal(bt.grad, db)


def _mma_emulate(x, w, b, g):
    """A float64 emulation of the bf16 kernels' decomposition (csrc/
    conv1_mma.cuh), used by these tests only: for each pooled position the
    four window row blocks of pre-pool positions (jh, jw) times the packed
    weights over the K order (taps (dt, dh, dw) with each kernel row padded
    to kw + 1: the pad tap reads the column past the halo, with weight 0),
    + bias, ReLU'd max (K1-bf16: rounded to bf16 once); the first maximal
    window, jh-major, routes the cotangent where the max is > 0 (bf16-exact
    dpre), and dW is the dense product of dpre with the patches in the K
    order, folded back to (kt, kh, kw, 1, C) (K4-bf16). x (B, T, H, W, 1),
    w (kt, kh, kw, 1, C), b (C,), g (B, T, H/2, W/2, C): numpy float32."""
    x, w, b, g = (torch.from_numpy(a).double() for a in (x, w, b, g))
    B, T, H, W, _ = x.shape
    kt, kh, kw, _, C = w.shape
    pt, ph, pw = (kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
    # one column more on the right: the pad tap of the last kernel row
    xp = torch.nn.functional.pad(x[..., 0], (pw, pw + 1, ph, ph, pt, pt))
    order = convpool.k_order(kt, kh, kw)
    patches = x.new_zeros(B, T, H, W, len(order))  # past K: zero columns, zero weights
    for k in range(kt * kh * (kw + 1)):
        row, dw = divmod(k, kw + 1)
        dt, dh = divmod(row, kh)
        patches[..., k] = xp[:, dt:dt + T, dh:dh + H, dw:dw + W]
    packed = convpool.pack_weights(w)[:C]  # (C, Kpad)
    pre = patches @ packed.t() + b  # (B, T, H, W, C)
    H2, W2 = H // 2, W // 2
    win = pre.reshape(B, T, H2, 2, W2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    win = win.reshape(B, T, H2, W2, 4, C)  # windows jh-major
    top, first = win.max(dim=4)
    pooled = torch.relu(top).float().to(BF16)
    dpre = torch.zeros_like(win).scatter_(4, first[:, :, :, :, None],
                                          torch.where(top > 0, g, 0.0)[:, :, :, :, None])
    dpre = dpre.reshape(B, T, H2, W2, 2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    dpre = dpre.reshape(B, T, H, W, C)
    dwk = torch.einsum("bthwc,bthwk->ck", dpre, patches)  # (C, Kpad)
    return pooled, convpool.fold_dw(dwk, kt, kh, kw, C), dpre.sum(dim=(0, 1, 2, 3))


def _exact_case(seed, B=2, T=5, H=16, W=24, k=(3, 5, 5), C=8):
    """Inputs on grids where every partial sum of the recompute and of the
    dense dW is exact in float32 in any order: x = i/16, w = j/64, b = k/64,
    g = m/8 (|j|, |k| <= 15, |m| <= 8); all bf16-exact."""
    r = np.random.default_rng(seed)
    x = (r.integers(0, 16, (B, T, H, W, 1)) / 16).astype(np.float32)
    w = (r.integers(-15, 16, (*k, 1, C)) / 64).astype(np.float32)
    b = (r.integers(-15, 16, C) / 64).astype(np.float32)
    g = (r.integers(-8, 9, (B, T, H // 2, W // 2, C)) / 8).astype(np.float32)
    return x, w, b, g


@pytest.mark.parametrize("shape", K_SHAPES, ids=K_IDS)
def test_mma_emulation_matches_pallas_on_exact_grids(shape):
    """The decomposition K1-bf16 and K4-bf16 run on the tensor cores (four
    window row blocks, the K order, the dense dW from bf16 dpre), emulated in
    float64, against the JAX package's kernels in interpret mode on exact-
    grid inputs: the pooled bf16 values bit for bit (ties, frequent here,
    route as the forward pools), dW and db exactly; and against the port's
    plain versions the same."""
    T, H, W, k, C, t_chunk = shape
    x, w, b, g = _exact_case(11, T=T, H=H, W=W, k=k, C=C)
    pooled, dk, db = _mma_emulate(x, w, b, g)
    jx, jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
    want = jax_fused(jx, jw, jnp.asarray(b), t_chunk=t_chunk, out_dtype=jnp.bfloat16,
                     interpret=True)
    assert np.array_equal(pooled.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the float32 sums: the JAX kernel on the same (bf16-exact) values in float32
    jdk, jdb = jax_bwd(*map(jnp.asarray, (x, w, b, g)), t_chunk=t_chunk,
                       out_dtype=jnp.float32, interpret=True)
    assert np.array_equal(dk.numpy(), np.asarray(jdk, dtype=np.float64))
    assert np.array_equal(db.numpy(), np.asarray(jdb, dtype=np.float64))
    tx, tw, tg = (torch.from_numpy(a).to(BF16) for a in (x, w, g))
    assert torch.equal(pooled, convpool.conv1_pool_fused(tx, tw, torch.from_numpy(b)))
    pdk, pdb = convpool.conv1_pool_bwd(tx, tw, torch.from_numpy(b), tg)
    assert torch.equal(dk, pdk.double()) and torch.equal(db, pdb.double())
    assert (pooled.float() > 0).any() and (dk != 0).any()


def test_bf16_wrappers_refuse_mixed_dtypes():
    x, w, b, _ = _k_case(4, T=3, H=8, W=12, C=4)
    x, w, b = (torch.from_numpy(a) for a in (x, w, b))
    for args, what in (((x.to(BF16), w, b), "kernel"), ((x.to(BF16), w.to(BF16), b.to(BF16)),
                                                        "bias")):
        with pytest.raises(ValueError, match=what):
            convpool._check_dtypes("conv1_pool", x.device,
                                   (("x", args[0]), ("kernel", args[1])), (("bias", args[2]),))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        convpool._check_dtypes("conv1_pool", x.device, (("x", x.half()),), ())


# ---------------------------------------------------------------------------
# the conv block, the input projection and the BiGRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,k", [(3, 6, (3, 5, 5)), (4, 5, (3, 3, 3))])
def test_bf16_conv_block_matches_jax(cin, cout, k):
    """conv3d(compute bf16, preferred bf16) + bias in bf16, ReLU, pool: the
    conv's sums rounded once, the bias added after (float32 rounding)."""
    r = np.random.default_rng(5)
    x = r.random((2, 5, 12, 16, cin)).astype(np.float32)
    w = (r.normal(size=(*k, cin, cout)) * 0.2).astype(np.float32)
    b = (r.normal(size=(cout,)) * 0.1).astype(np.float32)
    want = jax_max_pool3d(jax.nn.relu(jax_conv3d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), compute_dtype=jnp.bfloat16,
        preferred_dtype=jnp.bfloat16)))
    got = conv_relu_pool(torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(BF16),
                         torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous(),
                         torch.from_numpy(b))
    assert got.dtype == BF16
    got = got.float().permute(0, 2, 3, 4, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert (np.abs(got - want) <= _ulp(want)).all() and (got == want).mean() >= 0.99


def _gru_case(seed, D=20, H=8):
    r = np.random.default_rng(seed)
    x = r.normal(size=(2, 7, D)).astype(np.float32)

    def direction():
        return GRUParams(*(jnp.asarray((r.normal(size=s) * 0.3).astype(np.float32))
                           for s in ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))))

    return x, direction(), direction()


def _port_weights(p):
    return GRUWeights(*(torch.from_numpy(np.array(a)) for a in
                        (np.asarray(p.w_ih).T, np.asarray(p.w_hh).T, p.b_ih, p.b_hh)))


def test_bf16_input_projection_is_float32_from_bf16_operands():
    x, pf, _ = _gru_case(6)
    want = np.asarray(jnp.einsum("btd,dh->bth", jnp.asarray(x).astype(jnp.bfloat16),
                                 pf.w_ih.astype(jnp.bfloat16),
                                 preferred_element_type=jnp.float32) + pf.b_ih)
    got = input_projection(torch.from_numpy(x).to(BF16), _port_weights(pf), BF16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["gru_scan", "gru_scan_fused"])
def test_bf16_bigru_matches_jax(use_kernel):
    """The plain loop rounds h and w_hh in each step's product as `gru_scan`;
    the kernel path runs the float32 recurrence on the float32 gi, as the
    Pallas kernel (float32 rounding either way)."""
    x, pf, pb = _gru_case(7)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    if use_kernel:
        with pltpu.force_tpu_interpret_mode():
            want = [gru_scan_fused(p, xj, reverse=rev, compute_dtype=jnp.bfloat16)
                    for p, rev in ((pf, False), (pb, True))]
    else:
        want = [gru_scan(p, xj, reverse=rev, compute_dtype=jnp.bfloat16)
                for p, rev in ((pf, False), (pb, True))]
    want = np.concatenate([np.asarray(a) for a in want], -1)
    got = bigru(torch.from_numpy(x).to(BF16), _port_weights(pf), _port_weights(pb),
                use_kernel=use_kernel, compute_dtype=BF16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model: forward, one step, three steps
# ---------------------------------------------------------------------------

def _jax_params(jcfg, x, seed):
    with pltpu.force_tpu_interpret_mode():
        params = JaxLipNet(jcfg).init({"params": jax.random.PRNGKey(seed)},
                                      jnp.asarray(x))["params"]
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + r.normal(0.0, 0.05, np.shape(p))).astype(np.float32), params)


def _port_model(params, **model):
    m = LipNet(ModelConfig(**TINY, **model), img_hw=(16, 32), generator=torch.Generator())
    m.load_state_dict(lipnet_params_from_jax(params, conv_shape=CONV_SHAPE))
    return m


def _within_twice(got, bf16, f32, what, floor=0.0):
    """||port bf16 - JAX bf16|| <= 2 max(||JAX bf16 - JAX f32||, floor), L2
    over the tensor."""
    got, bf16, f32 = (np.asarray(a, np.float64) for a in (got, bf16, f32))
    bound = 2.0 * max(float(np.linalg.norm(bf16 - f32)), floor)
    d = float(np.linalg.norm(got - bf16))
    assert d <= bound, f"{what}: {d} > {bound}"


def _nearer_bf16(got, bf16, f32, what):
    """The port's bf16 result lies nearer the JAX bf16 result than the JAX
    float32 one (L2): it rounds, and where the JAX package does."""
    got, bf16, f32 = (np.asarray(a, np.float64) for a in (got, bf16, f32))
    assert np.linalg.norm(got - bf16) < np.linalg.norm(got - f32), what


def _elementwise_bound(bf16, f32):
    return 2.0 * float(np.max(np.abs(np.asarray(bf16) - np.asarray(f32))))


def _argmax_agrees_where_decided(got, f32, bound):
    """Greedy argmax equal wherever the JAX f32 top-2 margin exceeds `bound`."""
    top2 = np.sort(f32, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > bound
    assert decided.mean() > 0.5  # the check is not vacuous
    assert (got.argmax(-1) == f32.argmax(-1))[decided].all()


@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(8)
    x = r.random((2, 6, 16, 32, 1)).astype(np.float32)
    labels = np.asarray([[3, 5, 7, 0], [9, 9, 0, 0]], np.int32)
    lengths = np.asarray([3, 2], np.int32)
    params = _jax_params(JaxModelConfig(**TINY), x, 0)
    return x, labels, lengths, params


FLAGS = [dict(fused_conv_pool=f, use_pallas_gru=g) for f in (False, True) for g in (False, True)]
FLAG_IDS = ["plain", "pallas_gru", "fused_conv", "both_kernels"]


def _jax_apply(params, x, dtype, **flags):
    jcfg = JaxModelConfig(**TINY, compute_dtype=dtype, **flags)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(lambda p, v: JaxLipNet(jcfg).apply({"params": p}, v))(
            params, jnp.asarray(x)))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_bf16_forward_matches_jax(batch, flags):
    x, _, _, params = batch
    want = _jax_apply(params, x, "bfloat16", **flags)
    f32 = _jax_apply(params, x, "float32", **flags)
    m = _port_model(params, compute_dtype="bfloat16", **flags).eval()
    assert m.conv1.fused == flags["fused_conv_pool"]
    with torch.inference_mode():
        got = m(torch.from_numpy(x))
        feats = m.conv_features(torch.from_numpy(x))
    assert got.dtype == feats.dtype == torch.float32
    _within_twice(got.numpy(), want, f32, "log-probs")
    _nearer_bf16(got.numpy(), want, f32, "log-probs")
    _argmax_agrees_where_decided(got.numpy(), f32, _elementwise_bound(want, f32))


def _jax_grads_and_steps(params, x, labels, lengths, dtype, flags, steps):
    jcfg = JaxModelConfig(**TINY, compute_dtype=dtype, **flags)
    jmodel = JaxLipNet(jcfg)
    jopt = jax_make_optimizer(LR, 1.0)
    jb = {"video": jnp.asarray(x), "labels": jnp.asarray(labels),
          "label_lengths": jnp.asarray(lengths)}

    def loss_fn(p):
        return jax_ctc(jmodel.apply({"params": p}, jb["video"]), jb["labels"],
                       jb["label_lengths"])

    step_fn = jax.jit(make_train_step(jmodel, jopt))
    with pltpu.force_tpu_interpret_mode():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        state = JaxTrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
        losses = []
        for _ in range(steps):
            state, m = step_fn(state, jb, jax.random.PRNGKey(1), jnp.float32(LR))
            losses.append(float(m["loss"]))
    return (float(loss), jax.tree.map(np.asarray, grads), losses,
            jax.tree.map(np.asarray, state.params))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("flags", [FLAGS[0], FLAGS[3]], ids=["plain", "both_kernels"])
def test_bf16_train_step_and_three_steps_match_jax(batch, flags):
    x, labels, lengths, params = batch
    loss16, g16, losses16, p16 = _jax_grads_and_steps(params, x, labels, lengths, "bfloat16",
                                                      flags, 3)
    loss32, g32, _, _ = _jax_grads_and_steps(params, x, labels, lengths, "float32", flags, 0)
    model = _port_model(params, compute_dtype="bfloat16", **flags)
    tb = {"video": torch.from_numpy(x), "labels": torch.from_numpy(labels),
          "label_lengths": torch.from_numpy(lengths)}
    lp16, lp32 = (_jax_apply(params, x, dt, **flags) for dt in ("bfloat16", "float32"))
    loss = ctc_loss_mean(model(tb["video"]), tb["labels"], tb["label_lengths"])
    loss.backward()
    T = x.shape[1]
    loss_bound = float(np.mean(T * _elementwise_bound(lp16, lp32) / lengths))
    assert abs(loss.item() - loss16) <= loss_bound
    grads = _leaves(lipnet_params_to_jax({n: p.grad for n, p in model.named_parameters()},
                                         conv_shape=CONV_SHAPE))
    want16, want32 = _leaves(g16), _leaves(g32)
    assert set(grads) == set(want16)
    flat = [np.concatenate([d[k].ravel() for k in sorted(grads)]) for d in (grads, want16, want32)]
    _nearer_bf16(*flat, "gradients")
    rel = np.linalg.norm(flat[1] - flat[2]) / np.linalg.norm(flat[2])
    for name in grads:
        assert grads[name].dtype == np.float32
        _within_twice(grads[name], want16[name], want32[name], name,
                      floor=rel * float(np.linalg.norm(want32[name])))

    model = _port_model(params, compute_dtype="bfloat16", **flags)
    opt = make_optimizer(model.parameters(), LR)
    for i in range(3):
        step_loss, _ = train_step(model, opt, tb, LR)
        np.testing.assert_allclose(step_loss.item(), losses16[i], rtol=2e-2)
    after = _leaves(lipnet_params_to_jax(model.state_dict(), conv_shape=CONV_SHAPE))
    for name, want in _leaves(p16).items():
        assert after[name].dtype == np.float32  # parameters stay float32
        assert np.abs(after[name] - want).max() <= 6 * LR, name


# ---------------------------------------------------------------------------
# the device cache
# ---------------------------------------------------------------------------

def _cache_cfg(root, compute_dtype, **data):
    return AvsyncConfig(model=ModelConfig(compute_dtype=compute_dtype),
                        data=DataConfig(data_path=root, img_height=12, img_width=20,
                                        max_video_length=4, batch_size=2, **data))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from avsync.data import synthetic

    root = str(tmp_path_factory.mktemp("bf16_grid"))
    synthetic.write_corpus(root, n_speakers=1, clips_per_speaker=5, n_frames=4, height=12,
                           width=20, seed=11, with_audio=False, preprocessed=True)
    return root


def test_bf16_cache_post_cast_identical_to_streamed(corpus):
    """A standardized corpus fails the uint8 probe; under bf16 compute
    'auto' stores bf16, and the model's input after its bf16 rounding is
    the streamed one's bit for bit (tests/test_data.py's contract)."""
    cfg = _cache_cfg(corpus, "bfloat16", device_cache="on", standardize_clips=True)
    streamed = LipNetBatcher(GridDataSource(corpus), dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, device_cache="off")), device="cpu")
    cached = LipNetBatcher(GridDataSource(corpus), cfg, device="cpu")
    a = list(streamed.epoch(shuffle=True, seed=3, drop_last=True))
    b = list(cached.epoch(shuffle=True, seed=3, drop_last=True))
    assert cached._device_cache["dtype"] == "bfloat16" and len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["labels"], y["labels"])
        assert y["video"].dtype == torch.float32
        assert torch.equal(torch.as_tensor(x["video"]).to(BF16), y["video"].to(BF16))


def test_cache_dtype_budget_and_auto_resolution(corpus):
    """tests/test_data.py's cases: 'auto' follows the compute dtype, bf16
    halves the clip's charge, an explicit 'bfloat16' needs bf16 compute."""
    f32 = LipNetBatcher(GridDataSource(corpus), _cache_cfg(corpus, "float32"), device="cpu")
    bf16 = LipNetBatcher(GridDataSource(corpus), _cache_cfg(corpus, "bfloat16"), device="cpu")
    assert f32._cache_dtype() == torch.float32 and bf16._cache_dtype() == BF16
    assert 2 * bf16._clip_bytes() == f32._clip_bytes()
    forced = LipNetBatcher(GridDataSource(corpus),
                           _cache_cfg(corpus, "bfloat16", device_cache_dtype="bfloat16"),
                           device="cpu")
    assert forced._cache_dtype() == BF16
    assert LipNetBatcher(GridDataSource(corpus),
                         _cache_cfg(corpus, "bfloat16", device_cache_dtype="float32"),
                         device="cpu")._cache_dtype() == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        LipNetBatcher(GridDataSource(corpus),
                      _cache_cfg(corpus, "float32", device_cache_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="device_cache_dtype"):
        LipNetBatcher(GridDataSource(corpus),
                      _cache_cfg(corpus, "bfloat16", device_cache_dtype="float16"), device="cpu")


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

CLI_DATA = dict(img_height=16, img_width=32, max_video_length=8, batch_size=2,
                max_label_length=6, device_cache="off")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`cli train --compute_dtype bfloat16` for one epoch on a three-speaker
    corpus, its exported `.pth` and the config both packages read."""
    from avsync.data import synthetic
    from avsync_torch.cli import main
    from avsync_torch.config import TrainConfig

    d = tmp_path_factory.mktemp("bf16_cli")
    root = str(d / "grid")
    synthetic.write_corpus(root, n_speakers=3, clips_per_speaker=2, n_frames=8, height=16,
                           width=32, seed=17, with_audio=False)
    cfg = AvsyncConfig(data=DataConfig(data_path=root, **CLI_DATA),
                       model=ModelConfig(dropout_rate=0.0, use_pallas_gru=True,
                                         fused_conv_pool=True, **{k: TINY[k] for k in
                                                                  ("hidden_dim",
                                                                   "conv_channels")}),
                       train=TrainConfig(learning_rate=1e-3, checkpoint_dir=str(d / "ck"),
                                         log_dir=str(d / "logs")))
    port_cfg, jax_cfg = str(d / "port.json"), str(d / "jax.json")
    open(port_cfg, "w").write(cfg.to_json())
    open(jax_cfg, "w").write(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_pallas_gru=False, fused_conv_pool=False)).to_json())
    pth = str(d / "lipnet.pth")
    assert main(["train", "--data_path", root, "--config", port_cfg, "--epochs", "1",
                 "--checkpoint_dir", str(d / "ck"), "--export_pth", pth,
                 "--compute_dtype", "bfloat16", "--device", "cpu"]) == 0
    return d, root, port_cfg, jax_cfg, pth, cfg


def test_cli_train_then_both_test_commands_agree_in_bf16(trained):
    """`test --compute_dtype bfloat16` in both packages on the port's bf16
    training run's `.pth`: the same CER/WER JSON."""
    from avsync.cli import main as jax_main
    from avsync_torch.cli import main

    d, root, port_cfg, jax_cfg, pth, _ = trained
    hist = json.load(open(d / "ck" / "history.json"))
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"]).all()
    out_port, out_jax = str(d / "port_results.json"), str(d / "jax_results.json")
    assert main(["test", "--data_path", root, "--config", port_cfg, "--checkpoint", pth,
                 "--output", out_port, "--compute_dtype", "bfloat16", "--device", "cpu"]) == 0
    assert jax_main(["test", "--data_path", root, "--config", jax_cfg, "--checkpoint", pth,
                     "--output", out_jax, "--compute_dtype", "bfloat16"]) == 0
    assert json.load(open(out_port)) == json.load(open(out_jax))


def _bf16(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              compute_dtype="bfloat16"))


def test_infer_in_bf16_is_the_bf16_reader(trained, capsys):
    """`infer --compute_dtype bfloat16` prints what an in-process bf16
    LipReader transcribes; its log-probs are within twice the JAX bf16
    reader's distance from the JAX f32 reader's."""
    from avsync.config import AvsyncConfig as JaxConfig
    from avsync.predictor import LipReader as JaxReader
    from avsync_torch.cli import main
    from avsync_torch.predictor import LipReader

    d, root, port_cfg, jax_cfg, pth, cfg = trained
    clip = str(d / "clip.npy")
    frames = np.random.default_rng(9).integers(0, 256, (8, 16, 32), dtype=np.uint8)
    np.save(clip, frames)
    assert main(["infer", clip, "--checkpoint", pth, "--config", port_cfg,
                 "--compute_dtype", "bfloat16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    reader = LipReader(pth, config=_bf16(cfg), device="cpu")
    assert reader.model.compute_dtype == BF16
    assert reader.predict_frames(frames) in out
    jcfg = JaxConfig.from_json(open(jax_cfg).read())

    def jax_log_probs(c):
        r = JaxReader(pth, c)
        return np.asarray(r._logprobs(r.preprocess_device(frames[None])))

    got = reader._logprobs(reader.preprocess_device(frames[None])).numpy()
    _within_twice(got, jax_log_probs(_bf16(jcfg)), jax_log_probs(jcfg), "reader log-probs")


def test_export_in_bf16_matches_the_live_bf16_reader(trained, tmp_path):
    """`cli export --compute_dtype bfloat16`: the artifact computes what the
    live bf16 reader does (the same function, traced), at B = 1 and 3."""
    from avsync_torch.cli import main
    from avsync_torch.export import load_exported
    from avsync_torch.predictor import LipReader

    _, _, port_cfg, _, pth, cfg = trained
    out = str(tmp_path / "bf16.zip")
    assert main(["export", "--checkpoint", pth, "--config", port_cfg, "--compute_dtype",
                 "bfloat16", "--device", "cpu", "--out", out]) == 0
    art = load_exported(out)
    reader = LipReader(pth, config=_bf16(cfg), device="cpu")
    frames = np.random.default_rng(10).integers(0, 256, (3, 8, 16, 32), dtype=np.uint8)
    for B in (1, 3):
        want = reader._logprobs(reader.preprocess_device(frames[:B])).numpy()
        np.testing.assert_allclose(art.call(frames[:B])[2], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("command", ["test", "infer", "serve", "quantize"])
def test_int8_with_bf16_runs_each_command(command, trained, tmp_path, capsys):
    """`--quantize int8` (and `quantize`) under `--compute_dtype bfloat16`
    run on the bf16-trained `.pth`: `test` writes finite results, `infer`
    prints what an int8 bf16 LipReader transcribes, `serve`'s reader is an
    int8 bf16 reader whose log-probs are the int8 bf16 forward's, and
    `quantize` writes the float32 command's scales (float32 calibration)."""
    from avsync_torch.cli import build_parser, main, serving_reader, _serving_config
    from avsync_torch.ops.quant import make_int8_forward, quantize_lipnet
    from avsync_torch.predictor import LipReader

    d, root, port_cfg, _, pth, cfg = trained
    common = ["--checkpoint", pth, "--config", port_cfg, "--device", "cpu",
              "--compute_dtype", "bfloat16"]
    frames = np.random.default_rng(12).integers(0, 256, (8, 16, 32), dtype=np.uint8)
    if command == "test":
        out = str(tmp_path / "r.json")
        assert main(["test", "--data_path", root, *common, "--quantize", "int8", "--output",
                     out]) == 0
        assert np.isfinite(json.load(open(out))["cer"])
    elif command == "infer":
        clip = str(tmp_path / "c.npy")
        np.save(clip, frames)
        assert main(["infer", clip, *common, "--quantize", "int8"]) == 0
        reader = LipReader(pth, config=_bf16(cfg), device="cpu", quantize="int8")
        assert f"Predicted: {reader.predict_frames(frames)}" in capsys.readouterr().out
    elif command == "serve":
        args = build_parser().parse_args(["serve", *common, "--quantize", "int8"])
        reader = serving_reader(args, _serving_config(args))
        assert reader.cfg.model.compute_dtype == "bfloat16" and reader._quantize == "int8"
        x = reader._prepare(frames)
        got = reader._logprobs(x)
        qp = quantize_lipnet(reader.model, [x])
        assert torch.equal(got, make_int8_forward(reader.cfg.model)(qp, x))
    else:
        outs = [str(tmp_path / f"{k}.npz") for k in ("bf16", "f32")]
        assert main(["quantize", "--data_path", root, *common, "--out", outs[0]]) == 0
        assert main(["quantize", "--data_path", root, *common[:-2], "--compute_dtype",
                     "float32", "--out", outs[1]]) == 0
        np.testing.assert_array_equal(*(np.load(o)["input_scales"] for o in outs))


def test_int8_forward_takes_a_bf16_model():
    """`make_int8_forward` of a bf16 config is the int8 forward in bf16 for
    the PyTorch family: its log-probs differ from the float32 forward's. For
    the TF family it is the float32 forward, as the JAX switch's of a
    `make_lipnet` model; `tflipnet_int8_apply(compute_dtype="bfloat16")`
    is the TF int8 forward in bf16."""
    from avsync_torch.models import make_lipnet
    from avsync_torch.ops import quant

    x = torch.from_numpy(np.random.default_rng(13).random((2, 6, 16, 32, 1), np.float32))
    for family, conv in (("pytorch", (2, 3, 4)), ("tf", (3, 4, 6))):
        cfg = ModelConfig(family=family, compute_dtype="bfloat16", hidden_dim=8,
                          conv_channels=conv)
        torch.manual_seed(14)
        model = make_lipnet(cfg, img_hw=(16, 32)).eval()
        qp = quant.quantize_lipnet(model, [x])
        got = quant.make_int8_forward(cfg)(qp, x)
        f32 = quant.make_int8_forward(dataclasses.replace(cfg, compute_dtype="float32"))(qp, x)
        if family == "tf":
            assert torch.equal(got, f32)
            got = quant.tflipnet_int8_apply(qp, x, model.cfg, compute_dtype="bfloat16")
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert not torch.equal(got, f32)
        assert (got - f32).abs().max() < 0.5


# ---------------------------------------------------------------------------
# the sync scorer and data parallelism
# ---------------------------------------------------------------------------

def test_sync_scorer_in_bf16_matches_the_jax_scorer(tmp_path):
    """The port's MisalignmentScorer over bf16 conv features (K1-bf16's
    plain version, K5's) against the JAX scorer under bf16: probabilities
    within twice the JAX bf16 scorer's distance from its f32 self (L2), and
    nearer the JAX bf16 scorer than the f32 one."""
    from avsync import compat as jcompat
    from avsync.config import AudioConfig as JaxAudioConfig
    from avsync.config import AvsyncConfig as JaxConfig
    from avsync.config import DataConfig as JaxDataConfig
    from avsync.models import MisalignmentDetector as JaxDetector
    from avsync.predictor import MisalignmentScorer as JaxScorer
    from avsync_torch.config import AudioConfig
    from avsync_torch.predictor import MisalignmentScorer

    tiny, S = dict(hidden_dim=4, conv_channels=(2, 2, 3)), 4000
    lip = JaxLipNet(JaxModelConfig(**tiny)).init({"params": jax.random.PRNGKey(4)},
                                                jnp.zeros((1, 8, 16, 32, 1)))["params"]
    lip = jax.tree.map(lambda a: np.asarray(a) + np.float32(0.05), lip)  # no zero bias
    dim = 2 * 24 + 40
    det = jax.tree.map(np.asarray, JaxDetector(hidden_dim=16).init(
        {"params": jax.random.PRNGKey(5)}, jnp.zeros((1, dim)))["params"])
    lip_path, det_path = str(tmp_path / "lipnet.pth"), str(tmp_path / "det.pth")
    jcompat.save_lipnet_pth(lip, lip_path, conv_shape=(3, 2, 4))
    jcompat.save_detector_pth(det, det_path, dim, 16, {"n_mfcc": 20}, conv_shape=(3, 2, 4))
    data = dict(img_height=16, img_width=32, max_video_length=8)

    def jax_scorer(dtype):
        return JaxScorer(det_path, lip_path, config=JaxConfig(
            data=JaxDataConfig(**data), audio=JaxAudioConfig(max_audio_samples=S),
            model=JaxModelConfig(compute_dtype=dtype, fused_conv_pool=True, **tiny)))

    scorer = MisalignmentScorer(det_path, lip_path, device="cpu", config=AvsyncConfig(
        data=DataConfig(**data), audio=AudioConfig(max_audio_samples=S, use_pallas=True),
        model=ModelConfig(compute_dtype="bfloat16", fused_conv_pool=True, **tiny)))
    assert scorer.lipnet.compute_dtype == BF16 and scorer.lipnet.conv1.fused
    rng = np.random.default_rng(0)
    shifts = (-3, 0, 4)
    requests = [(rng.integers(0, 256, (8, 16, 32), dtype=np.uint8),
                 (0.3 * rng.standard_normal(S)).astype(np.float32)) for _ in range(4)]
    j16, j32 = jax_scorer("bfloat16"), jax_scorer("float32")
    got = np.stack([scorer.score_arrays(f, a, 25.0, shifts) for f, a in requests])
    want16 = np.stack([np.asarray(j16.score_arrays(f, a, 25.0, shifts)) for f, a in requests])
    want32 = np.stack([np.asarray(j32.score_arrays(f, a, 25.0, shifts)) for f, a in requests])
    assert np.isfinite(got).all()
    _within_twice(got, want16, want32, "sync probabilities")
    _nearer_bf16(got, want16, want32, "sync probabilities")


def test_data_parallel_bf16_steps_match_one_process(tmp_path):
    """DP (2, 1) over two gloo ranks under bf16 compute against the same
    three steps in one process on the whole batch. Each rank rounds its
    half's weight gradients to bf16 (the casts' VJP) before the all-reduce,
    where one process rounds the whole sum once: the step-1 gradients agree
    within two bf16 ulps of each leaf's largest element, the losses within
    1e-4 (the forward is row by row), the parameters within 6 * lr."""
    import sys

    from avsync_torch.parallel import multihost

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_parallel_worker as worker

    batch = worker.synth_batch(1)
    cfg = worker.lipnet_config(T=batch["video"].shape[1], compute_dtype="bfloat16")
    model = LipNet(cfg.model, img_hw=(16, 32), generator=torch.Generator().manual_seed(4))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    out = str(tmp_path)
    multihost.spawn(worker.bf16_world2, 2, (out, {"weights": weights, "batch": batch}),
                    device="cpu")
    ranks = [torch.load(os.path.join(out, f"bf16_dp2_{r}.pt"), weights_only=False)
             for r in range(2)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ctc_loss_mean(model(tb["video"]), tb["labels"], tb["label_lengths"]).backward()
    for name, p in model.named_parameters():
        got = ranks[0]["grads"][name]
        tol = 2 * _ulp(float(p.grad.abs().max()))
        assert float((got - p.grad).abs().max()) <= tol, name
    model.zero_grad(set_to_none=True)
    opt = make_optimizer(model.parameters(), LR)
    losses = [train_step(model, opt, tb, LR)[0].item() for _ in range(3)]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
        for name, p in model.named_parameters():
            assert float((res["full"][name] - p.detach()).abs().max()) <= 6 * LR, name
    for name in ranks[0]["per_step"][-1]:  # replicas bit for bit
        assert torch.equal(ranks[0]["per_step"][-1][name], ranks[1]["per_step"][-1][name])
