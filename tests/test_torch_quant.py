"""int8 serving of the port (`avsync_torch/ops/quant.py`, Q1's plain version
in `ops/cuda/quantconv.py`, `LipReader(quantize="int8")`, the `quantize`
command and `test`/`infer`/`serve --quantize int8`) against the JAX
package's (`avsync/ops/quant.py`) on the same numpy inputs, on the CPU.

Bounds: the int8 blocks' int32 sums are exact in both packages and the
epilogue is the same two f32 roundings, so blocks agree within atol/rtol
1e-6 (one ulp of room, should XLA contract the epilogue into an FMA);
calibration scales rtol 1e-5 (K1's plain version sums in another order than
XLA's conv); log-probs atol 1e-4 with greedy transcripts equal; the port's
int8 against its own f32 forward the JAX package's bounds
(tests/test_quant.py:127-137).
"""

import dataclasses
import io
import json
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from avsync.compat import save_lipnet_pth as jax_save_lipnet_pth
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import synthetic
from avsync.models.lipnet import LipNet as JaxLipNet
from avsync.ops import quant as jq
from avsync_torch import text as textlib
from avsync_torch.compat import lipnet_params_from_jax, quant_conv_from_jax, quant_params_from_jax
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.models.lipnet import LipNet
from avsync_torch.ops import quant as tq
from avsync_torch.ops.cuda import quantconv

ROOT = Path(__file__).resolve().parents[1]
DATA = dict(img_height=16, img_width=32, max_video_length=8)
MODEL = dict(hidden_dim=8, conv_channels=(2, 2, 3))
CONV_SHAPE = (3, 2, 4)
JAX_MODEL = JaxModelConfig(**MODEL)
CFG = AvsyncConfig(data=DataConfig(**DATA),
                   model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True, **MODEL))
BLOCK_TOL = dict(atol=1e-6, rtol=1e-6)
LOGPROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    params = JaxLipNet(JAX_MODEL).init({"params": jax.random.PRNGKey(0)},
                                       jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(0)
    return jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.3, np.shape(p))).astype(
        np.float32), params)


@pytest.fixture(scope="module")
def clips():
    return np.random.default_rng(1).random((3, 8, 16, 32, 1), np.float32)


def _model(params, **flags):
    cfg = dataclasses.replace(CFG.model, **flags)
    model = LipNet(cfg, img_hw=(16, 32), generator=torch.Generator())
    model.load_state_dict(lipnet_params_from_jax(params, conv_shape=CONV_SHAPE))
    return model.eval()


@pytest.fixture(scope="module")
def files(tmp_path_factory, jax_params):
    """A reference `.pth` of the seeded weights, the port's config (kernel
    flags on) and the JAX package's (flags off: its Pallas kernels run only
    on a TPU or in interpret mode), and a synthetic GRID corpus."""
    root = tmp_path_factory.mktemp("torch_quant")
    lip = str(root / "lipnet.pth")
    jax_save_lipnet_pth(jax_params, lip, conv_shape=CONV_SHAPE)
    port_cfg, jax_cfg = str(root / "port.json"), str(root / "jax.json")
    Path(port_cfg).write_text(CFG.to_json())
    Path(jax_cfg).write_text(JaxConfig(data=JaxDataConfig(**DATA), model=JAX_MODEL).to_json())
    corpus = str(root / "grid")
    synthetic.write_corpus(corpus, n_speakers=3, clips_per_speaker=2, preprocessed=True,
                           n_frames=8, height=16, width=32, seed=5, with_audio=False)
    return {"lipnet": lip, "port_cfg": port_cfg, "jax_cfg": jax_cfg, "corpus": corpus,
            "root": root}


# ---------------------------------------------------------------------------
# the quantizer and the int8 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_channels", [False, True], ids=["normal", "zero_slices"])
def test_quantize_symmetric_matches_jax(zero_channels):
    k = np.random.default_rng(2).normal(size=(3, 5, 5, 4, 8)).astype(np.float32)
    if zero_channels:
        k[..., 2] = 0.0
        k[..., 5] = 0.0
    jqk, jks = jq.quantize_symmetric(jnp.asarray(k), axes=(0, 1, 2, 3))
    q, s = tq.quantize_symmetric(torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy()),
                                 axes=(1, 2, 3, 4))
    assert q.dtype == torch.int8 and s.shape == (8, 1, 1, 1, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqk).transpose(4, 3, 0, 1, 2))
    np.testing.assert_allclose(s.numpy().reshape(-1), np.asarray(jks).reshape(-1), rtol=1e-7)
    if zero_channels:
        assert (s.reshape(-1)[[2, 5]] == 1.0).all() and (q[[2, 5]] == 0).all()


# (B, Cin, Cout, T, H, W, kernel): the tiny LipNet's three blocks, odd sizes,
# one full-width conv2 block (32 -> 64, 3x5x5, 25 x 50, a floor pool to 12)
BLOCKS = {
    "tiny_conv1": (2, 1, 2, 8, 16, 32, (3, 5, 5)),
    "tiny_conv2": (2, 2, 2, 8, 8, 16, (3, 5, 5)),
    "tiny_conv3": (2, 2, 3, 8, 4, 8, (3, 3, 3)),
    "odd": (2, 3, 5, 5, 9, 13, (1, 3, 5)),
    "full_conv2": (1, 32, 64, 3, 25, 50, (3, 5, 5)),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_quant_conv_block_matches_jax(case):
    """The same f32 input and the JAX block's params carried across
    (`quant_conv_from_jax`): the port's block within 1e-6 of the JAX one."""
    B, cin, cout, T, H, W, (kt, kh, kw) = BLOCKS[case]
    r = np.random.default_rng(3)
    x = r.normal(0.3, 0.5, (B, T, H, W, cin)).astype(np.float32)
    k = (r.normal(size=(kt, kh, kw, cin, cout)) / np.sqrt(cin * kt * kh * kw)).astype(np.float32)
    kq, ks = jq.quantize_symmetric(jnp.asarray(k), axes=(0, 1, 2, 3))
    qc = jq.QuantConvParams(kernel_q=kq, k_scale=ks.reshape(-1),
                            bias=jnp.asarray(r.normal(0, 0.1, cout).astype(np.float32)),
                            x_scale=jnp.asarray(np.abs(x).max() / 127.0, jnp.float32))
    want = np.asarray(jq.quant_conv_block(qc, jnp.asarray(x)))
    got = tq.quant_conv_block(quant_conv_from_jax(qc), torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.shape == (B, cout, T, H // 2, W // 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, **BLOCK_TOL)


def test_plain_version_is_the_operator_on_the_cpu():
    """`int8_conv_pool_ref` (the card's oracle) equals the operator's CPU
    kernel bit for bit; the operator's layout is channels-last, its fake the
    same shape and strides; `pack_kernel` round-trips."""
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.random((2, 3, 4, 7, 10), np.float32))
    kq = torch.from_numpy(r.integers(-127, 128, (5, 3, 3, 3, 3), dtype=np.int8))
    ks = torch.from_numpy(r.random(5, np.float32) * 0.01 + 1e-3)
    qc = tq.quant_conv_params(kq, ks, torch.from_numpy(r.normal(size=5).astype(np.float32)),
                              np.float32(0.02))
    assert torch.equal(quantconv.unpack_kernel(qc.packed, 5, 3, 3, 3, 3), kq)
    assert qc.packed.shape == (32, 96) and not qc.packed[5:].any() and not qc.packed[:, 81:].any()
    got = tq.quant_conv_block(qc, x)
    want = quantconv.int8_conv_pool_ref(x, kq, ks, qc.bias, 0.02)
    assert torch.equal(got, want)
    assert got.permute(0, 2, 3, 4, 1).is_contiguous()
    torch.library.opcheck(quantconv.int8_conv_pool_op,
                          (x, qc.packed, qc.scale, qc.bias, 0.02, 5, 3, 3, 3))


# the hand-off chain: (Cin, Cout, kernel) of three small blocks over (2, 5, 16, 32) clips
CHAIN = [(1, 4, (3, 5, 5)), (4, 16, (3, 5, 5)), (16, 6, (3, 3, 3))]


def _chain(mode):
    """Three blocks' params and an f32 input, seeded. 'random': random
    weights, scales from the f32 chain's absmax; 'ties': x in quarters at
    x_scale 0.5, every epilogue scale 1/8 and every bias a multiple of 1/16,
    so every block input hits exact halves at the next scale 1/8 (round half
    to even); 'extreme': every weight 127, inputs at +127 steps, outputs far
    past the clip."""
    r = np.random.default_rng({"random": 20, "ties": 21, "extreme": 22}[mode])
    x = r.normal(0.3, 0.5, (2, 1, 5, 16, 32)).astype(np.float32)
    if mode == "ties":
        x = (r.integers(-300, 301, x.shape) / 4).astype(np.float32)
    elif mode == "extreme":
        x = np.full(x.shape, 1.27, np.float32)
    qcs, xs = [], {"random": float(np.abs(x).max() / 127), "ties": 0.5, "extreme": 0.01}[mode]
    h = torch.from_numpy(x)
    for i, (cin, cout, k) in enumerate(CHAIN):
        kq = torch.from_numpy(r.integers(-127, 128, (cout, cin, *k), dtype=np.int8))
        ks = torch.from_numpy((r.random(cout) * 0.01 + 1e-4).astype(np.float32))
        bias = torch.from_numpy(r.normal(0, 0.1, cout).astype(np.float32))
        if mode == "ties":
            ks = torch.full((cout,), 0.125 / xs, dtype=torch.float32)
            bias = torch.from_numpy(r.integers(-8, 9, cout) / 16).float()
        elif mode == "extreme":
            kq.fill_(127)
        qc = tq.quant_conv_params(kq, ks, bias, np.float32(xs))
        qcs.append(qc)
        h = tq.quant_conv_block(qc, h)
        xs = {"random": float(h.abs().max()) / 127 or 1.0, "ties": 0.125, "extreme": 0.01}[mode]
    return qcs, torch.from_numpy(x)


@pytest.mark.parametrize("mode", ["random", "ties", "extreme"])
def test_int8_hand_off_equals_the_f32_contract_chain(mode):
    """Each int8 hand-off equals `quantize_input` of the f32-contract
    block's output at the next block's scale; the last block's f32 output
    equals the f32-contract chain's bit for bit."""
    qcs, x = _chain(mode)
    f32, handed = x, x
    for i, qc in enumerate(qcs):
        nxt = float(qcs[i + 1].x_scale) if i + 1 < len(qcs) else None
        plain = quantconv.int8_conv_pool_ref(handed, qc.kernel_q, qc.k_scale, qc.bias,
                                             float(qc.x_scale), nxt)
        f32 = tq.quant_conv_block(qc, f32)
        handed = tq.quant_conv_block(qc, handed, nxt)
        assert handed.permute(0, 2, 3, 4, 1).is_contiguous() and torch.equal(handed, plain)
        if nxt is None:
            assert handed.dtype == torch.float32 and torch.equal(handed, f32)
            continue
        assert handed.dtype == torch.int8
        assert torch.equal(handed, quantconv.quantize_input(f32, nxt).to(torch.int8))
        q = f32 / nxt
        if mode == "ties":  # the halves were there to round
            assert bool((q == q.floor() + 0.5).any())
        if mode == "extreme":  # and the clip to clip
            assert bool((q > 127.5).any()) and bool((handed == 127).any())


@pytest.mark.parametrize("mode", ["random", "ties", "extreme"])
def test_int8_forward_hand_off_keeps_the_log_probs_bit_for_bit(mode, monkeypatch):
    """`lipnet_int8_apply` with the int8 hand-off against the same forward
    through three f32-contract blocks: the same log-prob bits."""
    qcs, x = _chain(mode)
    cfg = ModelConfig(hidden_dim=8, conv_channels=(4, 16, 6), use_pallas_gru=True,
                      fused_conv_pool=True)
    model = LipNet(cfg, img_hw=(16, 32), generator=torch.Generator().manual_seed(23))
    qp = tq.QuantLipNetParams(convs=tuple(qcs), float_params=model.state_dict())
    clips = x.permute(0, 2, 3, 4, 1)
    got = tq.lipnet_int8_apply(qp, clips, cfg)
    block = tq.quant_conv_block
    monkeypatch.setattr(tq, "quant_conv_block",
                        lambda qc, h, out_scale=None, compute_dtype=None: block(
                            qc, h, compute_dtype=compute_dtype))
    want = tq.lipnet_int8_apply(qp, clips, cfg)
    assert got.shape == (2, 5, 39) and torch.equal(got, want)


def test_operator_contracts_on_the_cpu():
    """opcheck of the int8-in and int8-out signatures; an int8 input that is
    not channels-last raises in both versions."""
    r = np.random.default_rng(24)
    kq = torch.from_numpy(r.integers(-127, 128, (5, 16, 3, 3, 3), dtype=np.int8))
    qc = tq.quant_conv_params(kq, torch.full((5,), 0.01), torch.zeros(5), np.float32(0.02))
    x = torch.from_numpy(r.integers(-127, 128, (2, 3, 4, 6, 16), dtype=np.int8)).permute(
        0, 4, 1, 2, 3)
    xf = torch.from_numpy(r.random((2, 16, 3, 4, 6), np.float32))
    for args in [(x, 0.05), (x, None), (xf, 0.05)]:
        torch.library.opcheck(quantconv.int8_conv_pool_op,
                              (args[0], qc.packed, qc.scale, qc.bias, 0.02, 5, 3, 3, 3, args[1]))
    got = tq.quant_conv_block(qc, x, 0.05)
    assert got.dtype == torch.int8 and got.permute(0, 2, 3, 4, 1).is_contiguous()
    assert torch.equal(got, quantconv.quantize_input(tq.quant_conv_block(qc, x), 0.05).to(
        torch.int8))
    with pytest.raises(ValueError, match="channels-last"):
        tq.quant_conv_block(qc, x.contiguous())
    with pytest.raises(ValueError, match="channels-last"):
        quantconv.int8_conv_pool_ref(x.contiguous(), kq, qc.k_scale, qc.bias, 0.02)
    with pytest.raises(ValueError, match="output scale"):
        tq.quant_conv_block(qc, x, 0.0)


def test_tile_choice_and_its_limits():
    """Every tile the wrapper chooses at LipNet's blocks fits the shared
    memory of the CTAs per SM it was chosen under, its ring of kt + 1
    frames and its B ring included: two per SM at conv1; one at conv2 (4 x
    25 pooled positions, 14 warps, B through the ring in stages of 16
    k-chunks) and conv3 (its whole 6 x 12 pooled frame, 15 warps, B through
    the ring): each faster on the card than the earlier 12 x 5 and 6 x 4
    tiles at two per SM; a halo position takes S bytes with S / 16 odd
    where Cin % 4 == 0; a geometry whose single pooled position does not
    fit in one CTA raises and says so."""
    for H2, W2, cin, cout, k, budget in [
            (25, 50, 1, 32, (3, 5, 5), quantconv.TWO_PER_SM),
            (12, 25, 32, 64, (3, 5, 5), quantconv.MAX_SMEM),
            (6, 12, 64, 96, (3, 3, 3), quantconv.MAX_SMEM),
            (1, 1, 3, 5, (1, 1, 1), quantconv.TWO_PER_SM)]:
        tile = quantconv.tile_for(H2, W2, cin, cout, *k)
        rows, cols = tile.rows, tile.cols
        assert 1 <= rows <= H2 and 1 <= cols <= W2 and rows * cols <= 128
        kpad = quantconv.padded(cin * k[0] * k[1] * k[2])
        assert quantconv.shared_memory_bytes(cin, kpad, *k, *tile) <= budget
        assert quantconv.ctas_per_sm(cin, *k, tile) == (2 if budget == quantconv.TWO_PER_SM
                                                        else 1)
    assert quantconv.pos_bytes(32) == 48 and quantconv.pos_bytes(64) == 80
    assert quantconv.pos_bytes(3) == 3 and quantconv.pos_bytes(12) == 16
    with pytest.raises(ValueError, match="shared memory"):
        quantconv.tile_for(4, 4, 4096, 8, 5, 5, 5)
    x = torch.zeros(1, 2, 3, 4, 4)
    with pytest.raises(ValueError, match="odd kernel"):
        quantconv.check_geometry(x, (3, 2, 2, 3, 3), 0.1)
    with pytest.raises(ValueError, match="positive"):
        quantconv.check_geometry(x, (3, 2, 3, 3, 3), 0.0)


@pytest.mark.parametrize("B", [1, 8, 32])
def test_frames_per_cta_fill_the_card(B):
    """At LipNet's blocks (T = 75) the frames per CTA leave a CTA for every
    one of 132 SMs where the batch allows it, and the runs cover T with the
    last one not empty."""
    for H2, W2, cin, cout, k in [(25, 50, 1, 32, (3, 5, 5)), (12, 25, 32, 64, (3, 5, 5)),
                                 (6, 12, 64, 96, (3, 3, 3))]:
        tile = quantconv.tile_for(H2, W2, cin, cout, *k)
        tiles = -(-H2 // tile.rows) * -(-W2 // tile.cols)
        F = quantconv.frames_for(B, 75, tiles)
        runs = -(-75 // F)
        assert 1 <= F <= 75 and (runs - 1) * F < 75
        assert B * tiles * runs >= min(132, B * tiles * 75)
    assert quantconv.frames_for(1, 75, 1) == 1 and quantconv.frames_for(1024, 75, 8) == 75


# the TF-family LipNet's three blocks at full width (75 x 46 x 140 crops,
# 3x3x3 kernels): (H2, W2, Cin, Cout) of the pooled frames
TF_BLOCKS = {"conv1": (23, 70, 1, 128), "conv2": (11, 35, 128, 256),
             "conv3": (5, 17, 256, 64)}


@pytest.mark.parametrize("name", list(TF_BLOCKS))
def test_tf_tiles_fit_the_budget_they_were_chosen_under(name):
    """At the TF blocks the chosen tile's shared memory, the B ring counted,
    fits the CTAs per SM it was chosen under (`ctas_per_sm`, at least one),
    its warps fit the kernel and the SM; it and every candidate of
    `tiles_to_try` have a B ring (groups, chunks) exactly where Cin
    % 16 == 0 and fit one CTA and the kernel's limits."""
    H2, W2, cin, cout = TF_BLOCKS[name]
    k = (3, 3, 3)
    kpad = quantconv.padded(cin * 27)
    tile = quantconv.tile_for(H2, W2, cin, cout, *k)
    per_sm = quantconv.ctas_per_sm(cin, *k, tile)
    smem = quantconv.shared_memory_bytes(cin, kpad, *k, *tile)
    assert per_sm >= 1 and per_sm * (smem + 1024) <= quantconv.SM_SMEM
    assert smem <= quantconv.MAX_SMEM
    assert per_sm * quantconv.warps(tile) <= quantconv.SM_WARPS
    for t in [tile, *quantconv.tiles_to_try(H2, W2, cin, cout, *k)]:
        assert (t.groups > 0) == (cin % 16 == 0)
        assert t.groups == 0 or t.chunks in quantconv.RING_CHUNKS
        assert quantconv.shared_memory_bytes(cin, kpad, *k, *t) <= quantconv.MAX_SMEM
        assert quantconv.warps(t) <= quantconv.MAX_WARPS
        assert t.groups * 32 <= quantconv.padded(cout) and t.rows <= H2 and t.cols <= W2


def test_tf_conv3_tile_covers_16_pooled_positions():
    """The offset tables no longer crowd out the halo ring: TF conv3's tile
    (256 input channels) covers at least 16 pooled positions."""
    H2, W2, cin, cout = TF_BLOCKS["conv3"]
    tile = quantconv.tile_for(H2, W2, cin, cout, 3, 3, 3)
    assert tile.rows * tile.cols >= 16


@pytest.mark.parametrize("name,parent_tile,parent_gb", [("conv2", (4, 4), 14.3),
                                                        ("conv3", (5, 1), 4.5)])
def test_weight_traffic_at_the_tf_blocks_is_below_the_parents(name, parent_tile, parent_gb):
    """The planner's reckoning of the weight bytes one chain call (B=8,
    T=75) reads at TF conv2 and conv3 is below the earlier design's: its
    tiles read B per warp task, 14.3 and 4.5 GB."""
    H2, W2, cin, cout = TF_BLOCKS[name]
    old = quantconv.weight_traffic(8, 75, H2, W2, cin, cout, 3, 3, 3,
                                   quantconv.Q1Tile(*parent_tile))
    assert round(old / 1e9, 1) == parent_gb
    tile = quantconv.tile_for(H2, W2, cin, cout, 3, 3, 3)
    assert quantconv.weight_traffic(8, 75, H2, W2, cin, cout, 3, 3, 3, tile) < old


# ---------------------------------------------------------------------------
# calibration and the int8 forward
# ---------------------------------------------------------------------------

def test_calibrate_conv_input_scales_matches_jax(jax_params, clips):
    batches = [clips[:2], clips[2:]]
    want = jq.calibrate_conv_input_scales(jax_params, batches)
    got = tq.calibrate_conv_input_scales(_model(jax_params), batches)
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("flags", [True, False], ids=["kernel_flags", "plain"])
def test_lipnet_int8_apply_matches_jax(jax_params, clips, flags):
    """The JAX `lipnet_int8_apply` on its own quantized params, the port's on
    the same params carried across: log-probs within 1e-4, the same greedy
    transcripts."""
    qp = jq.quantize_lipnet(jax_params, [clips])
    want = np.asarray(jq.lipnet_int8_apply(qp, jnp.asarray(clips), JAX_MODEL))
    cfg = dataclasses.replace(CFG.model, use_pallas_gru=flags, fused_conv_pool=flags)
    got = tq.lipnet_int8_apply(quant_params_from_jax(jax.tree.map(np.asarray, qp),
                                                     conv_shape=CONV_SHAPE),
                               torch.from_numpy(clips), cfg)
    assert got.shape == want.shape == (3, 8, 39)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGPROB_ATOL, rtol=0)
    from avsync import text as jax_text

    assert textlib.decode_batch(got) == jax_text.decode_batch(jnp.asarray(want))
    # the port's own quantization gives the same params
    ours = tq.quantize_lipnet(_model(jax_params, **{"use_pallas_gru": flags,
                                                    "fused_conv_pool": flags}), [clips])
    np.testing.assert_allclose(tq.lipnet_int8_apply(ours, torch.from_numpy(clips), cfg).numpy(),
                               want, atol=LOGPROB_ATOL, rtol=0)


def test_int8_forward_stays_within_the_jax_bounds_of_f32(jax_params, clips):
    model = _model(jax_params)
    with torch.no_grad():
        ref = model(torch.from_numpy(clips)).numpy()
    got = tq.make_int8_forward(CFG.model)(tq.quantize_lipnet(model, [clips]),
                                          torch.from_numpy(clips)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).mean() < 0.05
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.95


def test_quantize_lipnet_requires_calibration(jax_params):
    model = _model(jax_params)
    with pytest.raises(ValueError, match="calibration"):
        tq.quantize_lipnet(model, [])
    with pytest.raises(ValueError, match="conv layers"):
        tq.quantize_lipnet(model, [], input_scales=np.ones(2, np.float32))
    qp = tq.quantize_lipnet(model, [], input_scales=np.array([0.01, 0.02, 0.03], np.float32))
    assert [float(c.x_scale) for c in qp.convs] == [float(np.float32(v))
                                                    for v in (0.01, 0.02, 0.03)]


def test_unported_int8_modes_raise(files):
    from avsync_torch.predictor import LipReader

    with pytest.raises(ValueError, match="quantize mode"):
        LipReader(checkpoint=files["lipnet"], config=CFG, device="cpu", quantize="int4")


# ---------------------------------------------------------------------------
# the reader, the quantize command and the qscales files
# ---------------------------------------------------------------------------

def _quantize(files, out, *extra):
    from avsync_torch.cli import main

    return main(["quantize", "--config", files["port_cfg"], "--data_path", files["corpus"],
                 "--checkpoint", files["lipnet"], "--out", out, "--device", "cpu", *extra])


def test_cli_quantize_exports_scales(files, tmp_path):
    """As tests/test_serving.py's: the JAX keys, one scale per conv layer; and
    the same scales as the JAX `quantize` on the same corpus and weights."""
    from avsync.cli import main as jax_main

    out, jax_out = str(tmp_path / "scales.npz"), str(tmp_path / "jax_scales.npz")
    assert _quantize(files, out, "--n_calib", "2") == 0
    with np.load(out) as z:
        scales = z["input_scales"]
        assert str(z["family"]) == "pytorch"
        assert int(z["n_calibration_clips"]) >= 2
        assert str(z["checkpoint"]) == str(Path(files["lipnet"]).resolve())
    assert scales.shape == (3,) and (scales > 0).all()
    assert jax_main(["quantize", "--config", files["jax_cfg"], "--data_path", files["corpus"],
                     "--checkpoint", files["lipnet"], "--out", jax_out, "--n_calib", "2"]) == 0
    with np.load(jax_out) as z:
        np.testing.assert_allclose(scales, z["input_scales"], rtol=1e-5)
        assert int(z["n_calibration_clips"]) == int(np.load(out)["n_calibration_clips"])


def test_reader_loads_exported_scales(files, tmp_path):
    from avsync_torch.predictor import LipReader

    out = str(tmp_path / "scales.npz")
    assert _quantize(files, out) == 0
    reader = LipReader(checkpoint=files["lipnet"], config=CFG, device="cpu", quantize="int8",
                       calibration_scales=out)
    # applied at load: no lazy calibration pass will run
    assert reader._qparams is not None
    np.testing.assert_allclose(np.array([float(c.x_scale) for c in reader._qparams.convs]),
                               np.load(out)["input_scales"], rtol=1e-6)
    pred = reader.predict_frames(np.random.default_rng(6).integers(0, 255, (8, 16, 32), np.uint8))
    assert isinstance(pred, str)


def test_family_mismatch_rejected(files, tmp_path):
    from avsync_torch.predictor import LipReader

    bad = str(tmp_path / "bad.npz")
    np.savez(bad, input_scales=np.ones(3, np.float32), family="tf")
    with pytest.raises(ValueError, match="family"):
        LipReader(checkpoint=files["lipnet"], config=CFG, device="cpu", quantize="int8",
                  calibration_scales=bad)


def test_int8_warmup_does_not_calibrate_on_dummy(files):
    from avsync_torch.predictor import LipReader
    from avsync_torch.serving import TranscribeService

    reader = LipReader(checkpoint=files["lipnet"], config=CFG, device="cpu", quantize="int8")
    svc = TranscribeService(reader, max_batch=4, max_wait_ms=5.0)
    try:
        svc.warmup()
        # the all-zero warm-up frames must not become the calibration set
        assert reader._qparams is None and reader._warming is False
        frames = np.random.default_rng(32).integers(0, 255, (8, 16, 32), np.uint8)
        got = svc.transcribe_frames(frames, timeout=60.0)
        assert reader._qparams is not None
        # the same transcript as a fresh int8 reader calibrated on this clip
        fresh = LipReader(checkpoint=files["lipnet"], config=CFG, device="cpu",
                          quantize="int8")
        assert got == fresh.predict_frames(frames)
    finally:
        svc.close()


def test_reader_calibrates_on_given_frames_as_the_jax_reader(files):
    """`calibration_frames` (the second source, after scales): calibrated at
    load on the prepared clips, the JAX reader's scales on the same frames,
    the same transcripts."""
    from avsync_torch.predictor import LipReader

    r = np.random.default_rng(12)
    frames = [r.integers(0, 256, (8, 16, 32), np.uint8) for _ in range(2)]
    ours = LipReader(checkpoint=files["lipnet"], config=CFG, device="cpu", quantize="int8",
                     calibration_frames=frames)
    theirs = _jax_reader(files, calibration_frames=frames)
    assert ours._qparams is not None
    np.testing.assert_allclose([float(c.x_scale) for c in ours._qparams.convs],
                               [float(c.x_scale) for c in theirs._qparams.convs], rtol=1e-5)
    clip = r.integers(0, 256, (8, 16, 32), np.uint8)
    assert ours.predict_frames(clip) == theirs.predict_frames(clip)


def _jax_reader(files, **kw):
    from avsync.predictor import LipReader as JaxLipReader

    return JaxLipReader(files["lipnet"], JaxConfig(data=JaxDataConfig(**DATA), model=JAX_MODEL),
                        quantize="int8", **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_qscales_files_cross_between_packages(files, tmp_path, writer):
    """A file written by either package's `quantize` loads in the other's
    LipReader: the same scales, and both readers give the same transcripts."""
    from avsync.cli import main as jax_main
    from avsync_torch.predictor import LipReader

    out = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        assert jax_main(["quantize", "--config", files["jax_cfg"], "--data_path",
                         files["corpus"], "--checkpoint", files["lipnet"], "--out", out]) == 0
    else:
        assert _quantize(files, out) == 0
    ours = LipReader(checkpoint=files["lipnet"], config=CFG, device="cpu", quantize="int8",
                     calibration_scales=out)
    theirs = _jax_reader(files, calibration_scales=out)
    np.testing.assert_array_equal([float(c.x_scale) for c in ours._qparams.convs],
                                  [float(c.x_scale) for c in theirs._qparams.convs])
    r = np.random.default_rng(7)
    for _ in range(3):
        frames = r.integers(0, 256, (8, 16, 32), np.uint8)
        assert ours.predict_frames(frames) == theirs.predict_frames(frames)


# ---------------------------------------------------------------------------
# test / infer / serve --quantize int8
# ---------------------------------------------------------------------------

def test_cli_test_quantize_matches_jax(files, tmp_path):
    from avsync.cli import main as jax_main
    from avsync_torch.cli import main

    out_port, out_jax = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert main(["test", "--data_path", files["corpus"], "--config", files["port_cfg"],
                 "--checkpoint", files["lipnet"], "--output", out_port, "--device", "cpu",
                 "--quantize", "int8"]) == 0
    assert jax_main(["test", "--data_path", files["corpus"], "--config", files["jax_cfg"],
                     "--checkpoint", files["lipnet"], "--output", out_jax,
                     "--quantize", "int8"]) == 0
    got, want = json.load(open(out_port)), json.load(open(out_jax))
    assert got == want and got["num_samples"] == 2


def test_cli_infer_quantize_matches_jax(files, tmp_path, capsys):
    from avsync.cli import main as jax_main
    from avsync_torch.cli import main

    clip = str(tmp_path / "clip.npy")
    np.save(clip, np.random.default_rng(9).integers(0, 256, (8, 16, 32), dtype=np.uint8))
    assert main(["infer", clip, "--checkpoint", files["lipnet"], "--config", files["port_cfg"],
                 "--device", "cpu", "--quantize", "int8"]) == 0
    ours = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Predicted:")]
    assert jax_main(["infer", clip, "--checkpoint", files["lipnet"], "--config",
                     files["jax_cfg"], "--quantize", "int8"]) == 0
    theirs = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Predicted:")]
    assert len(ours) == 1 and ours == theirs


def _post_npy(url, frames):
    buf = io.BytesIO()
    np.save(buf, frames)
    req = urllib.request.Request(url + "/v1/transcribe", data=buf.getvalue(), method="POST",
                                 headers={"Content-Type": "application/x-npy"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_quantize_answers_as_the_jax_int8_daemon(files, tmp_path):
    """`serve --quantize int8 --qscales FILE --port 0 --warmup` as a child
    process and the JAX package's int8 daemon on the same scales (in this
    process, port 0): the same transcripts; SIGTERM drains, exit 0."""
    from avsync.serving import AvsyncServer as JaxServer
    from avsync.serving import TranscribeService as JaxTranscribeService

    scales = str(tmp_path / "scales.npz")
    assert _quantize(files, scales) == 0
    theirs = JaxServer(JaxTranscribeService(_jax_reader(files, calibration_scales=scales),
                                            max_batch=2), port=0)
    theirs.start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "avsync_torch.cli", "serve", "--checkpoint", files["lipnet"],
         "--config", files["port_cfg"], "--device", "cpu", "--port", "0", "--warmup",
         "--max_batch", "2", "--quantize", "int8", "--qscales", scales],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url, lines = None, []
        deadline = time.time() + 120
        while url is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if " on http://" in line:
                url = line.split(" on ")[1].split()[0]
        assert url and not url.endswith(":0"), lines
        jax_url = f"http://{theirs.address[0]}:{theirs.address[1]}"
        r = np.random.default_rng(11)
        for _ in range(3):
            frames = r.integers(0, 256, (8, 16, 32), np.uint8)
            got, want = _post_npy(url, frames), _post_npy(jax_url, frames)
            assert got["transcript"] == want["transcript"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
    finally:
        theirs.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
