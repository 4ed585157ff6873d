"""int8 serving under bf16 compute in the port (Q1's bf16 epilogue and its
int8 hand-off, the bf16-operand recurrence, `lipnet_int8_apply` /
`tflipnet_int8_apply` with `compute_dtype="bfloat16"`, the commands) and the
CLI's backend-tuned defaults, against the JAX package on the same numpy
inputs, on the CPU at small sizes.

Bounds, each where it is used:
  * Q1's plain version under bf16 against `quant_conv_block(out_dtype=
    bfloat16)`, packed and unpacked, in every contract: bit for bit (exact
    int32 sums, then the same three bf16 roundings; the int8 hand-off
    quantizes the bf16 value in float32, as the next JAX block does);
  * the hand-off chain against three bf16-contract blocks: bit for bit;
  * `gru_recurrence_ref(compute_dtype=bf16)` against `gru_scan(compute_
    dtype=bf16)`: 1e-5 (the same roundings, float32 sums in another order);
  * the int8-bf16 forward of each family: the bf16 principle of
    tests/test_torch_bf16.py: log-probs within twice the JAX bf16
    result's L2 distance from the JAX f32 int8 result, and nearer the JAX
    bf16 result than the f32 one (a float32 port fails this), argmax equal
    where the f32 margin exceeds twice the largest bf16 error;
  * calibration scales under bf16: rtol 1e-5 (tests/test_torch_quant.py);
  * `test`/`infer`/`serve --quantize int8` under bf16 against the JAX CLI:
    the same JSON and transcripts.
"""

import dataclasses
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from avsync import cli as jax_cli
from avsync.compat import save_lipnet_pth as jax_save_lipnet_pth
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import synthetic
from avsync.models.lipnet import LipNet as JaxLipNet
from avsync.models.lipnet_tf import TFLipNet as JaxTFLipNet
from avsync.models.lipnet_tf import TFModelConfig as JaxTFModelConfig
from avsync.ops import quant as jq
from avsync.ops.gru import GRUParams, gru_scan
from avsync_torch import cli
from avsync_torch.compat import (quant_conv_from_jax, quant_params_from_jax,
                                  tflipnet_params_from_jax)
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.ops import quant as tq
from avsync_torch.ops.cuda import gru as cuda_gru
from avsync_torch.ops.cuda import quantconv
from avsync_torch.ops.gru import GRUWeights, input_projection

ROOT = Path(__file__).resolve().parents[1]
BF = torch.bfloat16
DATA = dict(img_height=16, img_width=32, max_video_length=8)
MODEL = dict(hidden_dim=8, conv_channels=(2, 2, 3))
CONV_SHAPE = (3, 2, 4)
JAX_MODEL = JaxModelConfig(**MODEL)
CFG = AvsyncConfig(data=DataConfig(**DATA),
                   model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True, **MODEL))
TF_SMALL = dict(conv_channels=(3, 4, 6), hidden_dim=8)
TF_CONV_SHAPE = (6, 2, 4)
GRU_ATOL = 1e-5


def _nhwc(t):
    return t.permute(0, 2, 3, 4, 1)


# ---------------------------------------------------------------------------
# Q1's bf16 epilogue and its hand-off
# ---------------------------------------------------------------------------

# (B, Cin, Cout, T, H, W, kernel): the tiny LipNet's blocks, odd sizes, a
# full-width conv2 block at T=2
BLOCKS = {
    "tiny_conv1": (2, 1, 2, 8, 16, 32, (3, 5, 5)),
    "tiny_conv2": (2, 2, 4, 6, 8, 16, (3, 5, 5)),
    "tiny_conv3": (2, 4, 3, 6, 4, 8, (3, 3, 3)),
    "odd": (2, 3, 5, 5, 9, 13, (1, 3, 5)),
    "full_conv2": (1, 32, 64, 2, 25, 50, (3, 5, 5)),
}
CONTRACTS = ("f32_bf16", "f32_s8", "s8_s8", "s8_bf16")


def _jax_block(case, seed):
    B, cin, cout, T, H, W, (kt, kh, kw) = BLOCKS[case]
    r = np.random.default_rng(seed)
    x = r.normal(0.3, 0.5, (B, T, H, W, cin)).astype(np.float32)
    k = (r.normal(size=(kt, kh, kw, cin, cout)) / np.sqrt(cin * kt * kh * kw)).astype(np.float32)
    kq, ks = jq.quantize_symmetric(jnp.asarray(k), axes=(0, 1, 2, 3))
    qc = jq.QuantConvParams(kernel_q=kq, k_scale=ks.reshape(-1),
                            bias=jnp.asarray(r.normal(0, 0.1, cout).astype(np.float32)),
                            x_scale=jnp.asarray(np.abs(x).max() / 127.0, jnp.float32))
    return x, qc


@pytest.mark.parametrize("contract", CONTRACTS)
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_q1_bf16_plain_version_equals_the_jax_block(case, packed, contract):
    """In each contract (float32 or int8 in; bf16 or int8 out) the port's
    block under bf16 (the operator's CPU kernel and `int8_conv_pool_ref`)
    equals `quant_conv_block(out_dtype=bfloat16)` bit for bit; the int8
    output equals the next JAX block's quantization of that bf16 output."""
    x, jqc = _jax_block(case, 30)
    want = jq.quant_conv_block(jqc, jnp.asarray(x), out_dtype=jnp.bfloat16, packed=packed)
    qc = quant_conv_from_jax(jqc)
    xin = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    if contract.startswith("s8"):  # a block's int8 output: the JAX block's own quantization
        xq = np.asarray(jq._quantize_activation(jnp.asarray(x), jqc.x_scale))
        xin = torch.from_numpy(xq).permute(0, 4, 1, 2, 3)
    out_scale = None
    if contract.endswith("s8"):
        out_scale = float(np.float32(np.abs(np.asarray(want, np.float32)).max() / 127.0 * 0.9))
        want = jq._quantize_activation(want, jnp.float32(out_scale))
    got = tq.quant_conv_block(qc, xin, out_scale, compute_dtype=BF)
    plain = quantconv.int8_conv_pool_ref(xin, qc.kernel_q, qc.k_scale, qc.bias,
                                         float(qc.x_scale), out_scale, compute_dtype=BF)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == (BF if out_scale is None else torch.int8)
    assert _nhwc(got).is_contiguous() and torch.equal(got, plain)
    assert torch.equal(_nhwc(got).float(), want)


def test_q1_bf16_operator_contracts_on_the_cpu():
    """opcheck of the bf16 signatures (f32 or int8 in, bf16 or int8 out);
    the bf16 scales are the float32 ones rounded once; the float32
    contract's arithmetic is unchanged."""
    r = np.random.default_rng(31)
    kq = torch.from_numpy(r.integers(-127, 128, (5, 16, 3, 3, 3), dtype=np.int8))
    qc = tq.quant_conv_params(kq, torch.from_numpy(r.random(5, np.float32) * 0.01 + 1e-3),
                              torch.from_numpy(r.normal(0, 0.1, 5).astype(np.float32)),
                              np.float32(0.02))
    assert qc.scale16.dtype == qc.bias16.dtype == BF
    assert torch.equal(qc.scale16, qc.scale.to(BF)) and torch.equal(qc.bias16, qc.bias.to(BF))
    x = torch.from_numpy(r.integers(-127, 128, (2, 3, 4, 6, 16), dtype=np.int8)).permute(
        0, 4, 1, 2, 3)
    xf = torch.from_numpy(r.random((2, 16, 3, 4, 6), np.float32))
    for xin, out_scale in [(x, 0.05), (x, None), (xf, 0.05), (xf, None)]:
        torch.library.opcheck(quantconv.int8_conv_pool_op, (xin, qc.packed, qc.scale16,
                                                            qc.bias16, 0.02, 5, 3, 3, 3,
                                                            out_scale))
    f32, bf16 = tq.quant_conv_block(qc, xf), tq.quant_conv_block(qc, xf, compute_dtype=BF)
    assert f32.dtype == torch.float32 and bf16.dtype == BF
    assert torch.equal(f32, quantconv.int8_conv_pool_ref(xf, kq, qc.k_scale, qc.bias, 0.02))
    assert not torch.equal(bf16.float(), f32)  # the epilogue rounds


# the hand-off chain: (Cin, Cout, kernel) of three small blocks over (2, 5, 16, 32) clips
CHAIN = [(1, 4, (3, 5, 5)), (4, 16, (3, 5, 5)), (16, 6, (3, 3, 3))]


def _chain(mode):
    """Three blocks' params and an f32 input, seeded: 'random' scales from
    the bf16 chain's absmax, 'extreme' every weight 127 and outputs past the
    clip (as tests/test_torch_quant.py's chain)."""
    r = np.random.default_rng({"random": 40, "extreme": 41}[mode])
    x = r.normal(0.3, 0.5, (2, 1, 5, 16, 32)).astype(np.float32)
    if mode == "extreme":
        x = np.full(x.shape, 1.27, np.float32)
    qcs, xs = [], {"random": float(np.abs(x).max() / 127), "extreme": 0.01}[mode]
    h = torch.from_numpy(x)
    for cin, cout, k in CHAIN:
        kq = torch.from_numpy(r.integers(-127, 128, (cout, cin, *k), dtype=np.int8))
        if mode == "extreme":
            kq.fill_(127)
        qc = tq.quant_conv_params(
            kq, torch.from_numpy((r.random(cout) * 0.01 + 1e-4).astype(np.float32)),
            torch.from_numpy(r.normal(0, 0.1, cout).astype(np.float32)), np.float32(xs))
        qcs.append(qc)
        h = tq.quant_conv_block(qc, h, compute_dtype=BF)
        xs = {"random": float(h.float().abs().max()) / 127 or 1.0, "extreme": 0.01}[mode]
    return qcs, torch.from_numpy(x)


@pytest.mark.parametrize("mode", ["random", "extreme"])
def test_bf16_hand_off_equals_three_bf16_contract_blocks(mode, monkeypatch):
    """Each int8 hand-off under bf16 equals `quantize_input` of the bf16
    block's output (widened) at the next block's scale, the last block's
    bf16 output the bf16-contract chain's, and `lipnet_int8_apply` under
    bf16 keeps its log-prob bits without the hand-off."""
    qcs, x = _chain(mode)
    b16, handed = x, x
    for i, qc in enumerate(qcs):
        nxt = float(qcs[i + 1].x_scale) if i + 1 < len(qcs) else None
        b16 = tq.quant_conv_block(qc, b16, compute_dtype=BF)
        handed = tq.quant_conv_block(qc, handed, nxt, compute_dtype=BF)
        if nxt is None:
            assert handed.dtype == BF and torch.equal(handed, b16)
        else:
            assert torch.equal(handed, quantconv.quantize_input(b16.float(), nxt).to(
                torch.int8))
    if mode == "extreme":
        assert bool((handed.float() > 0).any())
    from avsync_torch.models.lipnet import LipNet

    cfg = ModelConfig(hidden_dim=8, conv_channels=(4, 16, 6), use_pallas_gru=True,
                      fused_conv_pool=True, compute_dtype="bfloat16")
    model = LipNet(cfg, img_hw=(16, 32), generator=torch.Generator().manual_seed(42))
    qp = tq.QuantLipNetParams(convs=tuple(qcs), float_params=model.state_dict())
    clips = x.permute(0, 2, 3, 4, 1)
    got = tq.lipnet_int8_apply(qp, clips, cfg)
    block = tq.quant_conv_block
    monkeypatch.setattr(tq, "quant_conv_block",
                        lambda qc, h, out_scale=None, compute_dtype=None: block(
                            qc, h, compute_dtype=compute_dtype))
    assert got.dtype == torch.float32 and torch.equal(got, tq.lipnet_int8_apply(qp, clips, cfg))


# ---------------------------------------------------------------------------
# the recurrence with bf16 operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_bf16_operand_recurrence_matches_gru_scan(reverse):
    """`gru_recurrence_ref(compute_dtype=bf16)` on the port's bf16 input
    projection against the JAX `gru_scan(compute_dtype=bf16)`, within 1e-5;
    the bf16 operator's CPU kernel is that plain version for both
    directions, and differs from the float32 recurrence."""
    r = np.random.default_rng(50)
    B, T, D, H = 3, 9, 12, 20
    x = r.normal(size=(B, T, D)).astype(np.float32)
    w = [r.uniform(-0.3, 0.3, s).astype(np.float32) for s in ((D, 3 * H), (H, 3 * H),
                                                               (3 * H,), (3 * H,))]
    want = np.asarray(gru_scan(GRUParams(*map(jnp.asarray, w)), jnp.asarray(x), reverse=reverse,
                               compute_dtype=jnp.bfloat16))
    tw = GRUWeights(*(torch.from_numpy(a.T.copy() if a.ndim == 2 else a) for a in w))
    gi = input_projection(torch.from_numpy(x), tw, BF)
    got = cuda_gru.gru_recurrence_ref(gi, tw.weight_hh.t(), tw.bias_hh, reverse,
                                      compute_dtype=BF)
    np.testing.assert_allclose(got.numpy(), want, atol=GRU_ATOL, rtol=0)
    both = cuda_gru.bigru_recurrence_bf16(gi, gi, tw.weight_hh.t(), tw.weight_hh.t(),
                                          tw.bias_hh, tw.bias_hh)
    half = both[..., H:] if reverse else both[..., :H]
    assert torch.equal(half, got)
    f32 = cuda_gru.gru_recurrence_ref(gi, tw.weight_hh.t(), tw.bias_hh, reverse)
    assert not torch.equal(f32, got)
    torch.library.opcheck(cuda_gru.bigru_fwd_bf16_op, (gi, gi, tw.weight_hh.t(),
                                                       tw.weight_hh.t(), tw.bias_hh,
                                                       tw.bias_hh))


# ---------------------------------------------------------------------------
# the int8-bf16 forward of both families
# ---------------------------------------------------------------------------

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


def _bf16_principle(got, bf16, f32, what):
    """tests/test_torch_bf16.py's bound: within twice the JAX bf16 result's
    L2 distance from the JAX f32 one, nearer the JAX bf16 result than the
    f32 one, argmax equal where the f32 top-2 margin exceeds twice the
    largest bf16 error."""
    got, bf16, f32 = (np.asarray(a, np.float64) for a in (got, bf16, f32))
    assert np.linalg.norm(got - bf16) <= 2 * np.linalg.norm(bf16 - f32), what
    assert np.linalg.norm(got - bf16) < np.linalg.norm(got - f32), what
    bound = 2 * float(np.abs(bf16 - f32).max())
    top2 = np.sort(f32, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > bound
    assert decided.mean() > 0.5, what
    assert (got.argmax(-1) == f32.argmax(-1))[decided].all(), what


@pytest.mark.parametrize("kernel_flags", [True, False], ids=["kernel_flags", "plain"])
def test_lipnet_int8_bf16_forward_matches_jax(jax_params, clips, kernel_flags):
    """`lipnet_int8_apply(compute_dtype="bfloat16")` on the JAX package's
    quantized params carried across, against the JAX forward in bf16 and in
    f32: tests/test_torch_bf16.py's bound; the float32 port fails it; conv1
    takes the float32 frames as the JAX forward does."""
    qp = jq.quantize_lipnet(jax_params, [clips])
    x = jnp.asarray(clips)
    want16 = np.asarray(jq.lipnet_int8_apply(qp, x, JAX_MODEL, compute_dtype="bfloat16"))
    want32 = np.asarray(jq.lipnet_int8_apply(qp, x, JAX_MODEL))
    ours = quant_params_from_jax(jax.tree.map(np.asarray, qp), conv_shape=CONV_SHAPE)
    cfg = dataclasses.replace(CFG.model, use_pallas_gru=kernel_flags,
                              fused_conv_pool=kernel_flags)
    got = tq.lipnet_int8_apply(ours, torch.from_numpy(clips), cfg, "bfloat16")
    assert got.dtype == torch.float32 and got.shape == want16.shape == (3, 8, 39)
    _bf16_principle(got.numpy(), want16, want32, "LipNet int8 bf16")
    f32 = tq.lipnet_int8_apply(ours, torch.from_numpy(clips), cfg).numpy()
    with pytest.raises(AssertionError):
        _bf16_principle(f32, want16, want32, "a float32 port")
    # a bf16 model's forward is the same function (make_int8_forward)
    bf16_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    assert torch.equal(tq.make_int8_forward(bf16_cfg)(ours, torch.from_numpy(clips)), got)
    # the JAX forward feeds conv1 float32 frames: a bf16 input is not rounded first
    first = jq.quant_conv_block(qp.convs[0], x, out_dtype=jnp.bfloat16)
    rounded = jq.quant_conv_block(qp.convs[0], x.astype(jnp.bfloat16), out_dtype=jnp.bfloat16)
    assert not np.array_equal(np.asarray(first, np.float32), np.asarray(rounded, np.float32))


@pytest.fixture(scope="module")
def tf_tiny():
    r = np.random.default_rng(1)
    x = r.random((3, 6, 16, 32, 1)).astype(np.float32)
    params = JaxTFLipNet(JaxTFModelConfig(**TF_SMALL)).init(
        {"params": jax.random.PRNGKey(2)}, jnp.asarray(x))["params"]
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.2, np.shape(p))).astype(
        np.float32), params)
    return x, params


def test_tflipnet_int8_bf16_forward_matches_jax(tf_tiny):
    """`tflipnet_int8_apply(compute_dtype="bfloat16")` against the JAX one in
    bf16 and its f32 result: tests/test_torch_bf16.py's bound; the float32
    port fails it. The family switch under a bf16 config runs the float32
    forward, as the JAX `make_int8_forward` of a `make_lipnet` model does:
    equal to the port's float32 int8 forward, and within the TF int8 bound
    (tests/test_torch_quant_tf.py) of the JAX switch's."""
    from avsync.models import make_lipnet as jax_make_lipnet
    from avsync_torch.models.lipnet_tf import TFModelConfig

    x, params = tf_tiny
    qp = jq.quantize_lipnet(params, [x])
    jcfg = JaxTFModelConfig(**TF_SMALL)
    want16 = np.asarray(jq.tflipnet_int8_apply(qp, jnp.asarray(x), jcfg,
                                               compute_dtype="bfloat16"))
    want32 = np.asarray(jq.tflipnet_int8_apply(qp, jnp.asarray(x), jcfg))
    qp_np = jax.tree.map(np.asarray, qp)
    ours = tq.QuantLipNetParams(
        convs=tuple(quant_conv_from_jax(c) for c in qp_np.convs),
        float_params=tflipnet_params_from_jax(qp_np.float_params, TF_CONV_SHAPE))
    got = tq.tflipnet_int8_apply(ours, torch.from_numpy(x), TFModelConfig(**TF_SMALL),
                                 compute_dtype="bfloat16")
    assert got.dtype == torch.float32 and got.shape == want16.shape == (3, 6, 32)
    _bf16_principle(got.numpy(), want16, want32, "TF int8 bf16")
    f32 = tq.make_int8_forward(ModelConfig(family="tf", **TF_SMALL))(ours, torch.from_numpy(x))
    with pytest.raises(AssertionError):
        _bf16_principle(f32.numpy(), want16, want32, "a float32 port")
    switch = tq.make_int8_forward(ModelConfig(family="tf", compute_dtype="bfloat16", **TF_SMALL))
    assert torch.equal(switch(ours, torch.from_numpy(x)), f32)
    jmodel_cfg = JaxModelConfig(family="tf", compute_dtype="bfloat16", **TF_SMALL)
    jswitch = jq.make_int8_forward(jax_make_lipnet(jmodel_cfg), jmodel_cfg)
    np.testing.assert_allclose(f32.numpy(), np.asarray(jswitch(qp, jnp.asarray(x))),
                               atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the commands under bf16
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory, jax_params):
    """A reference `.pth` of the seeded weights, the port's config (kernel
    flags on) and the JAX package's (flags off), a synthetic corpus."""
    root = tmp_path_factory.mktemp("torch_int8_bf16")
    lip = str(root / "lipnet.pth")
    jax_save_lipnet_pth(jax_params, lip, conv_shape=CONV_SHAPE)
    port_cfg, jax_cfg = str(root / "port.json"), str(root / "jax.json")
    Path(port_cfg).write_text(CFG.to_json())
    Path(jax_cfg).write_text(JaxConfig(data=JaxDataConfig(**DATA), model=JAX_MODEL).to_json())
    corpus = str(root / "grid")
    synthetic.write_corpus(corpus, n_speakers=3, clips_per_speaker=2, preprocessed=True,
                           n_frames=8, height=16, width=32, seed=5, with_audio=False)
    return {"lipnet": lip, "port_cfg": port_cfg, "jax_cfg": jax_cfg, "corpus": corpus}


BF16_FLAG = ["--compute_dtype", "bfloat16"]


def _quantize(files, out, main, which, *extra):
    cfg = files["port_cfg"] if which == "port" else files["jax_cfg"]
    dev = ["--device", "cpu"] if which == "port" else []
    return main(["quantize", "--config", cfg, "--data_path", files["corpus"], "--checkpoint",
                 files["lipnet"], "--out", out, *dev, *extra])


def test_quantize_under_bf16_writes_the_jax_commands_scales(files, tmp_path):
    """`quantize --compute_dtype bfloat16` calibrates in float32: the same
    scales as the port's float32 command, and the JAX command's under bf16
    (rtol 1e-5)."""
    outs = {k: str(tmp_path / f"{k}.npz") for k in ("bf16", "f32", "jax")}
    assert _quantize(files, outs["bf16"], cli.main, "port", *BF16_FLAG) == 0
    assert _quantize(files, outs["f32"], cli.main, "port") == 0
    assert _quantize(files, outs["jax"], jax_cli.main, "jax", *BF16_FLAG) == 0
    got = np.load(outs["bf16"])["input_scales"]
    np.testing.assert_array_equal(got, np.load(outs["f32"])["input_scales"])
    np.testing.assert_allclose(got, np.load(outs["jax"])["input_scales"], rtol=1e-5)


def test_test_and_infer_quantize_under_bf16_match_jax(files, tmp_path, capsys):
    """`test --quantize int8` and `infer --quantize int8` under bf16: the JAX
    CLI's results JSON and transcript."""
    out_port, out_jax = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    common = ["--data_path", files["corpus"], "--checkpoint", files["lipnet"], "--quantize",
              "int8", *BF16_FLAG]
    assert cli.main(["test", *common, "--config", files["port_cfg"], "--output", out_port,
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["test", *common, "--config", files["jax_cfg"], "--output",
                         out_jax]) == 0
    got, want = json.load(open(out_port)), json.load(open(out_jax))
    assert got == want and got["num_samples"] == 2
    clip = str(tmp_path / "clip.npy")
    np.save(clip, np.random.default_rng(9).integers(0, 256, (8, 16, 32), dtype=np.uint8))
    capsys.readouterr()
    assert cli.main(["infer", clip, "--checkpoint", files["lipnet"], "--config",
                     files["port_cfg"], "--device", "cpu", "--quantize", "int8",
                     *BF16_FLAG]) == 0
    ours = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Predicted:")]
    assert jax_cli.main(["infer", clip, "--checkpoint", files["lipnet"], "--config",
                         files["jax_cfg"], "--quantize", "int8", *BF16_FLAG]) == 0
    theirs = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Predicted:")]
    assert len(ours) == 1 and ours == theirs


def test_serve_quantize_under_bf16_answers_as_the_jax_daemon(files, tmp_path):
    """`serve --quantize int8 --qscales --compute_dtype bfloat16` as a child
    process and the JAX package's int8 bf16 daemon (in this process, port
    0) on the same scales: the same transcripts; SIGTERM drains, exit 0."""
    import io
    import urllib.request

    from avsync.predictor import LipReader as JaxLipReader
    from avsync.serving import AvsyncServer as JaxServer
    from avsync.serving import TranscribeService as JaxTranscribeService

    def post(url, frames):
        buf = io.BytesIO()
        np.save(buf, frames)
        req = urllib.request.Request(url + "/v1/transcribe", data=buf.getvalue(),
                                     method="POST",
                                     headers={"Content-Type": "application/x-npy"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())["transcript"]

    scales = str(tmp_path / "scales.npz")
    assert _quantize(files, scales, cli.main, "port", *BF16_FLAG) == 0
    jcfg = JaxConfig(data=JaxDataConfig(**DATA),
                     model=dataclasses.replace(JAX_MODEL, compute_dtype="bfloat16"))
    theirs = JaxServer(JaxTranscribeService(
        JaxLipReader(files["lipnet"], jcfg, quantize="int8", calibration_scales=scales),
        max_batch=2), port=0)
    theirs.start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "avsync_torch.cli", "serve", "--checkpoint", files["lipnet"],
         "--config", files["port_cfg"], "--device", "cpu", "--port", "0", "--warmup",
         "--max_batch", "2", "--quantize", "int8", "--qscales", scales, *BF16_FLAG],
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
            assert post(url, frames) == post(jax_url, frames)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
    finally:
        theirs.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


# ---------------------------------------------------------------------------
# the backend-tuned defaults
# ---------------------------------------------------------------------------

PERF_FLAGS = {
    "none": [],
    "f32": ["--compute_dtype", "float32"],
    "bf16": ["--compute_dtype", "bfloat16"],
    "packed": ["--packed_conv"],
    "unpacked": ["--no-packed_conv"],
    "remat": ["--remat"],
    "f32_unpacked_remat": ["--compute_dtype", "float32", "--no-packed_conv", "--remat"],
}


def _backend(monkeypatch, card: bool):
    """The port's device resolution and the JAX package's default backend,
    both a card or both the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu" if card else "cpu")


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("flags", list(PERF_FLAGS))
def test_tuned_perf_defaults_match_the_jax_function(flags, card, monkeypatch):
    """`_tuned_perf_defaults` against the JAX function over the flag
    combinations, on the CPU and on a (monkeypatched) card: bf16 and
    packed_conv on the card, float32 on the CPU, remat off, explicit flags
    win; and the config without --config carries them."""
    _backend(monkeypatch, card)
    argv = ["test", "--checkpoint", "c", *PERF_FLAGS[flags]]
    ours = cli._tuned_perf_defaults(cli.build_parser().parse_args(argv))
    theirs = jax_cli._tuned_perf_defaults(jax_cli.build_parser().parse_args(argv))
    assert ours == theirs
    cfg = cli._config_from_args(cli.build_parser().parse_args(argv))
    jcfg = jax_cli._config_from_args(jax_cli.build_parser().parse_args(argv))
    assert (cfg.model.compute_dtype, cfg.model.packed_conv, cfg.train.remat) == (
        jcfg.model.compute_dtype, jcfg.model.packed_conv, jcfg.train.remat) == ours


# each command with its required arguments, and the function that makes its config
COMMANDS = {
    "train": ([], cli._config_from_args),
    "test": (["--checkpoint", "c.pth"], cli._config_from_args),
    "quantize": (["--checkpoint", "c.pth"], cli._config_from_args),
    "infer": (["clip.mpg", "--checkpoint", "c.pth"], lambda a: cli._config_from_args(a, ())),
    "export": (["--checkpoint", "c.pth"], cli._serving_config),
    "serve": (["--checkpoint", "c.pth"], cli._serving_config),
    "misalign-train": ([], cli._detector_config_from_args),
    "misalign-eval": ([], cli._detector_config_from_args),
}


@pytest.mark.parametrize("command", list(COMMANDS))
def test_every_command_takes_the_tuned_defaults(command, tmp_path, monkeypatch):
    """With a card, each command without --config computes in bf16 with
    packed_conv; `--device cpu` and `--compute_dtype float32` win; a
    --config file's dtype is kept whatever the device (`avsync/cli.py:
    144-155`), and an explicit flag wins over it. `ModelConfig`'s own
    default stays float32."""
    _backend(monkeypatch, True)
    extra, to_config = COMMANDS[command]
    parse = cli.build_parser().parse_args

    def model(*argv):
        m = to_config(parse([command, *extra, *argv])).model
        return m.compute_dtype, m.packed_conv

    assert model() == ("bfloat16", True)
    assert model("--device", "cpu") == ("float32", False)
    assert model("--compute_dtype", "float32") == ("float32", True)
    path = tmp_path / "cfg.json"
    for dtype in ("float32", "bfloat16"):
        path.write_text(AvsyncConfig(model=ModelConfig(compute_dtype=dtype)).to_json())
        assert model("--config", str(path)) == (dtype, False)
    assert model("--config", str(path), "--compute_dtype", "float32",
                 "--packed_conv") == ("float32", True)
    assert ModelConfig().compute_dtype == "float32"
