"""int8 serving of the TF-family LipNet in the port (`tflipnet_int8_apply` and
the family switch of `make_int8_forward`, `ops/quant.py`) against the JAX
package's (`avsync/ops/quant.py:208-254,303-315`) on the same numpy weights
and scales, on the CPU at a small width (Q1's plain version).

Bounds: calibration scales rtol 1e-5; log-probs atol 1e-4 with the greedy
transcripts equal (tests/test_torch_quant.py's bounds for the PyTorch
family); the int8 hand-off between blocks equal to three f32-contract blocks
bit for bit; int8 against the f32 forward within the JAX package's bounds
(mean |d log-prob| < 0.05, argmax agreement >= 0.95; tests/test_quant.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from avsync import text as jtext
from avsync.models.lipnet_tf import TFLipNet as JaxTFLipNet
from avsync.models.lipnet_tf import TFModelConfig as JaxTFModelConfig
from avsync.ops import quant as jq
from avsync_torch import text
from avsync_torch.compat import quant_conv_from_jax, tflipnet_params_from_jax
from avsync_torch.config import ModelConfig
from avsync_torch.models.lipnet_tf import TFLipNet, TFModelConfig
from avsync_torch.ops import quant as tq
from avsync_torch.ops.cuda import quantconv

# make_lipnet's TF stack (dense 512) at a small conv width and hidden size
SMALL = dict(conv_channels=(3, 4, 6), hidden_dim=8)
HW, CONV_SHAPE = (16, 32), (6, 2, 4)
LOGPROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    r = np.random.default_rng(1)
    clips = r.random((3, 6, *HW, 1)).astype(np.float32)
    jmodel = JaxTFLipNet(JaxTFModelConfig(**SMALL))
    params = jmodel.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(clips))["params"]
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.2, np.shape(p))).astype(
        np.float32), params)
    model = TFLipNet(TFModelConfig(**SMALL), img_hw=HW).eval()
    model.load_state_dict(tflipnet_params_from_jax(params, CONV_SHAPE))
    return clips, jmodel, params, model


def test_calibrate_conv_input_scales_matches_jax(tiny):
    clips, _, params, model = tiny
    batches = [clips[:2], clips[2:]]
    want = jq.calibrate_conv_input_scales(params, batches)
    got = tq.calibrate_conv_input_scales(model, batches)
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("own_scales", [False, True], ids=["jax_params", "port_quantized"])
def test_tflipnet_int8_apply_matches_jax(tiny, own_scales):
    """The JAX forward on its own quantized params; the port's on the same
    params carried across, or quantized by the port from the same weights
    and scales: log-probs within 1e-4, the same greedy transcripts."""
    clips, _, params, model = tiny
    qp = jq.quantize_lipnet(params, [clips])
    want = np.asarray(jq.tflipnet_int8_apply(qp, jnp.asarray(clips), JaxTFModelConfig(**SMALL)))
    if own_scales:
        scales = np.asarray([np.asarray(c.x_scale) for c in qp.convs], np.float32)
        ours = tq.quantize_lipnet(model, [], input_scales=scales)
    else:
        qp_np = jax.tree.map(np.asarray, qp)
        ours = tq.QuantLipNetParams(
            convs=tuple(quant_conv_from_jax(c) for c in qp_np.convs),
            float_params=tflipnet_params_from_jax(qp_np.float_params, CONV_SHAPE))
    fwd = tq.make_int8_forward(ModelConfig(family="tf", **SMALL))
    got = fwd(ours, torch.from_numpy(clips))
    assert got.shape == want.shape == (3, 6, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGPROB_ATOL, rtol=0)
    assert text.tf_decode_batch(got) == jtext.tf_decode_batch(jnp.asarray(want))


def test_int8_hand_off_equals_three_f32_contract_blocks(tiny, monkeypatch):
    clips, _, _, model = tiny
    qp = tq.quantize_lipnet(model, [clips])
    fwd = tq.make_int8_forward(ModelConfig(family="tf", **SMALL))
    before = quantconv.launches
    handed = fwd(qp, torch.from_numpy(clips))
    block = tq.quant_conv_block
    monkeypatch.setattr(tq, "quant_conv_block",
                        lambda qc, x, out_scale=None, compute_dtype=None: block(
                            qc, x, compute_dtype=compute_dtype))
    f32_contract = fwd(qp, torch.from_numpy(clips))
    assert torch.equal(handed, f32_contract)
    assert quantconv.launches == before  # the CPU runs the plain version


def test_int8_forward_stays_within_the_jax_bounds_of_f32(tiny):
    clips, _, _, model = tiny
    with torch.no_grad():
        ref = model(torch.from_numpy(clips)).numpy()
    got = tq.make_int8_forward(ModelConfig(family="tf", **SMALL))(
        tq.quantize_lipnet(model, [clips]), torch.from_numpy(clips)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).mean() < 0.05
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.95


def test_quantize_lipnet_reads_the_tf_conv_blocks(tiny):
    clips, _, _, model = tiny
    qp = tq.quantize_lipnet(model, [clips])
    assert [tuple(c.kernel_q.shape) for c in qp.convs] == [(3, 1, 3, 3, 3), (4, 3, 3, 3, 3),
                                                           (6, 4, 3, 3, 3)]
    assert {"lstm3.weight_hh_l0_reverse", "dense2.bias", "head.weight"} <= set(qp.float_params)
    with pytest.raises(ValueError, match="conv layers"):
        tq.quantize_lipnet(model, [], input_scales=np.ones(2, np.float32))
