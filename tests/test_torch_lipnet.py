"""The port's LipNet against the JAX package's on the same weights.

Weights: JAX `LipNet.init` from a seed, plus numpy noise so that no bias is
zero, carried across by `avsync_torch.compat.lipnet_params_from_jax` (the
weight bridge). Inputs: numpy draws from a seed. The port runs on the CPU
(`device="cpu"` paths), where the kernel flags take the kernels' plain
versions. Tolerances are the JAX package's own (tests/test_model_parity.py,
tests/test_pallas_convpool.py).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync import text as jax_text
from avsync.compat import save_lipnet_pth
from avsync.config import ModelConfig as JaxModelConfig
from avsync.models import LipNet as JaxLipNet
from avsync_torch import text as torch_text
from avsync_torch.compat import chw_to_hwc_perm, lipnet_params_from_jax, load_pth
from avsync_torch.config import ModelConfig
from avsync_torch.models import LipNet
from avsync_torch.ops.quant import make_int8_forward


def _jax_params(cfg, x, seed):
    params = JaxLipNet(cfg).init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"]
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + r.normal(0.0, 0.02, np.shape(p))).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def full_width():
    """B=2, T=15 at the full 50x100 geometry and default widths."""
    x = np.random.default_rng(1).random((2, 15, 50, 100, 1)).astype(np.float32)
    params = _jax_params(JaxModelConfig(), x, seed=0)
    model = JaxLipNet(JaxModelConfig())
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    ref_feats = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                       method=JaxLipNet.conv_features))
    return x, params, ref, ref_feats


def _port(params, cfg=ModelConfig(), img_hw=(50, 100), conv_shape=(96, 6, 12)):
    m = LipNet(cfg, img_hw=img_hw, generator=torch.Generator().manual_seed(0))
    m.load_state_dict(lipnet_params_from_jax(
        params, num_conv=len(cfg.conv_channels), num_gru=cfg.num_gru_layers,
        conv_shape=conv_shape))
    return m.eval()


class TestFullWidth:
    def test_log_probs_match(self, full_width):
        x, params, ref, _ = full_width
        with torch.inference_mode():
            got = _port(params)(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 15, 39)
        np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)

    def test_conv_features_match_after_permutation(self, full_width):
        x, params, _, ref_feats = full_width
        with torch.inference_mode():
            got = _port(params).conv_features(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 15, 6912)
        np.testing.assert_allclose(got[..., chw_to_hwc_perm((96, 6, 12))], ref_feats,
                                   atol=2e-5, rtol=1e-4)

    def test_decoded_text_is_equal(self, full_width):
        x, params, ref, _ = full_width
        with torch.inference_mode():
            got = _port(params)(torch.from_numpy(x))
        assert torch_text.decode_batch(got) == jax_text.decode_batch(ref)

    @pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "model_state_dict"])
    def test_reference_checkpoint_loads(self, full_width, tmp_path, wrapped):
        """A `.pth` written by the JAX package loads into the port directly
        (both reference layouts) and gives the same log-probs."""
        x, params, ref, _ = full_width
        path = str(tmp_path / "lipnet.pth")
        save_lipnet_pth(params, path)
        if wrapped:
            torch.save({"epoch": 3, "model_state_dict": torch.load(path)}, path)
        m = LipNet(ModelConfig(), generator=torch.Generator())
        m.load_state_dict(load_pth(path))
        with torch.inference_mode():
            got = m.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)

    def test_param_count_matches_jax(self, full_width):
        _, params, _, _ = full_width
        n_jax = sum(np.size(p) for p in jax.tree.leaves(params))
        assert sum(p.numel() for p in _port(params).parameters()) == n_jax


def test_narrow_model_with_both_kernel_flags_matches_jax():
    """hidden 8, channels (2,3,4), 16x32 frames, use_pallas_gru and
    fused_conv_pool on in both packages (JAX kernels in interpret mode)."""
    from jax.experimental.pallas import tpu as pltpu

    base = dict(hidden_dim=8, conv_channels=(2, 3, 4), use_pallas_gru=True,
                fused_conv_pool=True)
    x = np.random.default_rng(5).random((2, 6, 16, 32, 1)).astype(np.float32)
    jcfg = JaxModelConfig(**base)
    with pltpu.force_tpu_interpret_mode():
        params = _jax_params(jcfg, x, seed=2)
        ref = np.asarray(JaxLipNet(jcfg).apply({"params": params}, jnp.asarray(x)))
    cfg = ModelConfig(**base)
    m = _port(params, cfg, img_hw=(16, 32), conv_shape=(4, 2, 4))
    assert m.conv1.fused and m.gru1.use_kernel
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    plain = _port(params, dataclasses.replace(cfg, use_pallas_gru=False,
                                              fused_conv_pool=False),
                  img_hw=(16, 32), conv_shape=(4, 2, 4))
    with torch.inference_mode():
        np.testing.assert_allclose(plain(torch.from_numpy(x)).numpy(), ref,
                                   atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("build,err", [
    (lambda: LipNet(ModelConfig(family="tf")), "family"),
], ids=["tf_family"])
def test_unported_configurations_raise(build, err):
    with pytest.raises(NotImplementedError, match=err):
        build()


def test_int8_forward_under_bf16_with_the_kernel_flag():
    """bf16 compute and its int8 forward are ported (tests/test_torch_bf16.py,
    tests/test_torch_int8_bf16.py): with `use_pallas_gru` the bf16 int8
    forward takes the bf16-operand recurrence's operator, whose CPU kernel
    is the plain loop's rounding, so the log-probs equal the plain path's."""
    from avsync_torch.ops import quant

    base = dict(hidden_dim=8, conv_channels=(2, 3, 4), compute_dtype="bfloat16")
    x = torch.from_numpy(np.random.default_rng(6).random((2, 6, 16, 32, 1), np.float32))
    model = LipNet(ModelConfig(**base), img_hw=(16, 32),
                   generator=torch.Generator().manual_seed(7)).eval()
    qp = quant.quantize_lipnet(model, [x])
    got = make_int8_forward(ModelConfig(use_pallas_gru=True, **base))(qp, x)
    plain = make_int8_forward(ModelConfig(use_pallas_gru=False, **base))(qp, x)
    assert got.shape == (2, 6, 39) and torch.equal(got, plain)
