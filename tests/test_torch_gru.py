"""The port's GRU recurrence (plain version of csrc/gru_fwd.cu) against the
JAX package's Pallas kernel in interpret mode, and the full BiGRU layer
against `avsync.ops.gru.bigru`.

Inputs are drawn with numpy from a seed and handed to both packages. On the
CPU the port's wrappers run their plain versions; the CUDA kernels are held
against those on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
Tolerances are the JAX package's own for this op (tests/test_pallas_gru.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from avsync.ops.gru import GRUParams, bigru as jax_bigru
from avsync.ops.pallas.gru import pallas_gru_scan
from avsync_torch.ops.cuda.gru import bigru_recurrence, gru_recurrence, gru_recurrence_ref
from avsync_torch.ops.gru import GRUWeights, bigru

ATOL, RTOL = 1e-5, 1e-4


def _case(B, T, H, seed):
    r = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    gi = r.normal(0.0, 1.0, (B, T, 3 * H)).astype(np.float32)
    w_hh = r.uniform(-k, k, (H, 3 * H)).astype(np.float32)
    b_hh = r.uniform(-k, k, (3 * H,)).astype(np.float32)
    return gi, w_hh, b_hh


def _jax(gi, w_hh, b_hh, reverse):
    return np.asarray(pallas_gru_scan(jnp.asarray(gi), jnp.asarray(w_hh),
                                      jnp.asarray(b_hh), reverse=reverse,
                                      interpret=True))


@pytest.mark.parametrize("B,T,H,seed", [(8, 10, 8, 0), (3, 7, 8, 3), (2, 1, 8, 4),
                                        (4, 4, 256, 5)],
                         ids=["B8_T10", "odd_T7", "single_step_T1", "production_H256"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_recurrence_matches_pallas_interpret(B, T, H, seed, reverse):
    gi, w_hh, b_hh = _case(B, T, H, seed)
    ref = _jax(gi, w_hh, b_hh, reverse)
    got = gru_recurrence(torch.from_numpy(gi), torch.from_numpy(w_hh),
                         torch.from_numpy(b_hh), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_bidirectional_wrapper_concatenates_directions():
    gi_f, w_f, b_f = _case(3, 5, 8, 7)
    gi_b, w_b, b_b = _case(3, 5, 8, 8)
    got = bigru_recurrence(*(torch.from_numpy(a) for a in (gi_f, gi_b, w_f, w_b, b_f, b_b)))
    want = np.concatenate([_jax(gi_f, w_f, b_f, False), _jax(gi_b, w_b, b_b, True)], -1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_transposed_torch_weight_view_gives_the_same_result():
    """The model hands w_hh in as weight_hh.t(), a strided view."""
    gi, w_hh, b_hh = _case(2, 6, 8, 9)
    w_t = torch.from_numpy(np.ascontiguousarray(w_hh.T))  # torch layout (3H, H)
    got = gru_recurrence_ref(torch.from_numpy(gi), w_t.t(), torch.from_numpy(b_hh))
    np.testing.assert_allclose(got.numpy(), _jax(gi, w_hh, b_hh, False),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel_flag"])
def test_bigru_layer_matches_jax(use_kernel):
    r = np.random.default_rng(11)
    B, T, D, H = 2, 6, 12, 8
    k = 1.0 / np.sqrt(H)
    x = r.normal(size=(B, T, D)).astype(np.float32)

    def direction():
        return GRUParams(*(r.uniform(-k, k, s).astype(np.float32)
                           for s in ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))))

    fwd, bwd = direction(), direction()
    ref = np.asarray(jax_bigru(GRUParams(*map(jnp.asarray, fwd)),
                               GRUParams(*map(jnp.asarray, bwd)), jnp.asarray(x)))

    def torch_weights(p):
        return GRUWeights(torch.from_numpy(p.w_ih.T.copy()), torch.from_numpy(p.w_hh.T.copy()),
                          torch.from_numpy(p.b_ih), torch.from_numpy(p.b_hh))

    got = bigru(torch.from_numpy(x), torch_weights(fwd), torch_weights(bwd),
                use_kernel=use_kernel)
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_cpu_calls_do_not_count_as_kernel_launches():
    from avsync_torch.ops.cuda import gru as gru_mod

    before = gru_mod.launches
    gi, w_hh, b_hh = _case(2, 3, 8, 12)
    gru_recurrence(torch.from_numpy(gi), torch.from_numpy(w_hh), torch.from_numpy(b_hh))
    assert gru_mod.launches == before


def test_only_cpu_tensors_take_the_plain_version():
    """Any other device goes to the kernel or raises; it never falls back."""
    gi, w, b = (torch.empty(s, device="meta") for s in ((1, 3, 24), (8, 24), (24,)))
    with pytest.raises(ValueError, match="unsupported device"):
        gru_recurrence(gi, w, b)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from avsync_torch.ops.cuda import build

    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def _pad_inputs(gi, w_hh, b_hh, H):
    from avsync_torch.ops.cuda.gru import pad_gates, pad_w_hh, padded_hidden

    Hp = padded_hidden(H)
    return (pad_gates(torch.from_numpy(gi), H, Hp), pad_w_hh(torch.from_numpy(w_hh), H, Hp),
            pad_gates(torch.from_numpy(b_hh), H, Hp), Hp)


@pytest.mark.parametrize("H", [5, 20])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_hidden_size_padding_is_exact(H, reverse):
    """The wrappers pad H to a multiple of 8 with zero units for the card's
    kernels: on the plain version, the padded run sliced back equals the
    unpadded run, and every padded unit's h stays 0."""
    from avsync_torch.ops.cuda.gru import pad_units

    gi, w_hh, b_hh = _case(3, 7, H, 40 + H)
    gi_p, w_p, b_p, Hp = _pad_inputs(gi, w_hh, b_hh, H)
    got = gru_recurrence_ref(gi_p, w_p, b_p, reverse)
    want = gru_recurrence_ref(*(torch.from_numpy(a) for a in (gi, w_hh, b_hh)), reverse)
    assert got.shape == (3, 7, Hp) and not got[..., H:].any()
    np.testing.assert_allclose(pad_units(got, Hp, H).numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_padded_recurrence_matches_pallas_interpret(reverse):
    """H = 20, padded to 24 as the card's kernel takes it, against the JAX
    package's kernel on the unpadded inputs."""
    from avsync_torch.ops.cuda.gru import pad_units

    gi, w_hh, b_hh = _case(4, 6, 20, 50)
    gi_p, w_p, b_p, Hp = _pad_inputs(gi, w_hh, b_hh, 20)
    got = pad_units(gru_recurrence_ref(gi_p, w_p, b_p, reverse), Hp, 20)
    np.testing.assert_allclose(got.numpy(), _jax(gi, w_hh, b_hh, reverse), atol=ATOL, rtol=RTOL)
