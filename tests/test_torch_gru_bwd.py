"""The port's GRU backward (plain version of csrc/gru_bwd.cu) against the JAX
package's Pallas backward in interpret mode, against autograd of the port's
own forward, and the BiGRU layer's end-to-end gradient against `jax.grad`
through the JAX package's Pallas-backed layer.

Inputs are numpy draws from a seed handed to both packages. On the CPU the
port's wrappers run their plain versions; the CUDA kernel is held against
that plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). Tolerances are the JAX package's own
(tests/test_pallas_gru.py): atol 1e-5 / rtol 1e-4 for the kernel, 1e-4 /
1e-3 end to end.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync.ops.gru import GRUParams, gru_scan, gru_scan_fused
from avsync.ops.pallas.gru import pallas_gru_bwd
from avsync_torch.ops.cuda import gru as gru_mod
from avsync_torch.ops.cuda.gru import (bigru_recurrence_bwd, gru_recurrence_bwd,
                                       gru_recurrence_ref)
from avsync_torch.ops.gru import GRUWeights, bigru

ATOL, RTOL = 1e-5, 1e-4
E2E_ATOL, E2E_RTOL = 1e-4, 1e-3


def _case(B, T, H, seed):
    """gi, w_hh, b_hh, the forward's out (the port's plain forward) and a
    random cotangent g."""
    r = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    gi = r.normal(0.0, 1.0, (B, T, 3 * H)).astype(np.float32)
    w_hh = r.uniform(-k, k, (H, 3 * H)).astype(np.float32)
    b_hh = r.uniform(-k, k, (3 * H,)).astype(np.float32)
    g = r.normal(0.0, 1.0, (B, T, H)).astype(np.float32)
    return gi, w_hh, b_hh, g


def _out(gi, w_hh, b_hh, reverse):
    return gru_recurrence_ref(torch.from_numpy(gi), torch.from_numpy(w_hh),
                              torch.from_numpy(b_hh), reverse).numpy()


def _jax_bwd(gi, out, g, w_hh, b_hh, reverse):
    return [np.asarray(a) for a in pallas_gru_bwd(
        jnp.asarray(gi), jnp.asarray(out), jnp.asarray(g), jnp.asarray(w_hh),
        jnp.asarray(b_hh), reverse=reverse, interpret=True)]


def _port_bwd(gi, out, g, w_hh, b_hh, reverse):
    return [a.numpy() for a in gru_recurrence_bwd(
        *(torch.from_numpy(a) for a in (gi, out, g, w_hh, b_hh)), reverse=reverse)]


def _close(got, want, atol=ATOL, rtol=RTOL):
    for name, o, r in zip(("dgi", "dw_hh", "db_hh"), got, want):
        np.testing.assert_allclose(o, r, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("B,T,H,seed", [(4, 6, 8, 7), (3, 7, 8, 3), (3, 1, 8, 11),
                                        (2, 3, 256, 5)],
                         ids=["B4_T6", "odd_T7", "single_step_T1", "production_H256"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_bwd_matches_pallas_interpret(B, T, H, seed, reverse):
    gi, w_hh, b_hh, g = _case(B, T, H, seed)
    out = _out(gi, w_hh, b_hh, reverse)
    _close(_port_bwd(gi, out, g, w_hh, b_hh, reverse),
           _jax_bwd(gi, out, g, w_hh, b_hh, reverse))


def test_bwd_matches_pallas_streaming_variant(monkeypatch):
    """The JAX kernel's DMA-streaming variant (forced by a zero VMEM budget)
    computes the same function; the port's plain version matches it too."""
    import avsync.ops.pallas.gru as pg

    monkeypatch.setattr(pg, "_VMEM_BUDGET_BYTES", 0)
    gi, w_hh, b_hh, g = _case(4, 6, 8, 13)
    out = _out(gi, w_hh, b_hh, False)
    _close(_port_bwd(gi, out, g, w_hh, b_hh, False),
           _jax_bwd(gi, out, g, w_hh, b_hh, False))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_bwd_matches_autograd_of_the_forward(reverse):
    gi, w_hh, b_hh, g = _case(3, 5, 8, 17)
    ts = [torch.from_numpy(a).requires_grad_() for a in (gi, w_hh, b_hh)]
    out = gru_recurrence_ref(*ts, reverse)
    out.backward(torch.from_numpy(g))
    want = [t.grad.numpy() for t in ts]
    _close(_port_bwd(gi, out.detach().numpy(), g, w_hh, b_hh, reverse), want)


def test_bidirectional_bwd_is_two_directions():
    gi_f, w_f, b_f, g_f = _case(3, 5, 8, 21)
    gi_b, w_b, b_b, g_b = _case(3, 5, 8, 22)
    out = np.concatenate([_out(gi_f, w_f, b_f, False), _out(gi_b, w_b, b_b, True)], -1)
    g = np.concatenate([g_f, g_b], -1)
    got = bigru_recurrence_bwd(*(torch.from_numpy(a) for a in
                                 (gi_f, gi_b, out, g, w_f, w_b, b_f, b_b)))
    want_f = _jax_bwd(gi_f, out[..., :8], g_f, w_f, b_f, False)
    want_b = _jax_bwd(gi_b, out[..., 8:], g_b, w_b, b_b, True)
    _close([a.numpy() for a in got[0::2]], want_f)
    _close([a.numpy() for a in got[1::2]], want_b)


def test_cpu_backward_does_not_count_as_a_kernel_launch():
    gi, w_hh, b_hh, g = _case(2, 3, 8, 23)
    before = gru_mod.bwd_launches
    _port_bwd(gi, _out(gi, w_hh, b_hh, False), g, w_hh, b_hh, False)
    assert gru_mod.bwd_launches == before


def test_bigru_layer_gradient_matches_jax_pallas_layer():
    """jax.grad through the JAX package's fused layer (Pallas forward and
    backward in interpret mode) against the port's `bigru(use_kernel=True)`
    (the autograd Function whose forward is K2 and whose backward is K3,
    here their plain versions): dx and every weight, both directions."""
    from jax.experimental.pallas import tpu as pltpu

    r = np.random.default_rng(31)
    B, T, D, H = 3, 5, 7, 8
    k = 1.0 / np.sqrt(H)
    x = r.normal(size=(B, T, D)).astype(np.float32)
    dirs = [GRUParams(*(r.uniform(-k, k, s).astype(np.float32)
                        for s in ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))))
            for _ in range(2)]

    def jax_loss(pf, pb, x):
        hf = gru_scan_fused(pf, x, reverse=False)
        hb = gru_scan_fused(pb, x, reverse=True)
        return (jnp.concatenate([hf, hb], -1) ** 2).sum()

    with pltpu.force_tpu_interpret_mode():
        jf, jb, jx = jax.grad(jax_loss, argnums=(0, 1, 2))(
            *(GRUParams(*map(jnp.asarray, p)) for p in dirs), jnp.asarray(x))
    # sanity: the JAX reference layer agrees with its own scan version
    ref = jax.grad(lambda pf, pb, x: (jnp.concatenate(
        [gru_scan(pf, x), gru_scan(pb, x, reverse=True)], -1) ** 2).sum(),
        argnums=(2,))(*(GRUParams(*map(jnp.asarray, p)) for p in dirs), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(jx), np.asarray(ref[0]), atol=E2E_ATOL,
                               rtol=E2E_RTOL)

    def torch_weights(p):
        return GRUWeights(*(torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
                            for a in (p.w_ih.T, p.w_hh.T, p.b_ih, p.b_hh)))

    wf, wb = torch_weights(dirs[0]), torch_weights(dirs[1])
    xt = torch.from_numpy(x).requires_grad_()
    (bigru(xt, wf, wb, use_kernel=True) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), atol=E2E_ATOL, rtol=E2E_RTOL)
    for tw, jg in ((wf, jf), (wb, jb)):
        for got, want in ((tw.weight_ih.grad.T, jg.w_ih), (tw.weight_hh.grad.T, jg.w_hh),
                          (tw.bias_ih.grad, jg.b_ih), (tw.bias_hh.grad, jg.b_hh)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=E2E_ATOL,
                                       rtol=E2E_RTOL)


@pytest.mark.parametrize("H", [5, 20])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
def test_hidden_size_padding_is_exact(H, reverse):
    """The wrappers pad H to a multiple of 8 with zero units for the card's
    kernels: on the plain backward, the padded run (zero gi, w_hh, b_hh, out
    and cotangent for the padded units) sliced back equals the unpadded run,
    and the padded units' gradients are 0."""
    from avsync_torch.ops.cuda.gru import pad_gates, pad_units, pad_w_hh, padded_hidden

    gi, w_hh, b_hh, g = _case(3, 7, H, 60 + H)
    out = _out(gi, w_hh, b_hh, reverse)
    Hp = padded_hidden(H)
    gi_t, w_t, b_t, g_t, out_t = (torch.from_numpy(a) for a in (gi, w_hh, b_hh, g, out))
    dgi, dw, db = gru_recurrence_bwd(pad_gates(gi_t, H, Hp), pad_units(out_t, H, Hp),
                                     pad_units(g_t, H, Hp), pad_w_hh(w_t, H, Hp),
                                     pad_gates(b_t, H, Hp), reverse=reverse)
    assert not dgi.reshape(3, 7, 3, Hp)[..., H:].any()
    assert not dw[H:].any() and not dw.reshape(Hp, 3, Hp)[..., H:].any()
    got = (pad_gates(dgi, Hp, H).numpy(), pad_w_hh(dw, Hp, H).numpy(),
           pad_gates(db, Hp, H).numpy())
    _close(got, _port_bwd(gi, out, g, w_hh, b_hh, reverse))
