"""Context parallelism of the port: the GRU chain with the time axis split
over gloo ranks on the CPU (`avsync_torch.parallel.context`), against the
JAX package's `cp_gru_recurrence` on a mesh of the same size, against the
port's own recurrence over the whole sequence, and the plain recurrence's
initial state `h0` that the chain hands from chunk to chunk; the chain's
backward against `jax.grad` of the JAX function, and the plain backward's
`h0` in and `dh0` out against `jax.vjp` of the JAX chunk scan.

The chain's ranks run with fewer threads each than this process
(`multihost.spawn` shares the cores out); the CPU plain step sums its
products in an order that does not depend on the thread count, so the
chunks give the whole recurrence's bits.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync.parallel import make_mesh as jax_make_mesh
from avsync.parallel.context import _chunk_scan as jax_chunk_scan
from avsync.parallel.context import cp_gru_recurrence as jax_cp
from avsync_torch.ops.cuda.gru import (gru_recurrence, gru_recurrence_bwd_ref,
                                       gru_recurrence_ref)
from avsync_torch.parallel import multihost

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_worker as worker  # noqa: E402

B, T, H = 4, 16, 8


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    gi = r.normal(size=(B, T, 3 * H)).astype(np.float32)
    w_hh = (r.normal(size=(H, 3 * H)) * 0.3).astype(np.float32)
    b_hh = (r.normal(size=(3 * H,)) * 0.1).astype(np.float32)
    return gi, w_hh, b_hh


def _run_chain(n, out, gi, w_hh, b_hh):
    multihost.spawn(worker.cp_chain, n, (out, f"cp{n}", gi, w_hh, b_hh), device="cpu")
    return torch.cat([torch.load(os.path.join(out, f"cp{n}_{r}.pt")) for r in range(n)], dim=1)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cp"))
    gi, w_hh, b_hh = _inputs()
    return (gi, w_hh, b_hh), {n: _run_chain(n, out, gi, w_hh, b_hh) for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_cp_chain_matches_the_jax_function(chains, n):
    (gi, w_hh, b_hh), got = chains
    mesh = jax_make_mesh((n, 1), devices=jax.devices()[:n])
    want = jax_cp(mesh, jnp.asarray(gi), jnp.asarray(w_hh), jnp.asarray(b_hh))
    np.testing.assert_allclose(got[n].numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_cp_chain_equals_the_whole_recurrence_bit_for_bit(chains, n):
    (gi, w_hh, b_hh), got = chains
    whole = gru_recurrence(torch.from_numpy(gi), torch.from_numpy(w_hh), torch.from_numpy(b_hh))
    assert torch.equal(got[n], whole)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_recurrence_chained_over_chunks_from_h0(reverse):
    gi, w_hh, b_hh = (torch.from_numpy(a) for a in _inputs(1))
    whole = gru_recurrence_ref(gi, w_hh, b_hh, reverse)
    order = [(12, 16), (5, 12), (0, 5)] if reverse else [(0, 5), (5, 12), (12, 16)]
    h, parts = None, {}
    for lo, hi in order:
        parts[lo] = gru_recurrence_ref(gi[:, lo:hi], w_hh, b_hh, reverse, h0=h)
        h = parts[lo][:, 0] if reverse else parts[lo][:, -1]
    assert torch.equal(torch.cat([parts[k] for k in sorted(parts)], dim=1), whole)
    zeros = gru_recurrence_ref(gi, w_hh, b_hh, reverse, h0=torch.zeros(B, H))
    assert torch.equal(zeros, whole)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

# the JAX GRU gradient bound (tests/test_pallas_gru.py)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _cotangent(seed=5):
    return np.random.default_rng(seed).normal(size=(B, T, H)).astype(np.float32)


@pytest.fixture(scope="module")
def chain_grads(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cp_grad"))
    gi, w_hh, b_hh = _inputs()
    cot = _cotangent()
    got = {}
    for n in (2, 4):
        multihost.spawn(worker.cp_chain_grad, n, (out, f"cpg{n}", gi, w_hh, b_hh, cot),
                        device="cpu")
        got[n] = [torch.load(os.path.join(out, f"cpg{n}_{r}.pt")) for r in range(n)]
    return (gi, w_hh, b_hh, cot), got


@pytest.mark.parametrize("n", [2, 4])
def test_cp_chain_backward_matches_jax_grad(chain_grads, n):
    """dgi (each rank's chunk), dw_hh and db_hh (every rank's reduced copy)
    against jax.grad of sum(y * cot) through the JAX chain on a virtual mesh
    of n devices."""
    (gi, w_hh, b_hh, cot), got = chain_grads
    mesh = jax_make_mesh((n, 1), devices=jax.devices()[:n])

    def loss(g, w, b):
        return jnp.sum(jax_cp(mesh, g, w, b) * cot)

    dgi, dw, db = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(gi), jnp.asarray(w_hh),
                                                     jnp.asarray(b_hh))
    parts = got[n]
    np.testing.assert_allclose(torch.cat([p["dgi"] for p in parts], 1).numpy(),
                               np.asarray(dgi), **GRAD_TOL)
    for p in parts:
        np.testing.assert_allclose(p["dw"].numpy(), np.asarray(dw), **GRAD_TOL)
        np.testing.assert_allclose(p["db"].numpy(), np.asarray(db), **GRAD_TOL)
    assert all(torch.equal(p["dw"], parts[0]["dw"]) for p in parts)
    # the forward through the autograd Function is still the whole recurrence
    whole = gru_recurrence(*(torch.from_numpy(a) for a in (gi, w_hh, b_hh)))
    assert torch.equal(torch.cat([p["y"] for p in parts], 1), whole)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_backward_from_h0_matches_jax_vjp(reverse):
    """`gru_recurrence_bwd_ref` with h0 in and dh0 out against jax.vjp of the
    JAX chain's chunk scan from the same h0 (time flipped for `reverse`)."""
    gi, w_hh, b_hh = _inputs(2)
    r = np.random.default_rng(3)
    h0 = r.normal(size=(B, H)).astype(np.float32)
    cot = _cotangent(4)
    flip = (lambda a: a[:, ::-1]) if reverse else (lambda a: a)

    def f(h, g, w, b):
        return jax_chunk_scan(h, g, w, b)[1]

    ys, vjp = jax.vjp(f, jnp.asarray(h0), jnp.asarray(np.ascontiguousarray(flip(gi))),
                      jnp.asarray(w_hh), jnp.asarray(b_hh))
    dh0, dgi, dw, db = vjp(jnp.asarray(np.ascontiguousarray(flip(cot))))
    ts = [torch.from_numpy(a) for a in (gi, w_hh, b_hh)]
    out = gru_recurrence_ref(ts[0], ts[1], ts[2], reverse, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(flip(out.numpy()), np.asarray(ys), atol=1e-5)
    got = gru_recurrence_bwd_ref(ts[0], out, torch.from_numpy(cot), ts[1], ts[2], reverse,
                                 h0=torch.from_numpy(h0))
    np.testing.assert_allclose(flip(got[0].numpy()), np.asarray(dgi), **GRAD_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(dw), **GRAD_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(db), **GRAD_TOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(dh0), **GRAD_TOL)
    # without h0 the plain backward starts from zeros, as before, and returns
    # three results; h0 = zeros gives the same three and dh0
    args = (ts[0], out, torch.from_numpy(cot), ts[1], ts[2], reverse)
    none, zeros = (gru_recurrence_bwd_ref(*args), gru_recurrence_bwd_ref(
        *args, h0=torch.zeros(B, H)))
    assert len(none) == 3 and len(zeros) == 4
    assert all(torch.equal(a, b) for a, b in zip(none, zeros[:3]))
