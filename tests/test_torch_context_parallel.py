"""Context parallelism of the port: the GRU chain with the time axis split
over gloo ranks on the CPU (`avsync_torch.parallel.context`), against the
JAX package's `cp_gru_recurrence` on a mesh of the same size, against the
port's own recurrence over the whole sequence, and the plain recurrence's
initial state `h0` that the chain hands from chunk to chunk.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync.parallel import make_mesh as jax_make_mesh
from avsync.parallel.context import cp_gru_recurrence as jax_cp
from avsync_torch.ops.cuda.gru import gru_recurrence, gru_recurrence_ref
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
