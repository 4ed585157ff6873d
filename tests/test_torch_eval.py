"""The port's batched edit distance (`avsync_torch.eval.levenshtein_batch`,
`cer_wer_batch`) against the JAX package's on the same padded id batches:
random shapes, lengths and alphabets (hypothesis), empty predictions and
targets, and lengths past the padding's content. The distances are equal
integers; the rates agree to rtol 1e-6 (both divide in float32)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from avsync import eval as jeval
from avsync_torch import eval as teval


def _batch(seed, B, P, L, alphabet, empty_every=0):
    r = np.random.default_rng(seed)
    pred = r.integers(0, alphabet, (B, P)).astype(np.int32)
    tgt = r.integers(0, alphabet, (B, L)).astype(np.int32)
    pred_len = r.integers(0, P + 1, (B,)).astype(np.int32)
    tgt_len = r.integers(0, L + 1, (B,)).astype(np.int32)
    if empty_every:
        tgt_len[::empty_every] = 0
        pred_len[1::empty_every] = 0
    return pred, pred_len, tgt, tgt_len


def _both(fn_t, fn_j, arrays):
    got = fn_t(*(torch.from_numpy(a) for a in arrays)).numpy()
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays)))
    return got, want


# P, L >= 1: the JAX function's inner scan indexes the target's first column
@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), B=st.integers(1, 6), P=st.integers(1, 12),
       L=st.integers(1, 12), alphabet=st.integers(1, 6), empty_every=st.sampled_from([0, 2, 3]))
def test_levenshtein_and_rates_equal_the_jax_functions(seed, B, P, L, alphabet, empty_every):
    arrays = _batch(seed, B, P, L, alphabet, empty_every)
    got, want = _both(teval.levenshtein_batch, jeval.levenshtein_batch, arrays)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    got, want = _both(teval.cer_wer_batch, jeval.cer_wer_batch, arrays)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("P,L", [(20, 18), (0, 4), (5, 0)])
def test_distances_equal_the_host_edit_distance(P, L):
    pred, pred_len, tgt, tgt_len = _batch(0, 16, P, L, 5, empty_every=5)
    got = teval.levenshtein_batch(*(torch.from_numpy(a) for a in (pred, pred_len, tgt, tgt_len)))
    for b in range(16):
        assert int(got[b]) == teval.edit_distance(list(pred[b, :pred_len[b]]),
                                                  list(tgt[b, :tgt_len[b]]))


@pytest.mark.parametrize("pred,pred_len,tgt,tgt_len,want", [
    ([[1, 2], [1, 2], [0, 0]], [2, 2, 0], [[1, 2], [0, 0], [0, 0]], [2, 0, 0], [0.0, 1.0, 0.0]),
    ([[3, 3, 3]], [3], [[1, 2, 3, 4]], [4], [0.75]),
])
def test_rates_with_empty_targets(pred, pred_len, tgt, tgt_len, want):
    arrays = [np.asarray(a, np.int32) for a in (pred, pred_len, tgt, tgt_len)]
    got, jax_got = _both(teval.cer_wer_batch, jeval.cer_wer_batch, arrays)
    np.testing.assert_allclose(got, want)
    np.testing.assert_allclose(got, jax_got, rtol=1e-6)
