"""Greedy CTC decode and frame preprocessing: the port against the JAX
package on the same numpy inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from avsync import text as jax_text
from avsync.ops import image as jax_image
from avsync_torch import text as torch_text
from avsync_torch.ops import image as torch_image


def _log_probs_with_repeats_and_blanks(seed, B=4, T=30, V=39):
    r = np.random.default_rng(seed)
    # runs of a symbol, blanks between, and a repeat across a blank
    ids = r.choice([0, 0, 0, 1, 5, 5, 12, 37, 38], size=(B, T))
    ids[:, 5:9] = 7
    ids[:, 9] = 0
    ids[:, 10:12] = 7
    lp = r.normal(0.0, 1.0, (B, T, V)).astype(np.float32)
    np.put_along_axis(lp, ids[..., None], 10.0, axis=-1)
    return lp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_matches_jax(seed):
    lp = _log_probs_with_repeats_and_blanks(seed)
    assert torch_text.decode_batch(torch.from_numpy(lp)) == jax_text.decode_batch(lp)


def test_packed_indices_and_lengths_match_jax():
    lp = _log_probs_with_repeats_and_blanks(3)
    dec, lens = torch_text.ctc_greedy_decode(torch.from_numpy(lp))
    jdec, jlens = jax_text.ctc_greedy_decode(jnp.asarray(lp))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


def test_beam_search_is_not_ported_yet():
    """Beam search is ported now (`ops/beam.py`): beam_width > 1 no longer
    raises and decodes as the JAX package does (tests/test_torch_beam.py
    holds it at every width)."""
    lp = _log_probs_with_repeats_and_blanks(4)
    assert (torch_text.decode_batch(torch.from_numpy(lp), beam_width=4)
            == jax_text.decode_batch(lp, beam_width=4))


def test_align_parsing_matches_jax():
    content = "0 23750 sil\n23750 29500 bin\n29500 34000 blue\n34000 35500 sp\n35500 41000 at\n"
    assert torch_text.parse_align_text(content) == jax_text.parse_align_text(content)


@pytest.mark.parametrize("hw", [(288, 360), (120, 160), (75, 99)])
def test_preprocess_clips_matches_jax(hw):
    frames = np.random.default_rng(4).integers(0, 256, (2, 5, *hw), dtype=np.uint8)
    ref = np.asarray(jax_image.preprocess_clips(jnp.asarray(frames, jnp.float32)))
    got = torch_image.preprocess_clips(torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 5, 50, 100, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_standardize_clips_matches_jax():
    clips = np.random.default_rng(5).random((3, 6, 50, 100, 1)).astype(np.float32)
    ref = np.asarray(jax_image.standardize_clips(jnp.asarray(clips)))
    got = torch_image.standardize_clips(torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
