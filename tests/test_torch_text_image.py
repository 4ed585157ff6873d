"""Greedy CTC decode and frame preprocessing: the port against the JAX
package on the same numpy inputs, the JAX package's public helpers
(`decode_prediction`, the gray conversions, `pad_or_truncate_time`,
`resize_area`) included."""

import cv2
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_prediction_matches_jax(seed):
    lp = _log_probs_with_repeats_and_blanks(seed)[seed]
    want = jax_text.decode_prediction(lp)
    assert torch_text.decode_prediction(lp) == want
    assert torch_text.decode_prediction(torch.from_numpy(lp)) == want


@pytest.mark.parametrize("name", ["rgb_to_gray", "bgr_to_gray"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_gray_conversions_match_jax(name, dtype):
    frames = np.random.default_rng(6).integers(0, 256, (2, 5, 12, 16, 3)).astype(dtype)
    ref = np.asarray(getattr(jax_image, name)(jnp.asarray(frames)))
    got = getattr(torch_image, name)(torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 5, 12, 16) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_bgr_to_gray_matches_cv2():
    """As tests/test_image.py holds the JAX function: cv2 rounds to uint8."""
    frame = np.random.default_rng(0).integers(0, 256, size=(32, 40, 3), dtype=np.uint8)
    ref = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)
    got = torch_image.bgr_to_gray(torch.from_numpy(frame).float()).numpy()
    assert np.abs(got - ref).max() <= 0.51


@pytest.mark.parametrize("max_len", [3, 6, 9])
def test_pad_or_truncate_time_matches_jax(max_len):
    clips = np.random.default_rng(7).random((3, 6, 4, 5)).astype(np.float32)
    ref, ref_len = jax_image.pad_or_truncate_time(jnp.asarray(clips), max_len)
    got, got_len = torch_image.pad_or_truncate_time(torch.from_numpy(clips), max_len)
    assert got.shape == (3, max_len, 4, 5) and got_len.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))


@pytest.mark.parametrize("in_hw,out_hw", [((24, 36), (12, 18)), ((24, 36), (8, 12)),
                                          ((92, 280), (46, 140))])
def test_resize_area_integer_factor_matches_jax(in_hw, out_hw):
    frames = np.random.default_rng(8).random((2, 3, *in_hw)).astype(np.float32)
    ref = np.asarray(jax_image.resize_area(jnp.asarray(frames), out_hw))
    got = torch_image.resize_area(torch.from_numpy(frames), out_hw).numpy()
    assert got.shape == (2, 3, *out_hw)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((57, 91), (46, 140)), ((96, 112), (50, 100))])
def test_resize_area_falls_back_to_bilinear_as_jax(in_hw, out_hw):
    frames = np.random.default_rng(9).random((2, *in_hw)).astype(np.float32) * 255
    ref = np.asarray(jax_image.resize_area(jnp.asarray(frames), out_hw))
    got = torch_image.resize_area(torch.from_numpy(frames), out_hw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-5)
