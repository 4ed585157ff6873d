"""The port's audio front-end (`avsync_torch.ops.audio`) against the JAX
package's `avsync.ops.audio` and the numpy oracle, on the same numpy inputs.

Tolerances: audio statistics rtol 1e-5 / atol 1e-4 against the JAX package
and rtol 2e-5 / atol 2e-4 against the float64 oracle, as
tests/test_pallas_mfcc.py:31,48 holds the JAX kernel; constants, shifts and
the shift arithmetic exactly.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from avsync.config import AudioConfig as JaxAudioConfig
from avsync.ops import audio as jaudio
from avsync.ops import audio_ref as jref
from avsync_torch.config import AudioConfig
from avsync_torch.ops import audio, audio_ref
from avsync_torch.ops.cuda import mfcc

S = 8000
LENGTHS = [8000, 5000, 0, 300]  # full, partial, empty, one frame


def _batch(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    buf = np.zeros((len(lengths), S), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000
        buf[i, :n] = 0.5 * np.sin(2 * np.pi * (300 + 80 * i) * t) + 0.01 * rng.standard_normal(n)
    return buf, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("args", [(16000, 2048, 128, 20, 0.0, None),
                                  (8000, 256, 40, 13, 50.0, 3000.0)])
def test_constants_equal_the_jax_packages_bit_for_bit(args):
    for ours, theirs in zip(audio._constants(*args), jaudio._constants(*args)):
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


def test_oracle_copy_equals_the_jax_packages():
    y = np.random.default_rng(1).standard_normal(3000)
    np.testing.assert_array_equal(audio_ref.audio_stats(y, 16000), jref.audio_stats(y, 16000))
    np.testing.assert_array_equal(audio_ref.shift_audio(y, -3, 29.97, 16000),
                                  jref.shift_audio(y, -3, 29.97, 16000))


def test_power_spectrogram_matches_jax():
    """fp32 FFTs of two libraries: within 1e-5 of the spectrum's largest
    value (2048-point sums of fp32 products) and 1e-4 relative."""
    buf, _ = _batch()
    want = np.asarray(jaudio.power_spectrogram(jnp.asarray(buf), JaxAudioConfig()))
    got = audio.power_spectrogram(torch.from_numpy(buf), AudioConfig()).numpy()
    assert got.shape == want.shape == (4, 21, 1025) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(want.max()))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla_path", "kernel_path"])
def test_audio_stats_match_jax(use_pallas):
    buf, lens = _batch()
    jcfg = JaxAudioConfig(max_audio_samples=S, use_pallas=use_pallas)
    cfg = AudioConfig(max_audio_samples=S, use_pallas=use_pallas)
    want = np.asarray(jaudio.audio_stats(jnp.asarray(buf), jnp.asarray(lens), jcfg))
    before = mfcc.launches
    got = audio.audio_stats(torch.from_numpy(buf), torch.from_numpy(lens), cfg).numpy()
    assert mfcc.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[2], 0.0)
    np.testing.assert_array_equal(got[3, 20:], 0.0)  # one frame: std 0


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla_path", "kernel_path"])
def test_audio_stats_match_the_oracle(use_pallas):
    buf, lens = _batch()
    cfg = AudioConfig(max_audio_samples=S, use_pallas=use_pallas)
    got = audio.audio_stats(torch.from_numpy(buf), torch.from_numpy(lens), cfg).numpy()
    for i, n in enumerate(lens):
        ref = audio_ref.audio_stats(buf[i, :n].astype(np.float64), 16000, 20)
        np.testing.assert_allclose(got[i], ref, rtol=2e-5, atol=2e-4)


def test_both_paths_agree():
    buf, lens = _batch(seed=3)
    x, n = torch.from_numpy(buf), torch.from_numpy(lens)
    cfg = AudioConfig(max_audio_samples=S)
    torch.testing.assert_close(audio.audio_stats(x, n, cfg),
                               audio.audio_stats(x, n, dataclasses.replace(cfg, use_pallas=True)),
                               rtol=1e-5, atol=1e-4)


def test_shift_samples_for_frames_exactly_as_jax():
    shifts = np.array([s for m in range(1, 16) for s in (m, -m)], np.int32)
    for fps in (25.0, 29.97, 30.0):
        f = np.full(shifts.shape, fps, np.float32)
        want = np.asarray(jaudio.shift_samples_for_frames(jnp.asarray(shifts), jnp.asarray(f),
                                                          16000))
        got = audio.shift_samples_for_frames(torch.from_numpy(shifts), torch.from_numpy(f), 16000)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_shift_audio_exactly_as_jax():
    """Positive and negative shifts, shifts past the length, L < S and L = 0."""
    rng = np.random.default_rng(2)
    buf = rng.standard_normal((6, 500)).astype(np.float32)
    lens = np.array([500, 320, 0, 500, 100, 320], np.int32)
    shifts = np.array([37, -41, 5, 499, -600, 0], np.int32)
    want = np.asarray(jaudio.shift_audio(jnp.asarray(buf), jnp.asarray(lens), jnp.asarray(shifts)))
    got = audio.shift_audio(torch.from_numpy(buf), torch.from_numpy(lens),
                            torch.from_numpy(shifts)).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(6):  # and the reference's per-clip semantics
        y = buf[i, :lens[i]]
        if lens[i]:
            ref = audio_ref.shift_audio(y, int(shifts[i]), 16000.0, 16000)
            np.testing.assert_array_equal(got[i, :lens[i]], ref)
        np.testing.assert_array_equal(got[i, lens[i]:], 0.0)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla_path", "kernel_path"])
def test_shifted_audio_stats_match_jax(use_pallas):
    buf, lens = _batch(seed=4)
    shifts = np.array([3, -7, 0, 15], np.int32)
    fps = np.array([25.0, 29.97, 0.0, 30.0], np.float32)  # fps 0: a padded serving row
    jcfg = JaxAudioConfig(max_audio_samples=S, use_pallas=use_pallas)
    cfg = AudioConfig(max_audio_samples=S, use_pallas=use_pallas)
    want = np.asarray(jaudio.shifted_audio_stats(*map(jnp.asarray, (buf, lens, shifts, fps)),
                                                 jcfg))
    got = audio.shifted_audio_stats(*map(torch.from_numpy, (buf, lens, shifts, fps)), cfg)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_resample_host_equals_jax():
    y = np.random.default_rng(5).standard_normal(4410).astype(np.float32)
    np.testing.assert_array_equal(audio.resample_host(y, 44100, 16000),
                                  jaudio.resample_host(y, 44100, 16000))
    np.testing.assert_array_equal(audio.resample_host(y, 16000, 16000), y)


def test_device_constants_are_built_once_per_device():
    cfg = AudioConfig()
    a, b = audio.device_constants(cfg, "cpu"), audio.device_constants(cfg, torch.device("cpu"))
    assert all(x is y for x, y in zip(a, b))
