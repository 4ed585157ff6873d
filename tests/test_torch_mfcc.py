"""K5's plain version (`avsync_torch.ops.cuda.mfcc.mel_stats_ref`, which the
kernel is held to on the card) against the JAX package's Pallas kernel
`pallas_mel_stats` run in interpret mode, on the same power arrays; and the
host half of the kernel path (the band table the CUDA kernel reads).

Tolerance rtol 1e-5 / atol 1e-4, as tests/test_pallas_mfcc.py:31 holds the
Pallas kernel against the XLA path.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from avsync.ops.pallas.mfcc import pallas_mel_stats
from avsync_torch.config import AudioConfig
from avsync_torch.ops import audio_ref
from avsync_torch.ops.audio import device_constants
from avsync_torch.ops.cuda import mfcc

TOL = dict(rtol=1e-5, atol=1e-4)


def _constants(sr, n_fft, n_mels, n_mfcc):
    melT = audio_ref.mel_filterbank(sr, n_fft, n_mels).astype(np.float32).T
    dctT = audio_ref.dct_ortho_matrix(n_mfcc, n_mels).astype(np.float32).T
    return np.ascontiguousarray(melT), np.ascontiguousarray(dctT)


def _power(rng, B, F, K):
    # spectra spanning ~100 dB, so the top_db clamp bites
    return (rng.random((B, F, K)) ** 8 * 10.0 ** rng.uniform(-6, 3, (B, F, 1))).astype(np.float32)


def _compare(power, n_valid, melT, dctT, top_db=80.0):
    want = np.asarray(pallas_mel_stats(jnp.asarray(power), jnp.asarray(n_valid),
                                       jnp.asarray(melT), jnp.asarray(dctT), top_db=top_db,
                                       interpret=True))
    got = mfcc.mel_stats_ref(torch.from_numpy(power), torch.from_numpy(n_valid),
                             torch.from_numpy(melT), torch.from_numpy(dctT), top_db).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    return got


@pytest.mark.parametrize("melT_kind", ["filterbank", "dense_random"])
def test_ref_matches_pallas_kernel_at_odd_shapes(melT_kind):
    """F=21, K=129, M=40, C=13; n = F, partial, 1 and 0."""
    rng = np.random.default_rng(0)
    melT, dctT = _constants(8000, 256, 40, 13)
    if melT_kind == "dense_random":
        melT = rng.random(melT.shape).astype(np.float32) * 0.05
    n_valid = np.array([21, 9, 1, 0], np.int32)
    got = _compare(_power(rng, 4, 21, 129), n_valid, melT, dctT, top_db=60.0)
    np.testing.assert_array_equal(got[3], 0.0)
    np.testing.assert_array_equal(got[2, 13:], 0.0)


def test_ref_matches_pallas_kernel_at_full_width():
    """One clip at the detector's shape: F=121, K=1025, M=128, C=20."""
    melT, dctT = _constants(16000, 2048, 128, 20)
    _compare(_power(np.random.default_rng(1), 1, 121, 1025), np.array([97], np.int32),
             melT, dctT)


def test_ref_matches_pallas_kernel_with_one_frame():
    melT, dctT = _constants(8000, 256, 40, 13)
    _compare(_power(np.random.default_rng(2), 2, 1, 129), np.array([1, 0], np.int32), melT, dctT)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(3)
    melT, dctT = (torch.from_numpy(a) for a in _constants(8000, 256, 40, 13))
    power = torch.from_numpy(_power(rng, 3, 21, 129))
    n = torch.tensor([21, 5, 0], dtype=torch.int32)
    before = mfcc.launches
    got = mfcc.mel_stats(power, n, melT, dctT)
    assert mfcc.launches == before
    torch.testing.assert_close(got, mfcc.mel_stats_ref(power, n, melT, dctT), rtol=0, atol=0)


def test_wrapper_refuses_what_it_does_not_take():
    melT, dctT = (torch.from_numpy(a) for a in _constants(8000, 256, 40, 13))
    n = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="no gradient"):
        mfcc.mel_stats(torch.rand(1, 4, 129, requires_grad=True), n, melT, dctT)
    with pytest.raises(ValueError, match="do not fit"):
        mfcc.mel_stats(torch.rand(1, 4, 128), n, melT, dctT)


def test_band_table_of_the_default_filterbank():
    """2,020 nonzeros of 131,200, one contiguous band of 5-48 bins per mel
    column, no empty column; the table rebuilds melT exactly, and is built
    once per tensor."""
    melT = torch.from_numpy(_constants(16000, 2048, 128, 20)[0])
    lo, length, off, wpack = mfcc._band_table(melT)
    assert mfcc._band_table(melT)[3] is wpack
    lo, length, off, w = (t.numpy() for t in (lo, length, off, wpack))
    assert int((melT != 0).sum()) == 2020 == int(length.sum())
    assert length.min() >= 5 and length.max() <= 48
    rebuilt = np.zeros(melT.shape, np.float32)
    for m in range(128):
        rebuilt[lo[m]:lo[m] + length[m], m] = w[off[m]:off[m] + length[m]]
    np.testing.assert_array_equal(rebuilt, melT.numpy())


def test_constants_first_made_in_inference_mode_are_normal_tensors():
    """A serving process's first MFCC call runs under inference_mode: the
    cached filterbank must still carry a version counter, and the band table
    must take an inference tensor too (on the card both raised before)."""
    cfg = AudioConfig(sample_rate=8000, n_fft=256, n_mels=40, n_mfcc=13, fmax=3999.0)
    with torch.inference_mode():
        melT, dctT, win = device_constants(cfg, "cpu")
        assert not any(t.is_inference() for t in (melT, dctT, win))
        inf = melT.clone()
        assert inf.is_inference()
        table = mfcc._band_table(inf)
    assert mfcc._band_table(inf) is table
    assert mfcc._band_table(melT)[3].numel() == table[3].numel()


def test_band_table_of_a_column_of_zeros():
    melT = torch.zeros(6, 3)
    melT[1:4, 0] = 1.0
    melT[5, 2] = 2.0
    lo, length, off, w = (t.numpy() for t in mfcc._band_table(melT))
    assert lo.tolist() == [1, 0, 5] and length.tolist() == [3, 0, 1] and off.tolist() == [0, 3, 3]
    np.testing.assert_array_equal(w[:4], [1.0, 1.0, 1.0, 2.0])


@pytest.mark.parametrize("F", [1, 21, 121, 256, 257, 401, 1201])
def test_cluster_grid_of_the_detector_shape(F):
    """K5's grid at K=1025, M=128, C=20: at most 8 CTAs per clip (a
    portable cluster), every frame owned by exactly one CTA (no CTA without
    one), each CTA's shared memory within a block's 232,448 bytes, and the
    choice a function of (F, K, M, C) alone: never of the batch."""
    import inspect

    assert list(inspect.signature(mfcc.cluster_grid.__wrapped__).parameters) == ["F", "K", "M",
                                                                                 "C"]
    cs, R, sr, nbuf = mfcc.cluster_grid(F, 1025, 128, 20)
    assert 1 <= cs <= 8 and 32 % sr == 0 and nbuf == (2 if R > sr else 1)
    owner = np.zeros(F, np.int64)
    for rank in range(cs):
        rows = range(rank * R, min(F, rank * R + R))
        assert len(rows) > 0
        owner[rows.start:rows.stop] += 1
    np.testing.assert_array_equal(owner, 1)
    assert mfcc.shared_memory_bytes(1025, 128, 20, R, sr, nbuf) <= mfcc.SMEM_LIMIT <= 232_448
    # the half-height slabs a launch with more CTAs than SMs takes fit too
    half = mfcc.SHARED_SM_SLAB_ROWS
    half_smem = mfcc.shared_memory_bytes(1025, 128, 20, R, half, 2 if R > half else 1)
    assert half_smem <= mfcc.SMEM_LIMIT
    if F == 121:  # the detector's 3 s clips: two CTAs of half-height slabs share an SM
        assert (cs, R) == (2, 61) and 2 * (half_smem + 1024) <= 228 * 1024


def test_cluster_grid_limit_names_the_frames_it_takes():
    """Up to 2,936 frames (73 s at hop 400) at the detector's K, M, C; one
    more does not fit. A K too wide for one slab row takes no F."""
    top = mfcc.max_frames(1025, 128, 20)
    assert top == 2936 >= 1201
    assert mfcc.cluster_grid(top, 1025, 128, 20) is not None
    assert mfcc.cluster_grid(top + 1, 1025, 128, 20) is None
    assert mfcc.max_frames(60000, 4, 2) == 0 and mfcc.cluster_grid(3, 60000, 4, 2) is None


def test_ref_matches_pallas_kernel_on_long_audio():
    """F=401 (10 s of 16 kHz audio at hop 400: past what the one-CTA-per-clip
    kernel took) at the detector's K, M, C; n = F, a partial count, 1 and 0."""
    melT, dctT = _constants(16000, 2048, 128, 20)
    n_valid = np.array([401, 233, 1, 0], np.int32)
    got = _compare(_power(np.random.default_rng(4), 4, 401, 1025), n_valid, melT, dctT)
    np.testing.assert_array_equal(got[3], 0.0)
    np.testing.assert_array_equal(got[2, 20:], 0.0)
