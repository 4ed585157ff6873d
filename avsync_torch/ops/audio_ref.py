"""Numpy float64 reference MFCC — the port's own copy of
`avsync/ops/audio_ref.py` (the parity oracle of the audio front-end).

What `librosa.feature.mfcc(y=audio, sr=sr, n_mfcc=N, hop_length=H)` computes
with librosa >= 0.10 defaults (`misalignment_detection_train.py:117-127`):

  1. STFT: n_fft=2048, periodic Hann window, center=True with *zero* padding
     of n_fft//2 on both sides, frame count 1 + len(y)//hop.
  2. Power spectrogram |S|**2.
  3. Mel filterbank: n_mels=128, fmin=0, fmax=sr/2, Slaney mel scale with
     Slaney area normalization.
  4. power_to_db with ref=1.0, amin=1e-10, top_db=80.0 (the clamp is relative
     to the max over the whole spectrogram).
  5. DCT-II along the mel axis with 'ortho' normalization; first n_mfcc rows.

`ops/audio.py` builds its float32 mel, DCT and window constants from these
functions, so they equal the JAX package's bit for bit
(tests/test_torch_audio.py).
"""

from __future__ import annotations

import numpy as np


def hann_periodic(n: int) -> np.ndarray:
    """Periodic ('fftbins') Hann window, scipy.signal.get_window('hann', n)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def hz_to_mel_slaney(f):
    """Slaney mel scale (librosa htk=False)."""
    f = np.asanyarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    return np.where(
        above,
        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz_slaney(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0,
                   fmax=None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, 1 + n_fft//2)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min, mel_max = hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax)
    mel_f = mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])  # Slaney area normalization
    return weights * enorm[:, None]


def stft_power(y: np.ndarray, n_fft: int = 2048, hop_length: int = 400) -> np.ndarray:
    """Power spectrogram, (1 + n_fft//2, n_frames), center/zero-pad mode."""
    y = np.asarray(y, dtype=np.float64)
    pad = n_fft // 2
    yp = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + len(y) // hop_length
    win = hann_periodic(n_fft)
    frames = np.stack([yp[i * hop_length: i * hop_length + n_fft] for i in range(n_frames)])
    spec = np.fft.rfft(frames * win, axis=-1)
    return (np.abs(spec) ** 2).T


def power_to_db(S: np.ndarray, amin: float = 1e-10, top_db: float = 80.0) -> np.ndarray:
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def dct_ortho_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) DCT-II matrix with 'ortho' norm (scipy.fft.dct type 2)."""
    n = np.arange(n_in)
    k = np.arange(n_out)[:, None]
    D = np.cos(np.pi * (2 * n[None, :] + 1) * k / (2.0 * n_in))
    D *= np.sqrt(2.0 / n_in)
    D[0] /= np.sqrt(2.0)
    return D


def mfcc(y: np.ndarray, sr: int, n_mfcc: int = 20, hop_length: int | None = None,
         n_fft: int = 2048, n_mels: int = 128, fmin: float = 0.0, fmax=None,
         top_db: float = 80.0) -> np.ndarray:
    """(n_mfcc, n_frames) MFCCs, librosa-default semantics (see module doc)."""
    if hop_length is None:
        hop_length = max(1, sr // 40)
    S = stft_power(y, n_fft=n_fft, hop_length=hop_length)
    mel = mel_filterbank(sr, n_fft, n_mels, fmin, fmax) @ S
    return dct_ortho_matrix(n_mfcc, n_mels) @ power_to_db(mel, top_db=top_db)


def audio_stats(y: np.ndarray, sr: int, n_mfcc: int = 20) -> np.ndarray:
    """concat(mean, unbiased std) over time of the MFCCs — the reference's
    `compute_audio_stats` (`misalignment_detection_train.py:117-127`)."""
    if y.size == 0:
        return np.zeros(2 * n_mfcc)
    m = mfcc(y, sr, n_mfcc=n_mfcc).T  # (n_frames, n_mfcc)
    mean = m.mean(axis=0)
    std = m.std(axis=0, ddof=1) if m.shape[0] > 1 else np.zeros_like(mean)
    return np.concatenate([mean, std])


def shift_audio(y: np.ndarray, shift_frames: int, fps: float, sr: int) -> np.ndarray:
    """Reference zero-fill shift (`misalignment_detection_train.py:100-114`)."""
    if shift_frames == 0:
        return y.copy()
    shift = int(shift_frames / max(fps, 1e-5) * sr)
    if shift == 0:
        return y.copy()
    out = np.zeros_like(y)
    if shift > 0:
        if shift < len(y):
            out[shift:] = y[:-shift]
    else:
        shift = -shift
        if shift < len(y):
            out[:-shift] = y[shift:]
    return out
