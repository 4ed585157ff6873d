"""Audio front-end on the device: batched MFCC statistics and shift
augmentation (port of `avsync/ops/audio.py`).

  * Audio rides in fixed-size zero-padded buffers (B, max_samples) plus a
    lengths vector; zero padding composes exactly with librosa's 'constant'
    STFT pad, so masking the valid frames gives the variable-length result.
  * Framing is `unfold`, the FFT is `torch.fft.rfft` (cuFFT on the card), the
    power is real^2 + imag^2 (not abs()**2, which rounds through a square
    root).
  * `AudioConfig.use_pallas=True` sends mel -> dB -> DCT -> statistics to the
    fused kernel K5 (`ops/cuda/mfcc.mel_stats`: the CUDA kernel for a CUDA
    tensor, its plain version for a CPU one); False is the JAX package's XLA
    path, written out here: two fp32 einsums, the masked top_db clamp, the
    masked mean and std.
  * `shift_audio` is a roll plus an index mask, so the shift-contrastive
    negatives are made for the whole batch on the device.

The mel, DCT and window constants are built in float64 numpy by the port's
own copy of the oracle (`ops/audio_ref.py`) and cast to float32, as the JAX
package builds them: they are equal bit for bit.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from avsync_torch.config import AudioConfig
from avsync_torch.ops import audio_ref
from avsync_torch.ops.cuda.mfcc import mel_stats

_AMIN = 1e-10


@functools.lru_cache(maxsize=8)
def _constants(sr: int, n_fft: int, n_mels: int, n_mfcc: int, fmin: float,
               fmax) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(melT (n_bins, n_mels), dctT (n_mels, n_mfcc), window (n_fft,)),
    float32 numpy."""
    mel = audio_ref.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    dct = audio_ref.dct_ortho_matrix(n_mfcc, n_mels)
    win = audio_ref.hann_periodic(n_fft)
    return mel.astype(np.float32).T, dct.astype(np.float32).T, win.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_constants_cached(key: tuple, device: torch.device):
    # made outside inference mode whatever the first caller's mode: a cached
    # inference tensor would refuse later autograd and version checks
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in _constants(*key))


def device_constants(cfg: AudioConfig, device) -> Tuple[torch.Tensor, ...]:
    """`_constants` as tensors on `device`, moved there once per device (the
    same tensor objects on every call, so K5's band table is built once)."""
    key = (cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.n_mfcc, cfg.fmin, cfg.fmax)
    return _device_constants_cached(key, torch.device(device))


def num_frames(n_samples: int, hop_length: int) -> int:
    return 1 + n_samples // hop_length


def power_spectrogram(audio: torch.Tensor, cfg: AudioConfig = AudioConfig(),
                      consts=None) -> torch.Tensor:
    """(B, S) -> (B, F, 1 + n_fft//2) power spectrogram (centered, zero pad).
    `consts`: `device_constants(cfg, device)` when the caller holds them (an
    exported program, as buffers)."""
    _, _, win = consts or device_constants(cfg, audio.device)
    pad = cfg.n_fft // 2
    frames = torch.nn.functional.pad(audio, (pad, pad)).unfold(-1, cfg.n_fft, cfg.hop_length)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def mfcc_frames(audio: torch.Tensor, lengths: torch.Tensor,
                cfg: AudioConfig = AudioConfig()) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) padded audio + (B,) lengths -> ((B, F, n_mfcc) MFCCs, (B, F)
    mask of the 1 + length // hop frames librosa would have produced)."""
    return mfcc_from_power(power_spectrogram(audio, cfg), lengths, cfg)


def mfcc_from_power(power: torch.Tensor, lengths: torch.Tensor,
                    cfg: AudioConfig = AudioConfig(),
                    consts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`mfcc_frames` after the FFT: (B, F, K) power -> (MFCCs, valid mask)."""
    melT, dctT, _ = consts or device_constants(cfg, power.device)
    F = power.shape[1]
    log_spec = 10.0 * torch.log10(torch.clamp(torch.einsum("bfk,km->bfm", power, melT),
                                              min=_AMIN))
    valid = (torch.arange(F, device=power.device)[None, :]
             < (1 + lengths.to(torch.int64) // cfg.hop_length)[:, None])
    masked = torch.where(valid[..., None], log_spec, -torch.inf)
    ref_max = masked.amax(dim=(1, 2), keepdim=True)  # top_db relative to the VALID frames
    log_spec = torch.maximum(log_spec, ref_max - cfg.top_db)
    return torch.einsum("bfm,mc->bfc", log_spec, dctT), valid


def stats_from_power(power: torch.Tensor, lengths: torch.Tensor,
                     cfg: AudioConfig = AudioConfig(), consts=None) -> torch.Tensor:
    """The `use_pallas=False` path after the FFT (the JAX package's XLA
    path): two fp32 einsums, the masked top_db clamp, masked mean and std."""
    mfcc, valid = mfcc_from_power(power, lengths, cfg, consts)
    vm = valid[..., None].to(mfcc.dtype)
    n = vm.sum(dim=1)  # (B, 1)
    mean = (mfcc * vm).sum(dim=1) / n.clamp(min=1.0)
    var = (((mfcc - mean[:, None, :]) * vm) ** 2).sum(dim=1) / (n - 1.0).clamp(min=1.0)
    std = torch.where(n > 1, var.sqrt(), 0.0)
    return torch.where(lengths[:, None] > 0, torch.cat([mean, std], dim=-1), 0.0)


def audio_stats(audio: torch.Tensor, lengths: torch.Tensor,
                cfg: AudioConfig = AudioConfig(), consts=None) -> torch.Tensor:
    """(B, S), (B,) -> (B, 2*n_mfcc): concat(mean, unbiased std) over the
    valid MFCC frames (torch.mean/torch.std at
    `misalignment_detection_train.py:124-127`); zeros for empty audio.
    `consts` as for `power_spectrogram`."""
    power = power_spectrogram(audio, cfg, consts)
    if cfg.use_pallas:
        melT, dctT, _ = consts or device_constants(cfg, audio.device)
        lengths = lengths.to(torch.int32)
        n_valid = torch.where(lengths > 0, 1 + lengths // cfg.hop_length, 0).to(torch.int32)
        return mel_stats(power, n_valid, melT, dctT, top_db=cfg.top_db)
    return stats_from_power(power, lengths, cfg, consts)


def shift_samples_for_frames(shift_frames: torch.Tensor, fps: torch.Tensor,
                             sample_rate: int) -> torch.Tensor:
    """shift_frames / fps * sr truncated toward zero (python int() at
    `misalignment_detection_train.py:103`), in float32 and in this order, as
    the JAX package computes it: another order moves the truncation by one
    sample on some (shift, fps) pairs."""
    s = shift_frames.to(torch.float32) / torch.clamp(fps.to(torch.float32), min=1e-5)
    return torch.trunc(s * sample_rate).to(torch.int32)


def shift_audio(audio: torch.Tensor, lengths: torch.Tensor,
                shift_samples: torch.Tensor) -> torch.Tensor:
    """Batched zero-fill shift: out[i] = audio[i - s] where i - s and i lie
    in [0, length), else 0 (`misalignment_detection_train.py:100-114`): a
    positive shift delays the audio, a negative one advances it, and the
    padded tail stays zero. The gather reads the roll's index (i - s) mod S,
    exactly as jnp.roll does."""
    S = audio.shape[1]
    i = torch.arange(S, device=audio.device)[None, :]
    src = i - shift_samples.to(torch.int64)[:, None]
    L = lengths.to(torch.int64)[:, None]
    ok = (src >= 0) & (src < L) & (i < L)
    return torch.where(ok, audio.gather(1, src.remainder(S)), 0.0)


def shifted_audio_stats(audio: torch.Tensor, lengths: torch.Tensor, shift_frames: torch.Tensor,
                        fps: torch.Tensor, cfg: AudioConfig = AudioConfig(),
                        consts=None) -> torch.Tensor:
    """Shift -> MFCC -> statistics for a batch of (clip, shift) pairs, on
    the device (`misalignment_detection_train.py:199-206`)."""
    s = shift_samples_for_frames(shift_frames, fps, cfg.sample_rate)
    return audio_stats(shift_audio(audio, lengths, s), lengths, cfg, consts)


def resample_host(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Host polyphase resampling (scipy) where the reference calls
    `librosa.resample` (`misalignment_detection_train.py:203`)."""
    if orig_sr == target_sr:
        return y.astype(np.float32)
    from fractions import Fraction

    from scipy.signal import resample_poly

    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    return resample_poly(y.astype(np.float64), frac.numerator, frac.denominator).astype(
        np.float32)
