"""Fused mel -> dB -> DCT -> statistics of the MFCC front-end (K5): the CUDA
kernel and its plain twin.

Port of `avsync/ops/pallas/mfcc.py:pallas_mel_stats`: kernel
`avsync_torch/csrc/mel_stats.cu`, plain version `mel_stats_ref`, launches
counted in `launches`. The FFT stays outside (`ops/audio.power_spectrogram`,
`torch.fft.rfft`), as the JAX package leaves it to XLA.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. The kernel has no gradient (the JAX package defines none: no
gradient ever reaches the audio), so the wrapper refuses a `power` that
requires one.

The kernel sums each mel column over its band of nonzero filterbank rows
only. `_band_table` finds the bands of a `melT` once (on the host, where
the constants are built) and keeps them beside the tensor, so the default
filterbank's 2,020 nonzeros of 131,200 are all the kernel reads; a dense
`melT` (the tests' random ones) gives full-width bands.
"""

from __future__ import annotations

import ctypes
import threading
import weakref

import numpy as np
import torch

from avsync_torch.ops.cuda import build

# Kernel launches since the last reset (the caller resets them to 0).
launches = 0

_AMIN = 1e-10
NT = 1024  # threads per CTA (as in mel_stats.cu)
SMEM_LIMIT = 232_448  # bytes of shared memory one block can use on Hopper
MAX_ROWS_PER_CHUNK = 16  # power rows staged per chunk

# avs_mel_stats(power, n_valid, band_lo, band_len, band_off, wpack, dct, out,
#               B, F, K, M, C, R, top_db, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

_bands_lock = threading.Lock()
_bands: dict = {}  # id(melT) -> (weakref to melT, its _version, band table)


def mel_stats_ref(power: torch.Tensor, n_valid: torch.Tensor, melT: torch.Tensor,
                  dctT: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """Plain version: (B, F, K) power + (B,) valid-frame counts -> (B, 2C)
    concat(mean, unbiased std) of the MFCCs over the valid frames, as
    `_mel_stats_kernel` computes them."""
    B, F, _ = power.shape
    n = n_valid.to(device=power.device, dtype=torch.int64)[:, None]  # (B, 1)
    mel = torch.einsum("bfk,km->bfm", power, melT)
    log = 10.0 * torch.log10(torch.clamp(mel, min=_AMIN))
    valid = torch.arange(F, device=power.device)[None, :] < n  # (B, F)
    ref = torch.where(valid[..., None], log, -torch.inf).amax(dim=(1, 2), keepdim=True)
    log = torch.maximum(log, ref - top_db)
    mfcc = torch.einsum("bfm,mc->bfc", log, dctT)
    vm = valid[..., None].to(mfcc.dtype)
    nf = n.to(mfcc.dtype).clamp(min=1.0)
    mean = (mfcc * vm).sum(dim=1) / nf
    var = (((mfcc - mean[:, None, :]) * vm) ** 2).sum(dim=1) / (nf - 1.0).clamp(min=1.0)
    std = torch.where(n > 1, var.sqrt(), 0.0)
    return torch.where(n > 0, torch.cat([mean, std], dim=-1), 0.0)


def _band_table(melT: torch.Tensor):
    """(band_lo, band_len, band_off, wpack) of `melT` on its device: each mel
    column's first nonzero row, its band's length (first to last nonzero
    row; 0 for an all-zero column), the band's offset in `wpack`, and the
    bands' weights packed column after column. Built once per tensor (and
    again only if the tensor is modified in place)."""
    key = id(melT)
    with _bands_lock:
        hit = _bands.get(key)
        if hit is not None and hit[0]() is melT and hit[1] == melT._version:
            return hit[2]
        w = melT.detach().to("cpu", torch.float32).numpy()  # (K, M)
        K, M = w.shape
        nz = w != 0
        has = nz.any(axis=0)
        lo = np.where(has, nz.argmax(axis=0), 0)
        hi = np.where(has, K - 1 - nz[::-1].argmax(axis=0), -1)
        length = hi - lo + 1
        off = np.cumsum(length) - length
        wpack = np.concatenate([w[lo[m]:lo[m] + length[m], m] for m in range(M)] + [
            np.zeros(1, np.float32)])  # one spare element: never empty
        dev = melT.device
        table = tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
                      for a, dt in ((lo, np.int32), (length, np.int32), (off, np.int32),
                                    (wpack, np.float32)))
        for k in [k for k, v in _bands.items() if v[0]() is None]:
            del _bands[k]
        _bands[key] = (weakref.ref(melT), melT._version, table)
        return table


def shared_memory_bytes(F: int, K: int, M: int, C: int, R: int) -> int:
    """Dynamic shared memory of one CTA (as `smem_bytes` in mel_stats.cu)."""
    return 4 * (F * M + R * K + M * C + F * C + NT // 32) + 4 * 3 * M


def mel_stats(power: torch.Tensor, n_valid: torch.Tensor, melT: torch.Tensor,
              dctT: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """(B, F, K) fp32 power + (B,) int32 valid-frame counts, melT (K, M),
    dctT (M, C) -> (B, 2C) fp32 MFCC statistics (K5 on the card)."""
    global launches
    if power.dim() != 3 or melT.dim() != 2 or dctT.dim() != 2:
        raise ValueError("mel_stats: power (B, F, K), melT (K, M), dctT (M, C)")
    B, F, K = power.shape
    M, C = dctT.shape
    if melT.shape != (K, M) or tuple(n_valid.shape) != (B,):
        raise ValueError(f"mel_stats: shapes power {tuple(power.shape)}, n_valid "
                         f"{tuple(n_valid.shape)}, melT {tuple(melT.shape)}, dctT "
                         f"{tuple(dctT.shape)} do not fit together")
    if power.requires_grad:
        raise ValueError("mel_stats has no gradient: pass a power tensor that needs none")
    if power.device.type == "cpu":
        return mel_stats_ref(power, n_valid, melT, dctT, top_db)
    if power.device.type != "cuda":
        raise ValueError(f"mel_stats: unsupported device {power.device}")
    dev = power.device
    for name, t, dtype in (("power", power, torch.float32), ("n_valid", n_valid, torch.int32),
                           ("melT", melT, torch.float32), ("dctT", dctT, torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"mel_stats: {name} must be {dtype} on {dev}")
    if not (power.is_contiguous() and n_valid.is_contiguous() and dctT.is_contiguous()):
        raise ValueError("mel_stats: power, n_valid and dctT must be contiguous")
    fixed = shared_memory_bytes(F, 0, M, C, 0)
    R = min(MAX_ROWS_PER_CHUNK, F, (SMEM_LIMIT - fixed) // (4 * K))
    if R < 1:
        raise ValueError(f"mel_stats kernel: F={F}, K={K}, M={M}, C={C} need more shared "
                         f"memory than a block has ({SMEM_LIMIT} bytes)")
    lo, length, off, wpack = _band_table(melT)
    out = torch.empty(B, 2 * C, device=dev, dtype=torch.float32)
    if B == 0:
        return out
    fn = build.function("mel_stats", "avs_mel_stats", _ARGTYPES)
    err = fn(power.data_ptr(), n_valid.data_ptr(), lo.data_ptr(), length.data_ptr(),
             off.data_ptr(), wpack.data_ptr(), dctT.data_ptr(), out.data_ptr(),
             B, F, K, M, C, R, float(top_db), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("mel_stats", err, "mel_stats launch")
    launches += 1
    return out
