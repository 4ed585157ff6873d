"""Fused mel -> dB -> DCT -> statistics of the MFCC front-end (K5): the CUDA
kernel and its plain twin.

Port of `avsync/ops/pallas/mfcc.py:pallas_mel_stats`: kernel
`avsync_torch/csrc/mel_stats.cu`, plain version `mel_stats_ref`, launches
counted in `launches`. The FFT stays outside (`ops/audio.power_spectrogram`,
`torch.fft.rfft`), as the JAX package leaves it to XLA.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises (the operator `avsync_torch::mel_stats`, `mel_stats_op`, which
`torch.export` traces as one node; the dispatcher chooses by the tensor's
device). The kernel has no gradient (the JAX package defines none: no
gradient ever reaches the audio), so the wrapper refuses a `power` that
requires one.

The kernel sums each mel column over its band of nonzero filterbank rows
only. `_band_table` finds the bands of a `melT` once (on the host, where
the constants are built) and keeps them beside the tensor, so the default
filterbank's 2,020 nonzeros of 131,200 are all the kernel reads; a dense
`melT` (the tests' random ones) gives full-width bands. A CUDA graph that
captured the kernel holds the table's addresses: modifying its `melT` in
place afterwards rebuilds the table and frees the one the graph reads.

Each clip runs on a cluster of CTAs, each owning a slice of its frames:
`cluster_grid` chooses the cluster and the slices from (F, K, M, C) alone,
never from the batch or the card, so a clip's statistics are the same bits
in any batch. At the default K = 1025, M = 128, C = 20 the kernel takes F up
to `max_frames` (2,936 frames: 73 s of 16 kHz audio at hop 400); past it
the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import numpy as np
import torch

from avsync_torch.ops.cuda import build

# Kernel launches since the last reset (the caller resets them to 0).
launches = 0

_AMIN = 1e-10
NT = 512  # threads per CTA (as in mel_stats.cu)
# the dynamic shared memory one CTA may opt in to on Hopper (MAX_DYN_SMEM in
# csrc/cluster_exchange.cuh: 232,448 bytes less 64)
SMEM_LIMIT = 232_384
MAX_CLUSTER = 8  # CTAs per clip, at most (a portable cluster)
ROWS_PER_CTA = 64  # frames per CTA while the cluster grows (F <= 512)
SLAB_ROWS = (16, 8, 4, 2, 1)  # rows per staged slab, the first that fits
# slab height when a launch has more CTAs than the card has SMs: half-height
# slabs let two CTAs share an SM, one loading while the other computes
# (scripts/torch_kernel_breakdown.py --mode k5 times both)
SHARED_SM_SLAB_ROWS = 8

# avs_mel_stats(power, n_valid, band_lo, band_len, band_off, wpack, dct, out,
#               B, F, K, M, C, CS, R, SR, nbuf, top_db, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
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
    # an inference tensor keeps no version counter (and is modified in place
    # only inside inference mode)
    version = None if melT.is_inference() else melT._version
    with _bands_lock:
        hit = _bands.get(key)
        if hit is not None and hit[0]() is melT and hit[1] == version:
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
        _bands[key] = (weakref.ref(melT), version, table)
        return table


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def shared_memory_bytes(K: int, M: int, C: int, R: int, SR: int, nbuf: int) -> int:
    """Dynamic shared memory of one CTA (as `smem_bytes` in mel_stats.cu):
    nbuf slabs of SR power rows widened to 16 bytes (later the (R, C)
    MFCCs), the (R, M + 1) log-mel, the (M, C) DCT with its columns padded
    to a multiple of 4, the band table, the reductions and exchanges."""
    slab = _round4(SR * K + 8)
    a = _round4(max(nbuf * slab, R * C))
    red = _round4(NT // 32 + MAX_CLUSTER + 2 * MAX_CLUSTER * C)
    return 4 * (a + _round4(R * (M + 1)) + M * _round4(C) + _round4(3 * M) + red)


@functools.lru_cache(maxsize=None)
def cluster_grid(F: int, K: int, M: int, C: int):
    """(CS, R, SR, nbuf) of K5's grid for clips of F frames: CS CTAs per
    clip, CTA rank owning frames [rank R, rank R + R), staged in slabs of SR
    rows through nbuf buffers (two when a CTA has more than one slab). CS
    and R are a function of the shape alone, so a clip's bits depend
    neither on the batch nor on the card (the slabs do not enter the
    arithmetic: `mel_stats` may take shorter ones). None when no slab
    height fits a CTA's shared memory."""
    cs = min(MAX_CLUSTER, -(-F // ROWS_PER_CTA))
    R = -(-F // cs)
    for sr in SLAB_ROWS:
        nbuf = 2 if R > sr else 1
        if shared_memory_bytes(K, M, C, R, sr, nbuf) <= SMEM_LIMIT:
            return cs, R, sr, nbuf
    return None


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def max_frames(K: int, M: int, C: int) -> int:
    """The most frames per clip the kernel takes at (K, M, C) (0: none)."""
    if cluster_grid(1, K, M, C) is None:
        return 0
    lo, hi = 1, 1 << 24  # cluster_grid(lo) fits; the grid's rows grow with F
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if cluster_grid(mid, K, M, C) is None:
            hi = mid - 1
        else:
            lo = mid
    return lo


def mel_stats(power: torch.Tensor, n_valid: torch.Tensor, melT: torch.Tensor,
              dctT: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """(B, F, K) fp32 power + (B,) int32 valid-frame counts, melT (K, M),
    dctT (M, C) -> (B, 2C) fp32 MFCC statistics (K5 on the card), through
    the operator `mel_stats_op`."""
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
    if power.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mel_stats: unsupported device {power.device}")
    return mel_stats_op(power, n_valid, melT, dctT, float(top_db))


def _mel_stats_cuda(power: torch.Tensor, n_valid: torch.Tensor, melT: torch.Tensor,
                    dctT: torch.Tensor, top_db: float) -> torch.Tensor:
    """One K5 launch (the band table is built here at the first call with a
    filterbank: in an exported program, from the one the program holds)."""
    global launches
    B, F, K = power.shape
    M, C = dctT.shape
    dev = power.device
    for name, t, dtype in (("power", power, torch.float32), ("n_valid", n_valid, torch.int32),
                           ("melT", melT, torch.float32), ("dctT", dctT, torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"mel_stats: {name} must be {dtype} on {dev}")
    if not (power.is_contiguous() and n_valid.is_contiguous() and dctT.is_contiguous()):
        raise ValueError("mel_stats: power, n_valid and dctT must be contiguous")
    if power.data_ptr() % 4:
        raise ValueError("mel_stats: power must be 4-byte aligned")
    grid = cluster_grid(F, K, M, C)
    if grid is not None and grid[2] > SHARED_SM_SLAB_ROWS and B * grid[0] > _sm_count(dev):
        grid = (*grid[:2], SHARED_SM_SLAB_ROWS, 2 if grid[1] > SHARED_SM_SLAB_ROWS else 1)
    if grid is None:
        raise ValueError(f"mel_stats kernel: F={F} frames at K={K}, M={M}, C={C} need more "
                         f"shared memory than a block has ({SMEM_LIMIT} bytes); it takes "
                         f"F <= {max_frames(K, M, C)} there")
    lo, length, off, wpack = _band_table(melT)
    out = torch.empty(B, 2 * C, device=dev, dtype=torch.float32)
    if B == 0:
        return out
    fn = build.function("mel_stats", "avs_mel_stats", _ARGTYPES)
    err = fn(power.data_ptr(), n_valid.data_ptr(), lo.data_ptr(), length.data_ptr(),
             off.data_ptr(), wpack.data_ptr(), dctT.data_ptr(), out.data_ptr(),
             B, F, K, M, C, *grid, float(top_db), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("mel_stats", err, "mel_stats launch")
    launches += 1
    return out


# K5 as an operator, so that `torch.export` traces it as one node and an
# exported program launches it; the plain version for CPU tensors.
mel_stats_op = torch.library.custom_op("avsync_torch::mel_stats", _mel_stats_cuda,
                                       mutates_args=(), device_types="cuda")


@mel_stats_op.register_kernel("cpu")
def _mel_stats_cpu(power, n_valid, melT, dctT, top_db):
    return mel_stats_ref(power, n_valid, melT, dctT, top_db)


@mel_stats_op.register_fake
def _mel_stats_fake(power, n_valid, melT, dctT, top_db):
    return power.new_empty(power.shape[0], 2 * dctT.shape[1])
