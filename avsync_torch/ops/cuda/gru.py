"""GRU recurrence over precomputed input projections: CUDA kernel and plain twin.

Port of `avsync/ops/pallas/gru.py:pallas_gru_scan`; the kernel is
`avsync_torch/csrc/gru_fwd.cu`, which runs the whole T-step recurrence in
one launch with w_hh and h on chip. A CPU tensor goes to the plain version
`gru_recurrence_ref`; a CUDA tensor launches the kernel or raises. `launches`
counts kernel launches (the plain version does not count).

Weights use the JAX package's right-multiply layout: w_hh is (H, 3H) with
gate columns [r | z | n], so gh = h @ w_hh + b_hh. A torch GRU's
`weight_hh_l0` (3H, H) goes in as its transpose view `.t()` (no copy: the
kernel takes strides).
"""

from __future__ import annotations

import ctypes

import torch

from avsync_torch.ops.cuda import build

# Kernel launches since the last reset (the caller resets it to 0).
launches = 0

# avs_gru_fwd(gi0, gi1, w0, w1, b0, b1, out, 7 strides, B, T, H, ndir,
#             reverse_mask, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 7
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def gru_recurrence_ref(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                       reverse: bool = False) -> torch.Tensor:
    """Plain version: gi (B, T, 3H), w_hh (H, 3H), b_hh (3H,) -> (B, T, H),
    h_0 = 0, torch [r, z, n] gates; `reverse` walks time backwards and still
    returns outputs in forward time order."""
    B, T, threeH = gi.shape
    H = threeH // 3
    h = gi.new_zeros(B, H)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = h @ w_hh + b_hh
        gi_t = gi[:, t]
        r = torch.sigmoid(gi_t[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi_t[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi_t[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        outs[t] = h
    return torch.stack(outs, dim=1)


def _launch(gis, w_hhs, b_hhs, reverse_mask: int) -> torch.Tensor:
    """One launch for 1 or 2 directions; direction d writes out[..., d*H:(d+1)*H]."""
    global launches
    gi0, w0 = gis[0], w_hhs[0]
    B, T, threeH = gi0.shape
    H = threeH // 3
    dev = gi0.device
    if threeH != 3 * H or w0.shape != (H, threeH):
        raise ValueError(f"gru: gi {tuple(gi0.shape)} and w_hh {tuple(w0.shape)} "
                         "do not match (B, T, 3H) x (H, 3H)")
    if H % 8:
        raise ValueError("gru kernel needs H divisible by 8 (cluster of 8 CTAs)")
    for t in (*gis, *w_hhs, *b_hhs):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"gru: every input must be float32 on {dev}")
    for gi, w, b in zip(gis, w_hhs, b_hhs):
        if gi.shape != gi0.shape or w.shape != w0.shape or b.shape != (threeH,):
            raise ValueError("gru: directions must have the same shapes")
        if gi.stride() != gi0.stride() or w.stride() != w0.stride():
            raise ValueError("gru: directions must have the same strides")
        if gi.stride(2) != 1 or not b.is_contiguous():
            raise ValueError("gru: gi's last dim and b_hh must be contiguous")
    ndir = len(gis)
    out = torch.empty(B, T, ndir * H, device=dev, dtype=torch.float32)
    fn = build.function("gru_fwd", "avs_gru_fwd", _ARGTYPES)
    # with one direction, the second pointer set repeats the first (unused)
    err = fn(gis[0].data_ptr(), gis[-1].data_ptr(),
             w_hhs[0].data_ptr(), w_hhs[-1].data_ptr(),
             b_hhs[0].data_ptr(), b_hhs[-1].data_ptr(), out.data_ptr(),
             gi0.stride(0), gi0.stride(1), w0.stride(0), w0.stride(1),
             out.stride(0), out.stride(1), H,
             B, T, H, ndir, reverse_mask, dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("gru_fwd", err, "gru_fwd launch")
    launches += 1
    return out


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"gru: unsupported device {t.device}")
    return False


def gru_recurrence(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """One direction: gi (B, T, 3H), w_hh (H, 3H), b_hh (3H,) -> (B, T, H)."""
    if not _on_cuda(gi):
        return gru_recurrence_ref(gi, w_hh, b_hh, reverse)
    return _launch((gi,), (w_hh,), (b_hh,), int(reverse))


def bigru_recurrence(gi_f: torch.Tensor, gi_b: torch.Tensor,
                     w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                     b_hh_f: torch.Tensor, b_hh_b: torch.Tensor) -> torch.Tensor:
    """Both directions of a bidirectional layer in one launch: forward on
    (gi_f, w_hh_f, b_hh_f), backward in time on (gi_b, ...). Returns
    (B, T, 2H) = [forward | backward], torch's bidirectional layout."""
    if not _on_cuda(gi_f):
        return torch.cat([gru_recurrence_ref(gi_f, w_hh_f, b_hh_f, False),
                          gru_recurrence_ref(gi_b, w_hh_b, b_hh_b, True)], dim=-1)
    return _launch((gi_f, gi_b), (w_hh_f, w_hh_b), (b_hh_f, b_hh_b), 0b10)
