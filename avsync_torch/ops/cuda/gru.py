"""GRU recurrence over precomputed input projections, forward and backward:
CUDA kernels and their plain twins.

  * forward: port of `avsync/ops/pallas/gru.py:pallas_gru_scan`, kernel
    `avsync_torch/csrc/gru_fwd.cu` (K2), which runs the whole T-step
    recurrence in one launch with w_hh and h on chip; plain version
    `gru_recurrence_ref`; `launches` counts its launches;
  * backward: port of `pallas_gru_bwd`, kernel `avsync_torch/csrc/gru_bwd.cu`
    (K3): the reverse-time chain for dgi, then dW_hh/db_hh in a second,
    deterministic reduction kernel of the same launch; plain version
    `gru_recurrence_bwd_ref`; `bwd_launches` counts its launches (each runs
    both CUDA kernels).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. The counters count kernel launches only (the plain versions do not
count).

Weights use the JAX package's right-multiply layout: w_hh is (H, 3H) with
gate columns [r | z | n], so gh = h @ w_hh + b_hh. A torch GRU's
`weight_hh_l0` (3H, H) goes in as its transpose view `.t()` (no copy: the
kernel takes strides).
"""

from __future__ import annotations

import ctypes

import torch

from avsync_torch.ops.cuda import build

# Kernel launches since the last reset (the caller resets them to 0).
launches = 0
bwd_launches = 0

# avs_gru_fwd(gi0, gi1, w0, w1, b0, b1, out, 7 strides, B, T, H, ndir,
#             reverse_mask, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 7
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
MAX_HIDDEN = 256  # the forward kernel's register-resident w_hh (csrc/gru_fwd.cu)
# avs_gru_bwd(gi0, gi1, out0, out1, g0, g1, w0, w1, b0, b1, dgi0, dgi1,
#             dgh0, dgh1, dw0, dw1, db0, db1, 10 strides, B, T, H, ndir,
#             reverse_mask, device, stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_longlong] * 10
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
    if H % 8 or H > MAX_HIDDEN:
        raise ValueError(f"gru kernel needs H divisible by 8 (cluster of 8 CTAs) and at "
                         f"most {MAX_HIDDEN} (w_hh held in registers); got H={H}")
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


# ---------------------------------------------------------------------------
# backward (K3)
# ---------------------------------------------------------------------------

def gru_recurrence_bwd_ref(gi: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                           w_hh: torch.Tensor, b_hh: torch.Tensor,
                           reverse: bool = False):
    """Plain version of the backward, JAX layout: gi (B, T, 3H), out (B, T, H)
    the forward's outputs, g (B, T, H) their cotangent, w_hh (H, 3H), b_hh
    (3H,) -> (dgi (B, T, 3H), dw_hh (H, 3H), db_hh (3H,)).

    Walks the forward's steps in reverse, recomputing the gates from
    (gi_t, h_prev) as `_gru_gate_grads` does; h_prev is out at the
    direction's previous step and 0 at its first."""
    B, T, threeH = gi.shape
    H = threeH // 3
    dgi = gi.new_empty(B, T, threeH)
    dw = gi.new_zeros(H, threeH)
    db = gi.new_zeros(threeH)
    dh = gi.new_zeros(B, H)
    for i in range(T - 1, -1, -1):  # forward step index, walked backwards
        t = T - 1 - i if reverse else i
        hp = out[:, t + 1 if reverse else t - 1] if i > 0 else gi.new_zeros(B, H)
        gh = hp @ w_hh + b_hh
        gi_t = gi[:, t]
        r = torch.sigmoid(gi_t[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi_t[:, H:2 * H] + gh[:, H:2 * H])
        gh_n = gh[:, 2 * H:]
        n = torch.tanh(gi_t[:, 2 * H:] + r * gh_n)
        a = g[:, t] + dh
        dz = a * (hp - n)
        dpre_n = a * (1.0 - z) * (1.0 - n * n)
        dpre_r = dpre_n * gh_n * r * (1.0 - r)
        dpre_z = dz * z * (1.0 - z)
        dgi[:, t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=1)
        dgh = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=1)
        dh = a * z + dgh @ w_hh.t()
        dw += hp.t() @ dgh
        db += dgh.sum(0)
    return dgi, dw, db


def _launch_bwd(gis, outs, gs, w_hhs, b_hhs, reverse_mask: int):
    """One launch for 1 or 2 directions. dw_hh comes back in w_hh's layout:
    a transposed torch-layout view (H, 3H) with strides (1, H) gets a
    gradient of the same strides, anything else a contiguous (H, 3H)."""
    global bwd_launches
    gi0, out0, g0, w0 = gis[0], outs[0], gs[0], w_hhs[0]
    B, T, threeH = gi0.shape
    H = threeH // 3
    dev = gi0.device
    if threeH != 3 * H or w0.shape != (H, threeH):
        raise ValueError(f"gru_bwd: gi {tuple(gi0.shape)} and w_hh {tuple(w0.shape)} "
                         "do not match (B, T, 3H) x (H, 3H)")
    if H % 8:
        raise ValueError("gru_bwd kernel needs H divisible by 8 (cluster of 8 CTAs)")
    if T < 1 or B < 1:
        raise ValueError("gru_bwd needs B >= 1 and T >= 1")
    for t in (*gis, *outs, *gs, *w_hhs, *b_hhs):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"gru_bwd: every input must be float32 on {dev}")
    for gi, o, g, w, b in zip(gis, outs, gs, w_hhs, b_hhs):
        if (gi.shape != gi0.shape or o.shape != (B, T, H) or g.shape != (B, T, H)
                or w.shape != w0.shape or b.shape != (threeH,)):
            raise ValueError("gru_bwd: shapes must be gi (B, T, 3H), out and g "
                             "(B, T, H), w_hh (H, 3H), b_hh (3H,), alike in "
                             "both directions")
        if (gi.stride() != gi0.stride() or o.stride() != out0.stride()
                or g.stride() != g0.stride() or w.stride() != w0.stride()):
            raise ValueError("gru_bwd: directions must have the same strides")
        if gi.stride(2) != 1 or o.stride(2) != 1 or g.stride(2) != 1:
            raise ValueError("gru_bwd: the last dim of gi, out and g must be contiguous")
        if not b.is_contiguous():
            raise ValueError("gru_bwd: b_hh must be contiguous")
    ndir = len(gis)
    dgi = torch.empty(ndir, B, T, threeH, device=dev, dtype=torch.float32)
    dgh = torch.empty(ndir, B, T, threeH, device=dev, dtype=torch.float32)
    if w0.stride() == (1, H):
        dw = torch.empty(ndir, threeH, H, device=dev, dtype=torch.float32).transpose(1, 2)
    else:
        dw = torch.empty(ndir, H, threeH, device=dev, dtype=torch.float32)
    db = torch.empty(ndir, threeH, device=dev, dtype=torch.float32)
    fn = build.function("gru_bwd", "avs_gru_bwd", _BWD_ARGTYPES)
    last = ndir - 1  # with one direction, the second pointer set repeats the first
    err = fn(gis[0].data_ptr(), gis[-1].data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(),
             gs[0].data_ptr(), gs[-1].data_ptr(), w_hhs[0].data_ptr(), w_hhs[-1].data_ptr(),
             b_hhs[0].data_ptr(), b_hhs[-1].data_ptr(), dgi[0].data_ptr(),
             dgi[last].data_ptr(), dgh[0].data_ptr(), dgh[last].data_ptr(),
             dw[0].data_ptr(), dw[last].data_ptr(), db[0].data_ptr(), db[last].data_ptr(),
             gi0.stride(0), gi0.stride(1), out0.stride(0), out0.stride(1),
             g0.stride(0), g0.stride(1), w0.stride(0), w0.stride(1),
             dw.stride(1), dw.stride(2),
             B, T, H, ndir, reverse_mask, dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("gru_bwd", err, "gru_bwd launch")
    bwd_launches += 1
    return dgi, dw, db


def gru_recurrence_bwd(gi: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                       w_hh: torch.Tensor, b_hh: torch.Tensor, reverse: bool = False):
    """One direction, JAX layout: (gi, out, g, w_hh, b_hh) -> (dgi, dw_hh,
    db_hh), as `pallas_gru_bwd`."""
    if not _on_cuda(gi):
        return gru_recurrence_bwd_ref(gi, out, g, w_hh, b_hh, reverse)
    dgi, dw, db = _launch_bwd((gi,), (out,), (g,), (w_hh,), (b_hh,), int(reverse))
    return dgi[0], dw[0], db[0]


def bigru_recurrence_bwd(gi_f: torch.Tensor, gi_b: torch.Tensor, out: torch.Tensor,
                         g: torch.Tensor, w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                         b_hh_f: torch.Tensor, b_hh_b: torch.Tensor):
    """Backward of `bigru_recurrence`, both directions in one launch. out and
    g are (B, T, 2H) = [forward | backward]. Returns (dgi_f, dgi_b, dw_hh_f,
    dw_hh_b, db_hh_f, db_hh_b), each dw_hh in its w_hh's layout."""
    H = w_hh_f.shape[0]
    outs = (out[..., :H], out[..., H:])
    gs = (g[..., :H], g[..., H:])
    if not _on_cuda(gi_f):
        f = gru_recurrence_bwd_ref(gi_f, outs[0], gs[0], w_hh_f, b_hh_f, False)
        b = gru_recurrence_bwd_ref(gi_b, outs[1], gs[1], w_hh_b, b_hh_b, True)
        return f[0], b[0], f[1], b[1], f[2], b[2]
    dgi, dw, db = _launch_bwd((gi_f, gi_b), outs, gs, (w_hh_f, w_hh_b),
                              (b_hh_f, b_hh_b), 0b10)
    return dgi[0], dgi[1], dw[0], dw[1], db[0], db[1]
