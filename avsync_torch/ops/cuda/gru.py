"""GRU recurrence over precomputed input projections, forward and backward:
CUDA kernels and their plain twins.

  * forward: port of `avsync/ops/pallas/gru.py:pallas_gru_scan`, kernel
    `avsync_torch/csrc/gru_fwd.cu` (K2), which runs the whole T-step
    recurrence in one launch with w_hh and h on chip; plain version
    `gru_recurrence_ref`; `launches` counts its launches;
  * backward: port of `pallas_gru_bwd`, kernel `avsync_torch/csrc/gru_bwd.cu`
    (K3): the gh recompute as one product, the reverse-time chain for dgi,
    then dW_hh/db_hh in deterministic chunked products and a fixed-order
    sum, all in one launch; plain version `gru_recurrence_bwd_ref`;
    `bwd_launches` counts its launches (each runs four CUDA kernels).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. The counters count kernel launches only (the plain versions do not
count).

The kernels split the hidden units over a cluster of 8 CTAs, so they take H
in multiples of 8; any other H is zero-padded to the next multiple of 8 in
the wrapper (`pad_gates`, `pad_w_hh`, `pad_units`) and the padding sliced off
the results. That is exact: a padded unit has zero weights, bias and input
projection, so r = z = 1/2, n = 0 and its h stays at h_0 = 0; its zero rows
of w_hh add nothing to the real units; in the backward its cotangent is 0,
so its dgh is 0. Above H = 256 (w_hh no longer fits in registers) each
kernel takes a generic instantiation with w_hh in shared memory or read
through L2; past what the card's shared memory holds the wrapper raises.

Weights use the JAX package's right-multiply layout: w_hh is (H, 3H) with
gate columns [r | z | n], so gh = h @ w_hh + b_hh. A torch GRU's
`weight_hh_l0` (3H, H) goes in as its transpose view `.t()` (no copy: the
kernel takes strides).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from avsync_torch.ops.cuda import build

# Kernel launches since the last reset (the caller resets them to 0).
launches = 0
bwd_launches = 0

# avs_gru_fwd(gi0, gi1, w0, w1, b0, b1, out, 7 strides, B, T, H, ndir,
#             reverse_mask, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 7
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
# avs_gru_bwd(gi0, gi1, out0, out1, g0, g1, w0, w1, b0, b1, dgi0, dgi1,
#             dw0, dw1, db0, db1, gh, dgh, partial, 10 strides, B, T, H, ndir,
#             reverse_mask, n_chunks, device, stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_longlong] * 10
                 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_max_hidden = {}  # kernel name -> the largest H its shared memory holds


def padded_hidden(H: int) -> int:
    """H rounded up to a multiple of 8, the kernels' cluster of 8 CTAs."""
    return -(-H // 8) * 8


def pad_gates(t: torch.Tensor, H: int, Hp: int) -> torch.Tensor:
    """(..., 3H) -> (..., 3Hp): each gate block of [r | z | n] zero-padded to Hp
    units (and back with Hp < H: the first H of each)."""
    lead = t.shape[:-1]
    g = t.reshape(*lead, 3, H)
    g = F.pad(g, (0, Hp - H)) if Hp >= H else g[..., :Hp]
    return g.reshape(*lead, 3 * Hp)


def pad_w_hh(w: torch.Tensor, H: int, Hp: int) -> torch.Tensor:
    """(H, 3H) -> (Hp, 3Hp): zero rows and zero gate columns for the padded
    units (and back with Hp < H)."""
    g = pad_gates(w, H, Hp)
    return F.pad(g, (0, 0, 0, Hp - H)) if Hp >= H else g[:Hp]


def pad_units(t: torch.Tensor, H: int, Hp: int) -> torch.Tensor:
    """(..., H) -> (..., Hp): zero hidden units (and back with Hp < H)."""
    return F.pad(t, (0, Hp - H)) if Hp >= H else t[..., :Hp]


def _check_fits(name: str, symbol: str, H: int) -> None:
    """Raise if H is past what kernel `name`'s shared memory holds."""
    if name not in _max_hidden:
        fn = build.function(name, symbol, [])
        _max_hidden[name] = fn()
    if H > _max_hidden[name]:
        raise ValueError(f"{name}: H={H} needs more shared memory than the card has "
                         f"(the kernel takes H up to {_max_hidden[name]})")


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
    Hp = padded_hidden(H)
    if Hp != H:
        out = _launch(tuple(pad_gates(g, H, Hp) for g in gis),
                      tuple(pad_w_hh(w, H, Hp) for w in w_hhs),
                      tuple(pad_gates(b, H, Hp) for b in b_hhs), reverse_mask)
        return torch.cat([out[..., d * Hp:d * Hp + H] for d in range(len(gis))], dim=-1)
    _check_fits("gru_fwd", "avs_gru_fwd_max_hidden", H)
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


def bwd_chunks(B: int, T: int) -> int:
    """Chunks of the B*T (row, step) pairs that K3's dW_hh product splits
    into, each summed by its own CTAs into a partial (about 128 pairs each,
    at most 16): a function of the shape alone, so dW_hh's bits do not
    depend on the card."""
    return max(1, min(16, B * T // 128))


def _launch_bwd(gis, out, g, w_hhs, b_hhs, reverse_mask: int):
    """One launch for 1 or 2 directions. out and g are (B, T, ndir * H):
    direction d's forward outputs and their cotangent are columns [d H,
    (d + 1) H) (read in place: no slice is made). dw_hh comes back in w_hh's
    layout: a transposed torch-layout view (H, 3H) with strides (1, H) gets
    a gradient of the same strides, anything else a contiguous (H, 3H)."""
    global bwd_launches
    gi0, w0 = gis[0], w_hhs[0]
    ndir = len(gis)
    B, T, threeH = gi0.shape
    H = threeH // 3
    dev = gi0.device
    if threeH != 3 * H or w0.shape != (H, threeH):
        raise ValueError(f"gru_bwd: gi {tuple(gi0.shape)} and w_hh {tuple(w0.shape)} "
                         "do not match (B, T, 3H) x (H, 3H)")
    if T < 1 or B < 1:
        raise ValueError("gru_bwd needs B >= 1 and T >= 1")
    Hp = padded_hidden(H)
    if Hp != H:
        def pad_dirs(t):
            return torch.cat([pad_units(t[..., d * H:(d + 1) * H], H, Hp)
                              for d in range(ndir)], dim=-1)

        dgi, dw, db = _launch_bwd(tuple(pad_gates(x, H, Hp) for x in gis), pad_dirs(out),
                                  pad_dirs(g), tuple(pad_w_hh(w, H, Hp) for w in w_hhs),
                                  tuple(pad_gates(b, H, Hp) for b in b_hhs), reverse_mask)
        # back to H units; dw_hh in w_hh's layout, as below
        dw = torch.stack([pad_w_hh(w, Hp, H) for w in dw])
        if w0.stride() == (1, H):
            dw = dw.transpose(1, 2).contiguous().transpose(1, 2)
        return pad_gates(dgi, Hp, H), dw, pad_gates(db, Hp, H)
    _check_fits("gru_bwd", "avs_gru_bwd_max_hidden", H)
    for t in (*gis, out, g, *w_hhs, *b_hhs):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"gru_bwd: every input must be float32 on {dev}")
    if out.shape != (B, T, ndir * H) or g.shape != out.shape:
        raise ValueError(f"gru_bwd: out and g must be (B, T, {ndir} x H) = "
                         f"{(B, T, ndir * H)}, got {tuple(out.shape)} and {tuple(g.shape)}")
    if gi0.stride(2) != 1 or out.stride(2) != 1 or g.stride(2) != 1:
        raise ValueError("gru_bwd: the last dim of gi, out and g must be contiguous")
    for gi, w, b in zip(gis, w_hhs, b_hhs):
        if gi.shape != gi0.shape or w.shape != w0.shape or b.shape != (threeH,):
            raise ValueError("gru_bwd: shapes must be gi (B, T, 3H), w_hh (H, 3H), "
                             "b_hh (3H,), alike in both directions")
        if gi.stride() != gi0.stride() or w.stride() != w0.stride():
            raise ValueError("gru_bwd: directions must have the same strides")
        if not b.is_contiguous():
            raise ValueError("gru_bwd: b_hh must be contiguous")
    # the outputs in one allocation: dgi (ndir, B, T, 3H), dw_hh, db_hh
    n_dgi, n_dw = ndir * B * T * threeH, ndir * H * threeH
    res = torch.empty(n_dgi + n_dw + ndir * threeH, device=dev, dtype=torch.float32)
    dgi = res[:n_dgi].view(ndir, B, T, threeH)
    if w0.stride() == (1, H):
        dw = res[n_dgi:n_dgi + n_dw].view(ndir, threeH, H).transpose(1, 2)
    else:
        dw = res[n_dgi:n_dgi + n_dw].view(ndir, H, threeH)
    db = res[n_dgi + n_dw:].view(ndir, threeH)
    # scratch: gh and dgh (ndir, B, T, 3H) each, then the dW_hh/db_hh partials
    # (ndir, n_chunks, H + 1, 3H); every part starts at a multiple of 16 bytes
    n_chunks = bwd_chunks(B, T)
    work = torch.empty(2 * n_dgi + ndir * n_chunks * (H + 1) * threeH, device=dev,
                       dtype=torch.float32)
    wp, rp, op, gp = work.data_ptr(), res.data_ptr(), out.data_ptr(), g.data_ptr()
    last = ndir - 1  # with one direction, the second pointer set repeats the first
    step = 4 * H * last  # bytes to the last direction's columns of out and g
    fn = build.function("gru_bwd", "avs_gru_bwd", _BWD_ARGTYPES)
    err = fn(gis[0].data_ptr(), gis[-1].data_ptr(), op, op + step, gp, gp + step,
             w_hhs[0].data_ptr(), w_hhs[-1].data_ptr(), b_hhs[0].data_ptr(),
             b_hhs[-1].data_ptr(), rp, rp + 4 * (n_dgi // ndir) * last, rp + 4 * n_dgi,
             rp + 4 * (n_dgi + H * threeH * last), rp + 4 * (n_dgi + n_dw),
             rp + 4 * (n_dgi + n_dw + threeH * last), wp, wp + 4 * n_dgi, wp + 8 * n_dgi,
             gi0.stride(0), gi0.stride(1), out.stride(0), out.stride(1),
             g.stride(0), g.stride(1), w0.stride(0), w0.stride(1),
             dw.stride(1), dw.stride(2),
             B, T, H, ndir, reverse_mask, n_chunks, dev.index,
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
    dgi, dw, db = _launch_bwd((gi,), out, g, (w_hh,), (b_hh,), int(reverse))
    return dgi[0], dw[0], db[0]


def bigru_recurrence_bwd(gi_f: torch.Tensor, gi_b: torch.Tensor, out: torch.Tensor,
                         g: torch.Tensor, w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                         b_hh_f: torch.Tensor, b_hh_b: torch.Tensor):
    """Backward of `bigru_recurrence`, both directions in one launch. out and
    g are (B, T, 2H) = [forward | backward]. Returns (dgi_f, dgi_b, dw_hh_f,
    dw_hh_b, db_hh_f, db_hh_b), each dw_hh in its w_hh's layout."""
    if not _on_cuda(gi_f):
        H = w_hh_f.shape[0]
        f = gru_recurrence_bwd_ref(gi_f, out[..., :H], g[..., :H], w_hh_f, b_hh_f, False)
        b = gru_recurrence_bwd_ref(gi_b, out[..., H:], g[..., H:], w_hh_b, b_hh_b, True)
        return f[0], b[0], f[1], b[1], f[2], b[2]
    dgi, dw, db = _launch_bwd((gi_f, gi_b), out, g, (w_hh_f, w_hh_b), (b_hh_f, b_hh_b), 0b10)
    return dgi[0], dgi[1], dw[0], dw[1], db[0], db[1]
