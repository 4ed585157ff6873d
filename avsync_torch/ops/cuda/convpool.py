"""Fused conv1 + ReLU + MaxPool3D(1,2,2) (Cin = 1), forward and weight
gradient: CUDA kernels and their plain twins.

  * forward: port of `avsync/ops/pallas/convpool.py:conv1_pool_fused`, kernel
    `avsync_torch/csrc/conv1_pool.cu` (K1; a CTA per tile and chunk of
    frames, as `fwd_grid` chooses), plain version `conv1_pool_ref`, launches
    counted in `launches`;
  * dW/db: port of `conv1_pool_bwd`, kernel `avsync_torch/csrc/
    conv1_pool_bwd.cu` (K4; per-CTA partials over the tile and frame chunks
    that `bwd_grid` chooses, then a fixed-order sum in a second kernel of the
    same launch), plain version `conv1_pool_bwd_ref`, launches counted in
    `bwd_launches`;
  * `Conv1Pool`, the autograd Function around both that the model's fused
    conv1 block calls (the JAX package's `custom_vjp`,
    `convpool.py:154-196`).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. The counters count kernel launches only.

The plain versions accumulate the taps with `addcmul_` in the kernels' order
(taps dt, dh, dw from zero, then the bias). On the card that is one fused
multiply-add per tap, as in the kernels (which share that loop,
`csrc/conv1_recompute.cuh`), so the pre-pool values, and with them the pool
routing of the backward, agree bit for bit.

Layouts: `conv1_pool_fused` takes and returns the JAX package's
(B, T, H, W, 1) x (kt, kh, kw, 1, C) -> (B, T, H/2, W/2, C), so tests compare
like with like; `conv1_pool_block` is the model's NCDHW form,
(B, 1, T, H, W) x (C, 1, kt, kh, kw) -> (B, C, T, H/2, W/2), which conv2's
`F.conv3d` reads without a transpose.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from avsync_torch.ops.conv import conv_relu_pool
from avsync_torch.ops.cuda import build

# Kernel launches since the last reset (the caller resets them to 0).
launches = 0
bwd_launches = 0

# avs_conv1_pool(x, w, bias, out, B, T, H, W, kt, kh, kw, C, n_chunks,
#                tile_rows, tile_cols, 4 x strides, 2 w strides, 5 out strides,
#                device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_longlong] * 11
             + [ctypes.c_int, ctypes.c_void_p])
# avs_conv1_pool_bwd(x, w, bias, g, partial, dw, db, B, T, H, W, kt, kh, kw,
#                    C, n_chunks, tile_rows, tile_cols, 4 x strides,
#                    2 w strides, 5 g strides, 2 dw strides, device, stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_longlong] * 13
                 + [ctypes.c_int, ctypes.c_void_p])
BWD_THREADS = 256  # threads per CTA of the backward kernel: positions per tile, at most
BWD_MAX_TILE_COLS = 64
# CTAs the backward grid aims at: two per SM of an H100 (132 SMs). A constant,
# so that the partials (and dW's bits) do not depend on the card.
BWD_TARGET_CTAS = 264
MAX_CHANNELS, MAX_TAPS = 32, 128  # what the backward kernel takes
MAX_SMEM = 232448  # shared memory one CTA can opt in to on sm_90


def bwd_grid(B: int, T: int, H2: int, W2: int):
    """(tile_rows, tile_cols, tiles, n_chunks) of K4's grid for a pooled
    (H2, W2) frame: full-width tiles of at most BWD_THREADS positions (5 x 50
    for LipNet's 25 x 50: no dead position), and enough chunks of the B*T
    frames to fill BWD_TARGET_CTAS CTAs."""
    cols = min(W2, BWD_MAX_TILE_COLS)
    rows = max(1, min(H2, BWD_THREADS // cols))
    tiles = -(-H2 // rows) * -(-W2 // cols)
    return rows, cols, tiles, max(1, min(B * T, BWD_TARGET_CTAS // tiles))


def fwd_grid(B: int, T: int, H2: int, W2: int, kt: int, kh: int, kw: int, C: int):
    """(tile_rows, tile_cols, tiles, n_chunks) of K1's grid: K4's tile
    (`bwd_grid`; 5 x 50 for LipNet's 25 x 50, no dead position) while the
    CTA's shared memory (the weights and two input halos of float2 pairs,
    `smem_bytes` in csrc/conv1_pool.cu) fits, else fewer rows, then fewer
    columns; enough chunks of the B*T frames to fill BWD_TARGET_CTAS CTAs."""
    rows, cols, _, _ = bwd_grid(B, T, H2, W2)
    cpad = -(-C // 16) * 16

    def smem(r, c):
        return 4 * (kt * kh * kw * cpad + cpad) + 16 * kt * (2 * r + kh - 1) * (2 * c + kw - 1)

    while smem(rows, cols) > MAX_SMEM and rows * cols > 1:
        if rows > 1:
            rows = -(-rows // 2)
        else:
            cols = -(-cols // 2)
    if smem(rows, cols) > MAX_SMEM:
        raise ValueError(f"conv1_pool: a {kt}x{kh}x{kw} kernel with {C} channels needs more "
                         "shared memory than the card has")
    tiles = -(-H2 // rows) * -(-W2 // cols)
    return rows, cols, tiles, max(1, min(B * T, BWD_TARGET_CTAS // tiles))


def _windows(x: torch.Tensor, kt: int, kh: int, kw: int):
    """(dt, dh, dw, window) over the taps of a SAME-padded (B, T, H, W, 1)
    input; window is the (B, T, H, W, 1) slice that tap multiplies."""
    B, T, H, W, _ = x.shape
    pt, ph, pw = (kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x[..., 0], (pw, pw, ph, ph, pt, pt))  # (B, T+2pt, H+2ph, W+2pw)
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                yield dt, dh, dw, xp[:, dt:dt + T, dh:dh + H, dw:dw + W, None]


def _pre_pool(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """conv3d(x, kernel) + bias, (B, T, H, W, C), summed tap by tap as the
    kernels do — the kernels' own arithmetic, not a library conv."""
    B, T, H, W, _ = x.shape
    kt, kh, kw, _, C = kernel.shape
    acc = x.new_zeros(B, T, H, W, C)
    for dt, dh, dw, win in _windows(x, kt, kh, kw):
        acc.addcmul_(win, kernel[dt, dh, dw, 0])
    return acc + bias


def conv1_pool_ref(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain version, JAX layouts: max_pool(relu(conv3d(x, kernel) + bias))."""
    B, T, H, W, _ = x.shape
    C = kernel.shape[-1]
    pooled = _pre_pool(x, kernel, bias).reshape(B, T, H // 2, 2, W // 2, 2, C).amax(dim=(3, 5))
    return F.relu(pooled)


def conv1_pool_bwd_ref(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       g: torch.Tensor, sum_dtype=None):
    """Plain version of the backward, JAX layouts: (dkernel (kt, kh, kw, 1, C),
    dbias (C,)) given the pooled cotangent g (B, T, H/2, W/2, C).

    Each pooled gradient goes to the FIRST window position, jh-major
    ((0,0), (0,1), (1,0), (1,1)), whose ReLU'd value equals the pooled max,
    and only where its pre-activation is > 0 (`_bwd_kernel`,
    `avsync/ops/pallas/convpool.py:217-231`): the first argmax of the
    pre-activations when their max is > 0, nothing otherwise.

    dkernel sums each frame's positions, then the frames: on an H100 one
    fp32 product over all of a B=128 batch's 48 M positions strayed past
    K4's atol of 1e-3, where the kernel stays within it of float64 sums.
    `sum_dtype` (float64) takes the sums in another type on the same fp32
    routing, to check the fp32 ones (chip_smoke.py does at B=128)."""
    B, T, H, W, _ = x.shape
    kt, kh, kw, _, C = kernel.shape
    H2, W2 = H // 2, W // 2
    pre = _pre_pool(x, kernel, bias).reshape(B, T, H2, 2, W2, 2, C)
    pre = pre.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, H2, W2, 4, C)
    top, first = pre.max(dim=4, keepdim=True)  # max returns the first maximal index
    dpre = torch.zeros_like(pre).scatter_(4, first, torch.where(top > 0, g[..., None, :], 0.0))
    dpre = dpre.reshape(B, T, H2, W2, 2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    dpre = dpre.reshape(B, T, H, W, C).to(sum_dtype or dpre.dtype)
    dkernel = dpre.new_empty(kernel.shape)
    for dt, dh, dw, win in _windows(x, kt, kh, kw):
        dkernel[dt, dh, dw, 0] = torch.einsum("bthw,bthwc->btc", win[..., 0].to(dpre.dtype),
                                              dpre).sum(dim=(0, 1))
    return dkernel, dpre.sum(dim=(0, 1, 2, 3))


def _check_geometry(kt, kh, kw, H, W, C):
    if not (kt % 2 and kh % 2 and kw % 2):
        raise ValueError("conv1_pool needs odd kernel sizes (symmetric SAME padding)")
    if H % 2 or W % 2:
        raise ValueError("conv1_pool needs even H and W")
    if C < 1:
        raise ValueError("conv1_pool needs at least one output channel")


def _launch(x, x_strides, w, w_strides, bias, out, o_strides, B, T, H, W,
            kt, kh, kw, C):
    global launches
    for name, t in (("x", x), ("kernel", w), ("bias", bias), ("out", out)):
        if t.device != out.device or t.dtype != torch.float32:
            raise ValueError(f"conv1_pool: {name} must be float32 on {out.device}")
    if not bias.is_contiguous():
        raise ValueError("conv1_pool: bias must be contiguous")
    rows, cols, _, n_chunks = fwd_grid(B, T, H // 2, W // 2, kt, kh, kw, C)
    fn = build.function("conv1_pool", "avs_conv1_pool", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
             B, T, H, W, kt, kh, kw, C, n_chunks, rows, cols, *x_strides, *w_strides,
             *o_strides, out.device.index, torch.cuda.current_stream(out.device).cuda_stream)
    build.check("conv1_pool", err, "conv1_pool launch")
    launches += 1
    return out


def conv1_pool_fused(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 1) x (kt, kh, kw, 1, C) + (C,) -> (B, T, H/2, W/2, C)."""
    B, T, H, W, cin = x.shape
    kt, kh, kw, kcin, C = kernel.shape
    if cin != 1 or kcin != 1:
        raise ValueError("conv1_pool is specialised to one input channel")
    _check_geometry(kt, kh, kw, H, W, C)
    if x.device.type == "cpu":
        return conv1_pool_ref(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv1_pool: unsupported device {x.device}")
    if not kernel.is_contiguous():
        raise ValueError("conv1_pool: kernel must be contiguous")
    out = torch.empty(B, T, H // 2, W // 2, C, device=x.device, dtype=torch.float32)
    return _launch(x, x.stride()[:4], kernel, (C, 1), bias, out,
                   (out.stride(0), out.stride(1), out.stride(2), out.stride(3),
                    out.stride(4)), B, T, H, W, kt, kh, kw, C)


def _block_forward(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """NCDHW forward, no autograd: K1 on the card, the plain version on the CPU."""
    B, cin, T, H, W = x.shape
    C, kcin, kt, kh, kw = weight.shape
    if cin != 1 or kcin != 1:
        raise ValueError("conv1_pool is specialised to one input channel")
    _check_geometry(kt, kh, kw, H, W, C)
    if x.device.type == "cpu":
        y = conv1_pool_ref(x.permute(0, 2, 3, 4, 1), weight.permute(2, 3, 4, 1, 0), bias)
        return y.permute(0, 4, 1, 2, 3).contiguous()
    if x.device.type != "cuda":
        raise ValueError(f"conv1_pool: unsupported device {x.device}")
    if not weight.is_contiguous():
        raise ValueError("conv1_pool: weight must be contiguous")
    out = torch.empty(B, C, T, H // 2, W // 2, device=x.device, dtype=torch.float32)
    return _launch(x, (x.stride(0), x.stride(2), x.stride(3), x.stride(4)),
                   weight, (1, kt * kh * kw), bias, out,
                   (out.stride(0), out.stride(2), out.stride(3), out.stride(4),
                    out.stride(1)), B, T, H, W, kt, kh, kw, C)


# ---------------------------------------------------------------------------
# weight gradient (K4)
# ---------------------------------------------------------------------------

def _launch_bwd(x, x_strides, w, w_strides, bias, g, g_strides, dw, dw_strides, db,
                B, T, H, W, kt, kh, kw, C):
    global bwd_launches
    dev = x.device
    for name, t in (("x", x), ("kernel", w), ("bias", bias), ("g", g), ("dkernel", dw),
                    ("dbias", db)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"conv1_pool_bwd: {name} must be float32 on {dev}")
    if not (bias.is_contiguous() and db.is_contiguous()):
        raise ValueError("conv1_pool_bwd: bias must be contiguous")
    taps = kt * kh * kw
    if C > MAX_CHANNELS or taps > MAX_TAPS:
        raise ValueError(f"conv1_pool_bwd kernel takes at most {MAX_CHANNELS} channels "
                         f"and {MAX_TAPS} taps (got C={C}, {taps} taps)")
    rows, cols, tiles, n_chunks = bwd_grid(B, T, H // 2, W // 2)
    partial = torch.empty(tiles * n_chunks, taps * C + C, device=dev, dtype=torch.float32)
    fn = build.function("conv1_pool_bwd", "avs_conv1_pool_bwd", _BWD_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), g.data_ptr(), partial.data_ptr(),
             dw.data_ptr(), db.data_ptr(), B, T, H, W, kt, kh, kw, C, n_chunks, rows, cols,
             *x_strides, *w_strides, *g_strides, *dw_strides,
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check("conv1_pool_bwd", err, "conv1_pool_bwd launch")
    bwd_launches += 1
    return dw, db


def conv1_pool_bwd(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   g: torch.Tensor):
    """JAX layouts, as `avsync.ops.pallas.convpool.conv1_pool_bwd`: x (B, T,
    H, W, 1), kernel (kt, kh, kw, 1, C), bias (C,), pooled cotangent g (B, T,
    H/2, W/2, C) -> (dkernel (kt, kh, kw, 1, C), dbias (C,))."""
    B, T, H, W, cin = x.shape
    kt, kh, kw, kcin, C = kernel.shape
    if cin != 1 or kcin != 1:
        raise ValueError("conv1_pool is specialised to one input channel")
    _check_geometry(kt, kh, kw, H, W, C)
    if g.shape != (B, T, H // 2, W // 2, C):
        raise ValueError(f"conv1_pool_bwd: g {tuple(g.shape)} is not the pooled shape")
    if x.device.type == "cpu":
        return conv1_pool_bwd_ref(x, kernel, bias, g)
    if x.device.type != "cuda":
        raise ValueError(f"conv1_pool_bwd: unsupported device {x.device}")
    if not kernel.is_contiguous():
        raise ValueError("conv1_pool_bwd: kernel must be contiguous")
    dk = torch.empty_like(kernel)
    db = torch.empty(C, device=x.device, dtype=torch.float32)
    return _launch_bwd(x, x.stride()[:4], kernel, (C, 1), bias, g, g.stride(), dk, (C, 1),
                       db, B, T, H, W, kt, kh, kw, C)


def conv1_pool_block_bwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         g: torch.Tensor):
    """NCDHW form of `conv1_pool_bwd`: x (B, 1, T, H, W), weight (C, 1, kt,
    kh, kw), g (B, C, T, H/2, W/2) -> (dweight in weight's layout, dbias)."""
    B, cin, T, H, W = x.shape
    C, kcin, kt, kh, kw = weight.shape
    if cin != 1 or kcin != 1:
        raise ValueError("conv1_pool is specialised to one input channel")
    _check_geometry(kt, kh, kw, H, W, C)
    if g.shape != (B, C, T, H // 2, W // 2):
        raise ValueError(f"conv1_pool_bwd: g {tuple(g.shape)} is not the pooled shape")
    if x.device.type == "cpu":
        dk, db = conv1_pool_bwd_ref(x.permute(0, 2, 3, 4, 1), weight.permute(2, 3, 4, 1, 0),
                                    bias, g.permute(0, 2, 3, 4, 1))
        return dk.permute(4, 3, 0, 1, 2).contiguous(), db
    if x.device.type != "cuda":
        raise ValueError(f"conv1_pool_bwd: unsupported device {x.device}")
    if not weight.is_contiguous():
        raise ValueError("conv1_pool_bwd: weight must be contiguous")
    taps = kt * kh * kw
    dw = torch.empty_like(weight)
    db = torch.empty(C, device=x.device, dtype=torch.float32)
    gs = g.stride()
    return _launch_bwd(x, (x.stride(0), x.stride(2), x.stride(3), x.stride(4)),
                       weight, (1, taps), bias, g, (gs[0], gs[2], gs[3], gs[4], gs[1]),
                       dw, (1, taps), db, B, T, H, W, kt, kh, kw, C)


class Conv1Pool(torch.autograd.Function):
    """The model's fused conv1 block, NCDHW: forward K1, dW/db by K4 (their
    plain versions on the CPU). dx, needed only when conv1 is not the input
    layer, comes from autograd of the plain composition (cuDNN conv, ReLU,
    pool), as the JAX package takes it from XLA's VJP."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _block_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        dw, db = conv1_pool_block_bwd(x, weight, bias, g)
        dx = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                xr = x.detach().requires_grad_()
                y = conv_relu_pool(xr, weight.detach(), bias.detach())
                (dx,) = torch.autograd.grad(y, xr, g)
        return dx, dw, db


def conv1_pool_block(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """NCDHW: (B, 1, T, H, W) x (C, 1, kt, kh, kw) + (C,) -> (B, C, T, H/2, W/2),
    differentiable (`Conv1Pool`)."""
    return Conv1Pool.apply(x, weight, bias)
