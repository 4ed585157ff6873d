"""Fused conv1 + ReLU + MaxPool3D(1,2,2) (Cin = 1): CUDA kernel and plain twin.

Port of `avsync/ops/pallas/convpool.py:conv1_pool_fused`; the kernel is
`avsync_torch/csrc/conv1_pool.cu`. A CPU tensor goes to the plain version
`conv1_pool_ref`; a CUDA tensor launches the kernel or raises. `launches`
counts kernel launches (the plain version does not count).

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

from avsync_torch.ops.cuda import build

# Kernel launches since the last reset (the caller resets it to 0).
launches = 0

# avs_conv1_pool(x, w, bias, out, B, T, H, W, kt, kh, kw, C, 4 x strides,
#                2 w strides, 5 out strides, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 11
             + [ctypes.c_int, ctypes.c_void_p])


def conv1_pool_ref(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain version, JAX layouts: max_pool(relu(conv3d(x, kernel) + bias)).

    The conv is the kernel's own arithmetic — a sum over the kt*kh*kw taps
    of shifted input frames times that tap's weights — not a library conv.
    """
    B, T, H, W, _ = x.shape
    kt, kh, kw, _, C = kernel.shape
    pt, ph, pw = (kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x[..., 0], (pw, pw, ph, ph, pt, pt))  # (B, T+2pt, H+2ph, W+2pw)
    acc = x.new_zeros(B, T, H, W, C)
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                win = xp[:, dt:dt + T, dh:dh + H, dw:dw + W, None]
                acc += win * kernel[dt, dh, dw, 0]
    acc += bias
    pooled = acc.reshape(B, T, H // 2, 2, W // 2, 2, C).amax(dim=(3, 5))
    return F.relu(pooled)


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
    fn = build.function("conv1_pool", "avs_conv1_pool", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
             B, T, H, W, kt, kh, kw, C, *x_strides, *w_strides, *o_strides,
             out.device.index, torch.cuda.current_stream(out.device).cuda_stream)
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


def conv1_pool_block(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """NCDHW: (B, 1, T, H, W) x (C, 1, kt, kh, kw) + (C,) -> (B, C, T, H/2, W/2)."""
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
