"""Fused conv1 + ReLU + MaxPool3D(1,2,2) (Cin = 1), forward and weight
gradient: CUDA kernels and their plain twins.

  * forward: port of `avsync/ops/pallas/convpool.py:conv1_pool_fused`, kernel
    `avsync_torch/csrc/conv1_pool.cu` (K1; a CTA per tile and chunk of
    frames, as `fwd_grid` chooses), plain version `conv1_pool_ref`, launches
    counted in `launches`;
  * dW/db: port of `conv1_pool_bwd`, kernel `avsync_torch/csrc/
    conv1_pool_bwd.cu` (K4; per-CTA partials over the tiles, frame chunks
    and groups of 32 channels that `bwd_grid` chooses, then a fixed-order
    sum in a second kernel of the same launch), plain version
    `conv1_pool_bwd_ref`, launches counted in `bwd_launches`;
  * `Conv1Pool`, the autograd Function around both that the model's fused
    conv1 block calls (the JAX package's `custom_vjp`,
    `convpool.py:154-196`). Its forward is the operator
    `avsync_torch::conv1_pool` (`conv1_pool_op`), so that `torch.export`
    traces the block as one node and an exported program launches K1.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises (for the operator, the dispatcher chooses by the tensor's device).
The counters count kernel launches only. `fused_takes` says which blocks the
kernels take (the model's gate): one input channel, an odd kernel of at most
MAX_TAPS taps, even H and W; in float32 any channel count whose K1 CTA fits
the card's shared memory (the TF stack's 128 and more), in bf16 at most
CHANNEL_GROUP (32) channels.

The plain versions accumulate the taps with `addcmul_` in the kernels' order
(taps dt, dh, dw from zero, then the bias). On the card that is one fused
multiply-add per tap, as in the kernels (which share that loop,
`csrc/conv1_recompute.cuh`), so the pre-pool values, and with them the pool
routing of the backward, agree bit for bit.

bf16: x, the weights and the pooled output bf16, the bias float32, as the
JAX package's `conv1_pool_fused(..., out_dtype=bf16)` under
compute_dtype="bfloat16". The bf16 entries (`avs_conv1_pool_bf16`,
`avs_conv1_pool_bwd_bf16`) run their own kernels on the bf16 tensor cores
(`csrc/conv1_mma.cuh`): an implicit GEMM whose K order is the taps (dt, dh,
dw) with each kernel row padded to even (`k_order`; the kernels pack the
weights so, as `pack_weights` does), on a grid of tiles x runs of frames
(`mma_grid`). bf16 products are exact in float32, so only the order of the
float32 sums differs from the plain versions': the pre-pool values agree to
float32 rounding, and bit for bit where the sums are exact. K1 rounds its
pooled value once. K4's dW is a dense product of the routed pre-pool
gradient (bf16-exact) with the patches, folded back to (tap, c) (`fold_dw`);
it returns float32 sums, and `Conv1Pool.backward` rounds dW to bf16 once
(the JAX package's `dwmat.astype(bf16)`) and hands the float32 parameter
that value. A bf16 tensor on the card launches the bf16 kernel or raises:
nothing upcasts to the float kernel.

Layouts: `conv1_pool_fused` takes and returns the JAX package's
(B, T, H, W, 1) x (kt, kh, kw, 1, C) -> (B, T, H/2, W/2, C), so tests compare
like with like; `conv1_pool_block` is the model's NCDHW form,
(B, 1, T, H, W) x (C, 1, kt, kh, kw) -> (B, C, T, H/2, W/2), which conv2's
`F.conv3d` reads without a transpose.
"""

from __future__ import annotations

import ctypes
import functools

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
# K4's channels per CTA (a lane each in its dW phase; more channels take more
# groups), and all the channels K4-bf16 takes; the taps either kernel takes
CHANNEL_GROUP, MAX_TAPS = 32, 128
MAX_SMEM = 232448  # shared memory one CTA can opt in to on sm_90


def frame_tile(H2: int, W2: int, max_pos: int):
    """(rows, cols) of a tile of at most max_pos pooled positions and 64
    columns, a row's width split into 1-4 equal parts, with the fewest dead
    positions (then the fewest tiles): LipNet's 25 x 50 takes 5 x 50 for
    256 (none dead) and 5 x 25 for 128; the TF stack's 23 x 70 takes 7 x 35
    for 256 (8 tiles, 18% dead)."""
    best = None
    k0 = -(-W2 // BWD_MAX_TILE_COLS)
    for k in range(k0, k0 + 4):
        cols = -(-W2 // k)
        rows = max(1, min(H2, max_pos // cols))
        tiles = -(-H2 // rows) * -(-W2 // cols)
        key = (tiles * rows * cols - H2 * W2, tiles)
        if best is None or key < best[0]:
            best = (key, rows, cols)
    return best[1], best[2]


def bwd_grid(B: int, T: int, H2: int, W2: int, C: int):
    """(tile_rows, tile_cols, tiles, n_chunks, groups) of K4's float grid
    for a pooled (H2, W2) frame and C channels: `frame_tile`'s tile of at
    most BWD_THREADS positions (5 x 50 at LipNet's 25 x 50, 7 x 35 at the TF
    stack's 23 x 70), ceil(C / CHANNEL_GROUP) channel groups, and enough
    chunks of the B*T frames to fill BWD_TARGET_CTAS CTAs over the tiles and
    groups. C <= 32 is one group: LipNet's grid is the one-group grid."""
    rows, cols = frame_tile(H2, W2, BWD_THREADS)
    tiles = -(-H2 // rows) * -(-W2 // cols)
    groups = -(-C // CHANNEL_GROUP)
    return rows, cols, tiles, max(1, min(B * T, BWD_TARGET_CTAS // (tiles * groups))), groups


def _fwd_tile(H2: int, W2: int, kt: int, kh: int, kw: int, C: int):
    """(rows, cols) of K1's tile: `frame_tile`'s while the CTA's shared
    memory (the weights and two input halos of float2 pairs, `smem_bytes` in
    csrc/conv1_pool.cu) fits, else fewer rows, then fewer columns; None
    where no tile fits."""
    rows, cols = frame_tile(H2, W2, BWD_THREADS)
    cpad = -(-C // 16) * 16

    def smem(r, c):
        return 4 * (kt * kh * kw * cpad + cpad) + 16 * kt * (2 * r + kh - 1) * (2 * c + kw - 1)

    while smem(rows, cols) > MAX_SMEM and rows * cols > 1:
        if rows > 1:
            rows = -(-rows // 2)
        else:
            cols = -(-cols // 2)
    return (rows, cols) if smem(rows, cols) <= MAX_SMEM else None


def fwd_grid(B: int, T: int, H2: int, W2: int, kt: int, kh: int, kw: int, C: int):
    """(tile_rows, tile_cols, tiles, n_chunks) of K1's grid: `_fwd_tile`'s
    tile (K4's, 5 x 50 at LipNet's 25 x 50 and 7 x 35 at the TF stack's 23 x
    70, where it fits) and enough chunks of the B*T frames to fill
    BWD_TARGET_CTAS CTAs."""
    tile = _fwd_tile(H2, W2, kt, kh, kw, C)
    if tile is None:
        raise ValueError(f"conv1_pool: a {kt}x{kh}x{kw} kernel with {C} channels needs more "
                         "shared memory than the card has")
    rows, cols = tile
    tiles = -(-H2 // rows) * -(-W2 // cols)
    return rows, cols, tiles, max(1, min(B * T, BWD_TARGET_CTAS // tiles))


def fused_takes(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether the fused kernels (K1 and K4, or K1-bf16 and K4-bf16) take
    the NCDHW block x (B, 1, T, H, W) * weight (C, 1, kt, kh, kw) in x's
    dtype, on the card as on the CPU (the plain versions follow the
    kernels): one input channel, an odd kernel of at most MAX_TAPS taps,
    even H and W; float32 any C whose K1 CTA fits (K4's holds one group of
    channels whatever C), bf16 at most CHANNEL_GROUP channels. The model's
    conv blocks ask it at each forward; the answer is cached per shape and
    dtype."""
    return _takes(x.shape[1], x.shape[3], x.shape[4], tuple(weight.shape), x.dtype)


@functools.lru_cache(maxsize=None)
def _takes(cin: int, H: int, W: int, w_shape: tuple, dtype: torch.dtype) -> bool:
    C, kcin, kt, kh, kw = w_shape
    if (cin != 1 or kcin != 1 or H % 2 or W % 2 or not (kt % 2 and kh % 2 and kw % 2)
            or kt * kh * kw > MAX_TAPS):
        return False
    if dtype == torch.bfloat16:
        return C <= CHANNEL_GROUP
    return dtype == torch.float32 and _fwd_tile(H // 2, W // 2, kt, kh, kw, C) is not None


# The bf16 kernels' CTAs resident at once: two per SM of an H100 (132 SMs).
# A constant, so that the grid, and with it K4-bf16's partials, do not
# depend on the card. K4-bf16's tile holds at most 128 pooled positions, K1's
# 256 (BWD_THREADS).
MMA_SLOTS, MMA_BWD_MAX_POS = 2 * 132, 128


def mma_geometry(kt: int, kh: int, kw: int, C: int, TR: int, TC: int) -> dict:
    """The bf16 kernels' decomposition for a TR x TC tile of pooled
    positions (`mma_geo` in csrc/conv1_mma.cuh computes the same): the K
    order's length K (kt * kh * (kw + 1)) and Kpad (to 16), the channel
    paddings, the halo's rows IH and words per row RW, copy O's offset OP in
    a frame slot and the slot's words."""
    kwp = kw + 1
    K = kt * kh * kwp
    Kpad = -(-K // 16) * 16
    LE = -(-(2 * TC + kw + 4) // 4) * 4
    RW = LE // 2
    while not 10 <= RW % 32 <= 24:
        RW += 2
    IH = 2 * TR + kh - 1
    OP = IH * RW + (28 - IH * RW) % 32  # copy O's first word in a slot
    return dict(kwp=kwp, K=K, Kpad=Kpad, npad=-(-C // 32) * 32, mpad=-(-C // 16) * 16,
                wrow=Kpad // 2 + 4, P=TR * TC, mgroups=-(-(TR * TC) // 16), IH=IH,
                LE=LE, RWu=LE // 2, RW=RW, OP=OP, slot_words=OP + IH * RW, R=kt + 1)


def mma_smem_bytes(kt: int, kh: int, kw: int, C: int, TR: int, TC: int, bwd: bool) -> int:
    """Shared memory of one CTA of K1-bf16 (`mma_fwd_words` in
    csrc/conv1_pool.cu) or K4-bf16 (`mma_bwd_words`, conv1_pool_bwd.cu)."""
    g = mma_geometry(kt, kh, kw, C, TR, TC)
    words = (g["npad"] * g["wrow"] + g["npad"] + g["R"] * (g["Kpad"] // 2)
             + g["R"] * g["slot_words"])
    if not bwd:
        return 4 * (words + g["mgroups"] * 16 * (g["npad"] + 2) // 2)
    ntw = 3 if g["Kpad"] == 96 else 8  # `bwd_ntw`: tap tiles per warp
    return 4 * (words + g["R"] * g["Kpad"]
                + g["mgroups"] * 16 * (g["mpad"] + 2) // 2 + g["mgroups"] * 32 * (g["mpad"] + 8)
                + (8 * ntw + 8) * 256)


@functools.lru_cache(maxsize=None)
def mma_grid(B: int, T: int, H2: int, W2: int, kt: int, kh: int, kw: int, C: int,
             bwd: bool = False):
    """(tile_rows, tile_cols, tiles, runs) of K1-bf16's or (bwd) K4-bf16's
    grid: B x tiles x runs CTAs, each a tile of pooled positions (`frame_tile`:
    at most 256 for K1, 128 for K4; fewer rows, then fewer columns, while
    its shared memory does not fit) over a run of ceil(T / runs) frames. The
    runs minimise the waves of CTAs over the resident slots times the frames
    a CTA stages (its run, half its kt - 1 halo frames and one for its
    set-up); ties take fewer runs."""
    rows, cols = frame_tile(H2, W2, MMA_BWD_MAX_POS if bwd else BWD_THREADS)
    while mma_smem_bytes(kt, kh, kw, C, rows, cols, bwd) > MAX_SMEM and rows * cols > 1:
        if rows > 1:
            rows = -(-rows // 2)
        else:
            cols = -(-cols // 2)
    if mma_smem_bytes(kt, kh, kw, C, rows, cols, bwd) > MAX_SMEM:
        raise ValueError(f"conv1_pool: a {kt}x{kh}x{kw} kernel with {C} channels needs more "
                         "shared memory than the card has")
    tiles = -(-H2 // rows) * -(-W2 // cols)
    best = None
    for runs in range(1, T + 1):
        frames = -(-T // runs)
        if -(-T // frames) != runs:
            continue
        cost = -(-(B * tiles * runs) // MMA_SLOTS) * (frames + (kt - 1) / 2 + 1)
        if best is None or cost < best[0]:
            best = (cost, runs)
    return rows, cols, tiles, best[1]


def k_order(kt: int, kh: int, kw: int) -> list:
    """The bf16 kernels' K order: entry k is the tap (dt * kh + dh) * kw + dw
    that column k of the packed weights holds, or -1 (zero weight: the pad
    tap dw == kw of each kernel row, and past K). Each kernel row has kw + 1
    entries, so the taps (dw, dw + 1) of a row share one 32-bit A register."""
    kwp = kw + 1
    K = kt * kh * kwp
    order = [-1] * (-(-K // 16) * 16)
    for k in range(K):
        row, dw = divmod(k, kwp)
        if dw < kw:
            order[k] = row * kw + dw
    return order


def pack_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(kt, kh, kw, 1, C) weights -> the (npad, Kpad) B matrix the bf16
    kernels build in shared memory: row c, column k = the weight of tap
    k_order[k] and channel c, zero at the pad taps and past C."""
    kt, kh, kw, _, C = kernel.shape
    order = torch.tensor(k_order(kt, kh, kw))
    flat = kernel.reshape(kt * kh * kw, C)
    packed = kernel.new_zeros(-(-C // 32) * 32, len(order))
    real = order >= 0
    packed[:C, real] = flat[order[real]].t()
    return packed


def fold_dw(dwk: torch.Tensor, kt: int, kh: int, kw: int, C: int) -> torch.Tensor:
    """K4-bf16's dW in the K order, (>= C, Kpad) -> (kt, kh, kw, 1, C): the
    fold its CTAs apply before they write their partial rows."""
    order = torch.tensor(k_order(kt, kh, kw))
    taps = kt * kh * kw
    cols = torch.empty(taps, dtype=torch.long)
    cols[order[order >= 0]] = torch.nonzero(order >= 0)[:, 0]
    return dwk[:C, cols].t().reshape(kt, kh, kw, 1, C)


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


def _pre_pool(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """conv3d(x, kernel) + bias in float32 (or `dtype`), (B, T, H, W, C),
    summed tap by tap as the float kernels do — the kernels' own arithmetic,
    not a library conv. bf16 x and kernel are widened first (exact)."""
    x, kernel = x.to(dtype), kernel.to(dtype)
    B, T, H, W, _ = x.shape
    kt, kh, kw, _, C = kernel.shape
    acc = x.new_zeros(B, T, H, W, C)
    for dt, dh, dw, win in _windows(x, kt, kh, kw):
        acc.addcmul_(win, kernel[dt, dh, dw, 0])
    return acc + bias.to(dtype)


def near_ties(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              eps: float = 2.0 ** -12, chunk: int = 16) -> torch.Tensor:
    """(B, T, H/2, W/2, C) bool, JAX layouts: the pooled windows whose
    routing another order of the float32 sums can change, from float64
    pre-activations: the two largest of the four within eps of each other,
    or the largest within eps of 0 (the ReLU). K4-bf16 sums in the tensor
    cores' order, its plain version tap by tap; the checks on the card zero
    the cotangent of these windows (eps = 2^-12 exceeds the f32 reorder
    error of LipNet's 75-term sums, at most 75 * 2^-24 * sum |terms|)."""
    B, T, H, W, _ = x.shape
    C = kernel.shape[-1]
    out = []
    for i in range(0, B, chunk):
        pre = _pre_pool(x[i:i + chunk], kernel, bias, torch.float64)
        b = pre.shape[0]
        win = pre.reshape(b, T, H // 2, 2, W // 2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
        top = win.reshape(b, T, H // 2, W // 2, 4, C).topk(2, dim=4).values
        out.append((top[..., 0, :] - top[..., 1, :] < eps) | (top[..., 0, :].abs() < eps))
        del pre, win, top
    return torch.cat(out)


def conv1_pool_ref(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain version, JAX layouts: max_pool(relu(conv3d(x, kernel) + bias)),
    summed in float32 and returned in x's dtype (bf16: rounded once)."""
    B, T, H, W, _ = x.shape
    C = kernel.shape[-1]
    pooled = _pre_pool(x, kernel, bias).reshape(B, T, H // 2, 2, W // 2, 2, C).amax(dim=(3, 5))
    return F.relu(pooled).to(x.dtype)


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
    routing, to check the fp32 ones (chip_smoke.py does at B=128).
    bf16 x, kernel and g are widened first; dkernel and dbias are float32
    sums either way (K4's contract: the caller rounds dkernel)."""
    B, T, H, W, _ = x.shape
    kt, kh, kw, _, C = kernel.shape
    H2, W2 = H // 2, W // 2
    pre = _pre_pool(x, kernel, bias).reshape(B, T, H2, 2, W2, 2, C)
    pre = pre.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, H2, W2, 4, C)
    top, first = pre.max(dim=4, keepdim=True)  # max returns the first maximal index
    g = g.float()
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


_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}  # the C entry point per dtype


def _check_dtypes(what: str, dev, same, floats) -> str:
    """The entry point's suffix for the element dtype of the `same` tensors
    (float32 or bf16, all alike); the `floats` are float32. Raises otherwise."""
    dt = same[0][1].dtype
    if dt not in _SUFFIX:
        raise ValueError(f"{what}: {same[0][0]} must be float32 or bfloat16, not {dt}")
    for name, t in same:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt} on {dev}")
    for name, t in floats:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 on {dev}")
    return _SUFFIX[dt]


def _launch(x, x_strides, w, w_strides, bias, out, o_strides, B, T, H, W,
            kt, kh, kw, C):
    global launches
    suffix = _check_dtypes("conv1_pool", out.device, (("x", x), ("kernel", w), ("out", out)),
                           (("bias", bias),))
    if not bias.is_contiguous():
        raise ValueError("conv1_pool: bias must be contiguous")
    if suffix:  # bf16: n_chunks is the runs of frames per clip
        rows, cols, _, n_chunks = mma_grid(B, T, H // 2, W // 2, kt, kh, kw, C)
    else:
        rows, cols, _, n_chunks = fwd_grid(B, T, H // 2, W // 2, kt, kh, kw, C)
    fn = build.function("conv1_pool", "avs_conv1_pool" + suffix, _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
             B, T, H, W, kt, kh, kw, C, n_chunks, rows, cols, *x_strides, *w_strides,
             *o_strides, out.device.index, torch.cuda.current_stream(out.device).cuda_stream)
    build.check("conv1_pool", err, "conv1_pool launch")
    launches += 1
    return out


def conv1_pool_fused(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 1) x (kt, kh, kw, 1, C) + (C,) -> (B, T, H/2, W/2, C) in
    x's dtype (float32, or bf16 with a bf16 kernel and a float32 bias)."""
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
    out = torch.empty(B, T, H // 2, W // 2, C, device=x.device, dtype=x.dtype)
    return _launch(x, x.stride()[:4], kernel, (C, 1), bias, out,
                   (out.stride(0), out.stride(1), out.stride(2), out.stride(3),
                    out.stride(4)), B, T, H, W, kt, kh, kw, C)


def _conv1_pool_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The NCDHW forward on the card: one K1 launch."""
    B, _, T, H, W = x.shape
    C, _, kt, kh, kw = weight.shape
    if not weight.is_contiguous():
        raise ValueError("conv1_pool: weight must be contiguous")
    out = torch.empty(B, C, T, H // 2, W // 2, device=x.device, dtype=x.dtype)
    return _launch(x, (x.stride(0), x.stride(2), x.stride(3), x.stride(4)),
                   weight, (1, kt * kh * kw), bias, out,
                   (out.stride(0), out.stride(2), out.stride(3), out.stride(4),
                    out.stride(1)), B, T, H, W, kt, kh, kw, C)


# The NCDHW forward as an operator, so that `torch.export` traces it as one
# node and an exported program calls it: K1 for CUDA tensors, the plain
# version for CPU ones; the output has x's dtype.
conv1_pool_op = torch.library.custom_op("avsync_torch::conv1_pool", _conv1_pool_cuda,
                                        mutates_args=(), device_types="cuda")


@conv1_pool_op.register_kernel("cpu")
def _conv1_pool_cpu(x, weight, bias):
    y = conv1_pool_ref(x.permute(0, 2, 3, 4, 1), weight.permute(2, 3, 4, 1, 0), bias)
    return y.permute(0, 4, 1, 2, 3).contiguous()


@conv1_pool_op.register_fake
def _conv1_pool_fake(x, weight, bias):
    B, _, T, H, W = x.shape
    return x.new_empty(B, weight.shape[0], T, H // 2, W // 2)


def _block_forward(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """NCDHW forward, no autograd, through `conv1_pool_op`: K1 on the card,
    the plain version on the CPU."""
    _, cin, _, H, W = x.shape
    C, kcin, kt, kh, kw = weight.shape
    if cin != 1 or kcin != 1:
        raise ValueError("conv1_pool is specialised to one input channel")
    _check_geometry(kt, kh, kw, H, W, C)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv1_pool: unsupported device {x.device}")
    return conv1_pool_op(x, weight, bias)


# ---------------------------------------------------------------------------
# weight gradient (K4)
# ---------------------------------------------------------------------------

def _launch_bwd(x, x_strides, w, w_strides, bias, g, g_strides, dw, dw_strides, db,
                B, T, H, W, kt, kh, kw, C):
    global bwd_launches
    dev = x.device
    suffix = _check_dtypes("conv1_pool_bwd", dev, (("x", x), ("kernel", w), ("g", g)),
                           (("bias", bias), ("dkernel", dw), ("dbias", db)))
    if not (bias.is_contiguous() and db.is_contiguous()):
        raise ValueError("conv1_pool_bwd: bias must be contiguous")
    taps = kt * kh * kw
    if taps > MAX_TAPS or (suffix and C > CHANNEL_GROUP):
        raise ValueError(f"conv1_pool_bwd kernel takes at most {MAX_TAPS} taps, and in bf16 "
                         f"{CHANNEL_GROUP} channels (got C={C}, {taps} taps)")
    if suffix:  # bf16: a partial row per CTA, B x tiles x runs of frames
        rows, cols, tiles, n_chunks = mma_grid(B, T, H // 2, W // 2, kt, kh, kw, C, bwd=True)
        n_partials = B * tiles * n_chunks
    else:  # a partial row per (tile, chunk), its channel groups' columns side by side
        rows, cols, tiles, n_chunks, _ = bwd_grid(B, T, H // 2, W // 2, C)
        n_partials = tiles * n_chunks
    partial = torch.empty(n_partials, taps * C + C, device=dev, dtype=torch.float32)
    fn = build.function("conv1_pool_bwd", "avs_conv1_pool_bwd" + suffix, _BWD_ARGTYPES)
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
    H/2, W/2, C) -> (dkernel (kt, kh, kw, 1, C), dbias (C,)), float32 sums
    for float32 or bf16 x, kernel and g."""
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
    dk = torch.empty(kernel.shape, device=x.device, dtype=torch.float32)
    db = torch.empty(C, device=x.device, dtype=torch.float32)
    return _launch_bwd(x, x.stride()[:4], kernel, (C, 1), bias, g, g.stride(), dk, (C, 1),
                       db, B, T, H, W, kt, kh, kw, C)


def conv1_pool_block_bwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         g: torch.Tensor):
    """NCDHW form of `conv1_pool_bwd`: x (B, 1, T, H, W), weight (C, 1, kt,
    kh, kw), g (B, C, T, H/2, W/2) -> (dweight in weight's layout, dbias),
    float32 sums."""
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
    dw = torch.empty(weight.shape, device=x.device, dtype=torch.float32)
    db = torch.empty(C, device=x.device, dtype=torch.float32)
    gs = g.stride()
    return _launch_bwd(x, (x.stride(0), x.stride(2), x.stride(3), x.stride(4)),
                       weight, (1, taps), bias, g, (gs[0], gs[2], gs[3], gs[4], gs[1]),
                       dw, (1, taps), db, B, T, H, W, kt, kh, kw, C)


class Conv1Pool(torch.autograd.Function):
    """The model's fused conv1 block, NCDHW: forward K1, dW/db by K4 (their
    plain versions on the CPU). The block computes in x's dtype: a bf16 x
    runs K1/K4-bf16 on the weight rounded to bf16, and dW, K4's float32 sum,
    is rounded to bf16 once before it reaches the float32 parameter; db stays
    float32, as the JAX package's (its bias enters the kernel in float32). dx,
    needed only when conv1 is not the input layer, comes from autograd of the
    plain composition (cuDNN conv, ReLU, pool), as the JAX package takes it
    from XLA's VJP."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        w = weight.to(x.dtype)
        ctx.weight_dtype = weight.dtype
        ctx.save_for_backward(x, w, bias)
        return _block_forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        dw, db = conv1_pool_block_bwd(x, w, bias, g)
        dw = dw.to(w.dtype).to(ctx.weight_dtype)  # bf16: the one rounding
        dx = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                xr = x.detach().requires_grad_()
                y = conv_relu_pool(xr, w.detach(), bias.detach())
                (dx,) = torch.autograd.grad(y, xr, g)
        return dx, dw, db


def conv1_pool_block(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """NCDHW: (B, 1, T, H, W) x (C, 1, kt, kh, kw) + (C,) -> (B, C, T, H/2, W/2)
    in x's dtype, differentiable (`Conv1Pool`)."""
    return Conv1Pool.apply(x, weight, bias)
