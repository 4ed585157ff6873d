"""int8 Conv3D + dequant + ReLU + MaxPool3D(1,2,2) block for int8 serving:
the CUDA kernel Q1 and its plain twin.

  * kernel: `avsync_torch/csrc/int8_conv_pool.cu` (Q1), the port of the int8
    `lax.conv_general_dilated` block of `avsync/ops/quant.py:97-135`
    (`quant_conv_block`; the JAX package has no Pallas kernel for it): it
    quantizes the f32 block input with the static scale, runs the int8
    convolution on the tensor cores with exact int32 sums, dequantizes, adds
    the bias, applies ReLU and pools, in one launch; `launches` counts its
    launches, `bf16_launches` those of its bf16 epilogue;
  * plain version: `int8_conv_pool_ref`, the same function in PyTorch ops
    (the convolution of the int8 values in float64, which is exact: every
    partial sum is an integer below 2^53). It is the CPU path and the card's
    oracle; nothing on the card's main path calls it.

The block is the operator `avsync_torch::int8_conv_pool` (`int8_conv_pool_op`):
Q1 for CUDA tensors, the plain version for CPU ones (the dispatcher chooses by
the tensor's device), with an exact fake, so that a CUDA graph or a trace can
hold it. A CUDA tensor launches the kernel or raises.

Contracts, so that the int8 forward hands int8 from block to block:

  | input                                   | output (`out_scale`)                       |
  |-----------------------------------------|--------------------------------------------|
  | float32 at any strides, quantized with  | float32 (None)                             |
  | `x_scale` inside                        | or int8 quantized with `out_scale` (the    |
  | or int8 channels-last, used as is       | next block's x_scale), equal to            |
  |                                         | `quantize_input(float32 out, out_scale)`   |

Under bf16 compute (the JAX block's `out_dtype=bfloat16`) `scale` and `bias`
come as bf16, s16 = bf16(x_scale * k_scale) and b16 = bf16(bias), and the
epilogue rounds to bf16 after each op, as XLA does:
v = bf16(bf16(bf16(float(acc)) * s16) + b16); the output is then bf16 (None)
or int8, `quantize_input` of v widened to float32 (the JAX block divides the
bf16 value by its float32 scale in float32). The dtype of `scale` chooses
the epilogue: the kernel's `bf16` flag, or the plain version's bf16 ops.

Layouts: x (B, Cin, T, H, W); the kernel `kernel_q` (Cout, Cin, kt, kh, kw)
int8, which the kernel reads packed once per load (`pack_kernel`: (Npad,
Kpad) with k = ((dt*kh + dh)*kw + dw)*Cin + ci, rows and columns
zero-padded to multiples of 32); out (B, Cout, T, H//2, W//2), channels-last
in memory (the next block's halo reads a position's channels contiguously),
on both devices. An int8 input must be channels-last (a block's int8
output is); both versions raise on any other int8 layout.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from avsync_torch.ops.cuda import build

# Kernel launches since the last reset (the caller resets them to 0): the
# f32 epilogue's, and the bf16 epilogue's.
launches = 0
bf16_launches = 0

# avs_int8_conv_pool(x, w, scale, bias, out, x_scale, out_scale, x_int8, out_int8, bf16,
#                    B, Cin, T, H, W, Cout, kt, kh, kw, Kpad, Npad, tile_rows,
#                    tile_cols, groups, stage_chunks, pos_bytes, frames,
#                    5 x strides, 5 out strides, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int] * 20
             + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])
# avs_int8_conv_pool_smem(Cin, Kpad, kt, kh, kw, tile_rows, tile_cols, pos_bytes, groups,
#                         stage_chunks)
_SMEM_ARGTYPES = [ctypes.c_int] * 10

MAX_SMEM = 232448  # shared memory one CTA can opt in to on sm_90
SM_SMEM = 233472  # shared memory of one SM (228 KB); each CTA on it also takes 1 KB
TWO_PER_SM = SM_SMEM // 2 - 1024  # the most each of two CTAs on one SM can take
SM_WARPS = 16  # warps one SM holds at the kernel's 128 registers a thread
DIRECT_WARPS = 8  # warps of a CTA without the B ring
MAX_WARPS = 16  # warps of a CTA at most (512 threads)
MAX_TILE_POSITIONS = 128  # pooled positions per CTA without the ring: 8 warp tasks of 16
RING_STAGES = 2  # the B ring's stages (the kernel's B_STAGES)
RING_CHUNKS = (2, 4, 8, 16)  # k-chunks of 32 per stage of the B ring the planner tries
# The planner's rates (csrc/int8_conv_pool.cu's design; fitted to the tile
# sweep of scripts/torch_kernel_breakdown.py --mode q1 on an H100 80GB HBM3 at
# 700 W, where the tiles the estimate chooses are within ~3% of the sweep's
# best; its times run ~13% above the measured ones at the ring's blocks,
# alike for every tile, since the halo loads under the MMAs): k-chunks of
# one warp task (16 MMAs) an SM runs per microsecond with 16 warps
# resident, through the B ring (ldmatrix A) or
# with B per warp task (32-bit A loads and byte gathers: the rate of B per
# warp task with ldmatrix A, 26, over their instructions per chunk, 40 and
# 140 against 24); an SM with fewer warps runs (warps / 16) **
# OCCUPANCY_EXP of that (latency left exposed); the share CONFLICT_COST of a
# chunk's time each extra shared-memory wavefront of the A loads adds
# (`a_wavefronts`); bytes of weights per microsecond one SM reads from L2,
# into the ring (16-byte cp.async) or per warp task (4-byte loads); each
# ring stage's cost to its CTA (its barrier: ~0.3 us); the halo's staging
# per value without the ring (one value per load; the ring's blocks take
# the int8 chain's 16-byte cp.async, overlapped with the first stage's
# MMAs) and a fixed cost per CTA and frame, in microseconds
CHUNK_RATE = {"ring": 30.0, "words": 26.0 * 24 / 40, "bytes": 26.0 * 24 / 140}
OCCUPANCY_EXP = 0.5
CONFLICT_COST = 0.2
WEIGHT_RATE = {"ring": 10e3, "direct": 18e3}
STAGE_US = 0.3
HALO_US = 1e-3
CTA_US = 0.33


class Q1Tile(NamedTuple):
    """One CTA's share of a block: a tile of `rows` x `cols` pooled
    positions; where Cin % 16 == 0, B fragments staged once per CTA in a
    ring of RING_STAGES stages of `chunks` k-chunks of 32, `groups` x 32
    output channels a round, mgroups x groups warps (mgroups = ceil(rows *
    cols / 16)); else `groups` and `chunks` 0: eight warps read B per warp
    task from the packed weights."""
    rows: int
    cols: int
    groups: int = 0
    chunks: int = 0


def padded(n: int, m: int = 32) -> int:
    return -(-n // m) * m


def pos_bytes(cin: int) -> int:
    """Bytes per halo position: Cin, or for Cin % 4 == 0 the smallest
    S >= Cin with S / 16 odd (the kernel keeps even and odd halo columns in
    two planes, so a warp's eight A-fragment rows are positions S bytes
    apart, which then fall on distinct banks; csrc/int8_conv_pool.cu)."""
    if cin % 4:
        return cin
    s = padded(cin, 16)
    return s if (s // 16) % 2 else s + 16


def shared_memory_bytes(cin: int, kpad: int, kt: int, kh: int, kw: int, rows: int,
                        cols: int, groups: int = 0, chunks: int = 0) -> int:
    """The kernel's `smem_bytes`: four offset tables (two column parities, a
    frame-independent copy and the frame's; an int per k, per four k when
    Cin % 4 == 0, per sixteen when Cin % 16 == 0), a ring of kt + 1 frame
    slots, each the tile's int8 halo in two column planes, then the B ring:
    RING_STAGES x `chunks` k-chunks of `groups` x 32 channels."""
    entries = kpad // 16 if cin % 16 == 0 else kpad // 4 if cin % 4 == 0 else kpad
    ih, iwh = 2 * rows + kh - 1, -(-(2 * cols + kw - 1) // 2)
    return (padded(4 * 4 * entries, 16)
            + (kt + 1) * padded(2 * ih * iwh * pos_bytes(cin), 16)
            + RING_STAGES * chunks * groups * 32 * 32)


def warps(tile: Q1Tile) -> int:
    """Warps of one CTA."""
    return -(-tile.rows * tile.cols // 16) * tile.groups if tile.groups else DIRECT_WARPS


def ctas_per_sm(cin: int, kt: int, kh: int, kw: int, tile: Q1Tile) -> int:
    """CTAs one SM holds: by its warps (registers) and its shared memory."""
    smem = shared_memory_bytes(cin, padded(cin * kt * kh * kw), kt, kh, kw, *tile)
    return min(SM_WARPS // warps(tile), SM_SMEM // (smem + 1024))


def weight_bytes(cin: int, cout: int, kt: int, kh: int, kw: int, tile: Q1Tile) -> int:
    """Bytes of weights one CTA reads from L2 per output frame: the packed
    (Npad, Kpad) weights once through the B ring; else once per pass of
    its eight warps over the tasks (warps that read one channel group at
    once share L1's lines, a warp's successive tasks do not)."""
    kpad, ngroups = padded(cin * kt * kh * kw), padded(cout) // 32
    passes = 1 if tile.groups else -(-(-(-tile.rows * tile.cols // 16) * ngroups) // DIRECT_WARPS)
    return passes * ngroups * 32 * kpad


def weight_traffic(B: int, T: int, H2: int, W2: int, cin: int, cout: int, kt: int, kh: int,
                   kw: int, tile: Q1Tile) -> int:
    """Bytes of weights one launch reads: B x T x tiles CTA-frames."""
    tiles = -(-H2 // tile.rows) * -(-W2 // tile.cols)
    return B * T * tiles * weight_bytes(cin, cout, kt, kh, kw, tile)


@functools.lru_cache(maxsize=4096)
def a_wavefronts(cin: int, kw: int, rows: int, cols: int) -> float:
    """Shared-memory wavefronts per 8x8 matrix of the ldmatrix A loads
    (Cin % 16 == 0), averaged over the tile's: its eight rows are pooled
    positions of the tile (rows past it read position 0), S bytes apart
    within a plane row, 2 ceil(IW / 2) positions from one pooled row to the
    next; eight rows on the same 16-byte bank group of a 128-byte line at
    distinct addresses take a wavefront each (1 where the tile's width
    leaves none on the same group)."""
    S, iwh = pos_bytes(cin), -(-(2 * cols + kw - 1) // 2)
    P, total, n = rows * cols, 0, 0
    for first in range(0, -(-P // 16) * 16, 8):
        addrs = {(2 * (q // cols) * iwh + q % cols) * S for q in
                 (q if q < P else 0 for q in range(first, first + 8))}
        groups = [a // 16 % 8 for a in addrs]
        total += max(groups.count(g) for g in set(groups))
        n += 1
    return total / n


def tile_cost(H2: int, W2: int, cin: int, cout: int, kt: int, kh: int, kw: int,
              tile: Q1Tile) -> float:
    """The planner's estimate of one clip-frame, in SM-microseconds: per
    CTA and frame the longer of its MMA loop (the k-chunks of its busiest
    warp, at the rate its SM's resident warps give each: CHUNK_RATE x
    (warps / 16) ** OCCUPANCY_EXP shared among them, slowed by the A loads'
    bank conflicts; plus the ring's barriers) and its weights from L2 (the
    SM's bandwidth shared by its CTAs), plus its halo's staging (without the
    ring: with it the halo loads under the first stage's MMAs) and a fixed
    cost; times the tiles, over the CTAs an SM runs at
    once."""
    kpad, ngroups = padded(cin * kt * kh * kw), padded(cout) // 32
    chunks, mg = kpad // 32, -(-tile.rows * tile.cols // 16)
    per_sm = ctas_per_sm(cin, kt, kh, kw, tile)
    if tile.groups:  # ldmatrix A, slowed by its bank conflicts
        rounds, active = -(-ngroups // tile.groups), warps(tile)
        steps, barriers = rounds * chunks, rounds * -(-chunks // tile.chunks)
        rate = CHUNK_RATE["ring"] / (
            1 + CONFLICT_COST * (a_wavefronts(cin, kw, tile.rows, tile.cols) - 1))
        bandwidth, halo = WEIGHT_RATE["ring"], 0.0
    else:
        steps, active = -(-mg * ngroups // DIRECT_WARPS) * chunks, min(DIRECT_WARPS, mg * ngroups)
        rate = CHUNK_RATE["words" if cin % 4 == 0 else "bytes"]
        bandwidth, barriers = WEIGHT_RATE["direct"], 0
        halo = HALO_US * (2 * tile.rows + kh - 1) * (2 * tile.cols + kw - 1) * cin
    resident = min(per_sm * active, SM_WARPS)
    mma = (steps * per_sm * active / (rate * (resident / SM_WARPS) ** OCCUPANCY_EXP)
           + barriers * STAGE_US)
    weights = weight_bytes(cin, cout, kt, kh, kw, tile) * per_sm / bandwidth
    cta = max(mma, weights) + halo + CTA_US
    return -(-H2 // tile.rows) * -(-W2 // tile.cols) * cta / per_sm


def tiles_to_try(H2: int, W2: int, cin: int, cout: int, kt: int, kh: int, kw: int):
    """Every tile the kernel takes for this geometry and one CTA's shared
    memory: where Cin % 16 == 0 with the B ring (up to 16 warps, each group
    count up to the channels', each stage size), else
    without (up to MAX_TILE_POSITIONS pooled positions)."""
    kpad, ngroups = padded(cin * kt * kh * kw), padded(cout) // 32
    for rows in range(1, H2 + 1):
        for cols in range(1, W2 + 1):
            mg = -(-rows * cols // 16)
            if cin % 16 == 0:
                cands = [Q1Tile(rows, cols, g, c)
                         for g in range(1, min(ngroups, MAX_WARPS // mg) + 1)
                         for c in RING_CHUNKS]
            else:
                cands = [Q1Tile(rows, cols)] if rows * cols <= MAX_TILE_POSITIONS else []
            if not cands:
                break
            for t in cands:
                if shared_memory_bytes(cin, kpad, kt, kh, kw, *t) <= MAX_SMEM:
                    yield t


@functools.lru_cache(maxsize=256)
def tile_for(H2: int, W2: int, cin: int, cout: int, kt: int, kh: int,
             kw: int) -> Q1Tile:
    """The tile, and the B ring's shape where Cin % 16 == 0, per CTA: of
    `tiles_to_try`, the one with the least `tile_cost`, which weighs the MMA
    loop against the weights each CTA reads from L2 (`weight_bytes`) and
    the warps its shared memory and registers leave resident on an SM
    (`ctas_per_sm`: one CTA or several). Ties go to the tile that reads
    fewer weights, then to larger stages, fewer groups, the
    smaller tile. Raises where even a single pooled position's ring does not
    fit."""
    best = None
    for t in tiles_to_try(H2, W2, cin, cout, kt, kh, kw):
        key = (round(tile_cost(H2, W2, cin, cout, kt, kh, kw, t), 6),
               weight_traffic(1, 1, H2, W2, cin, cout, kt, kh, kw, t), -t.chunks,
               t.groups, t.rows * t.cols, t.rows)
        if best is None or key < best[0]:
            best = (key, t)
    if best is not None:
        return best[1]
    kpad = padded(cin * kt * kh * kw)
    raise ValueError(
        f"int8_conv_pool: one pooled position of a {kt}x{kh}x{kw} kernel over {cin} input "
        f"channels needs {shared_memory_bytes(cin, kpad, kt, kh, kw, 1, 1)} bytes of shared "
        f"memory for its ring of frames and offset tables; one CTA of sm_90 has {MAX_SMEM}")


@functools.lru_cache(maxsize=1024)
def frames_for(B: int, T: int, tiles: int, sms: int = 132, per_sm: int = 2) -> int:
    """Frames per CTA, F: the grid is B x tiles x ceil(T / F) CTAs, which
    run in waves of sms x per_sm; a CTA's time grows as F + 1 (F frames of
    MMAs, the kt halo frames it stages before the first, less the overlap).
    The F with the fewest waves x (F + 1), the smallest of equals: large
    batches take long runs, small ones short runs and more CTAs. F changes
    no bit of the result."""
    best = None
    for F in range(1, T + 1):
        ctas = B * tiles * -(-T // F)
        cost = -(-ctas // (sms * per_sm)) * (F + 1)
        if best is None or cost < best[0]:
            best = (cost, F)
    return best[1]


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pack_kernel(kernel_q: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kt, kh, kw) int8 -> (Npad, Kpad) int8, each row one output
    channel's taps with their channels contiguous, zero-padded: the layout
    Q1's B fragments read (done once per load)."""
    cout = kernel_q.shape[0]
    flat = kernel_q.permute(0, 2, 3, 4, 1).reshape(cout, -1)
    out = kernel_q.new_zeros(padded(cout), padded(flat.shape[1]))
    out[:cout, :flat.shape[1]] = flat
    return out


def unpack_kernel(packed: torch.Tensor, cout: int, cin: int, kt: int, kh: int,
                  kw: int) -> torch.Tensor:
    """The inverse of `pack_kernel`."""
    flat = packed[:cout, :cin * kt * kh * kw]
    return flat.reshape(cout, kt, kh, kw, cin).permute(0, 4, 1, 2, 3)


def quantize_input(x: torch.Tensor, x_scale: float) -> torch.Tensor:
    """clip(round(x / x_scale), -127, 127) as float values, round half to even.
    The divisor is a tensor on x's device: PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal, which is not the true quotient."""
    s = torch.tensor(x_scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / s), -127, 127)


def _dequant_pool(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """float32(acc) * scale + bias (two roundings, no FMA), ReLU, pool, in
    scale's dtype: under bf16 each op rounds to bf16, the convert through
    float32 as XLA converts int32."""
    view = (1, -1, 1, 1, 1)
    y = acc.to(torch.float32).to(scale.dtype) * scale.view(view)
    return F.max_pool3d(F.relu(y + bias.view(view)), (1, 2, 2))


def _ref(x, kernel_q, scale, bias, x_scale: float, out_scale: Optional[float]) -> torch.Tensor:
    kt, kh, kw = kernel_q.shape[2:]
    xq = x.to(torch.float32) if x.dtype == torch.int8 else quantize_input(x.to(torch.float32),
                                                                          x_scale)
    acc = F.conv3d(xq.double(), kernel_q.double(),
                   padding=((kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2))
    # integers below 2^53: exact, whatever the algorithm (round() only guards
    # a transform-based algorithm's rounding of a few ulps)
    out = _dequant_pool(acc.round().to(torch.int32), scale, bias)
    return out if out_scale is None else quantize_input(out.float(), out_scale).to(torch.int8)


def int8_conv_pool_ref(x: torch.Tensor, kernel_q: torch.Tensor, k_scale: torch.Tensor,
                       bias: torch.Tensor, x_scale: float,
                       out_scale: Optional[float] = None,
                       compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: maxpool(relu(float32(conv3d(q(x), kernel_q)) *
    (x_scale * k_scale) + bias)), NCDHW, q(x) = `quantize_input` of an f32 x
    (an int8 x is taken as already quantized); the convolution of the int8
    values in float64 (exact), then int32, then f32; with `out_scale`, the
    f32 result quantized to int8 by `quantize_input`, channels-last (the
    layout a next block takes). `compute_dtype` bf16: the bf16 epilogue
    (the module's docstring), bf16 or int8 out."""
    _check_int8_layout(x)
    scale = torch.tensor(x_scale, dtype=torch.float32) * k_scale.to("cpu", torch.float32)
    dt = compute_dtype or torch.float32
    out = _ref(x, kernel_q, scale.to(x.device, dt), bias.to(dt), x_scale, out_scale)
    return out if out_scale is None else out.contiguous(memory_format=torch.channels_last_3d)


def _check_int8_layout(x: torch.Tensor) -> None:
    if x.dtype == torch.int8 and not x.permute(0, 2, 3, 4, 1).is_contiguous():
        raise ValueError("int8_conv_pool: an int8 input must be channels-last, as a block's "
                         "int8 output is")


def _out_empty(x: torch.Tensor, cout: int, out_scale: Optional[float],
               dtype: torch.dtype) -> torch.Tensor:
    """The block's output, channels-last: `dtype` (the epilogue's), or int8
    with an `out_scale`."""
    B, _, T, H, W = x.shape
    dtype = dtype if out_scale is None else torch.int8
    return x.new_empty(B, T, H // 2, W // 2, cout, dtype=dtype).permute(0, 4, 1, 2, 3)


def _int8_conv_pool_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, x_scale: float, cout: int, kt: int, kh: int,
                         kw: int, out_scale: Optional[float] = None) -> torch.Tensor:
    """One Q1 launch: the f32 epilogue, or with bf16 scale and bias the bf16
    one."""
    global launches, bf16_launches
    B, cin, T, H, W = x.shape
    dev = x.device
    if x.dtype not in (torch.float32, torch.int8):
        raise ValueError("int8_conv_pool: x must be float32 or int8")
    _check_int8_layout(x)
    if packed.device != dev or packed.dtype != torch.int8 or not packed.is_contiguous():
        raise ValueError(f"int8_conv_pool: the packed kernel must be contiguous int8 on {dev}")
    dt = scale.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError("int8_conv_pool: scale and bias must be float32 or bfloat16")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() or t.shape != (cout,):
            raise ValueError(f"int8_conv_pool: {name} must be ({cout},) contiguous {dt} "
                             f"on {dev}")
    kpad, npad = padded(cin * kt * kh * kw), padded(cout)
    if packed.shape != (npad, kpad):
        raise ValueError(f"int8_conv_pool: packed kernel {tuple(packed.shape)}, expected "
                         f"{(npad, kpad)}")
    tile = tile_for(H // 2, W // 2, cin, cout, kt, kh, kw)
    tiles = -(-(H // 2) // tile.rows) * -(-(W // 2) // tile.cols)
    frames = frames_for(B, T, tiles, _sm_count(dev.index), ctas_per_sm(cin, kt, kh, kw, tile))
    out = _out_empty(x, cout, out_scale, dt)
    fn = build.function("int8_conv_pool", "avs_int8_conv_pool", _ARGTYPES)
    err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), x_scale, 1.0 if out_scale is None else out_scale,
             int(x.dtype == torch.int8), int(out_scale is not None),
             int(dt == torch.bfloat16), B, cin, T, H, W, cout, kt,
             kh, kw, kpad, npad, *tile, pos_bytes(cin), frames,
             *x.stride(), *out.stride(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check("int8_conv_pool", err, "int8_conv_pool launch")
    if dt == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return out


# The block as an operator: Q1 for CUDA tensors, the plain version for CPU
# ones, so that a CUDA graph or a trace holds it as one node.
int8_conv_pool_op = torch.library.custom_op("avsync_torch::int8_conv_pool",
                                            _int8_conv_pool_cuda, mutates_args=(),
                                            device_types="cuda")


@int8_conv_pool_op.register_kernel("cpu")
def _int8_conv_pool_cpu(x, packed, scale, bias, x_scale, cout, kt, kh, kw, out_scale=None):
    _check_int8_layout(x)
    kernel_q = unpack_kernel(packed, cout, x.shape[1], kt, kh, kw)
    out = _out_empty(x, cout, out_scale, scale.dtype)
    out.copy_(_ref(x, kernel_q, scale, bias, x_scale, out_scale))
    return out


@int8_conv_pool_op.register_fake
def _int8_conv_pool_fake(x, packed, scale, bias, x_scale, cout, kt, kh, kw, out_scale=None):
    return _out_empty(x, cout, out_scale, scale.dtype)


def check_geometry(x: torch.Tensor, kernel_shape, x_scale: float,
                   out_scale: Optional[float] = None) -> None:
    """Raise on what neither version takes: the JAX block's SAME padding is
    symmetric only for odd kernels; the static scales must be positive."""
    if x.dim() != 5:
        raise ValueError(f"int8_conv_pool: x must be (B, Cin, T, H, W), got {tuple(x.shape)}")
    cout, kcin, kt, kh, kw = kernel_shape
    if x.shape[1] != kcin:
        raise ValueError(f"int8_conv_pool: x has {x.shape[1]} channels, the kernel {kcin}")
    if not (kt % 2 and kh % 2 and kw % 2):
        raise ValueError("int8_conv_pool needs odd kernel sizes (symmetric SAME padding)")
    if x.shape[3] < 2 or x.shape[4] < 2:
        raise ValueError("int8_conv_pool needs H and W of at least 2 (a (1,2,2) pool)")
    for what, v in (("input", x_scale), ("output", out_scale)):
        if v is not None and not (math.isfinite(v) and v > 0):
            raise ValueError(f"int8_conv_pool: the {what} scale must be positive, got {v}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv_pool: unsupported device {x.device}")
