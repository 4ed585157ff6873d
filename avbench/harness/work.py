"""The yardstick's arithmetic: useful FLOPs of a clip, the H100's peaks and
the least time a kernel's work can take.

A multiply-accumulate counts 2 FLOPs. The LipNet count is the analytic model
of `avsync_torch/utils/flops.py` (convolutions, the GRU projections and
recurrences, the output layer; elementwise work, pooling, softmax and CTC
left out; a train step is 3x the forward; recompute is not useful work),
copied here so that a change to the program cannot move it. The TF family's
count is the same model over its layer equations: three 3x3x3 convolutions,
three BiLSTMs, two Dense layers and the head.

Kernel work counts are those of chip_smoke.py's bounds (K1/K4 in bf16, K2,
K3): each input byte read once, each output byte written once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), 700 W.
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    # float32-faithful products can run on the tensor cores (3xTF32) but
    # never faster than TF32 itself: the rate a float32 share is held to
    "float32": 495e12,
    "int8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def peak_flops(dtype: str) -> float:
    if dtype not in PEAK_FLOPS:
        raise ValueError(f"no H100 peak for dtype {dtype!r}")
    return PEAK_FLOPS[dtype]


def _pooled(h: int, w: int, n: int) -> Tuple[int, int]:
    for _ in range(n):
        h, w = h // 2, w // 2
    return h, w


def conv_stack_flops(channels: Sequence[int], kernels: Sequence[Sequence[int]],
                     T: int, H: int, W: int) -> int:
    """Forward FLOPs of SAME conv + (1,2,2) pool blocks for one clip."""
    total, cin, h, w = 0, 1, H, W
    for ch, (kt, kh, kw) in zip(channels, kernels):
        total += 2 * T * h * w * ch * cin * kt * kh * kw
        cin, h, w = ch, h // 2, w // 2
    return total


def recurrent_flops(layers: int, hidden: int, gates: int, T: int, feat: int) -> int:
    """Forward FLOPs of `layers` bidirectional recurrent layers of `gates`
    gates each (GRU 3, LSTM 4): input projection and recurrent product."""
    total, d = 0, feat
    for _ in range(layers):
        per_dir = 2 * T * d * gates * hidden + 2 * T * hidden * gates * hidden
        total += 2 * per_dir
        d = 2 * hidden
    return total


def forward_flops(cfg: dict) -> int:
    """Useful forward FLOPs of one clip of configuration `cfg`."""
    T, H, W = cfg["frames"], cfg["img_height"], cfg["img_width"]
    ch, kern = cfg["conv_channels"], cfg["conv_kernels"]
    h, w = _pooled(H, W, len(ch))
    feat = ch[-1] * h * w
    total = conv_stack_flops(ch, kern, T, H, W)
    if cfg["family"] == "tf":
        hid = cfg["hidden_dim"]
        total += recurrent_flops(cfg["num_lstm_layers"], hid, 4, T, feat)
        dense = cfg["dense_dim"]
        total += 2 * T * (2 * hid) * dense + 2 * T * dense * dense
        total += 2 * T * dense * cfg["outputs"]
        return total
    hid = cfg["hidden_dim"]
    total += recurrent_flops(cfg["num_gru_layers"], hid, 3, T, feat)
    return total + 2 * T * (2 * hid) * cfg["outputs"]


def train_flops(cfg: dict) -> int:
    """Useful FLOPs of one training sample: forward and backward (3x)."""
    return 3 * forward_flops(cfg)


def bound_s(n_bytes: float, n_ops: float, dtype: str) -> float:
    """The least time of a kernel's work: bytes over HBM bandwidth or
    operations over the dtype's peak, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / peak_flops(dtype))


# -- the kernels' work (chip_smoke.py's counts) ----------------------------------

def conv1_fwd_work(B: int, T: int, H: int, W: int, C: int, taps: int,
                   itemsize: int) -> Tuple[float, float]:
    """K1 (conv1 + ReLU + pool): reads the clips, the weights and bias,
    writes the pooled map; `taps` FMAs, the bias add and a pool compare per
    pre-pool value. (bytes, operations)."""
    n_pre = B * T * H * W * C
    n_bytes = itemsize * (B * T * H * W + taps * C + B * T * (H // 2) * (W // 2) * C) + 4 * C
    return n_bytes, n_pre * (2 * taps + 2)


def conv1_bwd_work(B: int, T: int, H: int, W: int, C: int, taps: int,
                   itemsize: int) -> Tuple[float, float]:
    """K4 (conv1's weight and bias gradient): reads the clips, the pooled
    cotangent and the weights, writes dW and db (float32 sums); the
    recomputed forward's operations. The routed positions' products depend
    on the data and are left out, so the count is a lower bound."""
    n_pre = B * T * H * W * C
    n_bytes = (itemsize * (B * T * H * W + B * T * (H // 2) * (W // 2) * C + taps * C)
               + 4 * (C + taps * C + C))
    return n_bytes, n_pre * (2 * taps + 2)


def gru_fwd_work(B: int, T: int, H: int) -> Tuple[float, float]:
    """K2, both directions: reads gi, w_hh, b_hh, writes h; the recurrent
    product and the gates."""
    n_bytes = 4 * 2 * (B * T * 3 * H + H * 3 * H + 3 * H + B * T * H)
    return n_bytes, 2 * (2 * B * T * H * 3 * H + 12 * B * T * H)


def gru_bwd_work(B: int, T: int, H: int) -> Tuple[float, float]:
    """K3, both directions: reads gi, out, g, w_hh, b_hh, writes dgi,
    dw_hh, db_hh; three (B*T, H) x (H, 3H) products and the gate math."""
    n_bytes = 4 * 2 * (B * T * 3 * H + 2 * B * T * H + H * 3 * H + 3 * H
                       + B * T * 3 * H + H * 3 * H + 3 * H)
    return n_bytes, 2 * (3 * 2 * B * T * H * 3 * H + 30 * B * T * H)
