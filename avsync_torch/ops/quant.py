"""int8 post-training quantization for LipNet serving (port of
`avsync/ops/quant.py`, float32 or bf16 compute, both model families).

The scheme is the JAX package's static PTQ:
  * weights: symmetric per-output-channel int8 (scale = absmax/127 over
    (Cin, kt, kh, kw) per Cout; 1 for an all-zero channel);
  * activations: symmetric per-tensor int8 with STATIC scales, each block
    input's absmax/127 over a few calibration batches, so quantizing is an
    elementwise step inside the block's kernel;
  * accumulation in exact int32, dequantized as acc * (x_scale * k_scale[c])
    + bias[c], then ReLU and the (1,2,2) max pool;
  * the BiGRU layers and the FC head run from the float state dict in the
    compute dtype (K2 when `use_pallas_gru`), as `lipnet_int8_apply` does;
    for the TF family the BiLSTM layers, the Dense layers and the head
    (`tflipnet_int8_apply`).

Under bf16 compute (`compute_dtype`, the JAX forward's `compute_dtype=
"bfloat16"`) each block ends in Q1's bf16 epilogue (s16 and b16 made once
per load, `QuantConvParams.scale16`/`bias16`), the last block's output is
bf16, the recurrences run the JAX `gru_scan`/`lstm_scan` step (h and w_hh
rounded to bf16 in the product, float32 sums and carry; K2's bf16-operand
instantiation on the card), and the heads are bf16 Dense layers
(`ops/precision.dense`) before a float32 log_softmax. conv1 takes the
float32 frames whatever the dtype, as the JAX forward casts only
non-floating inputs. Calibration runs in float32 in either case.

Each conv block is one launch of Q1 (`ops/cuda/quantconv.py`,
`csrc/int8_conv_pool.cu`) on the card and its plain version on the CPU,
chosen by the tensor's device. In the int8 forward the blocks hand int8 to
each other: a block writes its output quantized with the next block's
static scale, which is exactly the quantize step the next block would
apply to the f32 output, so the log-probs keep their bits. The JAX package's pack4 path is its TPU
layout trick with the same bits as the plain block (tests/test_quant.py);
the port has none.

Layouts are the port's: kernels (Cout, Cin, kt, kh, kw), activations NCDHW,
and the conv output flattens in (C, H, W) order, so the reference-layout GRU
and FC weights apply unchanged (`compat.quant_params_from_jax` carries a JAX
`QuantLipNetParams` across).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from avsync_torch.config import ModelConfig
from avsync_torch.ops import precision
from avsync_torch.ops.cuda import quantconv
from avsync_torch.ops.gru import GRUWeights, bigru
from avsync_torch.ops.lstm import LSTMWeights, bilstm


class QuantConvParams(NamedTuple):
    """One quantized Conv3D+ReLU+Pool block. `packed`, `scale` and (under
    bf16) `scale16`, `bias16` are what Q1 reads, made once by
    `quant_conv_params`."""

    kernel_q: torch.Tensor  # int8 (Cout, Cin, kt, kh, kw)
    k_scale: torch.Tensor  # f32 (Cout,), symmetric per output channel
    bias: torch.Tensor  # f32 (Cout,)
    x_scale: torch.Tensor  # f32 (), on the CPU: the static scale of the block's INPUT
    packed: torch.Tensor  # int8 (Npad, Kpad), `quantconv.pack_kernel`
    scale: torch.Tensor  # f32 (Cout,) = x_scale * k_scale
    scale16: torch.Tensor  # bf16 (Cout,) = bf16(scale), the bf16 epilogue's s16
    bias16: torch.Tensor  # bf16 (Cout,) = bf16(bias), its b16


class QuantLipNetParams(NamedTuple):
    """int8 conv stack + the float32 state dict (reference layout) whose BiGRU
    and FC weights the int8 forward reads."""

    convs: Tuple[QuantConvParams, ...]
    float_params: Dict[str, torch.Tensor]


def quant_conv_params(kernel_q: torch.Tensor, k_scale: torch.Tensor, bias: torch.Tensor,
                      x_scale) -> QuantConvParams:
    """A block's params on kernel_q's device, with the packed kernel and the
    epilogue scale (x_scale * k_scale, one f32 multiply, as the JAX block),
    and their bf16 roundings for the bf16 epilogue."""
    dev = kernel_q.device
    xs = torch.tensor(float(np.float32(x_scale)), dtype=torch.float32)
    k_scale = k_scale.reshape(-1).to(torch.float32)
    scale = (xs * k_scale.cpu()).to(dev).contiguous()
    bias = bias.to(dev, torch.float32)
    return QuantConvParams(
        kernel_q=kernel_q, k_scale=k_scale.to(dev), bias=bias, x_scale=xs,
        packed=quantconv.pack_kernel(kernel_q), scale=scale,
        scale16=scale.to(torch.bfloat16), bias16=bias.to(torch.bfloat16).contiguous())


def quantize_symmetric(x: torch.Tensor, axes: Sequence[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization: q = round(x / s), s = absmax/127 over
    `axes` (kept axes get their own scale); an all-zero slice gets scale 1,
    so q is exactly 0. Returns (q int8, s float32 with x's rank)."""
    amax = x.abs().amax(dim=tuple(axes), keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quant_conv_block(qc: QuantConvParams, x: torch.Tensor,
                     out_scale: Optional[float] = None,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """int8 Conv3D -> dequant -> ReLU -> MaxPool3D(1,2,2), NCDHW: (B, Cin, T,
    H, W) -> (B, Cout, T, H//2, W//2). A float x is quantized inside with the
    block's static scale (a bf16 x widened to float32 first, as the JAX
    block's bf16 / f32 division promotes); an int8 x (channels-last, a
    block's int8 output) is taken as already quantized. The output is
    float32 (bf16 under `compute_dtype` bf16: the JAX block's
    `out_dtype=bfloat16`), or with `out_scale` (the next block's x_scale)
    int8, quantized as the next block would quantize that output. Q1 on a
    CUDA tensor, its plain version on a CPU one."""
    x_scale = float(qc.x_scale)
    quantconv.check_geometry(x, tuple(qc.kernel_q.shape), x_scale, out_scale)
    cout, _, kt, kh, kw = qc.kernel_q.shape
    if x.dtype != torch.int8:
        x = x.to(torch.float32)
    scale, bias = ((qc.scale16, qc.bias16) if compute_dtype == torch.bfloat16
                   else (qc.scale, qc.bias))
    return quantconv.int8_conv_pool_op(x, qc.packed, scale, bias, x_scale, cout, kt, kh, kw,
                                       out_scale)


def _conv_blocks(model) -> list:
    return [getattr(model, f"conv{i + 1}") for i in range(len(model.cfg.conv_channels))]


def calibrate_conv_input_scales(model, batches: Sequence) -> np.ndarray:
    """Per-layer input absmax/127 over calibration batches of (B, T, H, W, 1)
    clips, running the model's own conv blocks in float32 whatever its
    compute dtype, as the JAX calibration runs f32 convs on the raw params
    (a block computes in its input's dtype, and the clips go in as float32;
    K1 for conv1 on the card when `fused_conv_pool`, cuDNN with TF32 off for
    the others; there is no dropout inside a block). Returns (n_layers,)
    float32."""
    convs = _conv_blocks(model)
    dev = next(model.parameters()).device
    amax = np.zeros(len(convs), np.float32)
    with torch.no_grad():
        for b in batches:
            x = torch.as_tensor(b, dtype=torch.float32).to(dev).permute(0, 4, 1, 2, 3)
            got = []
            for block in convs:
                got.append(x.abs().amax())
                x = block(x)
            amax = np.maximum(amax, torch.stack(got).cpu().numpy())
    return np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)


def quantize_lipnet(model, calibration_batches: Sequence,
                    input_scales: Optional[np.ndarray] = None) -> QuantLipNetParams:
    """f32 LipNet -> int8 serving params on the model's device.

    `calibration_batches`: a few (B, T, H, W, 1) preprocessed batches, the
    preprocessing serving runs. `input_scales` (n_layers,) skips calibration
    (a deployment's exported scales)."""
    convs = _conv_blocks(model)
    if input_scales is None:
        if not calibration_batches:
            raise ValueError("quantize_lipnet needs calibration batches or input_scales")
        input_scales = calibrate_conv_input_scales(model, calibration_batches)
    input_scales = np.asarray(input_scales, np.float32).reshape(-1)
    if input_scales.shape != (len(convs),):
        raise ValueError(f"{input_scales.shape[0]} input scales for {len(convs)} conv layers")
    qconvs = []
    for block, xs in zip(convs, input_scales):
        kq, ks = quantize_symmetric(block.weight.detach(), axes=(1, 2, 3, 4))
        qconvs.append(quant_conv_params(kq, ks, block.bias.detach(), xs))
    return QuantLipNetParams(convs=tuple(qconvs),
                             float_params={k: v.detach() for k, v in model.state_dict().items()})


def _int8_conv_stack(qp: QuantLipNetParams, x: torch.Tensor,
                     dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, T, H, W, 1) -> the int8 conv stack's (B, T, C*h*w) features in
    (C, H, W) order, float32 (bf16 under `dt` bf16), int8 between blocks:
    each block's output quantized with the next block's input scale (the
    same bits as quantizing its float32 or bf16 output there). conv1 takes
    float32 frames (a float input as it is), under either dtype."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    x = x.permute(0, 4, 1, 2, 3)
    n = len(qp.convs)
    for i, qc in enumerate(qp.convs):
        x = quant_conv_block(qc, x, float(qp.convs[i + 1].x_scale) if i + 1 < n else None,
                             compute_dtype=dt)
    B, C, T, h, w = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(B, T, C * h * w)


def _rnn_weights(p: Dict[str, torch.Tensor], prefix: str, layer: int, suffix: str):
    return tuple(p[f"{prefix}{layer}.{name}_l0{suffix}"]
                 for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))


def lipnet_int8_apply(qp: QuantLipNetParams, x: torch.Tensor, cfg: ModelConfig,
                      compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Quantized LipNet forward (`avsync/ops/quant.py:260-299`): (B, T, H, W,
    1) -> (B, T, vocab) float32 log-probs. The model's eval forward with the
    conv stack in int8, then the BiGRU layers (K2 when `cfg.use_pallas_gru`)
    and the FC head from `qp.float_params`, in `compute_dtype` (default
    `cfg.compute_dtype`; bf16 rounds as the module says)."""
    dt = precision.compute_dtype(compute_dtype or cfg.compute_dtype)
    x = _int8_conv_stack(qp, x, dt)
    p = qp.float_params
    for i in range(1, cfg.num_gru_layers + 1):
        x = bigru(x, GRUWeights(*_rnn_weights(p, "gru", i, "")),
                  GRUWeights(*_rnn_weights(p, "gru", i, "_reverse")), cfg.use_pallas_gru,
                  compute_dtype=dt, recurrence_dtype=dt)
    logits = precision.dense(x, p["fc.weight"], p["fc.bias"], dt)
    return F.log_softmax(logits.float(), dim=-1)


def tflipnet_int8_apply(qp: QuantLipNetParams, x: torch.Tensor, cfg,
                        compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Quantized TF-family forward (`avsync/ops/quant.py:208-257`): (B, T,
    H, W, 1) -> (B, T, vocab + 1) blank-last float32 log-probs. TFLipNet's
    eval forward with the conv stack in int8 (the same Conv3D + ReLU +
    Pool(1,2,2) blocks, so Q1 takes them); the BiLSTM layers, the two Dense
    layers and the head from `qp.float_params` in `compute_dtype` (default
    `cfg.compute_dtype`); dropout is the identity. `cfg` is a
    `TFModelConfig`."""
    dt = precision.compute_dtype(compute_dtype or cfg.compute_dtype)
    x = _int8_conv_stack(qp, x, dt)
    p = qp.float_params
    for i in range(1, cfg.num_lstm_layers + 1):
        x = bilstm(LSTMWeights(*_rnn_weights(p, "lstm", i, "")),
                   LSTMWeights(*_rnn_weights(p, "lstm", i, "_reverse")), x, compute_dtype=dt)
    for name in ("dense1", "dense2"):
        x = F.relu(precision.dense(x, p[f"{name}.weight"], p[f"{name}.bias"], dt))
    logits = precision.dense(x, p["head.weight"], p["head.bias"], dt)
    return F.log_softmax(logits.float(), dim=-1)


def make_int8_forward(model_cfg: ModelConfig):
    """`qfwd(qparams, video) -> log_probs`, the one family switch that eval
    (`cli._evaluate`), infer and serving (`predictor.LipReader`) share, in
    the config's compute dtype."""
    if model_cfg.family == "tf":
        from avsync_torch.models.lipnet_tf import tf_model_config

        tcfg = tf_model_config(model_cfg)
        return lambda qp, video: tflipnet_int8_apply(qp, video, tcfg)
    return lambda qp, video: lipnet_int8_apply(qp, video, model_cfg)
