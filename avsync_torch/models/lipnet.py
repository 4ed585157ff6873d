"""LipNet encoder in PyTorch (port of `avsync/models/lipnet.py`).

Three [Conv3D -> ReLU -> MaxPool3D(1,2,2) -> Dropout3d] blocks (32/64/96
channels, kernels (3,5,5)/(3,5,5)/(3,3,3)), flatten to (B, T, 96*6*12 =
6912), two bidirectional GRU(256) layers each followed by dropout,
Linear(512 -> vocab) and log_softmax.

The modules keep the reference checkpoint's key names and layouts
(`conv1.weight`, `gru1.weight_ih_l0_reverse`, `fc.bias`, ...), so
`load_state_dict` takes a reference `.pth` directly; weights of the JAX
package come across through `avsync_torch.compat.lipnet_params_from_jax`.
Inside, activations are NCDHW and the per-frame features flatten in
(C, H, W) order, as in the reference; the public input is the JAX package's
(B, T, H, W, 1).

`ModelConfig.compute_dtype="bfloat16"` computes as the JAX package does
under it (`avsync/models/lipnet.py:118-200`); the parameters stay float32:
the input is rounded to bf16 once at the top of the conv stack, the conv
blocks compute in bf16 (`ops/conv.conv_relu_pool`, or K1-bf16 for the fused
conv1), the BiGRUs take bf16 operands into float32 input projections and
return float32 (`ops/gru.py`), the head is a bf16 Dense
(`ops/precision.dense`), and log_softmax runs in float32 on the float32-cast
logits; `conv_features` returns float32.

Kernel routing (float32 and bf16):
  * `ModelConfig.fused_conv_pool`: conv1 runs the fused conv+ReLU+pool
    kernel, one launch per forward, and its weight-gradient kernel once per
    backward, where `ops/cuda/convpool.fused_takes` says the kernels take
    the block (Cin = 1, even H/W, odd kernel; float32 any Cout whose CTAs
    fit, bf16 Cout <= 32). LipNet's 32 channels pass the JAX gate of
    `lipnet.py:99-109` too (4 * Cout <= 128, a TPU lane rule);
  * `ModelConfig.use_pallas_gru`: each BiGRU layer runs its recurrence in
    the GRU kernel, both directions in one launch, and its backward in the
    GRU backward kernel, one launch per layer.
On the CPU the same calls take the kernels' plain versions.

Dropout (training only) draws its masks from a torch.Generator the caller
passes to `forward`, so a step's masks depend on nothing global.

`forward(remat=True)` rematerialises each conv block and BiGRU layer in the
backward (`torch.utils.checkpoint`, non-reentrant), the counterpart of the
JAX trainer's `jax.checkpoint` over the forward: only each block's input is
kept, and the block runs again when its gradient is needed. The dropouts
stay outside the recomputed blocks, so their masks are drawn once, from the
caller's generator (checkpoint would restore only the default generators),
and remat changes memory, never numbers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from avsync_torch.config import ModelConfig
from avsync_torch.ops.conv import conv_relu_pool
from avsync_torch.ops.cuda.convpool import conv1_pool_block, fused_takes
from avsync_torch.ops.gru import GRUWeights, bigru
from avsync_torch.ops.precision import compute_dtype, dense


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


def inverted_dropout(x: torch.Tensor, mask_shape, rate: float, train: bool,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout at `rate` with a mask of `mask_shape` (broadcast over
    x) drawn from `generator`; identity unless training."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training with dropout needs an explicit torch.Generator")
    keep = torch.rand(mask_shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) * (1.0 / (1.0 - rate))


def remat_block(module: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """module(x), recomputed in the backward when `remat` (and grad is on)."""
    if remat and torch.is_grad_enabled():
        # no randomness inside: the recompute needs no RNG state
        return checkpoint(module, x, use_reentrant=False, preserve_rng_state=False)
    return module(x)


class ConvPoolBlock(nn.Module):
    """Conv3D(SAME) -> ReLU -> MaxPool3D(1,2,2) on NCDHW; params `weight`
    (Cout, Cin, kt, kh, kw) and `bias` (Cout,), initialised like nn.Conv3d.
    `fused`: the block may run the fused kernels (`conv1_pool_block`); it
    does where `fused_takes` says they take its input, weight and dtype
    (only ever a Cin = 1 block)."""

    def __init__(self, cin: int, cout: int, kernel_size: Tuple[int, int, int],
                 fused: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(cin * math.prod(kernel_size))
        self.weight = _uniform((cout, cin, *kernel_size), bound, generator)
        self.bias = _uniform((cout,), bound, generator)
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and fused_takes(x, self.weight):
            return conv1_pool_block(x, self.weight, self.bias)
        return conv_relu_pool(x, self.weight, self.bias)


class BiGRU(nn.Module):
    """Bidirectional single-layer GRU with nn.GRU's parameter names
    (`weight_ih_l0`, ..., `bias_hh_l0_reverse`) and initialisation. `tp`: set
    by `parallel.mesh.shard_model` when its weights are row shards;
    `compute_dtype`: bf16 rounds as `ops/gru.py` says."""

    tp = None

    def __init__(self, input_dim: int, hidden_dim: int, use_kernel: bool = False,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        H = hidden_dim
        bound = 1.0 / math.sqrt(H)
        for suffix in ("", "_reverse"):
            self.register_parameter(f"weight_ih_l0{suffix}",
                                    _uniform((3 * H, input_dim), bound, generator))
            self.register_parameter(f"weight_hh_l0{suffix}",
                                    _uniform((3 * H, H), bound, generator))
            self.register_parameter(f"bias_ih_l0{suffix}", _uniform((3 * H,), bound, generator))
            self.register_parameter(f"bias_hh_l0{suffix}", _uniform((3 * H,), bound, generator))
        self.use_kernel = use_kernel
        self.compute_dtype = compute_dtype

    def _weights(self, suffix: str) -> GRUWeights:
        return GRUWeights(getattr(self, f"weight_ih_l0{suffix}"),
                          getattr(self, f"weight_hh_l0{suffix}"),
                          getattr(self, f"bias_ih_l0{suffix}"),
                          getattr(self, f"bias_hh_l0{suffix}"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bigru(x, self._weights(""), self._weights("_reverse"), self.use_kernel,
                     self.tp, self.compute_dtype)


class Linear(nn.Module):
    """nn.Linear's params and init, drawn from an explicit generator. With
    `tp` (row shards of the output units) its outputs are gathered whole;
    with `compute_dtype` it is a Dense in that dtype (`ops/precision.dense`)."""

    tp = None

    def __init__(self, din: int, dout: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(din)
        self.weight = _uniform((dout, din), bound, generator)
        self.bias = _uniform((dout,), bound, generator)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_linear(x, self.weight, self.bias, self.tp, self.compute_dtype)


def tp_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, tp,
              dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """`dense(x, weight, bias, dt)`, or with `tp` the rows' slice of the
    outputs gathered whole."""
    if tp is None:
        return dense(x, weight, bias, dt)
    return tp.gather(dense(tp.enter(x), weight, bias, dt), -1)


class LipNet(nn.Module):
    """(B, T, H, W, 1) clips in [0, 1] -> (B, T, vocab) log-probs."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 img_hw: Tuple[int, int] = (50, 100),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "pytorch":
            raise NotImplementedError(
                f"LipNet is the 'pytorch' family, not {cfg.family!r}: the 'tf' family is "
                "models.lipnet_tf.TFLipNet (models.make_lipnet builds either)")
        self.cfg = cfg
        self.compute_dtype = dt = compute_dtype(cfg.compute_dtype)
        cin = 1
        h, w = img_hw
        for i, (ch, kern) in enumerate(zip(cfg.conv_channels, cfg.conv_kernels)):
            self.add_module(f"conv{i + 1}", ConvPoolBlock(
                cin, ch, tuple(kern), fused=cfg.fused_conv_pool, generator=generator))
            cin, h, w = ch, h // 2, w // 2
        self.conv_output_dim = cin * h * w
        dim = self.conv_output_dim
        for i in range(cfg.num_gru_layers):
            self.add_module(f"gru{i + 1}", BiGRU(
                dim, cfg.hidden_dim, use_kernel=cfg.use_pallas_gru, generator=generator,
                compute_dtype=dt))
            dim = 2 * cfg.hidden_dim
        self.fc = Linear(dim, cfg.vocab_size, generator=generator, compute_dtype=dt)

    def _conv_stack(self, x: torch.Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    remat: bool = False) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)  # (B, 1, T, H, W)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)  # the one rounding of the input
        for i in range(len(self.cfg.conv_channels)):
            x = remat_block(getattr(self, f"conv{i + 1}"), x, remat)
            # Dropout3d: whole channels, as the JAX broadcast dropout
            x = inverted_dropout(x, (*x.shape[:2], 1, 1, 1), self.cfg.dropout_rate, train,
                                 generator)
        B, C, T, h, w = x.shape
        return x.permute(0, 2, 1, 3, 4).reshape(B, T, C * h * w)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                remat: bool = False) -> torch.Tensor:
        """`train=True` applies dropout with masks from `generator`, a
        torch.Generator on the model's device (never the global RNG);
        `remat=True` recomputes each block in the backward."""
        x = self._conv_stack(x, train, generator, remat)
        for i in range(self.cfg.num_gru_layers):
            x = remat_block(getattr(self, f"gru{i + 1}"), x, remat)
            x = inverted_dropout(x, x.shape, self.cfg.dropout_rate, train, generator)
        return F.log_softmax(self.fc(x).float(), dim=-1)

    def conv_features(self, x: torch.Tensor) -> torch.Tensor:
        """Conv stack only: (B, T, C*h*w) float32 features in (C, H, W) order."""
        return self._conv_stack(x).float()


class ConvStack(nn.Module):
    """A LipNet's conv blocks alone (the same modules, so the same
    parameters) with LipNet's own `conv_features`: all that the misalignment
    detector's visual statistics read. `torch.export` stores every
    parameter of the module it traces, read or not, so the exported sync
    scorer holds this and no BiGRU or head weights."""

    def __init__(self, lipnet: LipNet):
        super().__init__()
        self.cfg, self.compute_dtype = lipnet.cfg, lipnet.compute_dtype
        for i in range(len(lipnet.cfg.conv_channels)):
            self.add_module(f"conv{i + 1}", getattr(lipnet, f"conv{i + 1}"))

    _conv_stack = LipNet._conv_stack
    conv_features = LipNet.conv_features
