"""The TF-family LipNet in PyTorch (port of `avsync/models/lipnet_tf.py`): the
Keras stack the reference trained (`train.py:495-547`).

Three [Conv3D(3x3x3, SAME) -> ReLU -> MaxPool3D(1,2,2)] blocks with channels
(128, 256, 64), flattened to (B, T, C*h*w), three BiLSTM(256) layers each
followed by elementwise inverted dropout (Keras `Dropout`, not the PyTorch
family's channel dropout), two Linear(512) + ReLU layers (He-normal init),
then Linear(vocab_size + 1 = 32) and log_softmax in float32. The CTC blank
is the LAST unit (31; `text.TF_BLANK_ID`). The default input geometry is the
TF stack's 75 x 46 x 140 with per-clip standardization
(`DataConfig.standardize_clips`).

The conv blocks are the PyTorch family's `ConvPoolBlock` without the fused
kernel (conv1 has 128 channels, past K1's gate): cuDNN with TF32 off. The
LSTM recurrence is the plain step loop of `ops/lstm.py`. Inside, activations
are NCDHW and the conv features flatten in (C, H, W) order, where the JAX
package flattens (H, W, C): `compat.tflipnet_params_from_jax` permutes the
first LSTM's input rows.

`compute_dtype="bfloat16"` (`TFModelConfig.compute_dtype`) computes as the
JAX TFLipNet class does under it (`avsync/models/lipnet_tf.py:75-102`): the
input rounded to bf16 once, the conv blocks in bf16 (their bias added in
bf16 after the conv's rounding, as `nn.Conv(dtype=bf16)`), the BiLSTMs from
bf16 operands into float32 (`ops/lstm.py`), the two Dense layers and the
head in bf16 (`ops/precision.dense`), log_softmax in float32. The family
switch (`models.make_lipnet`, `tf_model_config`) builds the float32 model
whatever `ModelConfig.compute_dtype` says, as the JAX one does.

Parameter names: `conv{i}.weight/bias`, `lstm{i}.weight_ih_l0[_reverse]`,
... (`nn.LSTM`'s), `dense{i}.weight/bias`, `head.weight/bias`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from avsync_torch.models.lipnet import (ConvPoolBlock, _uniform, inverted_dropout, remat_block,
                                        tp_linear)
from avsync_torch.ops.ctc import optax_ctc_nll
from avsync_torch.ops.lstm import LSTMWeights, bilstm
from avsync_torch.ops.precision import compute_dtype


@dataclass(frozen=True)
class TFModelConfig:
    vocab_size: int = 31  # StringLookup vocabulary_size() (`train.py:640`)
    hidden_dim: int = 256
    dropout_rate: float = 0.5
    conv_channels: Tuple[int, int, int] = (128, 256, 64)
    num_lstm_layers: int = 3
    dense_dim: int = 512
    compute_dtype: str = "float32"


def tf_model_config(model_cfg) -> TFModelConfig:
    """The TFModelConfig of a ModelConfig of family 'tf', as the JAX
    `make_lipnet` resolves it (`avsync/models/__init__.py:16-29`): its hidden
    size, dropout rate and resolved conv channels; three BiLSTM layers, Dense
    512, 31 + 1 outputs, and float32 compute whatever `model_cfg.compute_dtype`
    says, so every TF command computes in float32 as the JAX CLI's do. A bf16
    TF model is built from the class: `TFLipNet(TFModelConfig(compute_dtype=
    "bfloat16"))`."""
    return TFModelConfig(hidden_dim=model_cfg.hidden_dim, dropout_rate=model_cfg.dropout_rate,
                         conv_channels=tuple(model_cfg.conv_channels))


class BiLSTM(nn.Module):
    """Bidirectional single-layer LSTM with nn.LSTM's parameter names and
    initialisation (uniform in +-1/sqrt(H), as the JAX package's). `tp`: set
    by `parallel.mesh.shard_model` when its weights are row shards."""

    tp = None

    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        H = hidden_dim
        bound = 1.0 / math.sqrt(H)
        for suffix in ("", "_reverse"):
            self.register_parameter(f"weight_ih_l0{suffix}",
                                    _uniform((4 * H, input_dim), bound, generator))
            self.register_parameter(f"weight_hh_l0{suffix}",
                                    _uniform((4 * H, H), bound, generator))
            self.register_parameter(f"bias_ih_l0{suffix}", _uniform((4 * H,), bound, generator))
            self.register_parameter(f"bias_hh_l0{suffix}", _uniform((4 * H,), bound, generator))

    def _weights(self, suffix: str) -> LSTMWeights:
        return LSTMWeights(*(getattr(self, f"{n}_l0{suffix}")
                             for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bilstm(self._weights(""), self._weights("_reverse"), x, self.tp,
                      self.compute_dtype)


class HeLinear(nn.Module):
    """A Dense layer as Flax's with `he_normal`: weight (out, in) from a
    normal truncated at two standard deviations, scaled to variance 2/in;
    bias zeros. With `tp` (row shards) its outputs are gathered whole; with
    `compute_dtype` it computes in that dtype (`ops/precision.dense`)."""

    tp = None

    def __init__(self, din: int, dout: int, generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        std = math.sqrt(2.0 / din) / 0.87962566103423978  # Flax's truncation factor
        w = torch.empty(dout, din)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_linear(x, self.weight, self.bias, self.tp, self.compute_dtype)


class TFLipNet(nn.Module):
    """(B, T, H, W, 1) clips -> (B, T, vocab_size + 1) log-probs, blank last."""

    def __init__(self, cfg: TFModelConfig = TFModelConfig(),
                 img_hw: Tuple[int, int] = (46, 140),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dt = compute_dtype(cfg.compute_dtype)
        cin, (h, w) = 1, img_hw
        for i, ch in enumerate(cfg.conv_channels):
            self.add_module(f"conv{i + 1}", ConvPoolBlock(cin, ch, (3, 3, 3),
                                                          generator=generator))
            cin, h, w = ch, h // 2, w // 2
        self.conv_output_dim = dim = cin * h * w
        for i in range(cfg.num_lstm_layers):
            self.add_module(f"lstm{i + 1}", BiLSTM(dim, cfg.hidden_dim, generator=generator,
                                                   compute_dtype=dt))
            dim = 2 * cfg.hidden_dim
        self.dense1 = HeLinear(dim, cfg.dense_dim, generator, dt)
        self.dense2 = HeLinear(cfg.dense_dim, cfg.dense_dim, generator, dt)
        self.head = HeLinear(cfg.dense_dim, cfg.vocab_size + 1, generator, dt)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                remat: bool = False) -> torch.Tensor:
        """`train=True` applies dropout after each BiLSTM with masks from
        `generator` (a torch.Generator on the model's device); `remat=True`
        recomputes each conv block in the backward."""
        # the input in the compute dtype first thing, as the JAX TFLipNet: a
        # float32 model takes a bf16 cached batch as float32
        x = x.permute(0, 4, 1, 2, 3).to(self.compute_dtype or torch.float32)  # (B, 1, T, H, W)
        for i in range(len(self.cfg.conv_channels)):
            x = remat_block(getattr(self, f"conv{i + 1}"), x, remat)
        B, C, T, h, w = x.shape
        x = x.permute(0, 2, 1, 3, 4).reshape(B, T, C * h * w)
        for i in range(self.cfg.num_lstm_layers):
            x = getattr(self, f"lstm{i + 1}")(x)
            x = inverted_dropout(x, x.shape, self.cfg.dropout_rate, train, generator)
        x = F.relu(self.dense2(F.relu(self.dense1(x))))
        return F.log_softmax(self.head(x).float(), dim=-1)


def tf_ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Keras CTCLoss (`train.py:468-490`): blank = the last class, label
    lengths from count_nonzero(labels) (the reference's 'FIX': an OOV id 0
    drops out of the length), the per-sequence NLL neither divided by the
    label length nor zeroed when infeasible, averaged over the batch. As the
    JAX package's, through optax's recursion (`ops.ctc.optax_ctc_nll`), so
    that an infeasible sequence's loss and gradient are the JAX package's
    too."""
    lens = (labels != 0).sum(dim=1)
    return optax_ctc_nll(log_probs, labels, lens, blank_id=log_probs.shape[-1] - 1).mean()
