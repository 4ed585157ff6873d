"""Models of the port."""

from typing import Optional, Tuple

import torch

from avsync_torch.models.detector import MisalignmentDetector
from avsync_torch.models.lipnet import LipNet
from avsync_torch.models.lipnet_tf import TFLipNet, tf_model_config


def make_lipnet(model_cfg, img_hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None):
    """The one family switch (`avsync/models/__init__.py:7-27`): 'pytorch'
    builds the Conv3D(32/64/96) + BiGRU LipNet (blank 0), 'tf' the
    Conv3D(128/256/64) + 3xBiLSTM TFLipNet (blank last). Every consumer
    (trainer, CLI, predictor, export, quantization) builds through it. The
    TF stack takes the config's resolved `conv_channels`, so an explicit
    (32, 64, 96) TF stack is representable, and computes in float32 whatever
    `model_cfg.compute_dtype` says, as the JAX switch builds it
    (`tf_model_config`); `fused_conv_pool` puts its conv1 on the fused
    kernels as LipNet's."""
    if model_cfg.family != "tf":
        return LipNet(model_cfg, img_hw=img_hw, generator=generator)
    return TFLipNet(tf_model_config(model_cfg), img_hw=img_hw, generator=generator,
                    fused_conv_pool=model_cfg.fused_conv_pool)


__all__ = ["LipNet", "TFLipNet", "MisalignmentDetector", "make_lipnet"]
