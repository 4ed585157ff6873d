"""Reference `.pth` checkpoints and the weight bridge from the JAX package.

The port's `LipNet` keeps the reference PyTorch key names and layouts
(`conv1.weight` (O, I, kt, kh, kw), `gru1.weight_ih_l0` (3H, D), `fc.weight`
(out, in), ...), so a reference checkpoint loads with `load_state_dict`.

`lipnet_params_from_jax` turns the JAX package's LipNet params (a nested dict
of numpy arrays, as `avsync.models.LipNet` initializes or restores them) into
that state dict:

  * Flax conv kernel (kt, kh, kw, I, O)  ->  Conv3d weight (O, I, kt, kh, kw)
  * GRU w_ih / w_hh (D, 3H)              ->  (3H, D); same [r, z, n] order
  * The FIRST GRU's input features are flattened conv maps: the JAX package
    orders them (H, W, C), the reference and the port (C, H, W), so that
    GRU's input rows are permuted.
  * Dense kernel (in, out)               ->  Linear weight (out, in)

`lipnet_params_to_jax` is its inverse: it hands a port-trained model (or a
dict of its gradients) back in the JAX package's layout.

`tflipnet_params_from_jax` / `tflipnet_params_to_jax` do the same for the
TF-family LipNet (`models/lipnet_tf.py`): conv kernels as above, LSTM
w_ih / w_hh (D, 4H) -> (4H, D) with the first LSTM's input rows permuted
between (H, W, C) and (C, H, W) order, Dense kernels (in, out) -> (out, in).

`quant_params_from_jax` carries the JAX package's int8 serving params
(`avsync.ops.quant.QuantLipNetParams`) across: each int8 kernel from (kt, kh,
kw, Cin, Cout) to (Cout, Cin, kt, kh, kw), its scales and bias as they are,
the float params through `lipnet_params_from_jax`. The bf16 epilogue's s16
and b16 are made from them as the JAX block makes its own (one rounding of
the f32 x_scale * k_scale and bias), so the same params serve either
compute dtype unchanged (tests/test_torch_int8_bf16.py).

The misalignment detector crosses the same way (`detector_params_from_jax`
/ `detector_params_to_jax`): its fc1 reads visual statistics that the JAX
package orders (H, W, C) and the reference and the port (C, H, W), so fc1's
mean and std column blocks are permuted; a reference detector `.pth`
(`load_detector_pth` / `save_detector_pth`) needs no permutation.

`localizer_params_from_jax` carries the mouth localizer's Flax params (the
bundle's flat `conv1/kernel`, ... arrays, or the nested tree): conv kernels
HWIO -> OIHW, Dense kernels (in, out) -> Linear weights (out, in).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from avsync_torch.ops.quant import QuantConvParams, QuantLipNetParams, quant_conv_params

# Conv-output geometry for the default 50x100 input: (C, H, W).
DEFAULT_CONV_SHAPE: Tuple[int, int, int] = (96, 6, 12)


def conv_shape_for(cfg) -> Tuple[int, int, int]:
    """(C, H, W) of the conv-stack output for an AvsyncConfig's geometry."""
    h, w = cfg.data.img_height, cfg.data.img_width
    for _ in cfg.model.conv_channels:
        h, w = h // 2, w // 2
    return (cfg.model.conv_channels[-1], h, w)


def chw_to_hwc_perm(conv_shape: Tuple[int, int, int]) -> np.ndarray:
    """Index array p with hwc_flat = chw_flat[p]: position i of the (H, W, C)
    flattening holds element p[i] of the (C, H, W) flattening."""
    C, H, W = conv_shape
    return np.arange(C * H * W).reshape(C, H, W).transpose(1, 2, 0).reshape(-1)


def unwrap_state_dict(ckpt: Mapping[str, Any]) -> Mapping[str, Any]:
    """Both reference layouts: a bare state dict, or one wrapped under
    'model_state_dict' beside epoch/optimizer entries."""
    if "model_state_dict" in ckpt:
        return ckpt["model_state_dict"]
    return ckpt


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference LipNet `.pth` (either layout) as a state dict on the
    CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {k: torch.as_tensor(v) for k, v in unwrap_state_dict(ckpt).items()}


def _np32(t) -> np.ndarray:
    t = t.detach().cpu() if hasattr(t, "detach") else t
    return np.ascontiguousarray(np.asarray(t, dtype=np.float32))


def _torch32(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}


def _convs_from_jax(params, num_conv: int, sd: Dict[str, np.ndarray]) -> None:
    for i in range(1, num_conv + 1):
        conv = params[f"conv{i}"]
        sd[f"conv{i}.weight"] = np.asarray(conv["kernel"]).transpose(4, 3, 0, 1, 2)
        sd[f"conv{i}.bias"] = np.asarray(conv["bias"])


def _convs_to_jax(sd, num_conv: int, params: Dict[str, Any]) -> None:
    for i in range(1, num_conv + 1):
        params[f"conv{i}"] = {"kernel": _np32(sd[f"conv{i}.weight"]).transpose(2, 3, 4, 1, 0),
                              "bias": _np32(sd[f"conv{i}.bias"])}


def _rnn_from_jax(params, prefix: str, num_layers: int, conv_shape,
                  sd: Dict[str, np.ndarray]) -> None:
    """Bidirectional recurrent layers `{prefix}1..n` (GRU or LSTM: the same
    keys), w (D, kH) -> (kH, D); the first layer's input rows go from (H, W,
    C) to (C, H, W) order."""
    inv = np.argsort(chw_to_hwc_perm(conv_shape))  # chw_flat = hwc_flat[inv]
    for g in range(1, num_layers + 1):
        layer = params[f"{prefix}{g}"]
        for suffix, name in (("", "fwd"), ("_reverse", "bwd")):
            w_ih = np.asarray(layer[f"w_ih_{name}"]).T
            if g == 1:
                w_ih = w_ih[:, inv]
            sd[f"{prefix}{g}.weight_ih_l0{suffix}"] = w_ih
            sd[f"{prefix}{g}.weight_hh_l0{suffix}"] = np.asarray(layer[f"w_hh_{name}"]).T
            sd[f"{prefix}{g}.bias_ih_l0{suffix}"] = np.asarray(layer[f"b_ih_{name}"])
            sd[f"{prefix}{g}.bias_hh_l0{suffix}"] = np.asarray(layer[f"b_hh_{name}"])


def _rnn_to_jax(sd, prefix: str, num_layers: int, conv_shape, params: Dict[str, Any]) -> None:
    perm = chw_to_hwc_perm(conv_shape)
    for g in range(1, num_layers + 1):
        layer: Dict[str, np.ndarray] = {}
        for suffix, name in (("", "fwd"), ("_reverse", "bwd")):
            w_ih = _np32(sd[f"{prefix}{g}.weight_ih_l0{suffix}"])
            if g == 1:
                w_ih = w_ih[:, perm]
            layer[f"w_ih_{name}"] = w_ih.T
            layer[f"w_hh_{name}"] = _np32(sd[f"{prefix}{g}.weight_hh_l0{suffix}"]).T
            layer[f"b_ih_{name}"] = _np32(sd[f"{prefix}{g}.bias_ih_l0{suffix}"])
            layer[f"b_hh_{name}"] = _np32(sd[f"{prefix}{g}.bias_hh_l0{suffix}"])
        params[f"{prefix}{g}"] = layer


def lipnet_params_from_jax(
    params: Mapping[str, Any],
    num_conv: int = 3,
    num_gru: int = 2,
    conv_shape: Tuple[int, int, int] = DEFAULT_CONV_SHAPE,
) -> Dict[str, torch.Tensor]:
    """JAX-layout LipNet params (nested dict of arrays) -> the port's
    float32 state dict."""
    sd: Dict[str, np.ndarray] = {}
    _convs_from_jax(params, num_conv, sd)
    _rnn_from_jax(params, "gru", num_gru, conv_shape, sd)
    sd["fc.weight"] = np.asarray(params["fc"]["kernel"]).T
    sd["fc.bias"] = np.asarray(params["fc"]["bias"])
    return _torch32(sd)


_TF_DENSE = ("dense1", "dense2", "head")


def tflipnet_params_from_jax(
    params: Mapping[str, Any],
    conv_shape: Tuple[int, int, int],
    num_conv: int = 3,
    num_lstm: int = 3,
) -> Dict[str, torch.Tensor]:
    """JAX-layout TFLipNet params -> the port's float32 `TFLipNet` state
    dict: conv kernels DHWIO -> OIDHW, LSTM w_ih / w_hh (D, 4H) -> (4H, D)
    (the first LSTM's input rows, both directions, from (H, W, C) to (C, H,
    W) order over `conv_shape`, (64, 5, 17) at 46x140), Dense kernels (in,
    out) -> (out, in); biases as they are."""
    sd: Dict[str, np.ndarray] = {}
    _convs_from_jax(params, num_conv, sd)
    _rnn_from_jax(params, "lstm", num_lstm, conv_shape, sd)
    for name in _TF_DENSE:
        sd[f"{name}.weight"] = np.asarray(params[name]["kernel"]).T
        sd[f"{name}.bias"] = np.asarray(params[name]["bias"])
    return _torch32(sd)


def tflipnet_params_to_jax(
    state_dict: Mapping[str, Any],
    conv_shape: Tuple[int, int, int],
    num_conv: int = 3,
    num_lstm: int = 3,
) -> Dict[str, Any]:
    """The inverse of `tflipnet_params_from_jax` (also for a same-keyed dict
    of gradients): the JAX package's nested float32 numpy params."""
    sd = unwrap_state_dict(state_dict)
    params: Dict[str, Any] = {}
    _convs_to_jax(sd, num_conv, params)
    _rnn_to_jax(sd, "lstm", num_lstm, conv_shape, params)
    for name in _TF_DENSE:
        params[name] = {"kernel": _np32(sd[f"{name}.weight"]).T,
                        "bias": _np32(sd[f"{name}.bias"])}
    return params


def localizer_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The localizer's JAX params, flat ("conv1/kernel") or nested
    ({"conv1": {"kernel"}}), -> the port's float32 `MouthLocalizer` state
    dict."""
    flat: Dict[str, Any] = {}
    for key, value in params.items():
        if isinstance(value, Mapping):
            flat.update({f"{key}/{k}": v for k, v in value.items()})
        else:
            flat[key] = value
    sd = {}
    for key, value in flat.items():
        layer, kind = key.split("/")
        a = np.asarray(value)
        if kind == "kernel":
            sd[f"{layer}.weight"] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        else:
            sd[f"{layer}.bias"] = a
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def lipnet_params_to_jax(
    state_dict: Mapping[str, Any],
    num_conv: int = 3,
    num_gru: int = 2,
    conv_shape: Tuple[int, int, int] = DEFAULT_CONV_SHAPE,
) -> Dict[str, Any]:
    """The inverse of `lipnet_params_from_jax`: the port's state dict (or a
    same-keyed dict of gradients) -> the JAX package's nested param dict of
    float32 numpy arrays, the first GRU's input rows permuted back from
    (C, H, W) to (H, W, C) order."""
    sd = unwrap_state_dict(state_dict)
    params: Dict[str, Any] = {}
    _convs_to_jax(sd, num_conv, params)
    _rnn_to_jax(sd, "gru", num_gru, conv_shape, params)
    params["fc"] = {"kernel": _np32(sd["fc.weight"]).T, "bias": _np32(sd["fc.bias"])}
    return params


def quant_conv_from_jax(qc: Any) -> QuantConvParams:
    """One JAX `QuantConvParams` block -> the port's, on the CPU: kernel_q
    (kt, kh, kw, Cin, Cout) -> (Cout, Cin, kt, kh, kw); k_scale, bias and
    x_scale as they are."""
    kq = np.ascontiguousarray(np.asarray(qc.kernel_q, np.int8).transpose(4, 3, 0, 1, 2))
    return quant_conv_params(torch.from_numpy(kq),
                             torch.from_numpy(np.array(qc.k_scale, np.float32).reshape(-1)),
                             torch.from_numpy(np.array(qc.bias, np.float32)),
                             np.float32(np.asarray(qc.x_scale)))


def quant_params_from_jax(
    qp: Any,
    num_gru: int = 2,
    conv_shape: Tuple[int, int, int] = DEFAULT_CONV_SHAPE,
) -> QuantLipNetParams:
    """A JAX `QuantLipNetParams` (its arrays as numpy or jax arrays) -> the
    port's `avsync_torch.ops.quant.QuantLipNetParams` on the CPU."""
    convs = [quant_conv_from_jax(c) for c in qp.convs]
    return QuantLipNetParams(
        convs=tuple(convs),
        float_params=lipnet_params_from_jax(qp.float_params, num_conv=len(convs),
                                            num_gru=num_gru, conv_shape=conv_shape))


def _cpu32(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32).contiguous()
            for k, v in state_dict.items()}


def save_lipnet_pth(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a state dict as a reference-loadable bare `.pth` (CPU float32)."""
    torch.save(_cpu32(state_dict), path)


# ---------------------------------------------------------------------------
# misalignment detector
# ---------------------------------------------------------------------------

def _detector_column_perm(conv_shape: Tuple[int, int, int], n_audio_feats: int) -> np.ndarray:
    """p with jax_cols = torch_cols[p] for fc1's input columns: the mean and
    the std blocks of the visual statistics go from (C, H, W) to (H, W, C)
    order; the audio statistics stay put (`avsync/compat.py:146-154`)."""
    vis = int(np.prod(conv_shape))
    perm = chw_to_hwc_perm(conv_shape)
    return np.concatenate([perm, perm + vis, np.arange(2 * vis, 2 * vis + n_audio_feats)])


def detector_params_from_jax(params: Mapping[str, Any],
                             conv_shape: Tuple[int, int, int] = DEFAULT_CONV_SHAPE,
                             n_audio_feats: int = 40) -> Dict[str, torch.Tensor]:
    """The JAX package's detector params ({"fc1": {kernel (in, hidden),
    bias}, "fc2": ...}, arrays) -> the port's float32 state dict under the
    reference key names, fc1's visual columns permuted back to (C, H, W)."""
    w1 = np.asarray(params["fc1"]["kernel"]).T  # (hidden, in), JAX column order
    full = _detector_column_perm(conv_shape, n_audio_feats)
    if w1.shape[1] != len(full):
        raise ValueError(f"detector input_dim {w1.shape[1]} != {len(full)} for conv shape "
                         f"{conv_shape} and {n_audio_feats} audio statistics")
    sd = {"classifier.0.weight": w1[:, np.argsort(full)],
          "classifier.0.bias": np.asarray(params["fc1"]["bias"]),
          "classifier.3.weight": np.asarray(params["fc2"]["kernel"]).T,
          "classifier.3.bias": np.asarray(params["fc2"]["bias"])}
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def detector_params_to_jax(state_dict: Mapping[str, Any],
                           conv_shape: Tuple[int, int, int] = DEFAULT_CONV_SHAPE,
                           n_audio_feats: int = 40) -> Dict[str, Any]:
    """The inverse of `detector_params_from_jax` (also for a same-keyed dict
    of gradients): nested float32 numpy arrays in the JAX layout."""
    sd = _cpu32(unwrap_state_dict(state_dict))
    w1 = sd["classifier.0.weight"].numpy()[:, _detector_column_perm(conv_shape, n_audio_feats)]
    return {"fc1": {"kernel": np.ascontiguousarray(w1.T),
                    "bias": sd["classifier.0.bias"].numpy()},
            "fc2": {"kernel": np.ascontiguousarray(sd["classifier.3.weight"].numpy().T),
                    "bias": sd["classifier.3.bias"].numpy()}}


def load_detector_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A detector `.pth` (the reference's self-describing layout, or a bare
    state dict) -> (state dict on the CPU, metadata: input_dim / hidden_dim /
    config where saved)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    meta = {k: ckpt[k] for k in ("input_dim", "hidden_dim", "config") if k in ckpt}
    return {k: torch.as_tensor(v) for k, v in unwrap_state_dict(ckpt).items()}, meta


def save_detector_pth(state_dict: Mapping[str, torch.Tensor], path: str, input_dim: int,
                      hidden_dim: int, config: Mapping[str, Any]) -> None:
    """Write a detector checkpoint in the reference's self-describing layout
    (`misalignment_detection_train.py:312-318`): model_state_dict (CPU
    float32), input_dim, hidden_dim, config."""
    torch.save({"model_state_dict": _cpu32(state_dict), "input_dim": int(input_dim),
                "hidden_dim": int(hidden_dim), "config": dict(config)}, path)
