"""Serving API: load checkpoints once, predict many times (port of
`avsync/predictor.py`).

`LipReader` turns (T, H, W) frames or clips (`.npy` or container files)
into transcripts with greedy CTC, for either LipNet family (the TF family
decodes blank-last over its own vocabulary); `MisalignmentScorer` turns (frames, audio,
fps, shifts) into audio-visual sync probabilities. Both run on the card
unless the caller passes `device="cpu"`; with `device=None` and no GPU they
raise instead of falling back. Native-size frames take the ROI program of
`DataConfig.roi_mode` (heuristic, variance, the learned localizer, or the
host cascade's boxes under 'detector'), pre-cropped ones only /255, as
training does. `LipReader(quantize="int8")` serves the conv stack in int8.
`LipReader(devices=[...])` serves data-parallel (the JAX reader's `mesh`):
a replica of the weights per device, made once at load, each batch's rows
split into contiguous blocks, one block per device, the log-probs back in
row order. No collective is needed.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from avsync_torch import text as textlib
from avsync_torch.compat import (conv_shape_for, detector_params_from_jax,
                                 lipnet_params_from_jax, load_detector_pth,
                                 tflipnet_params_from_jax, unwrap_state_dict)
from avsync_torch.config import AvsyncConfig
from avsync_torch.data import video as videolib
from avsync_torch.features import visual_stats
from avsync_torch.models.detector import MisalignmentDetector
from avsync_torch.models import make_lipnet
from avsync_torch.ops import image as imglib
from avsync_torch.ops.audio import shifted_audio_stats
from avsync_torch.ops.conv import fp32_step
from avsync_torch.ops.quant import make_int8_forward, quantize_lipnet
from avsync_torch.utils.checkpoint import CheckpointManager


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when None; raises when None and there is no GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def pad_frames(frames: np.ndarray, cfg: AvsyncConfig) -> np.ndarray:
    """Host pad/truncate (T, H, W) raw frames to max_video_length, keeping
    the dtype (uint8 stays uint8; the float cast happens on the device)."""
    max_len = cfg.data.max_video_length
    frames = np.asarray(frames)
    if frames.shape[0] >= max_len:
        return frames[:max_len]
    pad = np.zeros((max_len - frames.shape[0],) + frames.shape[1:], frames.dtype)
    return np.concatenate([frames, pad], axis=0)


def load_localizer(cfg: AvsyncConfig, device=None):
    """The bundled localizer on `device` when cfg asks for roi_mode='model'
    (None with a warning when the bundle is missing: the heuristic crop
    then, `models.localizer.load_bundled_or_none`); None otherwise."""
    if cfg.data.roi_mode != "model":
        return None
    from avsync_torch.models.localizer import load_bundled_or_none

    return load_bundled_or_none(device)


def load_mouth_detector(cfg: AvsyncConfig):
    """The host cascade detector when cfg asks for roi_mode='detector'; None
    otherwise. Serving classes and the batcher construct it once."""
    if cfg.data.roi_mode != "detector":
        return None
    from avsync_torch.data.mouth import MouthDetector

    return MouthDetector()


def detect_boxes_host(frames: np.ndarray, mouth_detector) -> np.ndarray:
    """The cascade's mouth boxes of one padded clip -> (1, T, 4) float32
    (the cascade takes 8-bit frames, as training decodes them)."""
    return mouth_detector.detect_clip(
        np.ascontiguousarray(np.clip(frames, 0, 255)).astype(np.uint8))[None]


def preprocess(frames: torch.Tensor, cfg: AvsyncConfig, coords=None, boxes=None,
               localizer=None) -> torch.Tensor:
    """(B, T, H, W) raw frames on the device -> (B, T, h, w, 1) float32 model
    input, then per-clip standardization if configured. Native-size frames:
    the crop of `boxes` ((B, T, 4), the host cascade's) where given, else
    the ROI program of cfg.data.roi_mode (`data.pipeline.make_roi_crop_fn`,
    with `localizer` for 'model'); pre-cropped ones: plain /255. `coords`:
    the program's resize coordinates (`data.pipeline.roi_coords`), when the
    caller holds them."""
    d = cfg.data
    target = (d.img_height, d.img_width)
    if tuple(frames.shape[2:]) == target:
        out = (frames.float() * (1.0 / 255.0))[..., None]
    elif boxes is not None:
        out = (imglib.crop_resize_boxes(frames.float(), boxes, target) * (1.0 / 255.0))[..., None]
    else:
        from avsync_torch.data.pipeline import make_roi_crop_fn

        out = make_roi_crop_fn(d, d.roi_mode, localizer)(frames, coords)
    return imglib.standardize_clips(out) if d.standardize_clips else out


def raw_payload(frames: np.ndarray, cfg: AvsyncConfig, mouth_detector) -> tuple:
    """Host half of the raw transport: (T, H, W) frames -> (frames (1, T,
    H, W) padded, in their own dtype[, boxes (1, T, 4)] for native frames
    under 'detector'). Padding comes first, as in training: the ROI's
    statistics see the zero tail, as the batcher's do (boxes from unpadded
    frames differ by up to 0.86 on [0, 1] pixels at T=5)."""
    frames = pad_frames(frames, cfg)
    d = cfg.data
    if frames.shape[1:] != (d.img_height, d.img_width) and d.roi_mode == "detector":
        return (frames[None], detect_boxes_host(frames, mouth_detector or
                                                load_mouth_detector(cfg)))
    return (frames[None],)


def prepare_clip(frames: np.ndarray, cfg: AvsyncConfig, device: torch.device,
                 localizer=None, mouth_detector=None) -> torch.Tensor:
    """(T, H, W) uint8/float frames -> (1, max_len, h, w, 1) model input:
    `raw_payload` on the host, then `preprocess` on the device."""
    frames, *boxes = (torch.as_tensor(p).to(device)
                      for p in raw_payload(frames, cfg, mouth_detector))
    return preprocess(frames, cfg, boxes=boxes[0] if boxes else None, localizer=localizer)


def load_input_scales(scales, family: str) -> np.ndarray:
    """Per-layer int8 input scales from a `quantize` export (an `.npz` path,
    the JAX package's keys) or an array; a file exported for another model
    family raises."""
    if isinstance(scales, str):
        with np.load(scales) as z:
            zfam = str(z["family"]) if "family" in z else None
            if zfam is not None and zfam != family:
                raise ValueError(f"calibration scales exported for family {zfam!r}, "
                                 f"model is {family!r}")
            scales = z["input_scales"]
    return np.asarray(scales, np.float32)


def read_lipnet_checkpoint(checkpoint: str, cfg: AvsyncConfig) -> Dict[str, torch.Tensor]:
    """A LipNet state dict on the CPU from a reference `.pth` (either
    layout), a port checkpoint directory (its latest snapshot) or one of its
    snapshot files. A snapshot's embedded config names its model family,
    which must be the config's; a reference `.pth` holds the PyTorch family,
    so family 'tf' refuses one (ValueError, as the JAX package does)."""
    if os.path.isdir(checkpoint):
        payload, _ = CheckpointManager(checkpoint).restore()
    else:
        payload = torch.load(checkpoint, map_location="cpu", weights_only=False)
    saved = payload.get("config") if isinstance(payload, Mapping) else None
    family = json.loads(saved)["model"]["family"] if isinstance(saved, str) else None
    if family is None and cfg.model.family == "tf":
        raise ValueError("reference .pth checkpoints hold the PyTorch-family LipNet; "
                         "family='tf' models load from avsync_torch checkpoint directories "
                         "(or their epoch_N.pth snapshots)")
    if family is not None and family != cfg.model.family:
        raise ValueError(f"{checkpoint} holds a {family!r}-family LipNet; the config asks for "
                         f"{cfg.model.family!r} (--model_family)")
    return {k: torch.as_tensor(v) for k, v in unwrap_state_dict(payload).items()}


def lipnet_state(cfg: AvsyncConfig, checkpoint: Optional[str] = None,
                 params: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """LipNet weights in the port's layout from exactly one of a checkpoint
    (`read_lipnet_checkpoint`), a state dict, or the JAX package's nested
    param dict of either family (through the weight bridge)."""
    if (checkpoint is None) == (params is None):
        raise ValueError("pass exactly one of checkpoint= or params=")
    if checkpoint is not None:
        return read_lipnet_checkpoint(checkpoint, cfg)
    if "conv1.weight" in params:
        return dict(params)
    m = cfg.model
    if m.family == "tf":
        return tflipnet_params_from_jax(params, conv_shape_for(cfg),
                                        num_conv=len(m.conv_channels))
    return lipnet_params_from_jax(params, num_conv=len(m.conv_channels),
                                  num_gru=m.num_gru_layers, conv_shape=conv_shape_for(cfg))


def load_lipnet(cfg: AvsyncConfig, state: Mapping, device: torch.device):
    """An eval-mode LipNet of the configured family and geometry holding
    `state` (`models.make_lipnet`)."""
    d = cfg.data
    model = make_lipnet(cfg.model, (d.img_height, d.img_width), generator=torch.Generator())
    model.load_state_dict(state)
    return model.to(device).eval()


def refuse_tf_detector(cfg: AvsyncConfig) -> None:
    """The misalignment detector reads the PyTorch-family LipNet's conv
    features (`LipNet.conv_features`, as the JAX package's
    `features.visual_stats_fn`); a TF-family config raises ValueError."""
    if cfg.model.family == "tf":
        raise ValueError("the misalignment detector's visual features come from the "
                         "PyTorch-family LipNet's conv stack (LipNet.conv_features); the "
                         "'tf' family has none")


class LipReader:
    """Greedy-CTC lipreading from LipNet weights of either family
    (`cfg.model.family`; the model from `models.make_lipnet`, the decode
    from `text.family_decoder`).

    Weights come from `checkpoint` (`read_lipnet_checkpoint`: a reference
    `.pth`, either layout, or a port checkpoint directory or snapshot) or
    `params`: a state dict in the port's layout, or the JAX package's nested
    param dict, which goes through the weight bridge.

    `quantize="int8"` runs the conv stack in int8 (`ops/quant.py`: Q1 on the
    card, three launches per batch) with static activation scales; the
    recurrent layers and the head run in the config's compute dtype, and
    under bf16 the blocks end in Q1's bf16 epilogue and K2 takes bf16
    operands, as the JAX LipReader's int8 forward. Calibration runs in
    float32 whatever the dtype. Calibration sources, in order of
    precedence:
      1. `calibration_scales`: the per-layer input scales of a `quantize`
         export (an `.npz` path, from either package, or the (n_layers,)
         array); the deployment needs no calibration data;
      2. `calibration_frames`: a few representative (T, H, W) clips;
      3. lazily, the first batch predicted.

    `devices` (e.g. ["cuda:0", "cuda:1"]): data-parallel serving over those
    devices (`device` is then the first, where inputs are preprocessed and
    the log-probs come back). Every replica holds the same weights and, under
    int8, the same calibration scales.
    """

    def __init__(self, checkpoint: Optional[str] = None,
                 params: Optional[Mapping] = None,
                 config: Optional[AvsyncConfig] = None, device=None,
                 quantize: Optional[str] = None,
                 calibration_frames: Optional[Sequence[np.ndarray]] = None,
                 calibration_scales=None, devices: Optional[Sequence] = None):
        self.cfg = config or AvsyncConfig()
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            if not devices:
                raise ValueError("devices: an empty list")
            device = devices[0]
        self.device = resolve_device(device)
        self._localizer = load_localizer(self.cfg, self.device)
        self._mouth = load_mouth_detector(self.cfg)
        self.model = load_lipnet(self.cfg, lipnet_state(self.cfg, checkpoint, params),
                                 self.device)
        # (device, model) per replica; the first is self.model
        self.replicas = [(self.device, self.model)] + [
            (d, copy.deepcopy(self.model).to(d)) for d in (devices or [])[1:]]
        self._replica_qparams = None
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        self._quantize = quantize
        self._qparams = None
        # set (briefly) by TranscribeService.warmup: warm-up's dummy frames
        # must never become the persistent int8 calibration set
        self._warming = False
        if quantize == "int8":
            self._qfwd = make_int8_forward(self.cfg.model)
            if calibration_scales is not None:
                self._qparams = quantize_lipnet(
                    self.model, [], input_scales=load_input_scales(calibration_scales,
                                                                   self.cfg.model.family))
            elif calibration_frames:
                self._qparams = quantize_lipnet(
                    self.model, [self._prepare(f) for f in calibration_frames])

    def _prepare(self, frames: np.ndarray) -> torch.Tensor:
        return prepare_clip(frames, self.cfg, self.device, self._localizer, self._mouth)

    def prepare_raw(self, frames: np.ndarray):
        """Host half of the raw serving transport: (T, H, W) frames -> a
        payload tuple (frames (1, T, H, W)[, boxes (1, T, 4)]), dtype kept
        (uint8 ships 4x fewer bytes than float32). `preprocess_device` is
        the device half; together they compute `_prepare`, batched."""
        return raw_payload(frames, self.cfg, self._mouth)

    def preprocess_device(self, frames, boxes=None) -> torch.Tensor:
        """(B, T, H, W) raw frames [+ (B, T, 4) boxes] -> (B, T, h, w, 1)
        model input on the device."""
        if boxes is not None:
            boxes = torch.as_tensor(boxes).to(self.device)
        return preprocess(torch.as_tensor(frames).to(self.device), self.cfg, boxes=boxes,
                          localizer=self._localizer)

    def _logprobs(self, clips: torch.Tensor) -> torch.Tensor:
        if len(self.replicas) > 1:
            return self._logprobs_dp(clips)
        with fp32_step(), torch.inference_mode():
            clips = clips.to(self.device)
            if self._quantize is None:
                return self.model(clips)
            if self._qparams is None:  # lazy calibration on the first input
                qp = quantize_lipnet(self.model, [clips])
                if self._warming:
                    # throwaway params: warm-up's all-zero frames would set
                    # every scale to the absmax-0 fallback (1.0), and real
                    # [0, 1] inputs would then round to 0 or 1 for good
                    return self._qfwd(qp, clips)
                self._qparams = qp
            return self._qfwd(self._qparams, clips)

    def _logprobs_dp(self, clips: torch.Tensor) -> torch.Tensor:
        """Data-parallel: contiguous blocks of rows, one per replica, each on
        its device (launched in turn, without waiting), back in row order."""
        blocks = torch.tensor_split(clips, len(self.replicas))
        with fp32_step(), torch.inference_mode():
            if self._quantize is not None:
                if self._qparams is None:  # lazy calibration on the first input
                    qp = quantize_lipnet(self.model, [clips.to(self.device)])
                    if self._warming:
                        return self._qfwd(qp, clips.to(self.device))
                    self._qparams = qp
                if self._replica_qparams is None:
                    scales = np.asarray([float(c.x_scale) for c in self._qparams.convs],
                                        np.float32)
                    self._replica_qparams = [self._qparams] + [
                        quantize_lipnet(m, [], input_scales=scales)
                        for _, m in self.replicas[1:]]
            outs = []
            for i, ((dev, model), block) in enumerate(zip(self.replicas, blocks)):
                if block.shape[0] == 0:
                    continue
                block = block.to(dev)
                outs.append(model(block) if self._quantize is None
                            else self._qfwd(self._replica_qparams[i], block))
            return torch.cat([o.to(self.device) for o in outs], dim=0)

    def _decode(self, log_probs) -> List[str]:
        return textlib.family_decoder(self.cfg.model.family)(log_probs)

    def predict_frames(self, frames: np.ndarray) -> str:
        return self._decode(self._logprobs(self._prepare(frames)))[0]

    def _load(self, video_path: str) -> np.ndarray:
        return videolib.decode_frames(video_path, self.cfg.data.max_video_length)

    def predict(self, video_path: str) -> str:
        return self.predict_frames(self._load(video_path))

    def predict_batch(self, video_paths: Sequence[str]) -> List[str]:
        """Batched path: decode every clip on the host, one upload, one batched
        preprocess, one forward, one decode. Clips of differing geometry are
        preprocessed one by one and then batched."""
        rows = [self.prepare_raw(self._load(p)) for p in video_paths]
        if len({tuple((p.shape, p.dtype.str) for p in r) for r in rows}) == 1:
            clips = self.preprocess_device(*(np.concatenate(parts, axis=0)
                                             for parts in zip(*rows)))
        else:
            clips = torch.cat([self.preprocess_device(*r) for r in rows], dim=0)
        return self._decode(self._logprobs(clips))


class MisalignmentScorer:
    """Audio-visual sync probability for (clip, shift) pairs.

    Weights: the detector from `detector_checkpoint` (a reference detector
    `.pth`) or `detector_params` (a state dict, or the JAX package's
    {"fc1", "fc2"} params, which go through the weight bridge); the frozen
    LipNet from `lipnet_checkpoint` or `lipnet_params`, as `LipReader` takes
    them. One batch of B requests x K shifts runs the device preprocess, the
    conv visual statistics (K1 with `ModelConfig.fused_conv_pool`), the
    shift -> MFCC -> statistics of all B*K audio rows at once (K5 with
    `AudioConfig.use_pallas`) and the detector, with TF32 off.
    """

    def __init__(self, detector_checkpoint: Optional[str] = None,
                 lipnet_checkpoint: Optional[str] = None,
                 config: Optional[AvsyncConfig] = None, device=None,
                 detector_params: Optional[Mapping] = None,
                 lipnet_params: Optional[Mapping] = None):
        self.cfg = config or AvsyncConfig()
        refuse_tf_detector(self.cfg)
        self.device = resolve_device(device)
        self._localizer = load_localizer(self.cfg, self.device)
        self._mouth = load_mouth_detector(self.cfg)
        if (detector_checkpoint is None) == (detector_params is None):
            raise ValueError("pass exactly one of detector_checkpoint= or detector_params=")
        n_audio = 2 * self.cfg.audio.n_mfcc
        if detector_checkpoint is not None:
            det_state, meta = load_detector_pth(detector_checkpoint)
        elif "fc1" in detector_params:
            det_state, meta = detector_params_from_jax(
                detector_params, conv_shape_for(self.cfg), n_audio), {}
        else:
            det_state, meta = dict(detector_params), {}
        w1 = det_state["classifier.0.weight"]
        hidden = int(meta.get("hidden_dim", w1.shape[0]))
        self.detector = MisalignmentDetector(w1.shape[1], hidden, self.cfg.detector.dropout,
                                             generator=torch.Generator())
        self.detector.load_state_dict(det_state)
        self.detector.to(self.device).eval()
        self.lipnet = load_lipnet(self.cfg, lipnet_state(self.cfg, lipnet_checkpoint,
                                                         lipnet_params), self.device)

    def prepare_raw(self, frames: np.ndarray, audio: np.ndarray, fps: float,
                    shifts: Sequence[int] = (0,)):
        """Host half: one request -> payload (frames (1, T, H, W) in their
        own dtype[, boxes (1, T, 4) under 'detector'], audio (1, S) float32
        zero-padded, audio_len (1,) int32, fps (1,) float32, shifts (1, K)
        int32)."""
        S = self.cfg.audio.max_audio_samples
        a = np.asarray(audio, np.float32)[:S]
        buf = np.zeros((1, S), np.float32)
        buf[0, :len(a)] = a
        return raw_payload(frames, self.cfg, self._mouth) + (
            buf, np.array([len(a)], np.int32), np.array([fps], np.float32),
            np.asarray(shifts, np.int32)[None])

    def score_payload_batch(self, payload) -> List[np.ndarray]:
        """Device half: a stacked payload of B rows -> B arrays of K sync
        probabilities."""
        frames, *boxes = (torch.as_tensor(p).to(self.device) for p in payload[:-4])
        audio, lens, fps, shifts = (torch.as_tensor(p).to(self.device) for p in payload[-4:])
        B, K = shifts.shape
        with fp32_step(), torch.inference_mode():
            clips = preprocess(frames, self.cfg, boxes=boxes[0] if boxes else None,
                               localizer=self._localizer)
            vis = visual_stats(self.lipnet, clips)
            astats = shifted_audio_stats(audio.repeat_interleave(K, 0),
                                         lens.repeat_interleave(K), shifts.reshape(-1),
                                         fps.repeat_interleave(K), self.cfg.audio)
            feats = torch.cat([vis.repeat_interleave(K, 0), astats], dim=-1)
            probs = torch.sigmoid(self.detector(feats)).reshape(B, K)
        return list(probs.cpu().numpy())

    def score_arrays(self, frames: np.ndarray, audio: np.ndarray, fps: float,
                     shifts: Sequence[int] = (0,)) -> np.ndarray:
        """(T, H, W) frames + mono audio at the configured rate -> (K,) sync
        probabilities, one per shift (in video frames)."""
        return self.score_payload_batch(self.prepare_raw(frames, audio, fps, shifts))[0]

    def score(self, video_path: str, shift_frames: int = 0) -> float:
        """Sync probability of a clip and its audio (a sibling `.wav`, else
        the container's own stream)."""
        frames, audio, fps = videolib.decode_av(video_path, self.cfg)
        return float(self.score_arrays(frames, audio, fps, shifts=(shift_frames,))[0])
