"""Single dataclass-tree configuration — the port's own copy of `avsync.config`.

Same dataclasses, same field names and defaults, same JSON, so a config
written by either package loads in the other (tests/test_torch_import.py
round-trips one). The port keeps a copy instead of importing `avsync.config`
so that `avsync_torch` imports nothing of the JAX package. Fields that only
the JAX package reads (mesh, roi_host, the one-hot gather crossover, ...)
are kept for the JSON; the kernel flags `use_pallas_gru` / `fused_conv_pool`
/ `AudioConfig.use_pallas` route the GRU recurrence, conv1 and the MFCC
stage to the hand-written CUDA kernels on the card.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Dataset / preprocessing parameters.

    Mirrors the reference's PyTorch-stack geometry (`dataset.py:15-17`):
    100x50 grayscale mouth crops, 75-frame clips, /255 normalization, and the
    heuristic mouth ROI (lower 40% of rows, middle 40% of columns,
    `dataset.py:216-218`).
    """

    data_path: str = "./data"
    img_width: int = 100
    img_height: int = 50
    max_video_length: int = 75
    max_label_length: int = 40
    # Heuristic mouth ROI fractions (row_start, col_start, col_end).
    mouth_crop: Tuple[float, float, float] = (0.6, 0.3, 0.7)
    # ROI strategy: 'heuristic' = fixed fractions above (`dataset.py:216-218`);
    # 'detector' = host MouthDetector boxes (dlib/Haar-equivalent,
    # `train.py:126-188`) + device crop; 'variance' = fully on-device
    # temporal-variance localization (avsync.ops.image.variance_mouth_boxes);
    # 'model' = learned on-device box regressor with bundled weights
    # (avsync.models.localizer; falls back to 'heuristic' with a warning if
    # the weights file is missing). Weights provenance: trained on the
    # synthetic mouth-ellipse distribution (scripts/train_localizer.py).
    # The port implements 'heuristic' only so far; the others raise
    # NotImplementedError there.
    roi_mode: str = "heuristic"
    # JAX package: run the ROI program on the host and ship uint8 crops
    # instead of full frames. The port's LipNetBatcher raises for it on
    # native-size frames (the host crop is not ported); pre-cropped clips
    # and the serving paths, which the JAX package never crops on the host,
    # ignore it.
    roi_host: bool = False
    # Per-clip standardization instead of /255 (the TF stack's convention,
    # `train.py:266-273`); off by default for parity with the PyTorch stack.
    standardize_clips: bool = False
    batch_size: int = 8
    shuffle_seed: int = 42
    # Train/val/test fractions over speakers (`main.py:63-77`).
    split: Tuple[float, float, float] = (0.7, 0.15, 0.15)
    # Known-bad clip basenames to skip, like the reference's exclude list of
    # corrupt GRID videos (`train.py:650-653`).
    exclude: Tuple[str, ...] = ()
    # Host decode threads per batch (the reference's DataLoader(num_workers=4),
    # `main.py:133`); np.load and the native ingest release the GIL.
    loader_threads: int = 4
    # Device-resident preprocessed-corpus cache: 'auto' pins the whole
    # preprocessed corpus in device memory from the second epoch on when it
    # fits device_cache_budget_mb, making epoch 2+ batches pure on-device
    # gathers (no host decode, no H2D). 'on' forces it, 'off' always
    # streams. Identical batch contents either way (tests/test_data.py).
    device_cache: str = "auto"
    device_cache_budget_mb: int = 4096
    # Cache element dtype. 'auto' picks the smallest LOSSLESS layout:
    #   * uint8 when the first decoded batch proves every preprocessed value
    #     is exactly k/255 (preprocessed/roi_host corpora, whose device
    #     preprocess is u8 * (1/255)) — 4x the clips per budget MB and the
    #     gather reproduces the streamed f32 values bit-for-bit;
    #   * else bfloat16 when the MODEL computes in bfloat16 (the accelerator
    #     default) — 2x capacity, and the model's entry cast makes it
    #     invisible to training (bf16(f32(bf16(x))) == bf16(x));
    #   * else float32 (raw batches themselves bit-identical).
    # Explicit 'float32'/'bfloat16' skip the probe and force the dtype.
    device_cache_dtype: str = "auto"
    # Cache-gather formulation crossover of the JAX package's data
    # pipeline (one-hot matmul below, jnp.take above). Kept for the JSON:
    # the port gathers with index_select at any size.
    cache_gather_onehot_max_mb: int = 768


@dataclass(frozen=True)
class ModelConfig:
    """LipNet encoder hyperparameters (`model.py:10-48`).

    family selects the model stack: 'pytorch' is the Conv3D(32/64/96)+BiGRU
    encoder with blank=0 CTC (`model.py`); 'tf' is the Keras-stack
    Conv3D(128/256/64)+3xBiLSTM encoder with blank-last CTC
    (`train.py:495-547`) — see avsync.models.lipnet_tf.

    conv_channels applies to whichever family is selected. Leaving it None
    resolves to the family's reference widths at construction time —
    (32, 64, 96) for 'pytorch' (`model.py:16-20`), (128, 256, 64) for 'tf'
    (`train.py:505-521`) — so an EXPLICIT (32, 64, 96) on a tf-family config
    builds exactly that model (it is not a sentinel).
    """

    family: str = "pytorch"
    vocab_size: int = 39  # 37 chars + blank(0) + <pad> (`dataset.py:41-46`)
    hidden_dim: int = 256
    dropout_rate: float = 0.5
    conv_channels: Optional[Tuple[int, int, int]] = None
    conv_kernels: Tuple[Tuple[int, int, int], ...] = (
        (3, 5, 5),
        (3, 5, 5),
        (3, 3, 3),
    )
    num_gru_layers: int = 2
    # Compute dtype for conv/GRU matmuls; params are kept in float32.
    # "bfloat16" rounds where the JAX package does (models/lipnet.py,
    # ops/precision.py, ops/quant.py). The field's default is "float32", as
    # in the JAX package; only the CLI tunes it per device (bfloat16 on the
    # card without --config: cli._tuned_perf_defaults).
    compute_dtype: str = "float32"
    # JAX package: pack4 conv blocks (a TPU lane-filling form of the same
    # math). The port accepts the flag and computes the same result.
    packed_conv: bool = False
    # Fused Conv3D+ReLU+MaxPool kernel where eligible (conv1: Cin=1, even
    # H/W, odd kernel; float32 any Cout whose CTAs fit, bf16 Cout <= 32,
    # `ops/cuda/convpool.fused_takes`): the pre-pool activation never
    # reaches device memory. In the port: csrc/conv1_pool.cu.
    fused_conv_pool: bool = False
    # Run the whole GRU recurrence in one kernel launch with w_hh and the
    # carried state on chip. In the port: csrc/gru_fwd.cu.
    use_pallas_gru: bool = False

    def __post_init__(self):
        if self.conv_channels is None:
            object.__setattr__(
                self, "conv_channels",
                (128, 256, 64) if self.family == "tf" else (32, 64, 96),
            )
        else:
            object.__setattr__(
                self, "conv_channels", tuple(self.conv_channels)
            )


@dataclass(frozen=True)
class AudioConfig:
    """MFCC front-end parameters (`misalignment_detection_train.py:84-86,117-127`).

    hop_length = sample_rate / 40 reproduces the reference's 40 MFCC frames/s.
    n_fft / n_mels / fmin / fmax / norm follow librosa.feature.mfcc defaults,
    which the reference relies on implicitly.
    """

    sample_rate: int = 16000
    n_mfcc: int = 20
    n_fft: int = 2048
    n_mels: int = 128
    fmin: float = 0.0
    fmax: Optional[float] = None  # None -> sample_rate / 2
    top_db: float = 80.0
    # Maximum audio length in samples for the static-shape device pipeline
    # (GRID clips are 3 s @ 25 fps = 75 frames; 3 s @ 16 kHz = 48000).
    max_audio_samples: int = 48000
    # Fuse mel->dB->DCT->stats into one Pallas kernel (ops/pallas/mfcc.py);
    # the FFT stays in XLA either way.
    use_pallas: bool = False

    @property
    def hop_length(self) -> int:
        return max(1, self.sample_rate // 40)


@dataclass(frozen=True)
class DetectorConfig:
    """Misalignment-detector parameters (`misalignment_detection_train.py:79-88`)."""

    hidden_dim: int = 256
    dropout: float = 0.3
    max_shift_frames: int = 15
    num_negative_samples: int = 1
    default_fps: float = 25.0
    lr: float = 1e-3
    weight_decay: float = 1e-5
    batch_size: int = 32
    epochs: int = 20


@dataclass(frozen=True)
class TrainConfig:
    """LipNet training parameters (`trainer.py:12-24`, `main.py:23-37`)."""

    learning_rate: float = 1e-4
    epochs: int = 50
    grad_clip_norm: float = 1.0
    checkpoint_every: int = 10
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    seed: int = 42
    # Rematerialize the forward pass in backward (jax.checkpoint; in the
    # port torch.utils.checkpoint per conv block and BiGRU layer): trades
    # ~33% more FLOPs for activation memory, unlocking larger per-chip
    # batches (the conv activations dominate device memory here).
    remat: bool = False
    # Mesh axes: batch is sharded over 'data'; 'model' is the tensor-parallel
    # axis (headroom; 1 by default for this 12.5M-param model).
    mesh_shape: Tuple[int, int] = (-1, 1)  # -1 -> all remaining devices
    quick_test: bool = False
    # Write TensorBoard event files (train/ + validation/ subdirs under
    # log_dir, tags epoch_loss/epoch_lr — the reference's Keras TensorBoard
    # callback layout, `train.py:745-748`). Pure-python writer, no TF
    # dependency (avsync/utils/tb.py).
    tensorboard: bool = False


@dataclass(frozen=True)
class AvsyncConfig:
    """Root configuration tree."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # ---- serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AvsyncConfig":
        def _build(dc_type, sub: Dict[str, Any]):
            fields = {f.name: f for f in dataclasses.fields(dc_type)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    continue  # forward compatibility: ignore unknown keys
                ft = fields[k].type
                if isinstance(v, list):
                    v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
                kwargs[k] = v
                del ft
            return dc_type(**kwargs)

        return cls(
            data=_build(DataConfig, d.get("data", {})),
            model=_build(ModelConfig, d.get("model", {})),
            audio=_build(AudioConfig, d.get("audio", {})),
            detector=_build(DetectorConfig, d.get("detector", {})),
            train=_build(TrainConfig, d.get("train", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "AvsyncConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **sections) -> "AvsyncConfig":
        """Return a copy with whole sections replaced, e.g.
        cfg.replace(model=cfg.model_with(hidden_dim=512))."""
        return dataclasses.replace(self, **sections)
