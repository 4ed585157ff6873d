"""Ahead-of-time serving export through `torch.export` (port of
`avsync/export.py`).

`export_transcriber` traces the whole serving computation into one program:
the device preprocess (uint8 -> the ROI program of `roi_mode` when the
client's frames are not the model's geometry: the heuristic crop, the
variance box or the localizer's box, its weights held as buffers -> /255 ->
standardize; 'detector', a host cascade, raises ValueError), the LipNet
forward of either family and the greedy CTC decode at the family's blank,
with the weights and tables baked in as the program's parameters and
buffers on the export device. K1 and K2
are the operators `avsync_torch::conv1_pool` and `avsync_torch::bigru_fwd`
(`ops/cuda`), so the program launches the hand-written kernels, not their
plain versions. `export_sync_scorer` does the same for the misalignment
pipeline: preprocess -> conv statistics (K1) -> shift -> rfft power -> K5
(`avsync_torch::mel_stats`) -> the detector's MLP.

Batch: `batch_sizes=None` gives one program with a symbolic batch
(`torch.export.Dim`); a list gives one static program per bucket, and
`call` pads to the smallest bucket that covers the batch.

The artifact is one file, a zip (stored, not compressed) of the programs,
each written by `torch.export.save` with the JSON meta record under its
`extra_files` (`meta.json`): format, kind, family, frame_shape,
batch_sizes, roi, outputs, device, config, and for a transcriber blank_id
and id_to_char. Loading (`load_exported`) needs torch and the kernel
operators (`avsync_torch.ops.cuda`), none of the model code. An artifact
exported on the card loads on the card; where there is no GPU loading it
raises. Exported signatures:

    transcriber  frames (b, T, H, W) uint8 -> (decoded_ids (b, T) int32,
                 lengths (b,) int32, log_probs (b, T, V) f32)
    sync_scorer  (frames (b, T, H, W) u8, audio (b, S) f32, audio_len (b,)
                 i32, fps (b,) f32, shifts (b, K) i32) -> sync_probs (b, K)
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# the kernel operators the programs call: importing the modules registers them
from avsync_torch.ops.cuda import convpool, gru, mfcc  # noqa: F401
from avsync_torch.ops.conv import fp32_step

_FORMAT = "avsync-torch-export-v1"
_META = "meta.json"
MAX_BATCH = 4096  # the symbolic batch's upper bound


def _as_uint8_frames(frames) -> np.ndarray:
    """Raw uint8 frames (0..255), as the live path's uint8 branch takes them:
    floats raise (normalized frames would floor to black under a bare cast),
    and so do integers outside 0..255."""
    frames = np.asarray(frames)
    if frames.dtype == np.uint8:
        return frames
    if np.issubdtype(frames.dtype, np.floating):
        raise ValueError(
            f"exported artifacts take raw uint8 frames (0..255); got {frames.dtype}. Pass "
            "the undecoded pixels (the live path's float branch is not part of the program).")
    if frames.size and (frames.min() < 0 or frames.max() > 255):
        raise ValueError(f"integer frames out of uint8 range [{frames.min()}, "
                         f"{frames.max()}]: expected raw 0..255 pixels")
    return frames.astype(np.uint8)


def _program_name(b: Optional[int]) -> str:
    return "program.pt2" if b is None else f"program_b{int(b)}.pt2"


def _save(path: str, programs: dict, meta: dict) -> None:
    """Write exactly `path` (through an open file: no suffix is added)."""
    with open(path, "wb") as f, zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as z:
        for b, ep in programs.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf, extra_files={_META: json.dumps(meta)})
            z.writestr(_program_name(b), buf.getvalue())


def _read_meta(program: bytes) -> dict:
    """The meta record inside one saved program, read without loading it."""
    with zipfile.ZipFile(io.BytesIO(program)) as z:
        name = next((n for n in z.namelist() if n.endswith("extra/" + _META)), None)
        if name is None:
            raise ValueError("not an avsync_torch export artifact: no meta record")
        return json.loads(z.read(name))


def _export_batched(program: torch.nn.Module, example_of_batch, batch_sizes):
    """{None: program with a symbolic batch} when batch_sizes is None, else
    {b: static program} for each bucket b."""
    with torch.no_grad():
        if batch_sizes is None:
            example = example_of_batch(2)
            b = torch.export.Dim("b", min=1, max=MAX_BATCH)
            return {None: torch.export.export(program, example,
                                              dynamic_shapes=tuple({0: b} for _ in example))}
        sizes = sorted({int(b) for b in batch_sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch_sizes must be positive ints, got {batch_sizes!r}")
        return {b: torch.export.export(program, example_of_batch(b)) for b in sizes}


class _BucketCaller:
    """Batch -> program dispatch for both artifact kinds: a symbolic program
    takes any batch; static ones take the smallest bucket >= B, with the
    rows zero-padded and the outputs cut back to B. Programs run with TF32
    off (as the live path), under no_grad, on the artifact's device."""

    def _init_programs(self, programs: dict, meta: dict) -> None:
        self._exported = dict(programs)
        self._modules = {b: ep.module() for b, ep in programs.items()}
        self._buckets = sorted(b for b in programs if b is not None)
        self.meta = meta
        self.device = torch.device(meta["device"])

    @property
    def batch_sizes(self):
        """Static bucket sizes, or None for a symbolic-batch artifact."""
        return list(self._buckets) if self._buckets else None

    def save(self, path: str) -> None:
        _save(path, self._exported, self.meta)

    def _dispatch(self, args: tuple) -> tuple:
        B = args[0].shape[0]
        if None in self._modules:
            module = self._modules[None]
        else:
            bucket = next((b for b in self._buckets if b >= B), None)
            if bucket is None:
                raise ValueError(f"batch of {B} exceeds the largest exported bucket "
                                 f"{self._buckets[-1]}; re-export with larger batch_sizes "
                                 "or split the batch")
            args = tuple(np.concatenate([a, np.zeros((bucket - B,) + a.shape[1:], a.dtype)])
                         if bucket > B else a for a in args)
            module = self._modules[bucket]
        inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in args]
        with torch.no_grad(), fp32_step():
            out = module(*inputs)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(o[:B].cpu().numpy() for o in out)


def _vocab_meta(cfg) -> dict:
    """The family's blank id and id -> character table (`avsync/export.py:161-177`)."""
    from avsync_torch import text as textlib

    if cfg.model.family == "tf":
        return {"blank_id": textlib.TF_BLANK_ID,
                "id_to_char": {str(i): c for i, c in textlib.TF_IDX_TO_CHAR.items()}}
    return {"blank_id": textlib.BLANK_ID,
            "id_to_char": {str(i): c for i, c in textlib.IDX_TO_CHAR.items() if len(c) == 1}}


def _check_roi(cfg, frame_hw: Tuple[int, int], what: str = "export supports the on-device ROI "
               "modes ('model', 'variance', heuristic) or pre-cropped native-geometry "
               "frames") -> bool:
    """True when frames of `frame_hw` need the embedded mouth ROI; raises
    for 'detector', whose cascade runs on the host, outside any program."""
    d = cfg.data
    native = tuple(frame_hw) != (d.img_height, d.img_width)
    if native and d.roi_mode == "detector":
        raise ValueError(f"roi_mode='detector' runs a host-side cascade; {what}")
    return native


class _Preprocess(torch.nn.Module):
    """`predictor.preprocess` with the ROI program's resize coordinates held
    as buffers (made on the export device once, not traced as constants)
    and, for 'model', the localizer as a submodule (its weights are
    buffers)."""

    def __init__(self, cfg, frame_hw: Tuple[int, int], localizer, device: torch.device,
                 native: bool):
        from avsync_torch.data.pipeline import roi_coords

        super().__init__()
        self.cfg = cfg
        self.localizer = localizer
        self._coords = ()
        if native:
            coords = roi_coords(cfg.data, cfg.data.roi_mode, frame_hw, localizer, device)
            self._coords = ("y0", "y1", "fy", "x0", "x1", "fx") if coords is not None else ()
            for name, t in zip(self._coords, coords or ()):
                self.register_buffer(name, t)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        from avsync_torch.predictor import preprocess

        coords = tuple(getattr(self, n) for n in self._coords) or None
        return preprocess(frames, self.cfg, coords, localizer=self.localizer)


class _TranscriberProgram(torch.nn.Module):
    def __init__(self, reader, frame_hw: Tuple[int, int], native: bool, blank_id: int):
        super().__init__()
        self.prep = _Preprocess(reader.cfg, frame_hw, reader._localizer, reader.device, native)
        self.model = reader.model
        self.blank_id = blank_id

    def forward(self, frames: torch.Tensor):
        from avsync_torch.text import ctc_greedy_decode

        log_probs = self.model(self.prep(frames))
        ids, lengths = ctc_greedy_decode(log_probs, self.blank_id)
        return ids.to(torch.int32), lengths.to(torch.int32), log_probs


class _SyncScorerProgram(torch.nn.Module):
    def __init__(self, scorer, frame_hw: Tuple[int, int], native: bool):
        from avsync_torch.ops import audio as audiolib

        super().__init__()
        self.prep = _Preprocess(scorer.cfg, frame_hw, scorer._localizer, scorer.device, native)
        self.lipnet, self.detector = scorer.lipnet, scorer.detector
        for name, t in zip(("melT", "dctT", "window"),
                           audiolib.device_constants(scorer.cfg.audio, scorer.device)):
            self.register_buffer(name, t.clone())

    def forward(self, frames, audio, audio_len, fps, shifts):
        from avsync_torch.features import visual_stats
        from avsync_torch.ops.audio import shifted_audio_stats

        K = shifts.shape[1]
        vis = visual_stats(self.lipnet, self.prep(frames))
        astats = shifted_audio_stats(audio.repeat_interleave(K, 0),
                                     audio_len.repeat_interleave(K), shifts.reshape(-1),
                                     fps.repeat_interleave(K), self.prep.cfg.audio,
                                     (self.melT, self.dctT, self.window))
        feats = torch.cat([vis.repeat_interleave(K, 0), astats], dim=-1)
        return torch.sigmoid(self.detector(feats)).reshape(-1, K)


def _meta(kind: str, cfg, frame_shape, batch_sizes, native: bool, device, outputs) -> dict:
    return {
        "format": _FORMAT,
        "kind": kind,
        "family": cfg.model.family,
        "frame_shape": list(frame_shape),
        "batch_sizes": None if batch_sizes is None else sorted({int(b) for b in batch_sizes}),
        "roi": ("embedded:" + cfg.data.roi_mode) if native else "none (pre-cropped)",
        "device": str(device),
        "outputs": outputs,
        "torch_version": torch.__version__,
        "config": cfg.to_dict(),
    }


def export_transcriber(checkpoint: str, cfg=None,
                       frame_geometry: Optional[Tuple[int, int]] = None, device=None,
                       batch_sizes: Optional[Sequence[int]] = None) -> "ExportedTranscriber":
    """The transcription artifact (in memory; see `save`) from a LipNet
    checkpoint of either family (`predictor.read_lipnet_checkpoint`: a
    reference `.pth`, or a port checkpoint directory or snapshot), on
    `device` (the card unless "cpu" is given).

    frame_geometry: (H, W) of the client's frames; the model's own geometry
    (pre-cropped mouth clips) by default, any other bakes the ROI program of
    `roi_mode` in front of the model ('detector', a host cascade, raises
    ValueError). batch_sizes: None for one symbolic-batch program,
    or one static program per size (e.g. the serving buckets 1, 2, 4, 8)."""
    from avsync_torch.config import AvsyncConfig
    from avsync_torch.predictor import LipReader

    cfg = cfg or AvsyncConfig()
    d = cfg.data
    H, W = frame_geometry or (d.img_height, d.img_width)
    native = _check_roi(cfg, (H, W))
    reader = LipReader(checkpoint=checkpoint, config=cfg, device=device)
    T = d.max_video_length
    vocab = _vocab_meta(cfg)
    program = _TranscriberProgram(reader, (H, W), native, vocab["blank_id"]).eval()
    programs = _export_batched(
        program,
        lambda b: (torch.zeros(b, T, H, W, dtype=torch.uint8, device=reader.device),),
        batch_sizes)
    meta = _meta("transcriber", cfg, (T, H, W), batch_sizes, native, reader.device,
                 ["decoded_ids (b, T) int32", "lengths (b,) int32", "log_probs (b, T, V) f32"])
    meta["input_dtype"] = "uint8"
    meta.update(vocab)
    return ExportedTranscriber(programs, meta)


class ExportedTranscriber(_BucketCaller):
    """A transcription artifact: `call` runs the program (any batch size:
    the symbolic program, or padded to the smallest static bucket);
    `transcribe` joins ids to text with the embedded vocabulary."""

    def __init__(self, programs: dict, meta: dict):
        self._init_programs(programs, meta)
        self._id_to_char = {int(k): v for k, v in meta["id_to_char"].items()}

    def prepare_rows(self, frames) -> np.ndarray:
        """Raw frames -> program-ready (B, T, H, W) uint8 rows on the host:
        (T', H, W) becomes a batch of one, short clips are zero-padded on T
        (as `predictor.pad_frames`), long ones cut. Rows of separate calls
        concatenate into one batched `call` (the serving path)."""
        frames = _as_uint8_frames(frames)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.ndim != 4:
            raise ValueError(f"expected (T, H, W) or (B, T, H, W) frames, got shape "
                             f"{frames.shape}")
        T, H, W = self.meta["frame_shape"]
        if frames.shape[2:] != (H, W):
            raise ValueError(f"artifact expects {H}x{W} frames, got {frames.shape[2]}x"
                             f"{frames.shape[3]}: re-export with frame_geometry="
                             f"({frames.shape[2]}, {frames.shape[3]})")
        if frames.shape[1] < T:
            pad = np.zeros((frames.shape[0], T - frames.shape[1], H, W), frames.dtype)
            frames = np.concatenate([frames, pad], axis=1)
        return frames[:, :T]

    def call(self, frames):
        """frames (B, T, H, W) uint8 (or (T, H, W)) -> (ids, lengths,
        log_probs) numpy arrays."""
        return self._dispatch((self.prepare_rows(frames),))

    def transcribe(self, frames):
        ids, lengths, _ = self.call(frames)
        return ["".join(self._id_to_char.get(int(i), "") for i in ids[r, :int(lengths[r])])
                for r in range(ids.shape[0])]


def export_sync_scorer(detector_checkpoint: str, lipnet_checkpoint: str, cfg=None,
                       num_shifts: int = 1, frame_geometry: Optional[Tuple[int, int]] = None,
                       device=None,
                       batch_sizes: Optional[Sequence[int]] = None) -> "ExportedSyncScorer":
    """The sync-scoring artifact: preprocess -> conv statistics -> shift ->
    MFCC statistics -> detector, both checkpoints baked in. num_shifts (K)
    is static per artifact; the batch as in `export_transcriber`."""
    from avsync_torch.config import AvsyncConfig
    from avsync_torch.predictor import MisalignmentScorer

    cfg = cfg or AvsyncConfig()
    d = cfg.data
    H, W = frame_geometry or (d.img_height, d.img_width)
    native = _check_roi(cfg, (H, W), "export supports the on-device ROI modes or pre-cropped "
                        "native-geometry frames")
    scorer = MisalignmentScorer(detector_checkpoint, lipnet_checkpoint, config=cfg,
                                device=device)
    T, S, K = d.max_video_length, cfg.audio.max_audio_samples, int(num_shifts)
    dev = scorer.device
    program = _SyncScorerProgram(scorer, (H, W), native).eval()

    def example(b):
        return (torch.zeros(b, T, H, W, dtype=torch.uint8, device=dev),
                torch.zeros(b, S, device=dev), torch.full((b,), S, dtype=torch.int32, device=dev),
                torch.full((b,), 25.0, device=dev), torch.zeros(b, K, dtype=torch.int32, device=dev))

    programs = _export_batched(program, example, batch_sizes)
    meta = _meta("sync_scorer", cfg, (T, H, W), batch_sizes, native, dev,
                 ["sync_probs (b, K) f32"])
    meta.update(max_audio_samples=S, num_shifts=K, input_dtype="uint8 frames, f32 audio")
    return ExportedSyncScorer(programs, meta)


class ExportedSyncScorer(_BucketCaller):
    """A sync-scoring artifact."""

    def __init__(self, programs: dict, meta: dict):
        self._init_programs(programs, meta)

    def call(self, frames, audio, audio_len, fps, shifts) -> np.ndarray:
        """Batched raw call; every array batch-first, shapes as in the meta."""
        (out,) = self._dispatch((_as_uint8_frames(frames), np.asarray(audio, np.float32),
                                 np.asarray(audio_len, np.int32), np.asarray(fps, np.float32),
                                 np.asarray(shifts, np.int32)))
        return out

    def prepare_row(self, frames, audio, fps: float, shifts: Sequence[int]) -> tuple:
        """One clip -> the program-ready batch-of-one row (frames u8, audio
        f32, audio_len i32, fps f32, shifts i32), padded on the host."""
        T, H, W = self.meta["frame_shape"]
        S = self.meta["max_audio_samples"]
        shifts = np.asarray(shifts, np.int32)
        if shifts.shape != (self.meta["num_shifts"],):
            raise ValueError(f"artifact was exported for {self.meta['num_shifts']} shifts per "
                             f"request, got {shifts.shape}")
        frames = _as_uint8_frames(frames)
        if frames.ndim != 3 or frames.shape[1:] != (H, W):
            raise ValueError(f"artifact expects (T, {H}, {W}) frames, got {frames.shape}")
        fbuf = np.zeros((1, T, H, W), np.uint8)
        fbuf[0, :min(len(frames), T)] = frames[:T]
        a = np.asarray(audio, np.float32)[:S]
        abuf = np.zeros((1, S), np.float32)
        abuf[0, :len(a)] = a
        return (fbuf, abuf, np.array([len(a)], np.int32), np.array([fps], np.float32),
                shifts[None])

    def score_arrays(self, frames, audio, fps: float, shifts: Sequence[int]) -> np.ndarray:
        """One clip -> (K,) sync probabilities, as `MisalignmentScorer.score_arrays`."""
        return self.call(*self.prepare_row(frames, audio, fps, shifts))[0]


def load_exported(path: str):
    """An ExportedTranscriber or ExportedSyncScorer, as the meta says, with
    its programs on the device they were exported on. Raises for a file that
    is not an artifact, and for a card artifact where there is no GPU."""
    try:
        with zipfile.ZipFile(path) as z:
            members = {n: z.read(n) for n in z.namelist() if n.startswith("program")}
    except zipfile.BadZipFile:
        raise ValueError(f"{path} is not an avsync_torch export artifact") from None
    if not members:
        raise ValueError(f"{path} is not an avsync_torch export artifact: it holds no program")
    meta = _read_meta(next(iter(members.values())))
    if meta.get("format") != _FORMAT:
        raise ValueError(f"not an avsync_torch export artifact: format={meta.get('format')!r}")
    if torch.device(meta["device"]).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for {meta['device']} and no CUDA device is "
                           "available; export it again with --device cpu to run on the CPU")
    programs = {}
    for name, data in members.items():
        b = name[len("program_b"):-len(".pt2")] if name.startswith("program_b") else None
        programs[None if b is None else int(b)] = torch.export.load(io.BytesIO(data))
    if meta.get("kind", "transcriber") == "sync_scorer":
        return ExportedSyncScorer(programs, meta)
    return ExportedTranscriber(programs, meta)
