"""Batching and device feed for LipNet training (port of
`avsync/data/pipeline.py`).

Streamed epochs (`device_cache="off"`, and the first epoch under "auto"):

  * the host only decodes clips (`.npy`, or containers through the libav
    ingest) to (T, H, W) uint8 on `DataConfig.loader_threads` threads and
    pads them to max_video_length;
  * a background thread prefetches batches, so decode overlaps device steps;
  * the uint8 frames are uploaded as they are (4x fewer bytes than float32)
    and preprocessed on the device by `predictor.preprocess`: /255 for
    pre-cropped clips, for native frames the ROI program of
    `DataConfig.roi_mode` (`make_roi_crop_fn`: the heuristic crop, the
    variance box or the localizer's box), or under 'detector' the crop of
    the host cascade's per-frame boxes;
  * under `DataConfig.roi_host` the ROI program runs on the host CPU instead
    and the crops, rounded to uint8, are what crosses to the device.

Same order and contents as the JAX package's `LipNetBatcher`:
`np.random.default_rng(seed).shuffle` of the sample indices, `drop_last`,
and for `drop_last=False` a last batch zero-padded (with sample 0's labels)
whose `valid` counts the real clips.

The device cache (`DataConfig.device_cache`): from the second `epoch()`
call under "auto" (the first under "on"), the preprocessed corpus, or the
prefix of it that fits `device_cache_budget_mb`, lives in device memory as
a flat (N, T*H*W) tensor, and batches become gathers on the device. Under
`device_cache_dtype="auto"` a probe of the first decoded batch stores
uint8 when every preprocessed value is exactly k/255 (pre-cropped corpora),
4x the clips per MB, and the gather then applies the streamed path's own
expression (`u8.float() * (1/255)`); else float32. Either way a cached
batch equals the streamed one bit for bit. A partial cache decodes only the
uncached rows of each batch and merges them on the device. The gather is
`index_select` on the flat cache: the JAX package's one-hot int8 matmul is
a TPU workaround, so `cache_gather_onehot_max_mb` has no effect here.
`scan_plan` hands a fully cached corpus to the trainers' whole-epoch
programs.

Under a mesh of ranks (`mesh`, the JAX batcher's `mesh`) the epoch's global
batches are the same, and each rank yields only its data index's block of
rows of each (`multihost.local_rows`, as `P('data')` cuts them): it
decodes, uploads and preprocesses those alone, a partial cache decodes only
its own uncached rows, and `scan_plan` gives it its columns of the (S, B)
plan. The device cache itself is the whole corpus on every rank (each
epoch's shuffle hands a rank other clips), built by each rank from a full
decode in source order.
"""

from __future__ import annotations

import copy
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from avsync_torch.config import AvsyncConfig
from avsync_torch.data.grid import GridDataSource
from avsync_torch.data.video import decode_video_gray
from avsync_torch.ops import image as imglib
from avsync_torch.parallel import multihost
from avsync_torch.predictor import (load_localizer, load_mouth_detector, preprocess,
                                    resolve_device)


def prefetch(iterator: Iterable, size: int = 2) -> Iterator:
    """Run `iterator` on a background thread, `size` items ahead.

    Closing the returned generator early stops the worker and closes the
    source iterator, so its `finally` blocks (the decode pool's shutdown)
    run now rather than at garbage collection. An exception in the worker
    is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            err.append(e)
        finally:
            try:
                close = getattr(iterator, "close", None)
                if close is not None:
                    close()
            finally:
                put(sentinel)  # the consumer never waits on a dead worker

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while True:  # unblock a worker parked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def make_roi_crop_fn(d, roi_mode: str, localizer=None):
    """The ROI program: full frames (B, T, H, W) uint8/float -> (B, T, h, w,
    1) float32 in [0, 1], on the frames' device. The one definition, shared
    by the device preprocess and the host crop of `roi_host`: 'variance'
    crops one temporal-variance box per clip, 'model' with a localizer its
    box gated against the heuristic fractions, anything else (also 'model'
    without one) the heuristic crop. The returned `run(x, coords=None)`
    takes the resize coordinates its mode uses (`roi_coords`), made per
    call when not given."""
    target = (d.img_height, d.img_width)

    def box_crop(xf, boxes):  # one box per clip, over all its frames
        per_frame = boxes[:, None, :].expand(xf.shape[0], xf.shape[1], 4)
        return (imglib.crop_resize_boxes(xf, per_frame, target) * (1.0 / 255.0))[..., None]

    if roi_mode == "variance":
        def run(x, coords=None):
            xf = x.float()
            return box_crop(xf, imglib.variance_mouth_boxes(xf))
    elif roi_mode == "model" and localizer is not None:
        from avsync_torch.models.localizer import gate_boxes, localize_clip_boxes

        heur = (d.mouth_crop[0], 1.0, d.mouth_crop[1], d.mouth_crop[2])

        def run(x, coords=None):
            xf = x.float()
            # a box that captures below-average motion takes the heuristic
            # crop for that clip (the weights are trained on synthetic clips)
            boxes = gate_boxes(xf, localize_clip_boxes(localizer, xf, coords),
                               torch.tensor(heur, dtype=torch.float32, device=xf.device))
            return box_crop(xf, boxes)
    else:
        def run(x, coords=None):
            return imglib.preprocess_clips(x, out_hw=target, crop=d.mouth_crop, coords=coords)
    return run


def roi_coords(d, roi_mode: str, frame_hw, localizer=None, device=None):
    """The resize coordinates `make_roi_crop_fn(d, roi_mode, localizer)`
    uses on frames of `frame_hw` (an exported program holds them as
    buffers): the heuristic crop's resize, the localizer's resize to its
    input, or None for 'variance'."""
    if roi_mode == "variance":
        return None
    if roi_mode == "model" and localizer is not None:
        from avsync_torch.models.localizer import NET_HW

        return imglib.resize_coords(tuple(frame_hw), NET_HW, device)
    return imglib.resize_coords(imglib.crop_hw(tuple(frame_hw), d.mouth_crop),
                                (d.img_height, d.img_width), device)


class LipNetBatcher:
    """Epoch iterators of batches for LipNetTrainer:
    {'video': (B, T, h, w, 1) float32 on the device, 'labels': (B, L) int32,
    'label_lengths': (B,) int32, 'valid': int} (labels stay numpy); under a
    `mesh`, this rank's rows of each batch ('valid' counts its real ones)."""

    def __init__(self, source: GridDataSource, config: AvsyncConfig, device=None, mesh=None):
        self.source = source
        self.cfg = config
        self.mesh = mesh if mesh is not None and mesh.data_size > 1 else None
        if device is None and multihost.rank_device() is not None:
            device = multihost.rank_device()
        self.device = resolve_device(device)
        self._device_cache: Optional[Dict] = None
        self._epoch_calls = 0
        # the ROI state, loaded once: the host cascade ('detector') or the
        # localizer ('model'; None with a warning when its bundle is missing)
        self._detector = load_mouth_detector(config)
        self._localizer = load_localizer(config, self.device)
        self._host_roi_fn = None  # the ROI program on the CPU (roi_host)
        if config.data.device_cache != "off":
            # fail now on an invalid dtype: under 'auto' the cache is built
            # only at the second epoch() call, after a whole epoch of work
            self._cache_dtype()

    def _decode_clip(self, video_path: str) -> np.ndarray:
        d = self.cfg.data
        frames = decode_video_gray(video_path, max_frames=d.max_video_length)
        T = frames.shape[0]
        if T == 0:
            return np.zeros((d.max_video_length, d.img_height, d.img_width), np.uint8)
        if T < d.max_video_length:
            pad = np.zeros((d.max_video_length - T,) + frames.shape[1:], np.uint8)
            frames = np.concatenate([frames, pad], axis=0)
        return frames

    def _host_roi(self, raw: np.ndarray) -> np.ndarray:
        """The ROI program (`make_roi_crop_fn`) on the host CPU, rounded to
        uint8 crops (B, T, h, w): under `roi_host` only crops cross to the
        device, 16x fewer bytes than 288x360 frames. torch.round rounds
        half to even, as jnp.round does."""
        if self._host_roi_fn is None:
            d = self.cfg.data
            loc = None if self._localizer is None else copy.deepcopy(self._localizer).cpu()
            self._host_roi_fn = make_roi_crop_fn(d, d.roi_mode, loc)
        with torch.inference_mode():
            out = self._host_roi_fn(torch.from_numpy(raw))[..., 0]
            return torch.round(out * 255.0).clamp(0.0, 255.0).to(torch.uint8).numpy()

    def _host_rows(self, raws: np.ndarray):
        """Host work on decoded native frames before the upload: (frames or,
        under `roi_host`, uint8 crops; the cascade's (B, T, 4) boxes under
        'detector', else None). Pre-cropped clips pass as they are."""
        d = self.cfg.data
        if tuple(raws.shape[2:]) == (d.img_height, d.img_width):
            return raws, None
        if self._detector is not None:  # its crop stays on the device
            return raws, np.stack([self._detector.detect_clip(r) for r in raws])
        if d.roi_host:
            return self._host_roi(raws), None
        return raws, None

    def _preprocess(self, raw: torch.Tensor, boxes: Optional[np.ndarray] = None) -> torch.Tensor:
        """`predictor.preprocess` of a raw batch on the device, with the
        host cascade's boxes where there are any."""
        if boxes is not None:
            boxes = torch.from_numpy(boxes).to(self.device)
        return preprocess(raw, self.cfg, boxes=boxes, localizer=self._localizer)

    def _rows(self, B: int) -> slice:
        """This rank's rows of a global batch of B (all of them without a mesh)."""
        return multihost.local_rows(B, self.mesh)

    def _local(self, idx: np.ndarray, valid: int, local: bool):
        """(rows of `idx` this rank takes, how many of them are real)."""
        if not local or self.mesh is None:
            return idx, valid
        rows = self._rows(len(idx))
        return idx[rows], max(0, min(valid - rows.start, rows.stop - rows.start))

    def _raw_batches(self, batch_size: Optional[int], shuffle: bool, seed: int,
                     drop_last: bool, prefetch_size: int, local: bool = True) -> Iterator[Dict]:
        """Prefetched host batches: {'raw' uint8 (B, T, H, W) (crops under
        roi_host), 'boxes' (detector mode) or None, 'labels',
        'label_lengths', 'valid'}; this rank's rows only when `local`."""
        d = self.cfg.data
        B = batch_size or d.batch_size
        n = len(self.source)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)

        def batches():
            pool = ThreadPoolExecutor(max_workers=max(1, int(d.loader_threads)))
            try:
                for i in range(0, n, B):
                    idx = order[i:i + B]
                    valid = len(idx)
                    if valid < B:
                        if drop_last:
                            return
                        idx = np.concatenate([idx, np.zeros(B - valid, np.int64)])
                    idx, valid = self._local(idx, valid, local)
                    raws, boxes = self._host_rows(np.stack(list(pool.map(
                        lambda j: self._decode_clip(self.source.samples[j].video_path), idx))))
                    labels, lengths = self.source.labels_batch(
                        list(idx), d.max_label_length, vocab=self.cfg.model.family)
                    yield {"raw": raws, "boxes": boxes, "labels": labels,
                           "label_lengths": lengths, "valid": valid}
            finally:
                pool.shutdown(wait=False)

        return prefetch(batches(), prefetch_size)

    def _host_epoch(self, batch_size: Optional[int], shuffle: bool, seed: int,
                    drop_last: bool, prefetch_size: int, local: bool = True) -> Iterator[Dict]:
        """The streamed epoch: host decode, upload, device preprocess."""
        gen = self._raw_batches(batch_size, shuffle, seed, drop_last, prefetch_size, local)
        try:
            for hb in gen:
                raw = torch.from_numpy(hb["raw"]).to(self.device)
                yield {"video": self._preprocess(raw, hb["boxes"]), "labels": hb["labels"],
                       "label_lengths": hb["label_lengths"], "valid": hb["valid"]}
        finally:
            gen.close()  # stop the prefetch worker and the decode pool now

    def epoch(self, batch_size: Optional[int] = None, shuffle: bool = True, seed: int = 0,
              drop_last: bool = True, prefetch_size: int = 2) -> Iterator[Dict]:
        """Yield batches with the video preprocessed on the device.

        drop_last=True keeps every batch the same shape; eval paths use
        drop_last=False, where the final partial batch is zero-padded and
        'valid' counts its real samples. From the second call on (the first
        under device_cache="on"), when `DataConfig.device_cache` allows it,
        batches come from the device cache: the same order, padding, labels
        and bits."""
        self._epoch_calls += 1
        if self._device_cache is None and self._cache_allowed(eager=self._epoch_calls >= 2):
            self.warm_device_cache()
        if self._device_cache is not None:
            return self._cached_epoch(batch_size, shuffle, seed, drop_last)
        return self._host_epoch(batch_size, shuffle, seed, drop_last, prefetch_size)

    # -- the device cache -------------------------------------------------------
    def _cache_dtype(self) -> torch.dtype:
        """The cache's element dtype before the uint8 probe (see
        `DataConfig.device_cache_dtype`), as the JAX package's: 'auto'
        follows the model's compute dtype. A bf16-computing model rounds its
        input to bf16 first thing, so a bf16 cache is invisible to it
        (bf16(f32(bf16(x))) == bf16(x)) and holds twice the clips per MB;
        under float32 compute the cache stays float32, and an explicit
        'bfloat16' raises: the cached epochs would train on bf16-rounded
        inputs."""
        mode = self.cfg.data.device_cache_dtype
        if mode not in ("auto", "float32", "bfloat16"):
            # uint8 is not a valid explicit value: it is only right when
            # the probe proves k/255-exactness ('auto' does that)
            raise ValueError(f"device_cache_dtype={mode!r}: use 'auto', 'float32' or "
                             "'bfloat16' (uint8 is chosen automatically when lossless)")
        bf16_compute = self.cfg.model.compute_dtype == "bfloat16"
        if mode == "auto":
            return torch.bfloat16 if bf16_compute else torch.float32
        if mode == "bfloat16" and not bf16_compute:
            raise ValueError(
                "device_cache_dtype='bfloat16' requires model.compute_dtype='bfloat16': "
                "with f32 compute the cached epochs would train on bf16-rounded inputs, "
                "breaking the cached==streamed guarantee. Use compute_dtype='bfloat16' or "
                "device_cache_dtype='auto'/'float32'.")
        return getattr(torch, mode)

    def _clip_bytes(self, itemsize: Optional[int] = None) -> int:
        d = self.cfg.data
        if itemsize is None:
            itemsize = self._cache_dtype().itemsize
        return itemsize * d.max_video_length * d.img_height * d.img_width

    def _budget_clip_count(self, itemsize: Optional[int]) -> int:
        n = len(self.source)
        if self.cfg.data.device_cache == "on":
            return n
        budget = self.cfg.data.device_cache_budget_mb * 2**20
        return min(n, int(budget // max(self._clip_bytes(itemsize), 1)))

    def _cache_clip_count(self) -> int:
        """How many clips (in source order) the cache may hold: 'on' the
        whole corpus, else what fits device_cache_budget_mb. A larger corpus
        is cached partially, its first clips, and the rest streams."""
        return self._budget_clip_count(None)

    def _cache_allowed(self, eager: bool = True) -> bool:
        """Whether (a prefix of) the corpus may live in device memory."""
        mode = self.cfg.data.device_cache
        if mode == "off":
            return False
        if mode == "on":  # explicit: cache from the first epoch
            return True
        if not eager:  # 'auto' waits for the second epoch() call, so one-
            return False  # shot draws never pay for the build
        return self._cache_clip_count() >= 1

    def warm_device_cache(self) -> None:
        """Decode and preprocess the corpus once (streamed, in source order)
        and keep it, or the prefix that fits, in device memory. Each batch is
        written into the preallocated cache as it arrives: the build holds
        the cache and one batch, never a list of parts. Under dtype 'auto'
        the first batch decides uint8 (every value exactly k/255) and later
        batches re-check it on the device, read once at the end; rows past
        the first that fails stay uncached and stream."""
        if self._device_cache is not None:
            return
        n = len(self.source)
        n_cached = self._cache_clip_count()
        if n_cached < 1:
            return
        policy = self.cfg.data.device_cache_dtype
        store_dt = self._cache_dtype()
        u8 = False
        buf, clip_shape, checks, got = None, None, [], 0

        def exact_u8(x):
            q = torch.round(x * 255.0).clamp(0.0, 255.0).to(torch.uint8)
            return q, torch.all(q.float() * (1.0 / 255.0) == x)

        gen = self._host_epoch(None, shuffle=False, seed=0, drop_last=False, prefetch_size=2,
                               local=False)
        try:
            for hb in gen:
                x = hb["video"]
                if clip_shape is None:
                    clip_shape = tuple(x.shape[1:])
                    if policy == "auto" and bool(exact_u8(x)[1]):  # one sync decides
                        u8, store_dt = True, torch.uint8
                        n_cached = self._budget_clip_count(1)
                    buf = torch.zeros((n_cached, int(np.prod(clip_shape))), dtype=store_dt,
                                      device=self.device)
                take = min(int(hb["valid"]), n_cached - got)
                x = x[:take].reshape(take, -1)
                if u8:
                    q, ok = exact_u8(x)
                    buf[got:got + take] = q
                    if got:
                        checks.append((got, ok))
                else:
                    buf[got:got + take] = x.to(store_dt)
                got += take
                if got >= n_cached:
                    break
        finally:
            gen.close()
        for start, ok in checks:
            if not bool(ok):
                got = start  # keep the verified prefix; the rest streams
                break
        labels, lengths = self.source.labels_batch(list(range(n)), self.cfg.data.max_label_length,
                                                   vocab=self.cfg.model.family)
        self._device_cache = {
            "video": buf, "n_cached": got, "u8": u8, "clip_shape": clip_shape,
            "dtype": str(store_dt).replace("torch.", ""),
            "labels": labels, "label_lengths": lengths,  # host copies, as streamed
            "labels_dev": torch.from_numpy(labels).long().to(self.device),
            "lengths_dev": torch.from_numpy(lengths).long().to(self.device),
        }

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """(B,) int64 cache rows on the device -> (B, T, h, w, 1) float32
        model input, bit for bit what the streamed path gives those clips (a
        bf16 cache: after the bf16 model's rounding of its input)."""
        cache = self._device_cache
        rows = cache["video"].index_select(0, idx).float()
        if cache["u8"]:
            rows = rows * (1.0 / 255.0)  # the streamed preprocess's expression
        return rows.view(-1, *cache["clip_shape"])

    def scan_plan(self, batch_size: Optional[int] = None, shuffle: bool = True,
                  seed: int = 0) -> Optional[Dict]:
        """A whole-epoch plan for `LipNetTrainer.train_epoch_scanned`, or None
        where it does not apply: a corpus that is not fully cached, the warm-
        up epoch under 'auto', or fewer clips than one batch. The plan holds
        the cache's gather, the labels and lengths on the device and the
        (S, B) int32 matrix of the epoch's sample indices (drop_last: training
        epochs only). A None does not count as an epoch() call, so 'auto'
        builds the cache at the same epoch either way."""
        if self._device_cache is None and self._cache_allowed(eager=self._epoch_calls + 1 >= 2):
            self.warm_device_cache()
        cache = self._device_cache
        n = len(self.source)
        if cache is None or cache["n_cached"] < n:
            return None
        B = batch_size or self.cfg.data.batch_size
        S = n // B
        if S == 0:
            return None
        self._epoch_calls += 1
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        return {"video": cache["video"], "gather": self.gather, "labels": cache["labels_dev"],
                "lengths": cache["lengths_dev"],
                "idx": order[:S * B].reshape(S, B)[:, self._rows(B)].astype(np.int32)}

    def _cached_epoch(self, batch_size, shuffle, seed, drop_last) -> Iterator[Dict]:
        """An epoch from the device cache: the streamed path's order and
        padding. A partial cache decodes only each batch's uncached clips
        (packed into the next power of two rows), preprocesses them as the
        streamed path does and puts them in their places on the device, so
        host work scales with the uncached share only."""
        d = self.cfg.data
        B = batch_size or d.batch_size
        n = len(self.source)
        cache = self._device_cache
        n_cached = cache["n_cached"]
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)

        def batch_rows():
            for i in range(0, n, B):
                idx = order[i:i + B]
                valid = len(idx)
                if valid < B:
                    if drop_last:
                        return
                    idx = np.concatenate([idx, np.zeros(B - valid, np.int64)])
                yield self._local(idx, valid, True)

        def out(idx, valid, video):
            return {"video": video, "labels": cache["labels"][idx],
                    "label_lengths": cache["label_lengths"][idx], "valid": valid}

        if n_cached >= n:  # fully cached: gathers only
            for idx, valid in batch_rows():
                yield out(idx, valid, self.gather(torch.from_numpy(idx).long().to(self.device)))
            return

        Bl = self._rows(B).stop - self._rows(B).start

        def cap_of(k):  # rows of a packed upload: k rounded up to a power of 2
            c = 1
            while c < k:
                c *= 2
            return min(c, Bl)

        def host_batches():  # decode only the uncached rows of each batch
            pool = ThreadPoolExecutor(max_workers=max(1, int(d.loader_threads)))
            try:
                for idx, valid in batch_rows():
                    miss = np.where(idx >= n_cached)[0]
                    raw = boxes = None
                    if miss.size:
                        decoded = list(pool.map(
                            lambda j: self._decode_clip(self.source.samples[j].video_path),
                            idx[miss]))
                        raw = np.zeros((cap_of(miss.size),) + decoded[0].shape, np.uint8)
                        raw[:miss.size] = np.stack(decoded)
                        raw, boxes = self._host_rows(raw)  # as the streamed path
                    yield {"idx": idx, "miss": miss, "raw": raw, "boxes": boxes,
                           "valid": valid}
            finally:
                pool.shutdown(wait=False)

        gen = prefetch(host_batches(), 2)
        try:
            for hb in gen:
                idx, miss = hb["idx"], hb["miss"]
                # uncached rows gather row 0 first; the merge replaces them
                safe = np.where(idx < n_cached, idx, 0)
                video = self.gather(torch.from_numpy(safe).long().to(self.device))
                if hb["raw"] is not None:
                    streamed = self._preprocess(torch.from_numpy(hb["raw"]).to(self.device),
                                                hb["boxes"])
                    rows = torch.from_numpy(miss).long().to(self.device)
                    video = video.index_copy(0, rows, streamed[:miss.size])
                yield out(idx, hb["valid"], video)
        finally:
            gen.close()  # stop the prefetch worker and the decode pool now

    def first_batch(self, **epoch_kwargs) -> Dict:
        """One batch, with the epoch generator (and its prefetch worker and
        decode pool) closed — for quick_test and template draws. It does not
        count as an epoch() call, so it never moves the cache's build."""
        epoch_kwargs.setdefault("shuffle", False)
        epoch_kwargs.setdefault("drop_last", False)
        epoch_kwargs.setdefault("batch_size", None)
        epoch_kwargs.setdefault("seed", 0)
        if self._device_cache is not None:
            epoch_kwargs.pop("prefetch_size", None)
            gen = self._cached_epoch(**epoch_kwargs)
        else:
            epoch_kwargs.setdefault("prefetch_size", 2)
            gen = self._host_epoch(**epoch_kwargs)
        try:
            return next(gen)
        finally:
            gen.close()
