"""The port's device-resident corpus cache (`avsync_torch.data.pipeline`)
against its own streamed path and the JAX package's batcher, on the CPU.

Cached epochs must equal streamed ones bit for bit (the JAX package's
guarantee, tests/test_data.py `TestDeviceCache`): full and partial caches,
the uint8 mode the probe picks for pre-cropped corpora and the float32 one
for everything else, and `scan_plan`'s sample order equal to the JAX
package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from avsync.data import synthetic
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.data.grid import GridDataSource
from avsync_torch.data.pipeline import LipNetBatcher

STREAM_KW = (dict(shuffle=True, seed=3, drop_last=True), dict(shuffle=False, drop_last=False))


def _corpus(tmp_path, clips=5, height=12, width=20, preprocessed=True, name="grid"):
    root = str(tmp_path / name)
    synthetic.write_corpus(root, n_speakers=1, clips_per_speaker=clips, n_frames=4,
                           height=height, width=width, seed=11, with_audio=False,
                           preprocessed=preprocessed)
    return root


def _cfg(root, device_cache, height=12, width=20, **data):
    return AvsyncConfig(data=DataConfig(data_path=root, img_height=height, img_width=width,
                                        max_video_length=4, batch_size=2,
                                        device_cache=device_cache, **data))


def _with(cfg, **data):
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data))


def _batcher(root, cfg):
    return LipNetBatcher(GridDataSource(root), cfg, device="cpu")


def _collect(batcher, **kw):
    return [{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in b.items()}
            for b in batcher.epoch(**kw)]


def _assert_same(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x["valid"] == y["valid"]
        np.testing.assert_array_equal(x["labels"], y["labels"])
        np.testing.assert_array_equal(x["label_lengths"], y["label_lengths"])
        assert x["video"].dtype == y["video"].dtype == np.float32
        np.testing.assert_array_equal(x["video"], y["video"])


@pytest.mark.parametrize("kw", STREAM_KW, ids=["train_order", "eval_order_padded"])
def test_cached_epochs_match_streamed_exactly(tmp_path, kw):
    """Under 'auto' the second epoch() call is served from the cache."""
    root = _corpus(tmp_path)
    cfg = _cfg(root, "auto")
    streamed, cached = _batcher(root, _with(cfg, device_cache="off")), _batcher(root, cfg)
    a = _collect(streamed, **kw)
    _collect(cached, **kw)
    assert cached._device_cache is None
    b = _collect(cached, **kw)
    assert cached._device_cache is not None
    _assert_same(a, b)


def test_uint8_exact_cache_on_a_precropped_corpus(tmp_path):
    """'on' caches from the first call; the probe stores uint8 and the
    gather reproduces the streamed float32 values."""
    root = _corpus(tmp_path)
    cfg = _cfg(root, "on")
    a = _collect(_batcher(root, _with(cfg, device_cache="off")), **STREAM_KW[0])
    cached = _batcher(root, cfg)
    b = _collect(cached, **STREAM_KW[0])
    assert cached._device_cache["dtype"] == "uint8"
    assert cached._device_cache["video"].dtype == torch.uint8
    _assert_same(a, b)


@pytest.mark.parametrize("case", ["native_frames", "standardized"])
def test_inexact_corpora_cache_float32_and_match_streamed(tmp_path, case):
    """Native frames (heuristic crop + resize) and standardized clips fail
    the probe: the cache holds float32, the same bits as streaming."""
    if case == "native_frames":
        root = _corpus(tmp_path, preprocessed=False)
        cfg = _cfg(root, "on")
    else:
        root = _corpus(tmp_path)
        cfg = _cfg(root, "on", standardize_clips=True)
    a = _collect(_batcher(root, _with(cfg, device_cache="off")), **STREAM_KW[1])
    cached = _batcher(root, cfg)
    b = _collect(cached, **STREAM_KW[1])
    assert cached._device_cache["dtype"] == "float32"
    _assert_same(a, b)


def test_uint8_rebudget_caches_4x_the_f32_count(tmp_path):
    """A 1 MB budget holds 2 float32 clips of (4, 120, 200) but 10 in uint8;
    the other two stream."""
    root = _corpus(tmp_path, clips=12, height=120, width=200)
    cached = _batcher(root, _cfg(root, "auto", 120, 200, device_cache_budget_mb=1))
    a = _collect(cached, shuffle=True, seed=5, drop_last=True)
    b = _collect(cached, shuffle=True, seed=5, drop_last=True)
    assert cached._device_cache["dtype"] == "uint8"
    assert cached._device_cache["n_cached"] == 10  # 1 MB // 96 kB
    _assert_same(a, b)


def test_uint8_mixed_corpus_truncates_to_the_exact_prefix(tmp_path):
    """Batches after the first pushed off the k/255 grid: the build keeps
    only the verified prefix, which still gives the streamed values."""
    root = _corpus(tmp_path)
    b = _batcher(root, _cfg(root, "on"))
    orig = b._host_epoch

    def tainted(*args, **kw):
        for i, hb in enumerate(orig(*args, **kw)):
            if i >= 1:
                hb = dict(hb, video=hb["video"] * (1.0 - 1e-3))
            yield hb

    b._host_epoch = tainted
    b.warm_device_cache()
    b._host_epoch = orig
    assert b._device_cache["dtype"] == "uint8" and b._device_cache["n_cached"] == 2
    first = next(iter(orig(2, shuffle=False, seed=0, drop_last=False, prefetch_size=2)))
    np.testing.assert_array_equal(b.gather(torch.arange(2)).numpy(), first["video"].numpy())


@pytest.mark.parametrize("kw", STREAM_KW, ids=["train_order", "eval_order_padded"])
def test_partial_cache_matches_streamed_exactly(tmp_path, kw):
    """Float32 pinned, 1 MB budget: 2 of 5 clips of 384 kB cached, the rest
    decoded per batch and merged on the device."""
    root = _corpus(tmp_path, clips=5, height=120, width=200)
    cfg = _cfg(root, "auto", 120, 200, device_cache_budget_mb=1, device_cache_dtype="float32")
    a = _collect(_batcher(root, _with(cfg, device_cache="off")), **kw)
    cached = _batcher(root, cfg)
    _collect(cached, **kw)
    b = _collect(cached, **kw)
    assert cached._device_cache["n_cached"] == 2
    _assert_same(a, b)
    assert cached.scan_plan(shuffle=True, seed=1) is None  # partial: no plan


def test_cache_dtype_and_budget_resolution(tmp_path):
    root = _corpus(tmp_path)
    cfg = _cfg(root, "auto")
    b = _batcher(root, cfg)
    assert b._cache_dtype() == torch.float32
    assert b._clip_bytes() == 4 * 4 * 12 * 20 and b._clip_bytes(1) == 4 * 12 * 20
    assert b._cache_clip_count() == 5
    assert _batcher(root, _with(cfg, device_cache_dtype="float32"))._cache_dtype() == torch.float32
    assert _batcher(root, _with(cfg, device_cache_budget_mb=0))._cache_clip_count() == 0
    assert _batcher(root, _with(cfg, device_cache="on", device_cache_budget_mb=0)
                    )._cache_clip_count() == 5
    # refused at construction, not at the second epoch
    with pytest.raises(ValueError, match="compute_dtype"):
        _batcher(root, _with(cfg, device_cache_dtype="bfloat16"))
    with pytest.raises(ValueError, match="device_cache_dtype"):
        _batcher(root, _with(cfg, device_cache_dtype="uint8"))
    # bf16 compute: 'auto' stores bf16 (the model rounds its input first thing)
    assert _batcher(root, dataclasses.replace(cfg, model=ModelConfig(compute_dtype="bfloat16"))
                    )._cache_dtype() == torch.bfloat16
    _batcher(root, _with(cfg, device_cache="off", device_cache_dtype="uint8"))  # never read


@pytest.mark.parametrize("mode,budget", [("off", 4096), ("auto", 0)])
def test_off_and_a_zero_budget_never_cache(tmp_path, mode, budget):
    root = _corpus(tmp_path)
    b = _batcher(root, _cfg(root, mode, device_cache_budget_mb=budget))
    for _ in range(3):
        list(b.epoch(shuffle=False, drop_last=False))
    assert b._device_cache is None
    assert b.scan_plan() is None


def test_first_batch_does_not_count_as_an_epoch(tmp_path):
    root = _corpus(tmp_path)
    b = _batcher(root, _cfg(root, "auto"))
    b.first_batch()
    list(b.epoch())
    assert b._device_cache is None  # the first epoch() call streams
    list(b.epoch())
    assert b._device_cache is not None
    np.testing.assert_array_equal(b.first_batch()["video"].numpy(),
                                  _collect(b, shuffle=False, drop_last=False)[0]["video"])


def test_scan_plan_matches_the_jax_plan_and_the_cache(tmp_path):
    """None for the warm-up epoch under 'auto' (and that call is not
    counted); then the JAX package's (S, B) order for the same corpus and
    seed, the device labels and a gather equal to the streamed batches."""
    from avsync.config import AvsyncConfig as JaxConfig
    from avsync.config import DataConfig as JaxDataConfig
    from avsync.data import GridDataSource as JaxSource
    from avsync.data import LipNetBatcher as JaxBatcher

    root = _corpus(tmp_path, clips=7)
    cfg = _cfg(root, "auto")
    b = _batcher(root, cfg)
    assert b.scan_plan(shuffle=True, seed=9) is None and b._epoch_calls == 0
    streamed = _collect(b, shuffle=True, seed=9, drop_last=True)  # the warm-up epoch
    plan = b.scan_plan(shuffle=True, seed=9)
    jb = JaxBatcher(JaxSource(root), JaxConfig(data=JaxDataConfig(
        data_path=root, img_height=12, img_width=20, max_video_length=4, batch_size=2,
        device_cache="on")))
    jplan = jb.scan_plan(shuffle=True, seed=9)
    assert plan["idx"].dtype == np.int32 and plan["idx"].shape == (3, 2)
    np.testing.assert_array_equal(plan["idx"], jplan["idx"])
    for row, batch in zip(plan["idx"], streamed):
        rows = torch.from_numpy(row).long()
        np.testing.assert_array_equal(plan["gather"](rows).numpy(), batch["video"])
        np.testing.assert_array_equal(plan["labels"][rows].numpy(), batch["labels"])
        np.testing.assert_array_equal(plan["lengths"][rows].numpy(), batch["label_lengths"])
    assert _batcher(root, _with(cfg, batch_size=8)).scan_plan() is None  # S = 0
