"""The port's host utilities against the JAX package's, on the CPU:
profiling (`StepTimer`, `trace`, `MetricsWriter`), the FLOP model (equal
integers), the synthetic corpus (the same bytes for the same seed), the
data tooling, and the `train` command's flags reaching the config and the
run (device cache, remat, a profiler trace, resume)."""

import json
import os
import warnings

import numpy as np
import pytest

from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import synthetic as jax_synthetic
from avsync.data import tooling as jax_tooling
from avsync.utils import flops as jax_flops
from avsync_torch import cli
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.data import synthetic, tooling
from avsync_torch.data.grid import GridDataSource
from avsync_torch.utils import flops
from avsync_torch.utils.profiling import MetricsWriter, StepTimer, trace

FLOP_CONFIGS = [dict(), dict(hidden_dim=8, conv_channels=(2, 2, 3)),
                dict(hidden_dim=512, num_gru_layers=3, vocab_size=28)]


def test_step_timer_excludes_warmup(monkeypatch):
    ticks = iter([0.0, 5.0, 10.0, 11.0, 20.0, 22.0])
    monkeypatch.setattr("avsync_torch.utils.profiling.time.perf_counter", lambda: next(ticks))
    t = StepTimer(warmup=1)
    for _ in range(3):
        with t:
            pass
    assert t.times == [1.0, 2.0]
    s = t.summary()
    assert s["steps"] == 2 and s["mean_s"] == 1.5 and s["total_s"] == 8.0
    assert StepTimer().summary() == {"steps": 0}


def test_metrics_writer_round_trips(tmp_path):
    path = str(tmp_path / "m" / "metrics.jsonl")
    w = MetricsWriter(path)
    w.write(1, loss=np.float32(2.5), tag="a")
    w.write(2, loss=1.0)
    w.close()
    rows = MetricsWriter.read(path)
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[0]["loss"] == 2.5 and rows[0]["tag"] == "a"


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    doc = json.load(open(tmp_path / "prof" / "trace.json"))
    assert doc["traceEvents"]


def test_trace_warns_and_runs_untraced_without_a_profiler(tmp_path, monkeypatch):
    import torch.profiler

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with pytest.warns(UserWarning, match="tracing disabled"):
        with trace(str(tmp_path / "p")):
            ran.append(1)
    assert ran == [1] and not os.path.exists(tmp_path / "p" / "trace.json")


@pytest.mark.parametrize("kw", FLOP_CONFIGS, ids=["default", "tiny", "wide"])
def test_flops_equal_the_jax_package(kw):
    cfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    assert flops.conv_stack_flops(cfg, 75, 50, 100) == jax_flops.conv_stack_flops(jcfg, 75, 50,
                                                                                  100)
    assert flops.gru_stack_flops(cfg, 75, 6912) == jax_flops.gru_stack_flops(jcfg, 75, 6912)
    for shape in ((75, 50, 100), (8, 16, 32)):
        assert flops.lipnet_forward_flops(cfg, *shape) == jax_flops.lipnet_forward_flops(jcfg,
                                                                                         *shape)
        assert flops.lipnet_train_flops(cfg, *shape) == jax_flops.lipnet_train_flops(jcfg,
                                                                                     *shape)
    # MFU against the H100's dense fp32 peak (a datasheet figure)
    assert flops.h100_peak_flops() == 67e12
    assert flops.mfu(100.0, cfg) == pytest.approx(
        100.0 * jax_flops.lipnet_train_flops(jcfg) / 67e12, rel=1e-12)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("layout,preprocessed", [("flat", True), ("standard", True),
                                                 ("mixed", False)])
def test_write_corpus_writes_the_jax_packages_bytes(tmp_path, layout, preprocessed):
    kw = dict(n_speakers=2, clips_per_speaker=2, layout=layout, preprocessed=preprocessed,
              n_frames=6, height=12, width=20, seed=3)
    a = synthetic.write_corpus(str(tmp_path / "port"), **kw)
    b = jax_synthetic.write_corpus(str(tmp_path / "jax"), **kw)
    assert a == b == ["s1", "s2"]
    ours, theirs = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs) and any(k.endswith(".wav") for k in ours)
    assert ours == theirs


def test_synthetic_helpers_equal_the_jax_package():
    np.testing.assert_array_equal(synthetic.phrase_envelope("bin blue at f", 40),
                                  jax_synthetic.phrase_envelope("bin blue at f", 40))
    np.testing.assert_array_equal(synthetic.mouth_box((0.7, 0.4), 1.2, 60, 120),
                                  jax_synthetic.mouth_box((0.7, 0.4), 1.2, 60, 120))
    ours = synthetic.make_localizer_batch(np.random.default_rng(2), batch=3, height=40,
                                          width=80, n_frames=3)
    theirs = jax_synthetic.make_localizer_batch(np.random.default_rng(2), batch=3, height=40,
                                                width=80, n_frames=3)
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x, y)


@pytest.fixture
def videos_only(tmp_path):
    """Two speaker folders with videos and no transcripts."""
    for s in ("s1", "s2"):
        d = tmp_path / "corpus" / s
        d.mkdir(parents=True)
        for c in range(3):
            np.save(str(d / f"clip{c}.npy"), np.zeros((2, 4, 4), np.uint8))
    return str(tmp_path / "corpus")


def test_tooling_repairs_a_corpus_as_the_jax_package_does(videos_only, tmp_path, capsys):
    import shutil

    twin = str(tmp_path / "twin")
    shutil.copytree(videos_only, twin)
    assert tooling.check_data_structure_interactive(videos_only, assume_yes=False) == []
    assert tooling.create_dummy_alignments(videos_only, per_speaker=2, seed=5) == 4
    assert jax_tooling.create_dummy_alignments(twin, per_speaker=2, seed=5) == 4
    assert _tree_bytes(videos_only) == _tree_bytes(twin)
    assert tooling.check_data_structure_interactive(videos_only, assume_yes=True) == ["s1",
                                                                                      "s2"]
    assert all(s.text in tooling.GRID_PHRASES for s in GridDataSource(videos_only).samples)
    os.makedirs(os.path.join(str(tmp_path), "align"))
    assert tooling.find_alignment_files(videos_only, verbose=False) == os.path.join(
        str(tmp_path), "align")


def test_train_flags_reach_the_config():
    p = cli.build_parser()
    args = p.parse_args(["train", "--data_path", "d", "--device_cache", "on", "--remat",
                         "--log_dir", "L", "--checkpoint_every", "3", "--tensorboard",
                         "--compute_dtype", "float32", "--packed_conv", "--profile_dir", "P"])
    cfg = cli._config_from_args(args)
    assert (cfg.data.device_cache, cfg.train.remat, cfg.train.log_dir,
            cfg.train.checkpoint_every, cfg.train.tensorboard, cfg.model.compute_dtype,
            cfg.model.packed_conv, args.profile_dir) == ("on", True, "L", 3, True, "float32",
                                                         True, "P")
    # unset flags keep the config's (here the defaults, kernel flags on)
    cfg = cli._config_from_args(p.parse_args(["train", "--no-remat"]))
    assert (cfg.data.device_cache, cfg.train.remat, cfg.train.checkpoint_every,
            cfg.train.tensorboard, cfg.model.use_pallas_gru) == ("auto", False, 10, False, True)


def test_train_and_quantize_take_bfloat16_compute(tmp_path):
    """bf16 compute is ported (`train --compute_dtype bfloat16` runs:
    tests/test_torch_bf16.py), and so are the int8 forward and the
    calibration that feeds it (tests/test_torch_int8_bf16.py): `quantize`
    under bf16 is not refused and gets past its flags to the missing
    checkpoint."""
    p = cli.build_parser()
    cfg = cli._config_from_args(p.parse_args(["train", "--compute_dtype", "bfloat16"]))
    assert cfg.model.compute_dtype == "bfloat16"
    with pytest.raises((FileNotFoundError, OSError)):
        cli.main(["quantize", "--data_path", str(tmp_path), "--out", str(tmp_path / "q.npz"),
                  "--checkpoint", str(tmp_path / "none.pth"), "--compute_dtype", "bfloat16",
                  "--device", "cpu"])


def test_cli_train_with_device_cache_remat_and_a_trace_resumes(tmp_path):
    """`train --device_cache on --remat --profile_dir` on the CPU: every
    epoch runs as a program over the cache, the second is traced, and a
    resume for a third epoch continues the run."""
    from avsync_torch.utils.checkpoint import CheckpointManager

    root = str(tmp_path / "grid")
    synthetic.write_corpus(root, n_speakers=3, clips_per_speaker=2, n_frames=8, height=16,
                           width=32, seed=17, with_audio=False)
    cfg = AvsyncConfig(data=DataConfig(data_path=root, img_height=16, img_width=32,
                                       max_video_length=8, batch_size=2, max_label_length=6),
                       model=ModelConfig(hidden_dim=8, conv_channels=(2, 2, 3),
                                         use_pallas_gru=True, fused_conv_pool=True),
                       train=TrainConfig(learning_rate=1e-3))
    path = str(tmp_path / "cfg.json")
    open(path, "w").write(cfg.to_json())
    ck, prof = str(tmp_path / "ck"), str(tmp_path / "prof")
    common = ["--data_path", root, "--config", path, "--checkpoint_dir", ck, "--device", "cpu",
              "--device_cache", "on", "--remat"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(["train", *common, "--epochs", "2", "--profile_dir", prof]) == 0
    assert json.load(open(os.path.join(prof, "trace.json")))["traceEvents"]
    assert cli.main(["train", *common, "--epochs", "3", "--resume", "auto"]) == 0
    hist = json.load(open(os.path.join(ck, "history.json")))
    assert len(hist["loss"]) == 3 and np.all(np.isfinite(hist["loss"]))
    payload, meta = CheckpointManager(ck).restore()
    # two training speakers of two clips: 2 steps of B=2 per epoch
    assert payload["step"] == 6 and meta["metrics"]["epochs_completed"] == 3
