"""Multi-process training of the port, as torchrun runs it: two OS processes
on this machine, each told its rank by RANK / WORLD_SIZE / LOCAL_RANK /
MASTER_ADDR / MASTER_PORT and joined by `multihost.initialize()` over gloo
on the CPU, run tests/_torch_multihost_worker.py (the port's counterpart of
tests/test_multihost.py). The test asserts that

  * both processes report the same losses (the ranks stay coherent);
  * those match a one-process run of the same helper on the whole batch;
  * a scanned epoch and a checkpoint round trip work across processes;
  * a SIGTERM to one process stops both at the same epoch boundary;
  * epoch 2 from the device cache equals the streamed epoch;
  * the partial cache splits its decode between the processes;
  * `cli train --distributed` under the same launch writes rank 0's whole
    snapshot, which a one-process `cli test` reads.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from avsync_torch.data import synthetic
from avsync_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
TIMEOUT = 600  # a rank that dies fails its peer's collective within 120 s


def _launch(argv, world=2, extra_env=None):
    """`world` processes of argv with torchrun's variables; (stdout, stderr)
    per rank."""
    port = multihost.free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="2", **(extra_env or {}))
        env.pop("JAX_PLATFORMS", None)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env, cwd=REPO))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{out[-3000:]}\n{err[-3000:]}"
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mh_corpus"))
    synthetic.write_corpus(root, n_speakers=2, clips_per_speaker=8, preprocessed=True,
                           n_frames=24, height=16, width=32, seed=11, with_audio=False)
    # 288 kB float32 clips: a 1 MB budget caches 3 of 16
    partial = str(tmp_path_factory.mktemp("mh_partial"))
    synthetic.write_corpus(partial, n_speakers=2, clips_per_speaker=8, preprocessed=True,
                           n_frames=24, height=48, width=64, seed=23, with_audio=False)
    return root, partial


@pytest.fixture(scope="module")
def results(corpora, tmp_path_factory):
    outs = []
    for r, (out, err) in enumerate(_launch([sys.executable, WORKER, *corpora,
                                            str(tmp_path_factory.mktemp("mh_out"))])):
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, f"no RESULT line from rank {r}:\n{out}\n{err[-2000:]}"
        outs.append(json.loads(line[-1][len("RESULT "):]))
    return outs


def _worker():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        import _torch_multihost_worker as w
    finally:
        sys.path.pop(0)
    return w


def test_processes_agree(results):
    a, b = results
    assert (a["rank"], b["rank"]) == (0, 1) and a["world"] == b["world"] == 2
    assert a["backend"] == "gloo"
    for key in ("stream", "cache", "scan", "partial"):
        assert a[key] == b[key] if key != "partial" else a[key]["losses"] == b[key]["losses"]


@pytest.mark.parametrize("mode", ["stream", "cache"])
def test_matches_a_one_process_run(results, corpora, mode):
    single = _worker().run_losses(corpora[0], mode)
    np.testing.assert_allclose(results[0][mode], single, rtol=2e-4, atol=1e-5)


def test_scan_epoch_and_checkpoint_roundtrip(results):
    a, b = results
    np.testing.assert_allclose(a["scan"]["losses"], a["stream"], rtol=2e-4, atol=1e-5)
    assert a["scan"]["ckpt_err"] == 0.0 and b["scan"]["ckpt_err"] == 0.0


def test_preemption_is_lockstep_across_processes(results):
    a, b = results
    assert a["preempt"] == b["preempt"]
    assert a["preempt"] == {"epochs_run": 2, "ckpt_latest": 3, "preempted_meta": True}


def test_cache_epoch2_matches_stream(results):
    assert results[0]["cache"] == results[0]["stream"]


def test_partial_cache_splits_decode_across_processes(results, corpora):
    """16 clips, 3 cached, B = 8: a one-process run decodes the 13 misses of
    each epoch; each of the two processes decodes at most its 4 rows of each
    of the 2 batches. Under 'auto' the second epoch() call builds the cache
    (a full decode of the prefix, prefetch included), so the steady state is
    the third epoch."""
    a, b = results
    single = _worker().run_partial_cache(corpora[1])
    assert a["partial"]["n_cached"] == single["n_cached"] == 3
    np.testing.assert_allclose(a["partial"]["losses"], single["losses"], rtol=2e-4, atol=1e-5)
    for r in (a, b):
        for ours, theirs in zip(r["partial"]["epoch_decodes"][2:], single["epoch_decodes"][2:]):
            assert ours <= 8 < theirs, (r["partial"], single)


def test_cli_train_distributed_checkpoint_loads_in_one_process(corpora, tmp_path):
    from avsync_torch.cli import main
    from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig

    root = corpora[0]
    cfg = AvsyncConfig(data=DataConfig(data_path=root, img_height=16, img_width=32,
                                       max_video_length=24, max_label_length=12, batch_size=4),
                       model=ModelConfig(hidden_dim=8, conv_channels=(2, 3, 4),
                                         use_pallas_gru=True, fused_conv_pool=True),
                       train=TrainConfig(learning_rate=1e-3, log_dir=str(tmp_path / "logs")))
    path = str(tmp_path / "cfg.json")
    open(path, "w").write(cfg.to_json())
    ck = str(tmp_path / "ck")
    outs = _launch([sys.executable, "-m", "avsync_torch.cli", "train", "--distributed",
                    "--device", "cpu", "--data_path", root, "--config", path, "--epochs", "1",
                    "--checkpoint_dir", ck, "--speakers", "s1", "s2"])
    assert "rank 0 of 2" in outs[0][0] and "mesh {'data': 2, 'model': 1}" in outs[0][0]
    # rank 1 names itself, then writes nothing more to the console
    assert outs[1][0].splitlines() == ["multi-process: rank 1 of 2 on cpu (gloo)"]
    assert os.path.exists(os.path.join(ck, "epoch_2.pth"))
    res = str(tmp_path / "res.json")
    assert main(["test", "--data_path", root, "--config", path, "--checkpoint", ck,
                 "--output", res, "--device", "cpu", "--speakers", "s1", "s2"]) == 0
    assert json.load(open(res))["num_samples"] > 0
