"""A whole run on the CPU at a tiny width, past the look for a card: the
last line's shape, and `correct` false with the timed path broken
underneath, once for each fault a cell can have."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from avbench.harness import spec

CHIP_SIZE_SEEDS = (2147483701, 2147483702, 2147483703)


def test_the_last_line(tiny):
    rc, line = tiny("lipnet.train")
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    bench = spec.benchmark()
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert line["device"]["count"] == 1 and "memory_peak_bytes" in line["device"]
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert line["attempted"] > 0 and line["failed"] == 0


def test_serve_line(tiny):
    rc, line = tiny("lipnet_tf.serve")
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"serve_p95_ms", "serve_requests_per_s", "setup_s"}
    assert line["attempted"] == 20 and list(line["checks"]) == ["served_gap", "logprob_err"]


def test_without_a_card_the_run_exits_without_a_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "avbench/run.py", "--workload", "lipnet.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_the_run_exits_without_a_result(tmp_path):
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "avbench", tmp_path / "avbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "avbench/run.py", "--workload", "lipnet.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


# -- faults planted in the program ------------------------------------------------

def _state_unchanged(monkeypatch):
    from avsync_torch.train import lipnet_trainer

    monkeypatch.setattr(lipnet_trainer, "_apply_update",
                        lambda model, optimizer, clip, mesh: lipnet_trainer.clip_grad_norm(
                            model.named_parameters(), clip, mesh).detach())


def _half_batch(monkeypatch):
    from avsync_torch.train import lipnet_trainer

    loss = lipnet_trainer.lipnet_ctc_loss

    def half(model, log_probs, batch):
        h = log_probs.shape[0] // 2
        return loss(model, log_probs[:h], {k: v[:h] for k, v in batch.items()})

    monkeypatch.setattr(lipnet_trainer, "lipnet_ctc_loss", half)


@pytest.mark.parametrize("cell", ["lipnet.train", "lipnet_tf.train"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_broken_training_step_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line = tiny(cell)
    assert rc == 0 and line["correct"] is False


def _altered_token(monkeypatch):
    from avsync_torch.predictor import LipReader

    decode = LipReader._decode

    def altered(self, log_probs):
        return [("q" if t[:1] != "q" else "r") + t[1:] for t in decode(self, log_probs)]

    monkeypatch.setattr(LipReader, "_decode", altered)


def _half_answered(monkeypatch):
    from avsync_torch.predictor import LipReader
    from avbench.kinds import serve

    decode = LipReader._decode
    monkeypatch.setattr(LipReader, "_decode",
                        lambda self, lp: decode(self, lp)[:max(1, lp.shape[0] // 2)])
    monkeypatch.setattr(serve, "LATE_WAIT_S", 1.0)


@pytest.mark.parametrize("cell", ["lipnet.serve", "lipnet_tf.serve"])
@pytest.mark.parametrize("fault", [_altered_token, _half_answered])
def test_a_broken_service_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line = tiny(cell)
    assert rc == 0 and line["correct"] is False


# -- the controls ----------------------------------------------------------------

@pytest.mark.parametrize("cell", ["lipnet_tf.train", "lipnet.train"])
def test_the_control_reads_worse_than_the_program(tiny, cell, capsys):
    import avbench.control as control

    rc, line = tiny(cell)
    program = max(v["value"] for k, v in line["checks"].items() if k != "window_losses_finite")
    capsys.readouterr()
    assert control.main(["--workload", cell, "--seed", "2147483659", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["readings"]
    assert max(got[k] for k in line["checks"] if k in got) > program


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lipnet.train", "lipnet_tf.train"])
def test_the_control_fails_the_limits_at_the_cells_size(cell, card):
    proc = subprocess.run(
        [sys.executable, "avbench/control.py", "--workload", cell]
        + [a for s in CHIP_SIZE_SEEDS for a in ("--seed", str(s))],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert len(rows) == len(CHIP_SIZE_SEEDS) and all(r["fails"] for r in rows)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's size")
