"""The port stands alone: no module of `avsync_torch` imports jax, flax or
anything of the `avsync` package, and its entry points refuse to fall back
to the CPU silently."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import avsync_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "avsync_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "avsync")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(avsync_torch.__path__, "avsync_torch."))


def test_every_module_imports_without_jax_or_avsync():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"the port pulled in {bad}"
    assert "avsync_torch.predictor" in loaded and "avsync_torch.serving" in loaded
    assert {"avsync_torch.train.lipnet_trainer", "avsync_torch.data.pipeline",
            "avsync_torch.utils.checkpoint", "avsync_torch.cli"} <= set(loaded)
    assert {"avsync_torch.ops.audio", "avsync_torch.ops.audio_ref", "avsync_torch.ops.cuda.mfcc",
            "avsync_torch.models.detector", "avsync_torch.features",
            "avsync_torch.train.detector_trainer"} <= set(loaded)
    assert {"avsync_torch.data.synthetic", "avsync_torch.data.tooling",
            "avsync_torch.utils.profiling", "avsync_torch.utils.flops",
            "avsync_torch.train.epoch_program", "avsync_torch.ops.ctc"} <= set(loaded)
    assert {"avsync_torch.export", "avsync_torch.ops.beam"} <= set(loaded)
    assert {"avsync_torch.ops.quant", "avsync_torch.ops.cuda.quantconv"} <= set(loaded)
    assert {"avsync_torch.ingest.native", "avsync_torch.models.localizer",
            "avsync_torch.data.mouth", "avsync_torch.train.localizer_trainer"} <= set(loaded)
    assert {"avsync_torch.ops.lstm", "avsync_torch.models.lipnet_tf"} <= set(loaded)
    assert {"avsync_torch.parallel", "avsync_torch.parallel.mesh",
            "avsync_torch.parallel.multihost", "avsync_torch.parallel.context"} <= set(loaded)
    # cv2 is a fallback imported when used, never at import (the card's
    # machine may have none)
    assert "cv2" not in loaded


def test_the_daemon_and_the_artifact_loader_import_no_model_code():
    """`serve --artifact` needs torch and the kernel operators only: the
    serving and export modules pull in neither the models nor the predictor
    (nor jax or the avsync package)."""
    code = ("import json, sys\n"
            "import avsync_torch.serving, avsync_torch.export, avsync_torch.ops.beam\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN
           or m.startswith(("avsync_torch.models", "avsync_torch.predictor"))]
    assert not bad, f"the serving modules pulled in {bad}"
    assert {"avsync_torch.ops.cuda.convpool", "avsync_torch.ops.cuda.gru",
            "avsync_torch.ops.cuda.mfcc"} <= set(loaded)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in
                                        [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
                                         *(ROOT / "scripts").glob("torch_*.py")]))
def test_no_import_statement_names_jax_or_avsync(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_lipreader_without_device_raises_when_cuda_is_absent(monkeypatch):
    from avsync_torch.predictor import LipReader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LipReader(params={}, device=None)


@pytest.mark.parametrize("make", ["scorer", "detector_trainer"])
def test_detector_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch, make):
    from avsync_torch.config import AvsyncConfig
    from avsync_torch.predictor import MisalignmentScorer
    from avsync_torch.train.detector_trainer import DetectorTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if make == "scorer":
            MisalignmentScorer(detector_params={}, lipnet_params={})
        else:
            DetectorTrainer(AvsyncConfig())


def test_config_json_round_trips_with_the_jax_package():
    from avsync.config import AvsyncConfig as JaxConfig, ModelConfig as JaxModelConfig
    from avsync_torch.config import AvsyncConfig, ModelConfig

    ours = AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True))
    assert JaxConfig.from_json(ours.to_json()).to_dict() == ours.to_dict()
    theirs = JaxConfig(model=JaxModelConfig(hidden_dim=8, conv_channels=(2, 3, 4)))
    assert AvsyncConfig.from_json(theirs.to_json()).to_dict() == theirs.to_dict()


@pytest.fixture(scope="module")
def full_width_pths(tmp_path_factory):
    from avsync_torch.compat import save_detector_pth, save_lipnet_pth
    from avsync_torch.config import ModelConfig
    from avsync_torch.models import LipNet, MisalignmentDetector

    root = tmp_path_factory.mktemp("entry_points")
    lip, det = str(root / "lip.pth"), str(root / "det.pth")
    save_lipnet_pth(LipNet(ModelConfig(), generator=torch.Generator()).state_dict(), lip)
    save_detector_pth(MisalignmentDetector(generator=torch.Generator()).state_dict(), det,
                      13864, 256, {})
    return lip, det


@pytest.mark.parametrize("entry", ["export", "export_sync_scorer", "serve", "serve_scorer"])
def test_serving_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch, tmp_path, full_width_pths, entry):
    """`export` and `serve` run on the card unless `--device cpu` is given."""
    from avsync_torch.cli import main

    lip, det = full_width_pths
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"export": ["export", "--checkpoint", lip, "--out", str(tmp_path / "a.zip")],
            "export_sync_scorer": ["export", "--checkpoint", lip, "--detector_checkpoint", det,
                                   "--out", str(tmp_path / "a.zip")],
            "serve": ["serve", "--checkpoint", lip, "--port", "0"],
            "serve_scorer": ["serve", "--checkpoint", lip, "--detector_checkpoint", det,
                             "--port", "0"]}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


@pytest.mark.parametrize("entry", ["quantize", "serve_int8", "infer_int8"])
def test_int8_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch, tmp_path, full_width_pths, entry):
    """`quantize`, `serve --quantize int8` and `infer --quantize int8` run on
    the card unless `--device cpu` is given."""
    from avsync_torch.cli import main

    lip, _ = full_width_pths
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"quantize": ["quantize", "--checkpoint", lip, "--data_path", str(tmp_path),
                         "--out", str(tmp_path / "q.npz")],
            "serve_int8": ["serve", "--checkpoint", lip, "--port", "0", "--quantize", "int8"],
            "infer_int8": ["infer", str(tmp_path / "clip.npy"), "--checkpoint", lip,
                           "--quantize", "int8"]}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
