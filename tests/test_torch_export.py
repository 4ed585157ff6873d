"""Export through torch.export (`avsync_torch/export.py`) and the artifact
services, on the CPU at a tiny size. Mirrors tests/test_export.py and
tests/test_serving.py's TestArtifactServing: the artifact against the
port's live reader (texts equal, log-probs atol 1e-6) and against the JAX
package's LipReader on the same weights (texts equal, log-probs atol 5e-5,
the bound of tests/test_model_parity.py); the sync scorer against the JAX
MisalignmentScorer (atol 1e-5); the kernel operators' fakes against their
CPU implementations.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from avsync.compat import save_detector_pth, save_lipnet_pth
from avsync.config import AudioConfig as JaxAudioConfig
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.models import LipNet as JaxLipNet
from avsync.models import MisalignmentDetector as JaxDetector
from avsync_torch.config import AudioConfig, AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.export import export_sync_scorer, export_transcriber, load_exported

ROOT = Path(__file__).resolve().parents[1]
DATA = dict(img_height=16, img_width=32, max_video_length=8)
MODEL = dict(hidden_dim=8, conv_channels=(2, 3, 4))
S = 8000
SHIFTS = (-4, -2, 0, 2, 4)
CFG = AvsyncConfig(data=DataConfig(**DATA),
                   model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True, **MODEL),
                   audio=AudioConfig(max_audio_samples=S, use_pallas=True))
JAX_CFG = JaxConfig(data=JaxDataConfig(**DATA), model=JaxModelConfig(**MODEL),
                    audio=JaxAudioConfig(max_audio_samples=S))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_export")
    params = JaxLipNet(JAX_CFG.model).init({"params": jax.random.PRNGKey(0)},
                                           jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(0)
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.3, np.shape(p))).astype(
        np.float32), params)
    lip = str(root / "lipnet.pth")
    save_lipnet_pth(params, lip, conv_shape=(4, 2, 4))
    feat_dim = 2 * 4 * 2 * 4 + 40
    det_params = JaxDetector(hidden_dim=16).init({"params": jax.random.PRNGKey(1)},
                                                 jnp.zeros((1, feat_dim)))["params"]
    det = str(root / "detector.pth")
    save_detector_pth(jax.device_get(det_params), det, feat_dim, 16,
                      {"sample_rate": 16000, "n_mfcc": 20, "max_shift_frames": 10},
                      conv_shape=(4, 2, 4), n_audio_feats=40)
    return {"lipnet": lip, "detector": det, "root": root}


@pytest.fixture(scope="module")
def reader(ckpts):
    from avsync_torch.predictor import LipReader

    return LipReader(checkpoint=ckpts["lipnet"], config=CFG, device="cpu")


@pytest.fixture(scope="module")
def artifacts(ckpts):
    """Saved artifacts: a symbolic-batch transcriber, a static (1, 2, 4)
    one, a native-geometry (32x64, embedded ROI) one and a K=5 sync scorer."""
    root = ckpts["root"]
    paths = {}
    for name, kw in (("symbolic", {}), ("static", dict(batch_sizes=(1, 2, 4))),
                     ("roi", dict(frame_geometry=(32, 64)))):
        paths[name] = str(root / f"{name}.zip")
        export_transcriber(ckpts["lipnet"], CFG, device="cpu", **kw).save(paths[name])
    paths["scorer"] = str(root / "scorer.zip")
    export_sync_scorer(ckpts["detector"], ckpts["lipnet"], CFG, num_shifts=len(SHIFTS),
                       device="cpu").save(paths["scorer"])
    return paths


@pytest.fixture(scope="module")
def loaded(artifacts):
    return {name: load_exported(path) for name, path in artifacts.items()}


def _frames(seed, shape=(8, 16, 32)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_transcriber_matches_the_live_reader(loaded, reader):
    frames = _frames(5, (3, 8, 16, 32))
    art = loaded["symbolic"]
    assert art.transcribe(frames) == [reader.predict_frames(f) for f in frames]
    ids, lengths, log_probs = art.call(frames)
    assert ids.dtype == np.int32 and lengths.dtype == np.int32 and log_probs.shape == (3, 8, 39)
    want = reader._logprobs(reader.preprocess_device(frames)).numpy()
    np.testing.assert_allclose(log_probs, want, rtol=0, atol=1e-6)


def test_transcriber_matches_the_jax_reader(loaded, ckpts):
    from avsync.predictor import LipReader as JaxLipReader

    jreader = JaxLipReader(ckpts["lipnet"], JAX_CFG)
    frames = _frames(6, (4, 8, 16, 32))
    art = loaded["symbolic"]
    assert art.transcribe(frames) == [jreader.predict_frames(f) for f in frames]
    want = np.asarray(jreader._logprobs(jreader.preprocess_device(frames)))
    np.testing.assert_allclose(art.call(frames)[2], want, rtol=0, atol=5e-5)


def test_symbolic_batch(loaded):
    """One program for every batch size; a row's result does not depend on
    the batch it rode in."""
    art = loaded["symbolic"]
    assert art.batch_sizes is None
    frames = _frames(7, (5, 8, 16, 32))
    _, _, lp5 = art.call(frames)
    for B in (1, 3, 5):
        ids, lengths, lp = art.call(frames[:B])
        assert lp.shape[0] == B
        np.testing.assert_allclose(lp, lp5[:B], rtol=0, atol=1e-6)


def test_static_buckets_pad_and_match_the_symbolic_program(loaded):
    sym, stat = loaded["symbolic"], loaded["static"]
    assert stat.batch_sizes == [1, 2, 4]
    assert stat.meta["batch_sizes"] == [1, 2, 4]
    frames = _frames(23, (4, 8, 16, 32))
    for B in (1, 2, 3, 4):  # 3 rides in the 4-bucket and is cut back
        ids_s, len_s, lp_s = sym.call(frames[:B])
        ids_t, len_t, lp_t = stat.call(frames[:B])
        assert lp_t.shape[0] == B
        np.testing.assert_array_equal(ids_t, ids_s)
        np.testing.assert_array_equal(len_t, len_s)
        np.testing.assert_allclose(lp_t, lp_s, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="largest exported bucket"):
        stat.call(np.zeros((5, 8, 16, 32), np.uint8))


def test_short_clip_zero_padded(loaded, reader):
    short = _frames(9, (5, 16, 32))
    assert loaded["symbolic"].transcribe(short) == [reader.predict_frames(short)]


def test_metadata_self_describes(artifacts, loaded):
    with zipfile.ZipFile(artifacts["symbolic"]) as z:
        assert z.namelist() == ["program.pt2"]
        program = z.read("program.pt2")
    with zipfile.ZipFile(artifacts["static"]) as z:
        assert sorted(z.namelist()) == ["program_b1.pt2", "program_b2.pt2", "program_b4.pt2"]
    extra = {"meta.json": ""}
    torch.export.load(io.BytesIO(program), extra_files=extra)  # the record rides in extra_files
    meta = json.loads(extra["meta.json"])
    assert meta == loaded["symbolic"].meta
    assert meta["format"] == "avsync-torch-export-v1" and meta["kind"] == "transcriber"
    assert meta["family"] == "pytorch" and meta["frame_shape"] == [8, 16, 32]
    assert meta["device"] == "cpu" and meta["batch_sizes"] is None
    assert meta["blank_id"] == 0 and meta["id_to_char"]["1"] == "a"
    assert meta["roi"] == "none (pre-cropped)"
    assert AvsyncConfig.from_dict(meta["config"]).to_dict() == CFG.to_dict()
    assert loaded["roi"].meta["roi"] == "embedded:heuristic"


def test_save_writes_exact_path_and_non_artifacts_are_rejected(loaded, tmp_path):
    out = str(tmp_path / "lipnet_serving.bin")
    loaded["symbolic"].save(out)
    assert os.path.exists(out) and not os.path.exists(out + ".zip")
    assert load_exported(out).meta == loaded["symbolic"].meta
    not_zip = tmp_path / "bogus.zip"
    not_zip.write_bytes(b"not an archive")
    empty = str(tmp_path / "empty.zip")
    with zipfile.ZipFile(empty, "w") as z:
        z.writestr("other.txt", "x")
    for path in (str(not_zip), empty):
        with pytest.raises(ValueError, match="not an avsync_torch export"):
            load_exported(path)


def test_card_artifact_without_a_gpu_raises(loaded, tmp_path, monkeypatch):
    """An artifact exported for the card does not move to the CPU."""
    art = loaded["symbolic"]
    path = str(tmp_path / "card.zip")
    meta = dict(art.meta, device="cuda:0")
    from avsync_torch import export

    export._save(path, art._exported, meta)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(path)


def test_bad_frames_rejected(loaded):
    art = loaded["symbolic"]
    with pytest.raises(ValueError, match="expects 16x32"):
        art.call(np.zeros((1, 8, 20, 40), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        art.call(np.random.default_rng(0).random((1, 8, 16, 32), np.float32))
    with pytest.raises(ValueError, match="range"):
        art.call(np.full((1, 8, 16, 32), 300, np.int32))
    with pytest.raises(ValueError, match="expected .* frames"):
        art.call(np.zeros((16, 32), np.uint8))
    ids, _, _ = art.call(np.full((1, 8, 16, 32), 128, np.int32))  # in-range ints pass
    assert ids.shape[0] == 1


def test_native_geometry_embeds_the_heuristic_roi(loaded, reader):
    frames = _frames(11, (2, 8, 32, 64))
    art = loaded["roi"]
    assert art.transcribe(frames) == [reader.predict_frames(f) for f in frames]
    want = reader._logprobs(reader.preprocess_device(frames)).numpy()
    np.testing.assert_allclose(art.call(frames)[2], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["detector", "model", "variance"])
def test_unported_roi_modes_raise(ckpts, mode):
    """The device ROI modes embed in the artifact ('variance', and 'model'
    with the localizer's weights as buffers) and give the live reader's
    log-probs; 'detector', a host cascade, raises the JAX package's
    ValueError (avsync/export.py:218-223)."""
    from avsync_torch.predictor import LipReader

    cfg = dataclasses.replace(CFG, data=dataclasses.replace(CFG.data, roi_mode=mode))
    if mode == "detector":
        with pytest.raises(ValueError, match="roi_mode='detector' runs a host-side cascade"):
            export_transcriber(ckpts["lipnet"], cfg, frame_geometry=(32, 64), device="cpu")
        return
    art = export_transcriber(ckpts["lipnet"], cfg, frame_geometry=(32, 64), device="cpu")
    assert art.meta["roi"] == f"embedded:{mode}"
    if mode == "model":
        assert {n for n, _ in art._exported[None].named_buffers()} >= {
            "prep.localizer.conv1.weight", "prep.localizer.fc2.bias"}
    live = LipReader(checkpoint=ckpts["lipnet"], config=cfg, device="cpu")
    frames = _frames(13, (3, 8, 32, 64))
    want = live._logprobs(live.preprocess_device(frames)).numpy()
    np.testing.assert_allclose(art.call(frames)[2], want, rtol=0, atol=1e-6)


def test_sync_scorer_matches_the_jax_scorer(loaded, ckpts):
    from avsync.predictor import MisalignmentScorer as JaxScorer
    from avsync_torch.predictor import MisalignmentScorer

    art = loaded["scorer"]
    assert art.meta["kind"] == "sync_scorer" and art.meta["num_shifts"] == len(SHIFTS)
    jscorer = JaxScorer(ckpts["detector"], ckpts["lipnet"], JAX_CFG)
    live = MisalignmentScorer(ckpts["detector"], ckpts["lipnet"], config=CFG, device="cpu")
    r = np.random.default_rng(17)
    for n in (0, 3000, 9000):  # no audio, partial, longer than max_audio_samples
        frames = r.integers(0, 256, (8, 16, 32), np.uint8)
        audio = (r.standard_normal(n) * 0.2).astype(np.float32)
        got = art.score_arrays(frames, audio, 25.0, SHIFTS)
        assert got.shape == (len(SHIFTS),)
        np.testing.assert_allclose(got, jscorer.score_arrays(frames, audio, 25.0, SHIFTS),
                                   atol=1e-5)
        np.testing.assert_allclose(got, live.score_arrays(frames, audio, 25.0, SHIFTS),
                                   atol=1e-6)
    rows = [art.prepare_row(_frames(i), np.full(100 * i, 0.1, np.float32), 25.0, SHIFTS)
            for i in range(3)]
    batch = art.call(*(np.concatenate(p) for p in zip(*rows)))
    for i, row in enumerate(rows):
        np.testing.assert_allclose(batch[i], art.call(*row)[0], atol=1e-6)
    with pytest.raises(ValueError, match="5 shifts per request"):
        art.score_arrays(_frames(0), np.zeros(10, np.float32), 25.0, (0, 2))


def test_loads_and_runs_without_the_model_code(artifacts, reader):
    """torch and the kernel operators suffice: the program runs with
    `avsync_torch.models` and `avsync_torch.predictor` never imported."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from avsync_torch.export import load_exported\n"
        f"art = load_exported({artifacts['symbolic']!r})\n"
        "frames = np.random.default_rng(15).integers(0, 256, (2, 8, 16, 32), np.uint8)\n"
        "texts = art.transcribe(frames)\n"
        "bad = [m for m in sys.modules if m.startswith(('avsync_torch.models', "
        "'avsync_torch.predictor', 'avsync_torch.features', 'jax')) or m == 'avsync']\n"
        "print(json.dumps({'texts': texts, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    frames = np.random.default_rng(15).integers(0, 256, (2, 8, 16, 32), np.uint8)
    assert res["texts"] == [reader.predict_frames(f) for f in frames]


# ---------------------------------------------------------------------------
# the artifact services and `serve --artifact`
# ---------------------------------------------------------------------------


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(url, data, ctype):
    req = urllib.request.Request(url, data=data, method="POST", headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_artifact_services_over_http(loaded, reader):
    """Transcripts equal the live reader's (short clips padded on T);
    concurrent clients coalesce; sync scores equal the artifact's own."""
    from avsync_torch.serving import (ArtifactSyncScoreService, ArtifactTranscribeService,
                                      AvsyncServer)

    svc = ArtifactTranscribeService(loaded["symbolic"], max_batch=4, max_wait_ms=200.0)
    svc.warmup()
    scorer = ArtifactSyncScoreService(loaded["scorer"], max_batch=4, max_wait_ms=5.0)
    srv = AvsyncServer(svc, scorer, port=0)
    srv.start()
    try:
        url = f"http://{srv.address[0]}:{srv.address[1]}"
        frames = _frames(40)
        for clip in (frames, frames[:5]):
            out = _post(url + "/v1/transcribe", _npy(clip), "application/x-npy")
            assert out["transcript"] == reader.predict_frames(clip)
        results, errors = [], []

        def client():
            try:
                results.append(_post(url + "/v1/transcribe", _npy(frames),
                                     "application/x-npy")["transcript"])
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and results == [reader.predict_frames(frames)] * 4
        with urllib.request.urlopen(url + "/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert any(int(k) > 1 for k in stats["transcribe"]["batches"])
        audio = (np.sin(np.linspace(0, 120, 6000)) * 0.4).astype(np.float32)
        got = scorer.score_arrays(frames, audio, 25.0, SHIFTS, timeout=60)
        np.testing.assert_allclose(got, loaded["scorer"].score_arrays(frames, audio, 25.0,
                                                                      SHIFTS), atol=1e-7)
        with pytest.raises(ValueError, match="5 shifts"):
            scorer.score_arrays(frames, audio, 25.0, (0, 1, 2))
        with pytest.raises(ValueError, match="one .* clip per request"):
            svc.transcribe_frames(np.zeros((2, 8, 16, 32), np.uint8))
    finally:
        srv.shutdown(drain_timeout=5.0)


def test_artifact_service_kinds_and_the_static_clamp(artifacts, loaded):
    from avsync_torch.serving import ArtifactSyncScoreService, ArtifactTranscribeService

    with pytest.raises(ValueError, match="not a transcriber"):
        ArtifactTranscribeService(artifacts["scorer"])
    with pytest.raises(ValueError, match="not a sync_scorer"):
        ArtifactSyncScoreService(artifacts["symbolic"])
    svc = ArtifactTranscribeService(artifacts["static"], max_batch=8, max_wait_ms=1.0)
    try:
        assert svc.batcher.max_batch == 4
        frames = _frames(31)
        assert svc.transcribe_frames(frames, timeout=60) == loaded["static"].transcribe(
            frames)[0]
    finally:
        svc.close()


def test_serve_artifact_flags(artifacts, loaded, tmp_path):
    from avsync_torch import export
    from avsync_torch.cli import build_parser, cmd_serve

    p = build_parser()
    args = p.parse_args(["serve", "--artifact", "a.zip", "--artifact", "b.zip", "--port", "0"])
    assert args.func is cmd_serve and args.artifact == ["a.zip", "b.zip"]
    assert args.checkpoint is None
    art = artifacts["symbolic"]
    for extra in (["--checkpoint", "x.pth"], ["--detector_checkpoint", "d.pth"],
                  ["--quantize", "int8"], ["--dp", "2"]):
        with pytest.raises(SystemExit):
            cmd_serve(p.parse_args(["serve", "--artifact", art, *extra]))
    bogus = str(tmp_path / "bogus.zip")
    export._save(bogus, loaded["symbolic"]._exported,
                 dict(loaded["symbolic"].meta, kind="detector"))
    with pytest.raises(SystemExit, match="unknown artifact kind"):
        cmd_serve(p.parse_args(["serve", "--artifact", bogus]))


def test_cli_export(ckpts, tmp_path, capsys):
    from avsync_torch.cli import main

    cfg = str(tmp_path / "tiny.json")
    Path(cfg).write_text(CFG.to_json())
    out = str(tmp_path / "cli.zip")
    assert main(["export", "--checkpoint", ckpts["lipnet"], "--config", cfg, "--out", out,
                 "--batch_sizes", "1,2", "--device", "cpu"]) == 0
    assert "static buckets [1, 2]" in capsys.readouterr().out
    assert load_exported(out).batch_sizes == [1, 2]
    with pytest.raises(SystemExit, match="positive"):
        main(["export", "--checkpoint", ckpts["lipnet"], "--config", cfg, "--out", out,
              "--batch_sizes", "0,2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the kernel operators' fakes
# ---------------------------------------------------------------------------


def _op_cases():
    g = torch.Generator().manual_seed(0)
    H = 5  # not a multiple of 8: the CUDA launch pads it, the fake must not
    gi = [torch.randn(2, 4, 3 * H, generator=g) for _ in range(2)]
    w = [torch.randn(3 * H, H, generator=g).t() for _ in range(2)]
    b = [torch.randn(3 * H, generator=g) for _ in range(2)]
    power = torch.rand(3, 7, 33, generator=g)
    return {
        "conv1_pool": (torch.ops.avsync_torch.conv1_pool,
                       (torch.rand(2, 1, 3, 6, 10, generator=g),
                        torch.randn(4, 1, 3, 3, 5, generator=g), torch.randn(4, generator=g))),
        "bigru_fwd": (torch.ops.avsync_torch.bigru_fwd, (*gi, *w, *b)),
        "mel_stats": (torch.ops.avsync_torch.mel_stats,
                      (power, torch.tensor([7, 3, 0], dtype=torch.int32),
                       torch.rand(33, 6, generator=g), torch.rand(6, 4, generator=g), 80.0)),
    }


@pytest.mark.parametrize("name", ["conv1_pool", "bigru_fwd", "mel_stats"])
def test_operator_fake_gives_the_shapes_of_its_cpu_implementation(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = _op_cases()[name]
    real = op(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
        fake = op(*fake_args)
    assert fake.shape == real.shape and fake.dtype == real.dtype == torch.float32
    assert fake.device == real.device
