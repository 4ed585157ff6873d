"""`--model_family tf` through the port's command line (`avsync_torch/cli.py`)
against the JAX package's, on a tiny synthetic GRID corpus on the CPU:
the config the flag gives, `train` (a snapshot naming the family), `test`
(greedy, beam and int8), `infer`, `quantize`, `export` and its artifact, the
daemon's answers, and the refusals (a reference `.pth`, the detector).

The JAX package reads TF-family weights only from Orbax directories, so its
commands run in-process with its checkpoint loader handed the same weights
(`avsync.cli._load_lipnet_params`, which its LipReader calls too); the port
reads them from its own checkpoint directory. Same weights, same corpus:
the same CER/WER JSON, transcripts and scales (rtol 1e-5).
"""

import contextlib
import dataclasses
import io
import json
import os
import urllib.request

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import avsync.cli as jax_cli
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import synthetic
from avsync.models import make_lipnet as jax_make_lipnet
from avsync_torch import cli, text
from avsync_torch.compat import save_lipnet_pth, tflipnet_params_from_jax
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.utils.checkpoint import CheckpointManager

MODEL = dict(family="tf", hidden_dim=8, conv_channels=(2, 3, 4), dropout_rate=0.0)
DATA = dict(img_height=16, img_width=32, max_video_length=8, batch_size=2,
            standardize_clips=True, device_cache="off")
CONV_SHAPE = (4, 2, 4)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A corpus, a tf-family config file, random TF weights (perturbed so the
    transcripts are not empty) as JAX params and as a port snapshot."""
    root = tmp_path_factory.mktemp("tf_cli")
    data = str(root / "grid")
    synthetic.write_corpus(data, n_speakers=3, clips_per_speaker=2, n_frames=8, height=16,
                           width=32, seed=17, with_audio=False)
    cfg = AvsyncConfig(data=DataConfig(**DATA), model=ModelConfig(**MODEL),
                       train=TrainConfig(learning_rate=1e-3))
    cfg_path = str(root / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    jmodel = jax_make_lipnet(JaxModelConfig(**MODEL))
    params = jmodel.init({"params": jax.random.PRNGKey(4)}, jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(4)
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 1.0, np.shape(p))).astype(
        np.float32), params)
    ck = str(root / "ck")
    CheckpointManager(ck).save(1, tflipnet_params_from_jax(params, CONV_SHAPE), config=cfg)
    clip = sorted(p for p in (os.path.join(dp, n) for dp, _, ns in os.walk(data) for n in ns)
                  if p.endswith(".npy"))[0]
    return {"root": root, "data": data, "cfg": cfg, "cfg_path": cfg_path, "params": params,
            "ck": ck, "clip": clip}


@pytest.fixture
def jax_weights(tiny, monkeypatch):
    """The JAX package's checkpoint loader hands back the fixture's weights."""
    monkeypatch.setattr(jax_cli, "_load_lipnet_params",
                        lambda checkpoint, model, cfg=None: jax.tree.map(jnp.asarray,
                                                                         tiny["params"]))


def _common(tiny):
    return ["--data_path", tiny["data"], "--config", tiny["cfg_path"], "--model_family", "tf"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

KERNEL_FLAGS = ("use_pallas_gru", "fused_conv_pool")


def _sections(cfg):
    model = {k: v for k, v in dataclasses.asdict(cfg.model).items() if k not in KERNEL_FLAGS}
    return dataclasses.asdict(cfg.data), model


@pytest.mark.parametrize("base", ["none", "pytorch_config", "tf_config"])
def test_model_family_tf_gives_the_jax_config(base, tiny, tmp_path):
    """Over no config and over a PyTorch-family one the flag switches to the
    TF widths and geometry (46x140, standardized); over a TF-family config
    it keeps the file's. Every command's config does the same."""
    extra = ["--data_path", "d", "--model_family", "tf"]
    if base != "none":
        path = str(tmp_path / "c.json")
        src = tiny["cfg"] if base == "tf_config" else AvsyncConfig(
            data=DataConfig(img_height=20, img_width=40), model=ModelConfig(hidden_dim=16))
        with open(path, "w") as f:
            f.write(src.to_json())
        extra += ["--config", path]
    ours = cli._config_from_args(cli.build_parser().parse_args(["test", "--checkpoint", "c",
                                                                *extra]))
    theirs = jax_cli._config_from_args(jax_cli.build_parser().parse_args(
        ["test", "--checkpoint", "c", *extra]))
    assert _sections(ours) == _sections(theirs)
    assert ours.model.family == "tf"
    if base == "tf_config":
        assert ours.model.conv_channels == (2, 3, 4) and ours.data.img_width == 32
    else:
        assert ours.model.conv_channels == (128, 256, 64)
        assert (ours.data.img_height, ours.data.img_width, ours.data.standardize_clips) == (
            46, 140, True)
    parser = cli.build_parser()
    for cmd, to_config in (("serve", cli._serving_config), ("export", cli._serving_config),
                           ("misalign-eval", cli._detector_config_from_args)):
        cfg = to_config(parser.parse_args([cmd, "--checkpoint", "c", *extra]))
        assert (cfg.model.family, cfg.model.conv_channels, cfg.data.img_width) == (
            "tf", ours.model.conv_channels, ours.data.img_width)


# ---------------------------------------------------------------------------
# train, test, infer, quantize, export
# ---------------------------------------------------------------------------

def test_train_writes_a_tf_snapshot(tiny, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert cli.main(["train", *_common(tiny), "--epochs", "2", "--checkpoint_dir", ck,
                     "--show_examples", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prediction:" in out and "Test results:" in out
    payload, meta = CheckpointManager(ck).restore()
    assert meta["config"]["model"]["family"] == "tf" and meta["metrics"]["epochs_completed"] == 2
    assert "lstm1.weight_ih_l0" in payload["model_state_dict"]
    with open(os.path.join(ck, "history.json")) as f:
        assert np.all(np.isfinite(json.load(f)["loss"]))
    with open(os.path.join(ck, "test_results.json")) as f:
        assert json.load(f)["num_samples"] == 2
    with pytest.raises(ValueError, match="export_pth"):
        cli.main(["train", *_common(tiny), "--epochs", "1", "--checkpoint_dir", ck,
                  "--export_pth", str(tmp_path / "x.pth"), "--device", "cpu"])


@pytest.mark.parametrize("extra", [[], ["--beam", "3"], ["--quantize", "int8"]],
                         ids=["greedy", "beam3", "int8"])
def test_test_json_equals_the_jax_evaluation(tiny, jax_weights, tmp_path, extra):
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    assert cli.main(["test", *_common(tiny), "--checkpoint", tiny["ck"], "--output", ours,
                     "--device", "cpu", *extra]) == 0
    assert jax_cli.main(["test", *_common(tiny), "--checkpoint", "weights", "--output", theirs,
                         *extra]) == 0
    with open(ours) as f, open(theirs) as g:
        got, want = json.load(f), json.load(g)
    assert got == want and got["num_samples"] == 2


def _printed(main, argv, prefix="Predicted:"):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [ln for ln in buf.getvalue().splitlines() if ln.startswith(prefix)]


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8"]], ids=["f32", "int8"])
def test_infer_prints_the_jax_transcript(tiny, jax_weights, extra):
    ours = _printed(cli.main, ["infer", tiny["clip"], *_common(tiny), "--checkpoint", tiny["ck"],
                               "--device", "cpu", *extra])
    theirs = _printed(jax_cli.main, ["infer", tiny["clip"], "--config", tiny["cfg_path"],
                                     "--model_family", "tf", "--checkpoint", "weights", *extra])
    assert len(ours) == 1 and ours == theirs
    assert set(ours[0][len("Predicted: "):]) <= set(text.TF_CHARACTERS)


def test_quantize_writes_the_jax_scales(tiny, jax_weights, tmp_path):
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    assert cli.main(["quantize", *_common(tiny), "--checkpoint", tiny["ck"], "--out", ours,
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["quantize", *_common(tiny), "--checkpoint", "weights",
                         "--out", theirs]) == 0
    with np.load(ours) as a, np.load(theirs) as b:
        assert str(a["family"]) == str(b["family"]) == "tf"
        np.testing.assert_allclose(a["input_scales"], b["input_scales"], rtol=1e-5)
    # the scales serve an int8 reader; a PyTorch-family scales file is refused
    from avsync_torch.predictor import LipReader

    reader = LipReader(checkpoint=tiny["ck"], config=tiny["cfg"], device="cpu",
                       quantize="int8", calibration_scales=ours)
    assert set(reader.predict(tiny["clip"])) <= set(text.TF_CHARACTERS)
    bad = str(tmp_path / "pytorch.npz")
    np.savez(bad, input_scales=np.ones(3, np.float32), family="pytorch")
    with pytest.raises(ValueError, match="family"):
        LipReader(checkpoint=tiny["ck"], config=tiny["cfg"], device="cpu", quantize="int8",
                  calibration_scales=bad)


def test_export_artifact_equals_the_live_reader(tiny, tmp_path):
    from avsync_torch.export import load_exported
    from avsync_torch.predictor import LipReader

    out = str(tmp_path / "tf.zip")
    assert cli.main(["export", *_common(tiny), "--checkpoint", tiny["ck"], "--out", out,
                     "--batch_sizes", "1,4", "--device", "cpu"]) == 0
    art = load_exported(out)
    assert art.meta["family"] == "tf" and art.meta["blank_id"] == text.TF_BLANK_ID
    assert art.meta["id_to_char"] == {str(i): c for i, c in text.TF_IDX_TO_CHAR.items()}
    reader = LipReader(checkpoint=tiny["ck"], config=tiny["cfg"], device="cpu")
    frames = np.random.default_rng(9).integers(0, 256, (3, 8, 16, 32), np.uint8)
    ids, lengths, lp = art.call(frames)
    # Three rows run in the bucket of 4, zero-padded: the artifact's program
    # is the live reader's function on that batch, bit for bit.
    padded = np.concatenate([frames, np.zeros_like(frames[:1])])
    np.testing.assert_array_equal(
        lp, reader._logprobs(reader.preprocess_device(padded)).numpy()[:3])
    # Against the live reader's own batch of 3, the products have M = 3 T
    # rows, not 4 T, and the CPU GEMM blocks and sums them in another order:
    # each sum rounds to within an ulp or two of its size. The head's logits
    # are of the log-probs' size (the perturbed weights drive them to about
    # -1,600 and the largest logit's log-prob to 0), and log_softmax adds one
    # rounding of the log-sum-exp, so each log-prob moves by a few ulps of
    # max|log-prob|: held to 8 of them (1.95e-3 at max|lp| = 2,211).
    want = reader._logprobs(reader.preprocess_device(frames))
    np.testing.assert_allclose(lp, want.numpy(), atol=8 * np.spacing(np.abs(lp).max()),
                               rtol=0)
    assert art.transcribe(frames) == text.tf_decode_batch(want)
    assert art.transcribe(frames[0]) == [reader.predict_frames(frames[0])]


# ---------------------------------------------------------------------------
# serving and refusals
# ---------------------------------------------------------------------------

def _post_npy(url, frames):
    buf = io.BytesIO()
    np.save(buf, frames)
    req = urllib.request.Request(url + "/v1/transcribe", data=buf.getvalue(), method="POST",
                                 headers={"Content-Type": "application/x-npy"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_daemon_answers_as_the_jax_daemon(tiny, jax_weights):
    """Both daemons on port 0 in one process, the same TF weights: the same
    JSON (`latency_ms` aside), in the TF alphabet."""
    from avsync.config import AvsyncConfig as JaxConfig
    from avsync.predictor import LipReader as JaxLipReader
    from avsync.serving import AvsyncServer as JaxServer
    from avsync.serving import TranscribeService as JaxTranscribeService
    from avsync_torch.predictor import LipReader
    from avsync_torch.serving import AvsyncServer, TranscribeService

    jcfg = JaxConfig.from_json(tiny["cfg"].to_json())
    ours = AvsyncServer(TranscribeService(LipReader(checkpoint=tiny["ck"], config=tiny["cfg"],
                                                    device="cpu"), max_batch=4), None, port=0)
    theirs = JaxServer(JaxTranscribeService(JaxLipReader("weights", jcfg), max_batch=4), None,
                       port=0)
    ours.start()
    theirs.start()
    try:
        for seed, shape in ((1, (8, 16, 32)), (2, (5, 40, 48))):  # a crop, native frames
            frames = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
            got = _post_npy(f"http://{ours.address[0]}:{ours.address[1]}", frames)
            want = _post_npy(f"http://{theirs.address[0]}:{theirs.address[1]}", frames)
            got.pop("latency_ms"), want.pop("latency_ms")
            assert got == want
            assert set(got["transcript"]) <= set(text.TF_CHARACTERS)
    finally:
        ours.shutdown(drain_timeout=5.0)
        theirs.shutdown(drain_timeout=5.0)


def test_a_reference_pth_is_refused_for_the_tf_family(tiny, tmp_path):
    """As the JAX package: a reference `.pth` holds the PyTorch family."""
    from avsync_torch.predictor import LipReader

    pth = str(tmp_path / "ref.pth")
    save_lipnet_pth({"conv1.weight": torch.zeros(2, 1, 3, 5, 5)}, pth)
    argv = ["test", *_common(tiny), "--checkpoint", pth, "--output", str(tmp_path / "r.json")]
    with pytest.raises(ValueError, match="PyTorch-family"):
        cli.main([*argv, "--device", "cpu"])
    with pytest.raises(ValueError, match="PyTorch-family"):
        jax_cli.main(argv)
    with pytest.raises(ValueError, match="PyTorch-family"):
        LipReader(checkpoint=pth, config=tiny["cfg"], device="cpu")
    # and a TF snapshot read as the PyTorch family names the mismatch
    with pytest.raises(ValueError, match="'tf'-family"):
        LipReader(checkpoint=tiny["ck"], config=AvsyncConfig(data=DataConfig(**DATA)),
                  device="cpu")


def test_the_detector_commands_refuse_the_tf_family(tiny, tmp_path):
    """The detector's features are the PyTorch-family conv stack's
    (`LipNet.conv_features`); the JAX package fails there too."""
    for cmd in ("misalign-train", "misalign-eval"):
        with pytest.raises(ValueError, match="conv_features"):
            cli.main([cmd, *_common(tiny), "--checkpoint", tiny["ck"], "--device", "cpu",
                      "--detector_checkpoint", str(tmp_path / "d.pth")])
