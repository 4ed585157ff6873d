"""CTC prefix beam search in the port (`avsync_torch/ops/beam.py`) against the
JAX package's (`avsync/ops/beam.py`) on the same seeded numpy log-probs: the
same prefixes, scores to rtol 1e-12 (the same float arithmetic on the
host); `text.decode_batch(beam_width=4)` and `cli test --beam 4` against
the JAX package's."""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from avsync import text as jax_text
from avsync.compat import save_lipnet_pth
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import synthetic
from avsync.models import LipNet as JaxLipNet
from avsync.ops import beam as jax_beam
from avsync_torch import text
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.ops import beam


def _log_probs(seed, B=4, T=75, V=39):
    logits = np.random.default_rng(seed).normal(size=(B, T, V)) * 3.0
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_beam_search_batch_equals_the_jax_package(width):
    lp = _log_probs(width)
    valid = range(1, 38)
    assert (beam.ctc_beam_search_batch(lp, width, 0, valid)
            == jax_beam.ctc_beam_search_batch(lp, width, 0, valid))
    for b in range(lp.shape[0]):
        ours, score = beam.ctc_beam_search(lp[b], width, 0, valid)
        theirs, jscore = jax_beam.ctc_beam_search(lp[b], width, 0, valid)
        assert ours == theirs
        np.testing.assert_allclose(score, jscore, rtol=1e-12)


def test_decode_batch_beam_equals_the_jax_package():
    lp = _log_probs(11)
    assert text.decode_batch(lp, beam_width=4) == jax_text.decode_batch(lp, beam_width=4)
    # a tensor decodes as its array does
    import torch

    assert text.decode_batch(torch.from_numpy(lp), beam_width=4) == text.decode_batch(
        lp, beam_width=4)


def test_cli_test_beam_writes_the_jax_results(tmp_path):
    """`test --beam 4` on one tiny `.pth` and corpus: the same CER/WER JSON
    as the JAX package's `test --beam 4`."""
    from avsync.cli import main as jax_main
    from avsync_torch.cli import main

    root = str(tmp_path / "grid")
    synthetic.write_corpus(root, n_speakers=3, clips_per_speaker=2, n_frames=8, height=16,
                           width=32, seed=5, with_audio=False)
    jm = JaxModelConfig(hidden_dim=8, conv_channels=(2, 3, 4))
    params = JaxLipNet(jm).init({"params": jax.random.PRNGKey(3)},
                                jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(3)
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.3, np.shape(p))).astype(
        np.float32), params)
    pth = str(tmp_path / "lipnet.pth")
    save_lipnet_pth(params, pth, conv_shape=(4, 2, 4))
    cfg = AvsyncConfig(data=DataConfig(img_height=16, img_width=32, max_video_length=8,
                                       batch_size=2, max_label_length=6, device_cache="off"),
                       model=ModelConfig(hidden_dim=8, conv_channels=(2, 3, 4),
                                         use_pallas_gru=True, fused_conv_pool=True))
    port_cfg, jax_cfg = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    open(port_cfg, "w").write(cfg.to_json())
    open(jax_cfg, "w").write(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_pallas_gru=False, fused_conv_pool=False)).to_json())
    results = {}
    for name, run, c in (("port", main, port_cfg), ("jax", jax_main, jax_cfg)):
        for width in (0, 4):
            out = str(tmp_path / f"{name}_{width}.json")
            extra = ["--device", "cpu"] if name == "port" else []
            assert run(["test", "--data_path", root, "--config", c, "--checkpoint", pth,
                        "--output", out, "--beam", str(width), *extra]) == 0
            results[name, width] = json.load(open(out))
    assert results["port", 4] == results["jax", 4]
    assert results["port", 0] == results["jax", 0]
    assert results["port", 4]["num_samples"] == 2
