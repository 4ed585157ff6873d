"""The plain reference at a tiny width against `avsync_torch`, and the
served transcript's gap."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from avbench.harness import reference, traffic
from avbench.harness.program import program_config


@pytest.mark.parametrize("name", ["lipnet", "lipnet_tf"])
def test_reference_forward_equals_the_programs(tiny, name):
    from avsync_torch.models import make_lipnet

    cfg = tiny.config(name)
    params = reference.init_params(cfg, 3, "cpu")
    model = make_lipnet(program_config(cfg, 2, 0).model, (cfg["img_height"], cfg["img_width"]),
                        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params)  # the same names and layouts
    frames = torch.randint(0, 256, (2, cfg["frames"], cfg["img_height"], cfg["img_width"]),
                           dtype=torch.uint8)
    x = reference.model_input(cfg, frames)
    with torch.no_grad():
        want = model.eval()(x)
    got = reference.logprobs(cfg, params, x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["lipnet.train", "lipnet_tf.train"])
def test_float32_program_steps_match_the_reference(tiny, name):
    rc, line = tiny(name)
    assert rc == 0 and line["correct"] is True
    for k in ("loss_rel", "grad_gap", "update_gap"):
        assert line["checks"][k]["value"] < 1e-4, k


def test_tf32_and_fp8_products_lose_precision():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    t = reference.round_tf32(x)
    assert 0 < (t - x).abs().max() <= x.abs().max() * 2.0 ** -11
    assert torch.equal(reference.round_tf32(t), t)
    f = reference.round_fp8(x)
    assert (f - x).abs().max() > (t - x).abs().max()


def _cfg():
    return {"charset": "ab ", "separators": [0, 4]}


def test_transcript_gap_of_the_reference_greedy_path_is_zero():
    rng = np.random.default_rng(0)
    lp = rng.normal(size=(20, 5))
    text = reference.greedy_text(_cfg(), lp)
    assert reference.transcript_gap(_cfg(), lp, text) == 0.0


def test_transcript_gap_is_the_min_max_over_alignments():
    lp = np.log(np.full((4, 5), 0.01))
    lp[:, 0] = np.log(0.5)   # blank best everywhere
    lp[1, 1] = np.log(0.4)   # 'a' second at frame 1
    lp[2, 1] = np.log(0.3)
    # "a" needs one frame of 'a': the cheapest is frame 1
    assert reference.transcript_gap(_cfg(), lp, "a") == pytest.approx(np.log(0.5 / 0.4))
    # "aa" needs a separator between: frames 1 and 3 ('a' at 0.01) or 0 ...
    assert reference.transcript_gap(_cfg(), lp, "aa") == pytest.approx(np.log(0.5 / 0.01))
    assert reference.transcript_gap(_cfg(), lp, "") == 0.0
    assert math.isinf(reference.transcript_gap(_cfg(), lp, "x"))       # not in the charset
    assert math.isinf(reference.transcript_gap(_cfg(), lp, "ababa"))   # too long for 4 frames


def test_an_altered_character_opens_a_gap():
    rng = np.random.default_rng(1)
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(30, 5)) * 3), -1).numpy()
    text = reference.greedy_text(_cfg(), lp)
    assert text
    swapped = ("b" if text[0] != "b" else "a") + text[1:]
    assert reference.transcript_gap(_cfg(), lp, swapped) > 0.1


def test_the_schedule_offers_the_same_gaps_in_another_order():
    cell = {"pool_clips": 10}
    a = traffic.arrivals(cell, 50.0, 4.0, 1)
    b = traffic.arrivals(cell, 50.0, 4.0, 2**31 + 5)
    assert len(a["due"]) == len(b["due"]) == 200
    gaps = [np.sort(np.diff(np.append(s["due"], 4.0))) for s in (a, b)]
    assert np.allclose(gaps[0], gaps[1], rtol=0, atol=1e-9)
    assert not np.array_equal(a["clip"], b["clip"])
    assert a["due"][0] == 0.0 and a["due"][-1] < 4.0


def test_inputs_repeat_from_the_seed():
    cfg = dict(frames=2, img_height=2, img_width=4, standardize_clips=False, charset="ab ",
               max_label_length=40)
    cell = {"corpus_clips": 5}
    a = traffic.train_corpus(dict(cfg, charset="abcdefghijklmnopqrstuvwxyz "), cell, 7, "cpu")
    b = traffic.train_corpus(dict(cfg, charset="abcdefghijklmnopqrstuvwxyz "), cell, 7, "cpu")
    assert torch.equal(a["video"], b["video"]) and np.array_equal(a["labels"], b["labels"])
    feed = traffic.PlanFeed(10, 3, 7)
    rows = np.concatenate([feed.take(1).ravel(), feed.take(2).ravel()])
    assert len(set(rows.tolist())) == 9
