"""The localizer's training in the port (`models/localizer.py`'s box math
and bundle reader/writer, `compat.localizer_params_to_jax`,
`train/localizer_trainer.py`, `scripts/torch_train_localizer.py`) against
the JAX package (`avsync.models.localizer`, `scripts/train_localizer.py`)
on the CPU, on the same numpy inputs. Tolerances: decode_box and iou rtol
1e-6; localizer boxes 1e-5 (tests/test_torch_roi.py); net inputs atol 1e-6
(the resize's bound in tests/test_torch_roi.py); augmentation atol 1e-7;
the loss rtol 1e-5 and its gradients atol 1e-5 / rtol 1e-4; parameters
after three Adam steps within 6 lr (PERF.md's bound for train steps)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avsync.data import synthetic as jax_synthetic
from avsync.data.synthetic import make_localizer_batch as jax_make_localizer_batch
from avsync.models import localizer as jax_loc
from avsync.ops.image import resize_bilinear as jax_resize_bilinear
from avsync_torch.compat import localizer_params_from_jax, localizer_params_to_jax
from avsync_torch.data.synthetic import make_localizer_batch
from avsync_torch.models import localizer
from avsync_torch.train import localizer_trainer as lt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_ATOL = 1e-5
LR = 1e-3


@pytest.fixture(scope="module")
def jax_params():
    """Flax-initialised localizer params (the JAX script's init)."""
    params = jax_loc.MouthLocalizer().init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *jax_loc.NET_HW, 1)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _frames(n=6, seed=0, hw=(60, 120)):
    frames, boxes = make_localizer_batch(np.random.default_rng(seed), n, *hw)
    return frames, boxes


def _jax_prep(frames):
    """The JAX script's `prep`: each frame over its max, resized to 48x96."""
    x = jnp.asarray(frames)
    x = x / jnp.maximum(x.max(axis=(1, 2), keepdims=True), 1e-6)
    return np.asarray(jax_resize_bilinear(x, jax_loc.NET_HW))


def _jax_loss(params, x, y):
    pred = jax_loc.MouthLocalizer().apply({"params": params}, x[..., None])
    return jnp.abs(pred - y).mean() + (1.0 - jax_loc.iou(pred, y).mean())


# ---------------------------------------------------------------------------
# box math
# ---------------------------------------------------------------------------

def test_decode_box_matches_jax():
    raw = (np.random.default_rng(0).normal(size=(256, 4)) * 3).astype(np.float32)
    got = localizer.decode_box(torch.from_numpy(raw)).numpy()
    want = np.asarray(jax_loc.decode_box(jnp.asarray(raw)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[:, 0] <= got[:, 1]).all() and (got[:, 2] <= got[:, 3]).all()
    assert (got >= 0).all() and (got <= 1).all()


def test_iou_matches_jax():
    r = np.random.default_rng(1)
    y0, x0 = r.uniform(0, 0.6, (2, 256)), r.uniform(0, 0.6, (2, 256))
    boxes = np.stack([y0, y0 + r.uniform(0, 0.4, (2, 256)), x0, x0 + r.uniform(0, 0.4, (2, 256))],
                     -1).astype(np.float32)
    a, b = boxes
    b[:3] = ((0.2, 0.6, 0.1, 0.5), (0.7, 0.9, 0.6, 0.8), (0.2, 0.6, 0.3, 0.7))
    a[:3] = (0.2, 0.6, 0.1, 0.5)  # identity, disjoint, half overlap
    a[3] = b[3] = (0.4, 0.4, 0.2, 0.2)  # empty boxes: the union's 1e-9 floor
    got = localizer.iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_loc.iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == pytest.approx(1.0) and got[1] == 0.0 and got[3] == 0.0
    assert got[2] == pytest.approx(0.2 / 0.6, rel=1e-5)


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------

def test_params_round_trip_bit_for_bit(jax_params):
    for params in (jax_params, jax_loc.load_bundled_params()):
        back = _leaves(localizer_params_to_jax(localizer_params_from_jax(params)))
        want = _leaves(jax.tree_util.tree_map(np.asarray, params))
        assert back.keys() == want.keys()
        for k in want:
            assert back[k].dtype == np.float32
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def _boxes_both(jax_tree, state, frames):
    want = np.asarray(jax_loc.localize_frames(jax_tree, jnp.asarray(frames)))
    got = localizer.localize_frames(localizer.load_localizer(state, "cpu"),
                                    torch.from_numpy(frames)).detach().numpy()
    return got, want


def test_a_port_bundle_loads_in_jax(tmp_path):
    """A bundle of Flax-default weights drawn by the port: the JAX package's
    keys, shapes and dtype, and its boxes within 1e-5 of the port's."""
    state = lt.init_localizer(torch.Generator().manual_seed(3)).state_dict()
    path = str(tmp_path / "port.npz")
    localizer.save_params(state, path)
    with np.load(path) as z, np.load(localizer.WEIGHTS_FILE) as ref:
        assert sorted(z.files) == sorted(ref.files)
        assert all(z[k].shape == ref[k].shape and z[k].dtype == np.float32 for k in ref.files)
    frames, _ = _frames()
    got, want = _boxes_both(jax_loc.load_bundled_params(path), state, frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)


def test_a_jax_bundle_loads_in_the_port(tmp_path, jax_params):
    path = str(tmp_path / "jax.npz")
    jax_loc.save_params(jax_params, path)
    state = localizer.load_bundled_params(path)
    want_state = localizer_params_from_jax(jax_params)
    assert state.keys() == want_state.keys()
    for k in state:
        assert torch.equal(state[k], want_state[k]), k
    frames, _ = _frames(seed=2)
    got, want = _boxes_both(jax_params, state, frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)
    model = localizer.load_bundled_or_none("cpu", path=path)
    assert model is not None and not list(model.parameters())  # frozen: buffers only


def test_a_missing_bundle_raises(tmp_path):
    missing = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError):
        localizer.load_bundled_params(missing)
    with pytest.warns(UserWarning, match="bundle missing"):
        assert localizer.load_bundled_or_none("cpu", path=missing) is None


# ---------------------------------------------------------------------------
# the dataset and the batch order
# ---------------------------------------------------------------------------

def test_dataset_and_batch_order_match_the_jax_script(monkeypatch):
    """Reduced counts, drawn in chunks of 16 (the draws are sequential, so
    the chunking changes nothing): boxes bit for bit, net inputs atol 1e-6,
    the first two epochs' batch rows equal."""
    monkeypatch.setattr(lt, "CHUNK", 16)
    seed, n_large, n_small, n_val, B = 3, 40, 24, 16, 16
    data = lt.build_dataset(seed, n_large, n_small, n_val=n_val)

    rng = np.random.default_rng(seed)
    frames_a, boxes_a = jax_make_localizer_batch(rng, n_large, height=200, width=400)
    frames_b, boxes_b = jax_make_localizer_batch(rng, n_small, height=120, width=160)
    X = np.concatenate([_jax_prep(frames_a), _jax_prep(frames_b)])
    Y = np.concatenate([boxes_a, boxes_b])
    np.testing.assert_array_equal(np.concatenate([data.y_val, data.y_train]), Y)
    np.testing.assert_allclose(np.concatenate([data.x_val, data.x_train]), X, rtol=0, atol=1e-6)
    assert data.x_val.shape == (n_val, *jax_loc.NET_HW) and len(data.x_train) == 48
    np.testing.assert_array_equal(data.sample_frames, frames_a[:4])
    np.testing.assert_array_equal(data.sample_boxes, boxes_a[:4])

    n = len(X) - n_val
    steps = 2 * (n // B)
    order, want = np.arange(n), []
    for step in range(steps):  # scripts/train_localizer.py's loop
        if step % (n // B) == 0:
            rng.shuffle(order)
        want.append(order[(step * B) % n: (step * B) % n + B].copy())
    got = list(lt.batch_indices(data.rng, n, B, steps))
    assert len(got) == steps
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got[:n // B])) == list(range(n))  # an epoch is a permutation


# ---------------------------------------------------------------------------
# initialisation and augmentation
# ---------------------------------------------------------------------------

def test_init_is_flax_lecun_normal_with_zero_biases(jax_params):
    model = lt.init_localizer(torch.Generator().manual_seed(0))
    pooled = []
    for name, p in model.named_parameters():
        w = p.detach().numpy()
        if name.endswith("bias"):
            assert not w.any(), name
            continue
        sigma = np.sqrt(1.0 / w[0].size)  # lecun_normal's standard deviation
        z = w / sigma
        assert np.abs(z).max() <= 2.0 / lt.TRUNC_STD + 1e-6, name  # truncated at 2 sigma
        if w.size >= 1000:
            assert abs(z.std() / 1.0 - 1.0) < 0.1, (name, z.std())
        pooled.append(z.ravel())
    assert abs(np.concatenate(pooled).std() - 1.0) < 0.1
    # Flax's own draw of the same kernels, pooled the same way
    flax_z = np.concatenate([(v / np.sqrt(1.0 / np.prod(v.shape[:-1]))).ravel()
                             for k, v in _leaves(jax_params).items() if k.endswith("kernel")])
    assert abs(np.concatenate(pooled).std() - flax_z.std()) < 0.1


def _numpy_augment(x, d):
    """scripts/train_localizer.py's augment (lines 82-101) in numpy float32,
    given its draws."""
    B, H, W = x.shape
    x = np.clip(x * d["contrast"] + d["brightness"] + d["noise"] * d["noise_scale"], 0.0, 1.0)
    yy = ((np.arange(H, dtype=np.float32) + np.float32(0.5)) / np.float32(H))[None, :, None]
    xx = ((np.arange(W, dtype=np.float32) + np.float32(0.5)) / np.float32(W))[None, None, :]
    occ = ((yy >= d["occ_y"]) & (yy < d["occ_y"] + d["occ_h"])
           & (xx >= d["occ_x"]) & (xx < d["occ_x"] + d["occ_w"]))
    return np.where(occ, d["occ_fill"], x)


def test_augment_matches_the_jax_script_arithmetic():
    x = np.random.default_rng(4).random((8, *jax_loc.NET_HW)).astype(np.float32)
    draws = lt.draw_augment(torch.Generator().manual_seed(5), 8, *jax_loc.NET_HW)
    got = lt.augment(torch.from_numpy(x), draws).numpy()
    want = _numpy_augment(x, {k: v.numpy() for k, v in draws.items()})
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got.dtype == np.float32 and (got >= 0).all() and (got <= 1).all()
    fill = draws["occ_fill"].numpy()
    assert ((got == fill) & (want == fill)).any()  # occluders were drawn in


@pytest.mark.parametrize("name,lo,hi", [("contrast", 0.5, 1.5), ("brightness", -0.2, 0.2),
                                        ("noise_scale", 0.0, 0.08), ("occ_y", 0.0, 1.0),
                                        ("occ_x", 0.0, 1.0), ("occ_h", 0.05, 0.25),
                                        ("occ_w", 0.05, 0.25), ("occ_fill", 0.0, 1.0)])
def test_augment_draws_span_the_jax_ranges(name, lo, hi):
    B = 4096
    d = lt.draw_augment(torch.Generator().manual_seed(6), B, 4, 5)
    v = d[name].numpy()
    assert v.shape == (B, 1, 1) and v.dtype == np.float32
    assert v.min() >= lo and v.max() <= hi
    assert v.min() < lo + 0.01 * (hi - lo) and v.max() > hi - 0.01 * (hi - lo)
    assert abs(v.mean() - (lo + hi) / 2) < 0.02 * (hi - lo)
    noise = d["noise"].numpy()
    assert noise.shape == (B, 4, 5) and abs(noise.mean()) < 0.02 and abs(noise.std() - 1) < 0.02


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _batch(B=16, seed=7):
    frames, boxes = _frames(B, seed)
    return lt.net_frames(torch.from_numpy(frames)).numpy(), boxes


def test_loss_and_gradients_match_jax(jax_params):
    x, y = _batch()
    want_loss, want_grads = jax.value_and_grad(_jax_loss)(
        jax.tree_util.tree_map(jnp.asarray, jax_params), jnp.asarray(x), jnp.asarray(y))
    model = localizer.MouthLocalizer()
    model.load_state_dict(localizer_params_from_jax(jax_params))
    loss = lt.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = _leaves(localizer_params_to_jax({k: p.grad for k, p in model.named_parameters()}))
    want = _leaves(jax.tree_util.tree_map(np.asarray, want_grads))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_three_adam_steps_match_optax(jax_params):
    batches = [_batch(seed=s) for s in (8, 9, 10)]
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    model = localizer.MouthLocalizer()
    model.load_state_dict(localizer_params_from_jax(jax_params))
    opt = lt.optimizer(model)
    for x, y in batches:
        loss, grads = jax.value_and_grad(_jax_loss)(params, jnp.asarray(x), jnp.asarray(y))
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        got_loss = lt.train_step(model, opt, torch.from_numpy(x), torch.from_numpy(y))
        assert got_loss.item() == pytest.approx(float(loss), rel=1e-4)
    got = _leaves(localizer_params_to_jax(model.state_dict()))
    want = _leaves(jax.tree_util.tree_map(np.asarray, params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=6 * LR, err_msg=k)
    moved = max(np.abs(want[k] - v).max() for k, v in _leaves(jax_params).items())
    assert moved > LR  # the steps did move the parameters


def test_accuracy_gates_are_the_jax_tests_figures():
    """`accuracy_gates` on the bundled weights against tests/test_localizer.py's
    own computations through the JAX package (boxes within 1e-5, so the
    IoU means within 1e-4)."""
    got, failed = lt.accuracy_gates(localizer.load_bundled_or_none("cpu"), "cpu")
    params = jax_loc.load_bundled_params()
    want = {}
    for seed, (h, w) in lt.GATE_GEOMETRIES:
        frames, boxes = jax_make_localizer_batch(np.random.default_rng(seed), 32, h, w)
        pred = jax_loc.localize_frames(params, jnp.asarray(frames))
        want[f"iou_{h}x{w}"] = float(jax_loc.iou(pred, jnp.asarray(boxes)).mean())
    r = np.random.default_rng(77)
    frames, boxes = jax_make_localizer_batch(r, 32, height=160, width=280)
    f = frames / max(frames.max(), 1e-6)
    f = np.clip(f * 0.6 + 0.15, 0, 1)
    f = np.clip(f + r.normal(0, 0.05, f.shape).astype(np.float32), 0, 1)
    f[:, 10:40, 20:60] = 0.5
    pred = jax_loc.localize_frames(params, jnp.asarray(f))
    want["iou_degraded"] = float(jax_loc.iou(pred, jnp.asarray(boxes)).mean())
    video, _ = jax_synthetic.make_clip(np.random.default_rng(7), n_frames=16, height=200,
                                       width=400, mouth_center=(0.7, 0.55), mouth_scale=1.0)
    box = jax_loc.localize_clip_boxes(params, jnp.asarray(video, jnp.float32)[None])
    want["iou_clip"] = float(jax_loc.iou(box[0], jnp.asarray(
        jax_synthetic.mouth_box((0.7, 0.55), 1.0, 200, 400))))
    r, (h, w) = np.random.default_rng(42), (160, 320)
    kept_model, kept_heuristic = [], []
    for _ in range(8):
        center = (r.uniform(0.25, 0.4), r.uniform(0.75, 0.9))
        video, _ = jax_synthetic.make_clip(r, n_frames=8, height=h, width=w,
                                           mouth_center=center, mouth_scale=1.0)
        b = np.asarray(jax_loc.localize_clip_boxes(params,
                                                   jnp.asarray(video, jnp.float32)[None]))[0]
        bright = video.max(0) > 150
        for kept, bx in ((kept_model, b), (kept_heuristic, np.array([0.6, 1.0, 0.3, 0.7]))):
            kept.append(bright[int(bx[0] * h):int(bx[1] * h), int(bx[2] * w):int(bx[3] * w)].sum()
                        / max(bright.sum(), 1))
    want["retention_model"] = float(np.mean(kept_model))
    want["retention_heuristic"] = float(np.mean(kept_heuristic))
    assert got.keys() == want.keys() and failed == []
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k


# ---------------------------------------------------------------------------
# the trainer and the script
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_data():
    return lt.build_dataset(0, 64, 32, n_val=32)


def test_two_runs_from_one_seed_give_equal_bits(small_data):
    (a, ha), (b, hb) = (lt.train_localizer(12, 16, 0, "cpu", data=small_data) for _ in range(2))
    assert ha == hb and a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert [h["step"] for h in ha] == [0, 11]
    c, _ = lt.train_localizer(12, 16, 1, "cpu", data=small_data)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])


def test_the_trainer_takes_the_card_or_raises(monkeypatch, small_data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lt.train_localizer(1, 16, data=small_data)


def test_the_script_writes_a_bundle_the_jax_package_loads(tmp_path):
    """20 steps at the JAX script's full dataset on the CPU: the loss falls,
    and the bundle loads in the JAX package with the port's boxes."""
    out = str(tmp_path / "loc.npz")
    res = subprocess.run([sys.executable, "scripts/torch_train_localizer.py", "20", out,
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "dataset: train=1792 val=256" in res.stdout
    losses = {int(line.split()[1]): float(line.split("loss=")[1].split()[0])
              for line in lines if line.startswith("step ")}
    assert sorted(losses) == [0, 19] and losses[19] < losses[0]
    assert any(line.startswith("final val IoU: ") for line in lines)
    assert "sample boxes:" in res.stdout and "truth boxes:" in res.stdout
    assert "the JAX package's accuracy gates" in lines[-1]
    frames, _ = _frames(seed=11)
    got, want = _boxes_both(jax_loc.load_bundled_params(out), localizer.load_bundled_params(out),
                            frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)
