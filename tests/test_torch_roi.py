"""The mouth-ROI modes of the port (`ops/image.py`'s `crop_resize_boxes` and
`variance_mouth_boxes`, `models/localizer.py`, `data/mouth.py`,
`data/pipeline.make_roi_crop_fn`, the predictor's ROI state) against the
JAX package's functions on the CPU, on the same numpy inputs and the same
bundled localizer weights. Tolerances: crops atol 1e-4 on the 0-255 scale
(1e-5 on [0, 1]), localizer boxes 1e-5, discrete choices (variance boxes,
the gate, the detector's fallback) equal, log-probs atol 5e-5 (the bound of
tests/test_torch_serving.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from avsync.compat import save_lipnet_pth
from avsync.config import AvsyncConfig as JaxConfig
from avsync.config import DataConfig as JaxDataConfig
from avsync.config import ModelConfig as JaxModelConfig
from avsync.data import mouth as jax_mouth
from avsync.data import synthetic
from avsync.data.pipeline import make_roi_crop_fn as jax_roi_fn
from avsync.models import LipNet as JaxLipNet
from avsync.models import localizer as jax_loc
from avsync.ops import image as jax_image
from avsync.predictor import LipReader as JaxLipReader
from avsync_torch.compat import localizer_params_from_jax
from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
from avsync_torch.data import mouth
from avsync_torch.data.pipeline import make_roi_crop_fn
from avsync_torch.ingest import native
from avsync_torch.models import localizer
from avsync_torch.ops import image
from avsync_torch.predictor import LipReader

MODES = ["heuristic", "detector", "variance", "model"]
DATA = dict(img_height=16, img_width=32, max_video_length=8)
MODEL = dict(hidden_dim=8, conv_channels=(2, 2, 3))


@pytest.fixture(scope="module")
def jax_params():
    return jax_loc.load_bundled_params()


@pytest.fixture(scope="module")
def loc():
    return localizer.load_bundled_or_none("cpu")


def _clips(n=4, T=8, H=72, W=90, seed=0):
    """Synthetic talking clips with the mouth at a different place in each."""
    r = np.random.default_rng(seed)
    return np.stack([synthetic.make_clip(r, n_frames=T, height=H, width=W,
                                         mouth_center=(0.68 + 0.04 * i, 0.38 + 0.07 * i))[0]
                     for i in range(n)])


def test_crop_resize_boxes_matches_jax():
    r = np.random.default_rng(1)
    frames = r.integers(0, 256, (2, 5, 40, 60)).astype(np.float32)
    y0, x0 = r.uniform(0, 0.5, (2, 5)), r.uniform(0, 0.5, (2, 5))
    boxes = np.stack([y0, y0 + r.uniform(0.1, 0.5, (2, 5)), x0, x0 + r.uniform(0.1, 0.5, (2, 5))],
                     -1).astype(np.float32)
    boxes[0, 0] = (-0.05, 0.4, 0.9, 1.1)  # past the edges: clamped, weight 0 below 0
    got = image.crop_resize_boxes(torch.from_numpy(frames), torch.from_numpy(boxes), (16, 32))
    want = jax_image.crop_resize_boxes(jnp.asarray(frames), jnp.asarray(boxes), (16, 32))
    assert got.shape == (2, 5, 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_a_full_frame_box_reproduces_resize_bilinear():
    frames = torch.from_numpy(np.random.default_rng(2).random((3, 36, 50)).astype(np.float32))
    full = torch.tensor([0.0, 1.0, 0.0, 1.0]).expand(3, 4)
    got = image.crop_resize_boxes(frames, full, (16, 32))
    torch.testing.assert_close(got, image.resize_bilinear(frames, (16, 32)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_image.resize_bilinear(
        jnp.asarray(frames.numpy()), (16, 32))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("lower_half_only", [True, False])
def test_variance_boxes_equal_jax(lower_half_only):
    clips = _clips().astype(np.float32)
    got = image.variance_mouth_boxes(torch.from_numpy(clips), lower_half_only=lower_half_only)
    want = jax_image.variance_mouth_boxes(jnp.asarray(clips), lower_half_only=lower_half_only)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len({tuple(b) for b in got.numpy()}) == 4  # one box per mouth


def test_variance_boxes_take_the_first_maximum_on_a_tie():
    """Exact ties in both packages' arithmetic: a static clip (every score
    0), and two mirror-image patches of pixels toggling between 0 and 2
    (variance exactly 1, integer sums) where the left one must win."""
    static = np.full((1, 6, 40, 50), 90.0, np.float32)
    toggle = np.zeros((1, 6, 40, 50), np.float32)
    toggle[0, ::2, 26:34, 4:10] = 2.0
    toggle[0, ::2, 26:34, 40:46] = 2.0
    for clips in (static, toggle):
        got = image.variance_mouth_boxes(torch.from_numpy(clips)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_image.variance_mouth_boxes(
            jnp.asarray(clips))))
    assert got[0, 2] == 0.0 and got[0, 0] == 20 / 40  # the first of the tied boxes


def test_localizer_boxes_match_jax(loc, jax_params):
    clips = _clips().astype(np.float32)
    got = localizer.localize_clip_boxes(loc, torch.from_numpy(clips)).numpy()
    want = np.asarray(jax_loc.localize_clip_boxes(jax_params, jnp.asarray(clips)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not list(loc.parameters()) and len(list(loc.buffers())) == 12


@pytest.mark.parametrize("hw", [(48, 96), (47, 95), (31, 64)])
def test_localizer_net_pads_as_flax_same(loc, jax_params, hw):
    """Flax's "SAME" pads a stride-2 3x3 conv on an even size by (0, 1): a
    symmetric (1, 1) pad shifts every feature map by a pixel."""
    x = np.random.default_rng(4).random((3, *hw, 1)).astype(np.float32)
    want = np.asarray(jax_loc.MouthLocalizer().apply({"params": jax_params}, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_allclose(loc(xt).numpy(), want, rtol=0, atol=1e-5)
    assert localizer.same_pad(torch.zeros(1, 1, *hw), 3, 2).shape[-2:] == (
        hw[0] + (2 if hw[0] % 2 else 1), hw[1] + (2 if hw[1] % 2 else 1))
    if hw == (48, 96):
        sym = F.relu(F.conv2d(F.pad(xt, (1, 1, 1, 1)), loc.conv1.weight, loc.conv1.bias, 2))
        flax = F.relu(loc.conv1(localizer.same_pad(xt, 3, 2)))
        assert (sym - flax).abs().max() > 1e-2


def test_localizer_bridge_takes_the_flat_bundle_and_the_tree(jax_params):
    with np.load(localizer.WEIGHTS_FILE) as z:
        flat = localizer_params_from_jax({k: z[k] for k in z.files})
    tree = localizer_params_from_jax(jax.tree.map(np.asarray, jax_params))
    assert flat.keys() == tree.keys() == localizer.MouthLocalizer().state_dict().keys()
    for k in flat:
        assert torch.equal(flat[k], tree[k])
    assert flat["conv2.weight"].shape == (16, 8, 3, 3) and flat["fc2.weight"].shape == (2, 32)


def test_missing_bundle_warns_and_gives_none(tmp_path):
    with pytest.warns(UserWarning, match="falls back to the heuristic crop"):
        assert localizer.load_bundled_or_none("cpu", str(tmp_path / "absent.npz")) is None


def test_gate_boxes_with_padded_tails_choose_as_jax():
    clips = _clips(n=4, T=8).astype(np.float32)
    clips[1, 5:] = 0.0  # padded tails
    clips[3, 3:] = 0.0
    good = np.asarray(jax_image.variance_mouth_boxes(jnp.asarray(clips)))
    boxes = good.copy()
    boxes[2] = (0.0, 0.2, 0.0, 0.2)  # a static corner: gated
    boxes[3] = (0.0, 0.3, 0.7, 1.0)
    heur = np.array([0.6, 1.0, 0.3, 0.7], np.float32)
    got = localizer.gate_boxes(torch.from_numpy(clips), torch.from_numpy(boxes),
                               torch.from_numpy(heur)).numpy()
    want = np.asarray(jax_loc.gate_boxes(jnp.asarray(clips), jnp.asarray(boxes),
                                         jnp.asarray(heur)))
    np.testing.assert_array_equal(got, want)
    assert (got[2] == heur).all() and (got[0] == boxes[0]).all() and (got[1] == boxes[1]).all()


@pytest.mark.parametrize("mode", MODES)
def test_roi_program_matches_jax(loc, jax_params, mode):
    """Native 72x90 clips of 8 frames to 16x32 crops, uint8 in. Under
    'model' the localizer's boxes agree to 1e-5, not bit for bit, and a box
    that moves by 1e-7 moves the crop by ~2e-5: the crops are held to the
    JAX crop of the port's own boxes, and the boxes to the JAX boxes."""
    clips = _clips()
    d = DataConfig(**DATA, roi_mode=mode)
    got = make_roi_crop_fn(d, mode, loc if mode == "model" else None)(torch.from_numpy(clips))
    assert got.shape == (4, 8, 16, 32, 1)
    if mode == "model":
        xf = torch.from_numpy(clips).float()
        heur = torch.tensor([0.6, 1.0, 0.3, 0.7])
        boxes = localizer.gate_boxes(xf, localizer.localize_clip_boxes(loc, xf), heur).numpy()
        jboxes = jax_loc.gate_boxes(jnp.asarray(clips, jnp.float32), jax_loc.localize_clip_boxes(
            jax_params, jnp.asarray(clips, jnp.float32)), jnp.asarray(heur.numpy()))
        np.testing.assert_allclose(boxes, np.asarray(jboxes), rtol=0, atol=1e-5)
        want = jax_image.crop_resize_boxes(
            jnp.asarray(clips, jnp.float32),
            jnp.broadcast_to(jnp.asarray(boxes)[:, None], (4, 8, 4)), (16, 32))[..., None] / 255.0
    else:
        want = jax_roi_fn(JaxDataConfig(**DATA, roi_mode=mode), mode, None)(jnp.asarray(clips))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_detector_falls_back_to_the_fixed_box_in_both_packages():
    frames = _clips(n=1)[0]
    ours, theirs = mouth.MouthDetector(), jax_mouth.MouthDetector()
    assert ours.use_cascade == theirs.use_cascade
    got = ours.detect_clip(frames)
    np.testing.assert_array_equal(got, theirs.detect_clip(frames))
    if not ours.use_cascade:  # cv2 without CascadeClassifier (OpenCV 5), or no cascades
        assert mouth.FALLBACK_BOX == jax_mouth.FALLBACK_BOX
        assert (got == np.float32(mouth.FALLBACK_BOX)).all() and got.shape == (8, 4)
    np.testing.assert_array_equal(ours.extract_mouth(frames[0]), theirs.extract_mouth(frames[0]))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny LipNet .pth and one native 72x90 clip as an .mp4 (written by
    the port's mux), decoded to 8 frames of 8 in the clip."""
    root = tmp_path_factory.mktemp("torch_roi")
    params = JaxLipNet(JaxModelConfig(**MODEL)).init(
        {"params": jax.random.PRNGKey(2)}, jnp.zeros((1, 8, 16, 32, 1)))["params"]
    r = np.random.default_rng(5)
    params = jax.tree.map(lambda p: (np.asarray(p) + r.normal(0, 0.3, np.shape(p))).astype(
        np.float32), params)
    ckpt = str(root / "lipnet.pth")
    save_lipnet_pth(params, ckpt, conv_shape=(3, 2, 4))
    clip = _clips(n=1, T=6, seed=6)[0]
    path = str(root / "clip.mp4")
    native.mux_mp4(path, np.repeat(clip[..., None], 3, axis=-1), 25.0)
    return ckpt, path


@pytest.mark.parametrize("mode", MODES)
def test_lipreader_predicts_a_container_file_as_jax(tiny, mode):
    ckpt, path = tiny
    cfg = AvsyncConfig(data=DataConfig(**DATA, roi_mode=mode), model=ModelConfig(**MODEL))
    jcfg = JaxConfig(data=JaxDataConfig(**DATA, roi_mode=mode), model=JaxModelConfig(**MODEL))
    reader = LipReader(checkpoint=ckpt, config=cfg, device="cpu")
    jreader = JaxLipReader(ckpt, config=jcfg)
    assert reader.predict(path) == jreader.predict(path)
    frames = reader._load(path)
    assert frames.shape == (6, 72, 90)  # a short clip: padded to 8 before the ROI
    got = reader._logprobs(reader._prepare(frames)).numpy()
    want = np.asarray(jreader._logprobs(jreader._prepare(frames)))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # the raw transport (what the daemon batches) carries the same boxes
    payload, jpayload = reader.prepare_raw(frames), jreader.prepare_raw(frames)
    assert len(payload) == len(jpayload) == (2 if mode == "detector" else 1)
    for a, b in zip(payload, jpayload):
        np.testing.assert_array_equal(a, np.asarray(b))
    batched = reader._logprobs(reader.preprocess_device(
        *(np.concatenate([p, p]) for p in payload))).numpy()
    np.testing.assert_allclose(batched, np.concatenate([got, got]), rtol=0, atol=5e-5)


def test_model_mode_without_weights_takes_the_heuristic_crop():
    """A missing bundle gives no localizer: 'model' then crops as the
    heuristic mode, as the JAX package's make_roi_crop_fn does."""
    x = torch.from_numpy(_clips(n=2))
    d = DataConfig(**DATA, roi_mode="model")
    got = make_roi_crop_fn(d, "model", None)(x)
    torch.testing.assert_close(got, make_roi_crop_fn(d, "heuristic")(x), rtol=0, atol=0)
    want = jax_roi_fn(JaxDataConfig(**DATA, roi_mode="model"), "model", None)(jnp.asarray(
        x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
