"""Training of the mouth localizer (port of `scripts/train_localizer.py`).

Supervised box regression on the synthetic corpus, where the mouth box is
known by construction (`data.synthetic.make_localizer_batch`): the loss is
|pred - y|.mean() + (1 - IoU), the optimiser Adam 1e-3, B = 128 for 1500
steps, each batch augmented on the training device (contrast, brightness,
noise and an occluding rectangle: the boxes do not change), the validation
IoU taken on the first 256 samples. The result is the port's state dict,
which `models.localizer.save_params` writes as the bundle both packages
read.

Reproduced from the JAX script bit for bit, since both are pure numpy: the
dataset (one `np.random.default_rng(seed)` draws 1536 frames at 200x400,
then 512 at 120x160; each frame is scaled by its own max and resized to
NET_HW) and the batch order (the same generator, reshuffled every
len(train) // B steps). Drawn from the same distributions but not the same
bits: the initial parameters (Flax's defaults, lecun-normal kernels and
zero biases, from a torch generator on the CPU, so every device starts
from the same ones) and the augmentation (from a generator on the
training device).

The steps run under `ops.conv.train_scope` (TF32 off, cuDNN
deterministic): two runs from one seed give the same bits.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from avsync_torch.data.synthetic import make_clip, make_localizer_batch, mouth_box
from avsync_torch.models.localizer import (MouthLocalizer, NET_HW, iou, localize_clip_boxes,
                                           localize_frames, net_frames)
from avsync_torch.ops.conv import train_scope
from avsync_torch.ops.image import true_div
from avsync_torch.predictor import resolve_device

# the JAX script's two draws: 1536 frames at 200x400, then 512 at 120x160,
# so the resize to 48x96 sees both aspect treatments
GEOMETRIES = ((200, 400), (120, 160))
N_VAL = 256  # the first samples, held out for the validation IoU
CHUNK = 128  # frames drawn and resized at a time (the draws are sequential)
LR = 1e-3
LOG_EVERY = 200
# Flax's lecun_normal: a normal truncated at +-2 sigma, rescaled by the
# truncated distribution's standard deviation
TRUNC_STD = 0.87962566103423978
# the JAX package's accuracy gates on the bundled weights
# (tests/test_localizer.py:54-123): mean IoU at three geometries no training
# frame has, on a degraded set and on one clip's box; the share of the
# mouth's pixels inside the box on off-centre mouths, against the heuristic
# crop's share
GATE_GEOMETRIES = ((1234, (180, 360)), (99, (120, 160)), (55, (240, 320)))
GATE_IOU, GATE_DEGRADED, GATE_CLIP = 0.8, 0.7, 0.7
GATE_RETENTION, GATE_RETENTION_MARGIN = 0.9, 0.3
HEURISTIC_BOX = (0.6, 1.0, 0.3, 0.7)  # DataConfig.mouth_crop as a box


@dataclass
class LocalizerData:
    """The net inputs (N, 48, 96) float32 in [0, 1] and their (N, 4) boxes,
    split into validation and training samples."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    rng: np.random.Generator  # drew the frames; orders the batches next
    sample_frames: np.ndarray  # the first 4 raw frames at 200x400, and
    sample_boxes: np.ndarray  # their boxes (the script's sanity check)


def build_dataset(seed: int = 0, n_large: int = 1536, n_small: int = 512,
                  n_val: int = N_VAL) -> LocalizerData:
    """The JAX script's training set, drawn from `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    xs, ys, samples = [], [], []
    for n, (h, w) in zip((n_large, n_small), GEOMETRIES):
        for start in range(0, n, CHUNK):
            frames, boxes = make_localizer_batch(rng, min(CHUNK, n - start), height=h, width=w)
            if not samples:
                samples = [frames[:4], boxes[:4]]
            xs.append(net_frames(torch.from_numpy(frames)).numpy())
            ys.append(boxes)
    x, y = np.concatenate(xs), np.concatenate(ys)
    return LocalizerData(x[n_val:], y[n_val:], x[:n_val], y[:n_val], rng, *samples)


def batch_indices(rng: np.random.Generator, n: int, batch: int,
                  steps: int) -> Iterator[np.ndarray]:
    """Each step's rows of the training set, in the JAX script's order."""
    order = np.arange(n)
    for step in range(steps):
        if step % (n // batch) == 0:
            rng.shuffle(order)
        start = (step * batch) % n
        yield order[start:start + batch].copy()


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill `w` (a conv's OIHW or a Linear's (out, in) weight) as Flax's
    lecun_normal would: sqrt(1 / fan_in) / TRUNC_STD times a standard
    normal truncated at +-2 (drawn by the inverse CDF)."""
    std = math.sqrt(1.0 / w[0].numel()) / TRUNC_STD
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    with torch.no_grad():
        return w.copy_(z.clamp(-2.0, 2.0) * std)


def init_localizer(generator: torch.Generator) -> MouthLocalizer:
    """A trainable MouthLocalizer on the CPU with Flax's default
    initialisation: lecun-normal kernels, zero biases."""
    model = MouthLocalizer()
    for name, p in model.named_parameters():
        if name.endswith("weight"):
            lecun_normal_(p, generator)
        else:
            with torch.no_grad():
                p.zero_()
    return model


def draw_augment(generator: torch.Generator, B: int, H: int, W: int) -> Dict[str, torch.Tensor]:
    """One batch's augmentation draws, on the generator's device: contrast
    U(0.5, 1.5), brightness U(-0.2, 0.2), noise N(0, 1) scaled by U(0,
    0.08), and one occluder per sample, its corner U(0, 1), its sides U(0.05,
    0.25) and its fill U(0, 1)."""
    dev = generator.device

    def uniform(lo, hi, shape=(B, 1, 1)):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    return {"contrast": uniform(0.5, 1.5), "brightness": uniform(-0.2, 0.2),
            "noise": torch.randn((B, H, W), generator=generator, device=dev),
            "noise_scale": uniform(0.0, 0.08),
            "occ_y": uniform(0.0, 1.0), "occ_x": uniform(0.0, 1.0),
            "occ_h": uniform(0.05, 0.25), "occ_w": uniform(0.05, 0.25),
            "occ_fill": uniform(0.0, 1.0)}


def augment(x: torch.Tensor, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, H, W) net inputs -> the same, with `draw_augment`'s draws applied
    as the JAX script applies its own: clip(x * a + b + noise, 0, 1), then
    the occluder's pixels set to its fill."""
    _, H, W = x.shape
    x = (x * d["contrast"] + d["brightness"] + d["noise"] * d["noise_scale"]).clamp(0.0, 1.0)
    yy = true_div(torch.arange(H, device=x.device, dtype=x.dtype) + 0.5, H)[None, :, None]
    xx = true_div(torch.arange(W, device=x.device, dtype=x.dtype) + 0.5, W)[None, None, :]
    occ = ((yy >= d["occ_y"]) & (yy < d["occ_y"] + d["occ_h"])
           & (xx >= d["occ_x"]) & (xx < d["occ_x"] + d["occ_w"]))
    return torch.where(occ, d["occ_fill"], x)


def loss_fn(model: MouthLocalizer, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """L1 on the corners plus (1 - IoU), both batch means; x (B, 48, 96)."""
    pred = model(x[:, None])
    return (pred - y).abs().mean() + (1.0 - iou(pred, y).mean())


def optimizer(model: MouthLocalizer) -> torch.optim.Optimizer:
    """The JAX script's `optax.adam(1e-3)` (the same betas and eps)."""
    return torch.optim.Adam(model.parameters(), lr=LR)


def train_step(model: MouthLocalizer, opt: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """One Adam step on the (augmented) batch x (B, 48, 96); returns the loss."""
    loss = loss_fn(model, x, y)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss


def val_iou(model: MouthLocalizer, x: torch.Tensor, y: torch.Tensor) -> float:
    with torch.no_grad():
        return iou(model(x[:, None]), y).mean().item()


def train_localizer(steps: int = 1500, batch: int = 128, seed: int = 0, device=None,
                    data: Optional[LocalizerData] = None,
                    log: Optional[Callable[[str], None]] = None,
                    ) -> Tuple[Dict[str, torch.Tensor], List[Dict[str, float]]]:
    """Train from Flax-default parameters on `data` (`build_dataset(seed)`
    when None; left unchanged, so it can serve several runs) on `device`
    (the card when None; raises without one). Returns the trained state
    dict (CPU tensors) and the history: step, loss and validation IoU every
    LOG_EVERY steps and at the last, each passed to `log` as a line too."""
    dev = resolve_device(device)
    data = data if data is not None else build_dataset(seed)
    model = init_localizer(torch.Generator().manual_seed(seed)).to(dev)
    opt = optimizer(model)
    draws = torch.Generator(device=dev).manual_seed(seed)
    xt, yt, xv, yv = (torch.from_numpy(a).to(dev) for a in
                      (data.x_train, data.y_train, data.x_val, data.y_val))
    rows = list(batch_indices(copy.deepcopy(data.rng), len(xt), batch, steps))
    flat = torch.from_numpy(np.concatenate(rows) if rows else np.zeros(0, np.int64)).to(dev)
    H, W = NET_HW
    history: List[Dict[str, float]] = []
    t0, at = time.perf_counter(), 0
    with train_scope():
        for step, idx in enumerate(rows):
            i = flat[at:at + len(idx)]
            at += len(idx)
            loss = train_step(model, opt, augment(xt[i], draw_augment(draws, len(idx), H, W)),
                              yt[i])
            if step % LOG_EVERY == 0 or step == steps - 1:
                history.append({"step": step, "loss": loss.item(),
                                "val_iou": val_iou(model, xv, yv)})
                if log:
                    log(f"step {step:5d}  loss={history[-1]['loss']:.4f}  "
                        f"val_iou={history[-1]['val_iou']:.3f}  "
                        f"({time.perf_counter() - t0:.1f} s)")
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}, history


def accuracy_gates(model: MouthLocalizer, device) -> Tuple[Dict[str, float], List[str]]:
    """The JAX package's accuracy tests of the bundled weights
    (tests/test_localizer.py:54-123) on `model` (on `device`), on the same
    seeded synthetic inputs. Returns their figures and the gates that
    failed (none when every one holds)."""
    def boxes(frames):
        with torch.no_grad():
            return localize_frames(model, torch.from_numpy(frames).to(device)).cpu()

    def clip_box(video):
        with torch.no_grad():
            return localize_clip_boxes(model, torch.from_numpy(video).float()[None]
                                       .to(device))[0].cpu().numpy()

    g, failed = {}, []
    for seed, (h, w) in GATE_GEOMETRIES:
        frames, truth = make_localizer_batch(np.random.default_rng(seed), 32, height=h, width=w)
        g[f"iou_{h}x{w}"] = iou(boxes(frames), torch.from_numpy(truth)).mean().item()
        if g[f"iou_{h}x{w}"] < GATE_IOU:
            failed.append(f"mean IoU at {h}x{w} < {GATE_IOU}")
    r = np.random.default_rng(77)
    frames, truth = make_localizer_batch(r, 32, height=160, width=280)
    f = frames / max(frames.max(), 1e-6)
    f = np.clip(f * 0.6 + 0.15, 0, 1)  # contrast and brightness
    f = np.clip(f + r.normal(0, 0.05, f.shape).astype(np.float32), 0, 1)
    f[:, 10:40, 20:60] = 0.5  # an occluder away from the mouths
    g["iou_degraded"] = iou(boxes(f), torch.from_numpy(truth)).mean().item()
    if g["iou_degraded"] < GATE_DEGRADED:
        failed.append(f"degraded mean IoU < {GATE_DEGRADED}")
    center, scale = (0.7, 0.55), 1.0
    video, _ = make_clip(np.random.default_rng(7), n_frames=16, height=200, width=400,
                         mouth_center=center, mouth_scale=scale)
    g["iou_clip"] = iou(torch.from_numpy(clip_box(video)),
                        torch.from_numpy(mouth_box(center, scale, 200, 400))).item()
    if g["iou_clip"] < GATE_CLIP:
        failed.append(f"one clip's IoU < {GATE_CLIP}")
    r, (h, w) = np.random.default_rng(42), (160, 320)
    kept_model, kept_heuristic = [], []
    for _ in range(8):
        center = (r.uniform(0.25, 0.4), r.uniform(0.75, 0.9))
        video, _ = make_clip(r, n_frames=8, height=h, width=w, mouth_center=center,
                             mouth_scale=1.0)
        bright = video.max(0) > 150  # the mouth's pixels

        def kept(b):
            y0, y1, x0, x1 = int(b[0] * h), int(b[1] * h), int(b[2] * w), int(b[3] * w)
            return bright[y0:y1, x0:x1].sum() / max(bright.sum(), 1)

        kept_model.append(kept(clip_box(video)))
        kept_heuristic.append(kept(HEURISTIC_BOX))
    g["retention_model"] = float(np.mean(kept_model))
    g["retention_heuristic"] = float(np.mean(kept_heuristic))
    if g["retention_model"] < GATE_RETENTION:
        failed.append(f"mouth retention < {GATE_RETENTION}")
    if g["retention_model"] <= g["retention_heuristic"] + GATE_RETENTION_MARGIN:
        failed.append(f"mouth retention not above the heuristic's + {GATE_RETENTION_MARGIN}")
    return g, failed
