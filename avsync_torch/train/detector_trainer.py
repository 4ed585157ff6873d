"""Misalignment-detector training on one GPU (port of
`avsync/train/detector_trainer.py`).

The reference's semantics (`misalignment_detection_train.py:253-280,
345-486`): Adam(lr 1e-3, weight_decay 1e-5) with torch's coupled L2 (the
decay joins the gradient before the moments: exactly the JAX package's
`optax.chain(add_decayed_weights, adam)`), weighted BCE with logits,
accuracy at 0.5 and ROC-AUC per epoch, best-val-AUC selection (the latest
tie wins), periodic snapshots and a SIGTERM snapshot.

Features come from a `FeatureBank` on the device: each step gathers its
(clip, shift) pairs and computes their audio statistics there (K5 with
`AudioConfig.use_pallas`), then runs the detector's forward and backward,
with TF32 off and cuDNN deterministic (`ops/conv.train_scope`). No gradient
reaches the audio: only the detector's parameters are trained.

`run_epoch` runs the epoch's full batches as one program, as the JAX
package's `train_epoch_scan` / `eval_epoch_scan`: on the card a CUDA graph
of the step (bank gather, K5, forward, backward, Adam) replayed over the
(S, B) plan (`train.epoch_program`), on the CPU the eager loop of the same
step. The ragged tail runs as its own unpadded step, as the JAX package
runs it on one device. `_force_loop` runs the per-step loop instead (the
program equals it bit for bit). Step s draws its dropout masks from the
trainer's generator reseeded with seed * 1,000,003 + s before the step or
its replay. On the card Adam is `capturable=True`.

Over a mesh of ranks (data parallelism, the JAX trainer's `mesh`): every
rank holds the whole bank and a replica of the detector; each batch tiles
the data size, a ragged tail padded with zero-weight rows, and each rank
takes its contiguous block of rows. The loss is sum(w * l) / sum(w) over the
GLOBAL batch: each rank divides its weighted sum by the global weight sum
(known on the host from the plan), and one all-reduce (SUM) of one flat
buffer of its gradients and loss term gives every rank the global loss and
its gradient (a padded tail gives the ranks unequal weights, so averaging
the ranks' means would be wrong). The probabilities come back in row order
by a gather over the data group. The epoch programs split at the reduction
(`train/epoch_program.py`); eval programs all-reduce their loss buffer once.
Dropout masks come from (seed, step, data index).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from avsync_torch.compat import conv_shape_for, detector_params_from_jax
from avsync_torch.config import AudioConfig, AvsyncConfig
from avsync_torch.eval import auroc, binary_accuracy
from avsync_torch.features import FeatureBank, gather_features, sample_shift_labels
from avsync_torch.models.detector import MisalignmentDetector
from avsync_torch.ops.conv import train_scope
from avsync_torch.parallel import multihost
from avsync_torch.parallel.mesh import GradientReducer, Mesh, mesh_from_shape
from avsync_torch.predictor import resolve_device
from avsync_torch.train.epoch_program import EpochProgram, fingerprint
from avsync_torch.utils.logging import Logger, format_time
from avsync_torch.utils.signals import sigterm_flag


def make_detector_optimizer(params, lr: float, weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam(lr, weight_decay=wd) (`misalignment_detection_train.py:412`):
    L2 coupled into the gradient, not decoupled AdamW; `capturable` on the
    card, so a CUDA graph can hold the update."""
    params = list(params)
    on_card = bool(params) and params[0].device.type == "cuda"
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=on_card)


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                 denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum(BCE-with-logits * w) / max(sum(w), 1); with `denom`, the rows'
    share of a larger batch's loss: sum(BCE * w) / denom."""
    bce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    return (bce * weights).sum() / (weights.sum().clamp(min=1.0) if denom is None else denom)


def detector_train_step(model: MisalignmentDetector, optimizer: torch.optim.Optimizer,
                        bank: FeatureBank, video_idx: torch.Tensor, shifts: torch.Tensor,
                        labels: torch.Tensor, weights: torch.Tensor, audio_cfg: AudioConfig,
                        generator: Optional[torch.Generator] = None,
                        reducer: Optional[GradientReducer] = None,
                        denom: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update on the gathered (clip, shift) batch, dropout masks from
    `generator` (under a mesh: this rank's rows, `denom` the global weight
    sum, the gradients reduced through `reducer`). Returns (loss, sigmoid of
    the pre-update logits) as device tensors; on one device nothing here
    waits for it."""
    optimizer.zero_grad(set_to_none=True)
    return _detector_update(model, optimizer, bank, video_idx, shifts, labels, weights,
                            audio_cfg, generator, reducer, denom)


def _detector_forward_backward(model, bank, video_idx, shifts, labels, weights, audio_cfg,
                               generator, reducer=None, denom=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Features, forward, loss and backward on gradients that start as
    None (and the pack into the reducer's buffer); (loss, probabilities)."""
    with train_scope():
        with torch.no_grad():
            feats = gather_features(bank, video_idx, shifts, audio_cfg)
        logits = model(feats, train=True, generator=generator)
        loss = weighted_bce(logits, labels, weights, denom)
        loss.backward()
    if reducer is not None:
        reducer.pack(loss.detach())
    return loss.detach(), torch.sigmoid(logits.detach())


def _detector_apply(optimizer, reducer=None) -> Optional[torch.Tensor]:
    """(The reduced gradients back, then) Adam; the reduced loss or None."""
    loss = None
    with train_scope():
        if reducer is not None:
            loss = reducer.unpack().clone()  # the buffer is the next step's
        optimizer.step()
    return loss


def _detector_update(model, optimizer, bank, video_idx, shifts, labels, weights, audio_cfg,
                     generator, reducer=None, denom=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The body shared by `detector_train_step` and the epoch program, on
    gradients that start as None; no host value is read."""
    loss, probs = _detector_forward_backward(model, bank, video_idx, shifts, labels, weights,
                                             audio_cfg, generator, reducer, denom)
    if reducer is not None:
        reducer.reduce()
    reduced = _detector_apply(optimizer, reducer)
    return (loss if reduced is None else reduced), probs


def detector_eval_step(model: MisalignmentDetector, bank: FeatureBank, video_idx: torch.Tensor,
                       shifts: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                       audio_cfg: AudioConfig, denom: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, probabilities) of the inference forward (`denom` as in
    `weighted_bce`)."""
    with train_scope(), torch.no_grad():
        logits = model(gather_features(bank, video_idx, shifts, audio_cfg))
        return weighted_bce(logits, labels, weights, denom), torch.sigmoid(logits)


@dataclass
class DetectorState:
    """The detector, its optimizer and the number of optimizer steps taken
    (step s draws its dropout masks from a generator seeded with (seed, s))."""

    model: MisalignmentDetector
    optimizer: torch.optim.Adam
    step: int = 0
    reducer: Optional[GradientReducer] = None  # under a mesh of ranks


class DetectorTrainer:
    """Host loop over device steps on one GPU (or the CPU, `device="cpu"`),
    or over a mesh of ranks (`mesh`; by default the config's `mesh_shape`
    over the process group when it has more than one rank)."""

    def __init__(self, config: AvsyncConfig, device=None, log: Optional[Logger] = None,
                 mesh: Optional[Mesh] = None):
        if mesh is None and multihost.is_multiprocess():
            mesh = mesh_from_shape(config.train.mesh_shape)
        if mesh is not None and mesh.model_size > 1:
            raise ValueError(f"the detector shards no parameter: mesh {mesh.shape} has a "
                             "model axis")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.config = config
        if device is None and multihost.rank_device() is not None:
            device = multihost.rank_device()
        self.device = resolve_device(device)
        self.log = log or Logger(None, console=True)
        self.dropout_gen = torch.Generator(device=self.device)
        self._preempted = False
        self._programs: Dict[tuple, EpochProgram] = {}
        # test hook: the per-step loop (the epoch programs must equal it)
        self._force_loop = False

    def init_state(self, feature_dim: int, params: Optional[Mapping] = None) -> DetectorState:
        """A fresh detector with weights drawn from the training seed, or
        `params`: a state dict, or the JAX package's {"fc1", "fc2"} params
        (through the weight bridge)."""
        det = self.config.detector
        model = MisalignmentDetector(feature_dim, det.hidden_dim, det.dropout,
                                     generator=torch.Generator().manual_seed(
                                         self.config.train.seed))
        if params is not None:
            if "fc1" in params:
                params = detector_params_from_jax(params, conv_shape_for(self.config),
                                                  2 * self.config.audio.n_mfcc)
            model.load_state_dict(params)
        model.to(self.device)
        reducer = None
        if self.mesh is not None:
            reducer = GradientReducer(model.parameters(), self.mesh, mean=False)
        return DetectorState(model, make_detector_optimizer(model.parameters(), det.lr,
                                                            det.weight_decay), 0, reducer)

    def _step_generator(self, step: int) -> torch.Generator:
        seed = self.config.train.seed * 1_000_003 + step
        if self.mesh is not None:  # each data rank its own masks
            seed = seed * self.mesh.data_size + self.mesh.data_index
        return self.dropout_gen.manual_seed(seed)

    def _gather_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data ranks' blocks of rows back in row order."""
        if self.mesh is None:
            return t
        return multihost.all_gather(t, dim, self.mesh.data_group)

    def _sum_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            t = multihost.all_reduce(t.clone(), group=self.mesh.data_group)
        return t

    def stop_requested(self) -> bool:
        """The SIGTERM flag, voted over the ranks (every rank calls it at
        the same boundary)."""
        if self.mesh is None:
            return self._preempted
        return multihost.any_process_flagged(self._preempted)

    def run_epoch(self, state: DetectorState, bank: FeatureBank, n_videos: int, seed: int,
                  train: bool = True, batch_size: Optional[int] = None
                  ) -> Tuple[DetectorState, Dict]:
        """One pass over the shift-contrastive plan drawn from `seed`
        (`run_epoch`, `misalignment_detection_train.py:253-280`): loss (the
        batch losses weighted by their sizes, summed in float64 in batch
        order), acc, auc, and the plan's labels and probabilities. The full
        batches run as one epoch program (unless `_force_loop`), the ragged
        tail as a step of its own. Under a mesh the batches tile the data
        size (a ragged tail padded with zero-weight rows) and each rank runs
        its block of every batch."""
        det = self.config.detector
        B = batch_size or det.batch_size
        video_idx, shifts, labels = sample_shift_labels(
            n_videos, det.max_shift_frames, det.num_negative_samples,
            np.random.default_rng(seed), shuffle=train)
        tile = 1 if self.mesh is None else self.mesh.data_size
        vi_d, sh_d, lb_d = (torch.from_numpy(a).to(self.device)
                            for a in (video_idx, shifts, labels))
        losses, sizes, probs = [], [], []
        start, S = 0, len(video_idx) // B
        if S > 0 and B % tile == 0 and not self._force_loop:
            start = S * B
            rows = multihost.local_rows(B, self.mesh)
            plan_losses, plan_probs = self._run_program(
                state, bank, *(a[:start].view(S, B)[:, rows] for a in (vi_d, sh_d, lb_d)),
                S, B, train)
            losses.append(plan_losses)
            sizes += [B] * S
            probs.append(plan_probs.reshape(-1))
        for i in range(start, len(video_idx), B):
            vi, sh, lb = vi_d[i:i + B], sh_d[i:i + B], lb_d[i:i + B]
            valid, denom = len(vi), None
            w = torch.ones(valid, device=self.device)
            if self.mesh is not None:  # zero-weight rows up to the tile; this rank's block
                pad = (-valid) % tile
                vi, sh, lb, w = (F.pad(a, (0, pad)) for a in (vi, sh, lb, w))
                rows = multihost.local_rows(valid + pad, self.mesh)
                vi, sh, lb, w = vi[rows], sh[rows], lb[rows], w[rows]
                denom = torch.tensor(float(max(valid, 1)), device=self.device)
            if train:
                loss, p = detector_train_step(state.model, state.optimizer, bank, vi, sh, lb,
                                              w, self.config.audio,
                                              self._step_generator(state.step),
                                              state.reducer, denom)
                state.step += 1
            else:
                loss, p = detector_eval_step(state.model, bank, vi, sh, lb, w,
                                             self.config.audio, denom)
                loss = self._sum_over_ranks(loss)
            losses.append(loss.view(1))
            sizes.append(valid)
            probs.append(self._gather_rows(p)[:valid])
        total = 0.0
        if losses:
            for loss, n in zip(torch.cat(losses).cpu().numpy(), sizes):
                total += float(loss) * n
        probs = torch.cat(probs).cpu().numpy() if probs else np.zeros(0, np.float32)
        return state, {"loss": total / max(len(video_idx), 1),
                       "acc": binary_accuracy(labels, probs), "auc": auroc(labels, probs),
                       "labels": labels, "probs": probs}

    def _run_program(self, state: DetectorState, bank: FeatureBank, vi: torch.Tensor,
                     sh: torch.Tensor, lb: torch.Tensor, S: int, B: int, train: bool):
        """The train or eval epoch program over S full batches of B (the
        JAX package's `train_epoch_scan` / `eval_epoch_scan`): (S,) losses
        and (S, B) probabilities on the device."""
        dev = self.device
        Bl = vi.shape[1]  # this rank's columns: B, or B / data size under a mesh
        key = (train, S, B) + fingerprint(list(bank))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = EpochProgram(dev, {
                "vi": torch.zeros((S, Bl), dtype=vi.dtype, device=dev),
                "sh": torch.zeros((S, Bl), dtype=sh.dtype, device=dev),
                "lb": torch.zeros((S, Bl), dtype=torch.float32, device=dev),
                "w": torch.ones((Bl,), dtype=torch.float32, device=dev),
                "denom": torch.tensor(float(B), device=dev),
                "loss": torch.zeros((S,), dtype=torch.float32, device=dev),
                "probs": torch.zeros((S, Bl), dtype=torch.float32, device=dev)})
        for name, plan in (("vi", vi), ("sh", sh), ("lb", lb)):
            prog.buffers[name].copy_(plan)
        audio = self.config.audio
        reducer = state.reducer if train else None
        denom = None if self.mesh is None else prog.buffers["denom"]

        def args():
            return (prog.row("vi"), prog.row("sh"), prog.row("lb"), prog.buffers["w"])

        def body():
            if train:
                loss, p = _detector_update(state.model, state.optimizer, bank, *args(), audio,
                                           self.dropout_gen, None, denom)
            else:
                loss, p = detector_eval_step(state.model, bank, *args(), audio, denom)
            prog.put("loss", loss)
            prog.put("probs", p)
            prog.counter.add_(1)

        def forward_backward():  # a data-parallel train step, up to its reduction
            _, p = _detector_forward_backward(state.model, bank, *args(), audio,
                                              self.dropout_gen, reducer, denom)
            prog.put("probs", p)

        def finish():
            prog.put("loss", _detector_apply(state.optimizer, reducer))
            prog.counter.add_(1)

        def before():
            if train:
                self._step_generator(state.step)
                state.step += 1

        graph_ok = dev.type == "cuda"
        if train and reducer is not None:
            prog.run(S, forward_backward, before, graph_ok,
                     lambda: fingerprint(state.optimizer, [reducer.flat]),
                     zero_grad=lambda: state.optimizer.zero_grad(set_to_none=True),
                     generator=self.dropout_gen, reduce=reducer.reduce, finish=finish)
        elif train:
            prog.run(S, body, before, graph_ok, lambda: fingerprint(state.optimizer),
                     zero_grad=lambda: state.optimizer.zero_grad(set_to_none=True),
                     generator=self.dropout_gen)
        else:
            prog.run(S, body, before, graph_ok,
                     lambda: fingerprint(list(state.model.parameters())))
        losses = prog.buffers["loss"]
        if not train:
            losses = self._sum_over_ranks(losses)  # the ranks' shares of each batch's loss
        return losses, self._gather_rows(prog.buffers["probs"], 1)

    def train(self, bank: FeatureBank, train_videos: int, val_bank: FeatureBank,
              val_videos: int, epochs: Optional[int] = None, save_every: Optional[int] = None,
              save_fn=None) -> Tuple[DetectorState, Dict[str, float]]:
        """Full run with best-val-AUC selection
        (`misalignment_detection_train.py:418-444`): `save_fn(state, epoch)`
        every `save_every` epochs. A SIGTERM stops at the epoch boundary
        after a snapshot through `save_fn` (validation is skipped when it
        lands during the training pass)."""
        epochs = epochs or self.config.detector.epochs
        seed = self.config.train.seed
        state = self.init_state(bank.visual.shape[1] + 2 * self.config.audio.n_mfcc)
        best, best_auc = None, -1.0
        t0 = time.time()
        with sigterm_flag(self):
            for epoch in range(1, epochs + 1):
                te = time.time()
                state, tr = self.run_epoch(state, bank, train_videos, seed=seed + epoch)
                if self.stop_requested():
                    self.log.log(f"preemption signal observed during epoch {epoch}: "
                                 "snapshotting and stopping")
                    if save_fn:
                        save_fn(state, epoch)
                    break
                _, va = self.run_epoch(state, val_bank, val_videos, seed=seed + 10_000 + epoch,
                                       train=False)
                self.log.log(
                    f"Epoch {epoch:02d}/{epochs} | train_loss={tr['loss']:.4f} "
                    f"train_acc={tr['acc']:.3f} | val_loss={va['loss']:.4f} "
                    f"val_acc={va['acc']:.3f} val_auc={va['auc']:.3f} | "
                    f"time={time.time() - te:.1f}s")
                # >=: ties go to the LATEST epoch, the reference's effective
                # behaviour (its best_state aliases the live tensors, so the
                # last epoch's weights ship; `avsync/train/detector_trainer.py:364-373`)
                if not np.isnan(va["auc"]) and va["auc"] >= best_auc:
                    best_auc = va["auc"]
                    best = copy.deepcopy(state.model.state_dict())
                    self.log.log(f"  -> New best model (val_auc={best_auc:.3f})")
                saved = False
                if save_every and save_fn and epoch % save_every == 0:
                    save_fn(state, epoch)
                    self.log.log(f"  -> Checkpoint saved: epoch {epoch}")
                    saved = True
                if self.stop_requested():
                    self.log.log(f"preemption signal observed after epoch {epoch}: "
                                 "snapshotting and stopping")
                    if save_fn and not saved:
                        save_fn(state, epoch)
                    break
        if best is not None:
            state.model.load_state_dict(best)
        self.log.log(f"Training done in {format_time(time.time() - t0)}")
        return state, {"best_val_auc": best_auc}
