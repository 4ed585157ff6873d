"""LipNet CTC training on one GPU (port of `avsync/train/lipnet_trainer.py`).

The reference's semantics (`trainer.py:9-170`): Adam(lr, betas (0.9,
0.999), eps 1e-8), CTC loss with blank=0 / mean over target length /
zero_infinity, global-norm gradient clipping at 1.0, per-epoch train and
validation loss means, periodic checkpoints and a final snapshot, the loss
curve. With `ModelConfig.fused_conv_pool` and `use_pallas_gru` on, a step
runs the hand-written CUDA kernels K1 (conv1 block) and K2 (GRU recurrence)
forward and K3 (GRU backward) and K4 (conv1 weight gradient) backward.

Full fp32 and deterministic: every train step's forward and backward runs
with TF32 off for both cuDNN and cuBLAS and with cuDNN's deterministic
algorithms (`ops/conv.train_scope`, evaluation steps too). The conv calls'
own scope (`ops/conv.fp32_convs`) is
not enough for training: it covers the forward call only, and autograd runs
the conv's backward later, in `loss.backward()`, outside that `with`, under
the process-wide `torch.backends.cudnn.allow_tf32`, which is True by
default. Gradients of conv2/conv3 would then keep about 3 decimal digits
where the JAX reference computes in fp32. Under `compute_dtype="bfloat16"`
the model rounds where the JAX model does (`models/lipnet.py`); the
parameters, their gradients, the clipping and Adam's state stay float32, and
the step scope also makes cuBLAS reduce bf16 products in float32.

Whole-epoch programs (`train_epoch_scanned`, the JAX trainer's
`_scan_program`): a fully device-cached corpus (`LipNetBatcher.scan_plan`)
trains an epoch without host work per step. On the card one train step is
captured in a CUDA graph that picks its batch from the (S, B) plan through
a step counter on the device, gathers it from the cache, runs forward, CTC
(lengths on the device), backward, clipping and Adam, and writes its loss
and gradient norm into (S,) device buffers; the host replays it S times and
reads the buffers once at the epoch's end. On the CPU the same step runs in
a loop. Either way the epoch equals the per-batch loop (`train_epoch`) bit
for bit, as the JAX package's scan equals its loop: the step scope sets
`torch.backends.cudnn.deterministic`, because cuDNN's default algorithms for
conv2's and conv3's backward sum in an order that changes from run to run
(two eager runs of the same steps part from the second step). The flag
costs about a fifth of the step on the H100 (PERF.md §5), which
deterministic conv2/conv3 kernels of our own would win back (ROADMAP).

Dropout: step s draws its masks from the trainer's generator reseeded with
seed * 1,000,003 + s before the step (and before the graph's replay for
step s, which reads the generator's seed and offset at replay), so a loop,
a graph and a resumed run draw the same masks. They cannot equal the JAX
package's `fold_in` keys.

On the card the optimizer is Adam with `capturable=True` and its learning
rate a device tensor, filled when the rate changes (once per epoch under a
schedule), so the captured step needs no host value; on the CPU it is the
plain Adam with a float rate.

Both model families train here (`models.make_lipnet`): the TF family's
loss is `tf_ctc_loss` (blank last, label lengths from count_nonzero, the
per-sequence NLL not length-normalised, averaged over the batch;
`avsync/train/lipnet_trainer.py:157-164`), the PyTorch family's
`ctc_loss_mean`; `lipnet_ctc_loss` picks it by the model.

Over a mesh of ranks (`parallel.mesh`, one process per device, the JAX
trainer's `mesh`): each rank runs forward and backward on its rows of the
global batch (`LipNetBatcher(mesh=...)` gives it only those), then ONE
all-reduce of one flat buffer of its gradients and its loss over the data
group, divided by the data size (`parallel.mesh.GradientReducer`), then the
global-norm clip and Adam, so every replica takes the same update and the
replicas stay equal bit for bit. The loss is the mean over the global batch:
both CTC losses are means over rows, so the mean of the ranks' means is the
global mean when every rank has the same number of rows (`local_rows`
insists). Under a 'model' axis of m > 1 the GRU / LSTM gate rows and the
head's rows (where V divides) are row shards with Adam moments of their
shape (`parallel.mesh.shard_model`); the forward gathers them whole before
each recurrence, and the clip sums the sharded leaves' norms over the model
group. Dropout masks come from (seed, step, data index). Checkpoints hold
whole tensors (`multihost.get_global`), written by rank 0, so a snapshot of
a (2, 2) run loads on one device. A data-parallel epoch program splits its
captured step at the reduction: a graph of forward and backward into the
flat buffer, the all-reduce, a graph of the clip and Adam (a collective of
gloo cannot be captured). Under a model axis the programs run their eager
loop (the gathers are collectives in the forward).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from avsync_torch.config import AvsyncConfig
from avsync_torch.models import make_lipnet
from avsync_torch.models.lipnet_tf import TFLipNet, tf_ctc_loss
from avsync_torch.ops.conv import train_scope
from avsync_torch.ops.ctc import ctc_loss_mean
from avsync_torch.parallel import multihost
from avsync_torch.parallel.mesh import (GradientReducer, Mesh, clip_grad_norm, mesh_from_shape,
                                        shard_model, shard_rows)
from avsync_torch.predictor import resolve_device
from avsync_torch.train.epoch_program import EpochProgram, fingerprint
from avsync_torch.utils import profiling
from avsync_torch.utils.checkpoint import CheckpointManager
from avsync_torch.utils.logging import Logger, format_time
from avsync_torch.utils.signals import sigterm_flag


def make_optimizer(params, learning_rate: float = 1e-4) -> torch.optim.Adam:
    """Adam with torch defaults (`trainer.py:23`). The learning rate is a
    runtime value (`set_learning_rate`), so a schedule changes it without
    rebuilding anything. On the card: `capturable=True` and the rate a
    device tensor, so a captured step reads both from the device. Clipping
    runs in the step, before the update (`trainer.py:64-70`)."""
    params = list(params)
    on_card = bool(params) and params[0].device.type == "cuda"
    lr = (torch.tensor(float(learning_rate), device=params[0].device) if on_card
          else float(learning_rate))
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=on_card)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's rate to `lr`: for a capturable Adam a fill of its device
    tensor (no host-device copy, no sync; a rate that `load_state_dict`
    brought back on the host becomes a device tensor again), else a float."""
    for group in optimizer.param_groups:
        rate = group["lr"]
        if not group.get("capturable", False):
            group["lr"] = float(lr)
        elif isinstance(rate, torch.Tensor) and rate.device == group["params"][0].device:
            rate.fill_(float(lr))
        else:
            group["lr"] = torch.tensor(float(lr), device=group["params"][0].device)


def keras_lr_schedule(epoch: int, lr: float) -> float:
    """The TF stack's LearningRateScheduler (`train.py:611-618`): flat for 30
    epochs, halve each epoch until 60, then exp(-0.1) decay per epoch.
    `epoch` is 0-based as Keras passes it."""
    if epoch < 30:
        return lr
    if epoch < 60:
        return lr * 0.5
    return lr * float(np.exp(-0.1))


def device_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Video float32, labels and label lengths (int64) on the device."""
    return {
        "video": torch.as_tensor(batch["video"], dtype=torch.float32).to(device),
        "labels": torch.as_tensor(np.asarray(batch["labels"]), dtype=torch.long).to(device),
        "label_lengths": torch.as_tensor(np.asarray(batch["label_lengths"]),
                                         dtype=torch.long).to(device),
    }


def lipnet_ctc_loss(model: torch.nn.Module, log_probs: torch.Tensor,
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The model family's CTC loss of a batch's log-probs: `tf_ctc_loss` for a
    TFLipNet, else `ctc_loss_mean` with the batch's label lengths."""
    if isinstance(model, TFLipNet):
        return tf_ctc_loss(log_probs, batch["labels"])
    return ctc_loss_mean(log_probs, batch["labels"], batch["label_lengths"])


def _forward_backward(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator], remat: bool,
                      reducer: Optional[GradientReducer]) -> torch.Tensor:
    """Forward, CTC and backward into gradients that start as None; under
    data parallelism the gradients and the loss packed into the reducer's
    flat buffer."""
    log_probs = model(batch["video"], train=True, generator=generator, remat=remat)
    loss = lipnet_ctc_loss(model, log_probs, batch)
    _mark("head_ctc.bwd", loss.device)
    loss.backward()
    if reducer is not None:
        _mark("reduce", loss.device)
        reducer.pack(loss.detach())
    return loss.detach()


def _apply_update(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  grad_clip_norm: float, mesh: Optional[Mesh]) -> torch.Tensor:
    """Global-norm clip and Adam; returns the pre-clip norm."""
    _mark("update", next(model.parameters()).device)
    grad_norm = clip_grad_norm(model.named_parameters(), grad_clip_norm, mesh)
    optimizer.step()
    return grad_norm.detach()


def _update(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
            batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
            grad_clip_norm: float, remat: bool, reducer: Optional[GradientReducer] = None,
            mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward, CTC, backward, (the data group's all-reduce,) clip, Adam on
    gradients that start as None: the body shared by `train_step` and the
    whole-epoch program. No host value is read, so without a reducer it can
    be captured in a CUDA graph."""
    loss = _forward_backward(model, batch, generator, remat, reducer)
    if reducer is not None:
        reducer.reduce()
        loss = reducer.unpack().clone()  # the buffer is the next step's
    return loss, _apply_update(model, optimizer, grad_clip_norm, mesh)


# The training step's marked layers in forward order (`step_marks` places
# them): the conv blocks, either family's recurrent layers, and the head
# with its CTC loss (LipNet's `fc`; the TF family's three Dense layers).
STEP_LAYERS = ("conv1", "conv2", "conv3", "gru1", "gru2", "gru3", "gru4",
               "lstm1", "lstm2", "lstm3", "lstm4", "head_ctc")
# Every device mark of the step, in the order of `csrc/span_mark.cu`'s
# kernels (`utils.profiling.mark`): the cache gather, each layer's forward
# and backward, the data group's gradient reduction (pack, all-reduce,
# unpack), the update (global-norm clip and Adam), the tail (the loss and
# norm puts and the step counter).
SPAN_MARKS = ("gather", *(f"{layer}.fwd" for layer in STEP_LAYERS),
              *(f"{layer}.bwd" for layer in STEP_LAYERS), "reduce", "update", "tail")

# Whether the calling thread is inside `step_marks`: a bare `train_step`
# marks nothing.
_marking = threading.local()


def _mark(name: str, device) -> None:
    """`profiling.mark(name, device)` inside `step_marks` only."""
    if getattr(_marking, "on", False):
        profiling.mark(name, device)


def _marked_layers(model: torch.nn.Module) -> list:
    """(span name, module) of the step's layers that carry marks, in forward
    order: the conv blocks, the recurrent layers, and the first module of
    the head (LipNet's `fc`, the TF family's `dense1`)."""
    layers = [(name, getattr(model, name)) for name in STEP_LAYERS[:-1]
              if isinstance(getattr(model, name, None), torch.nn.Module)]
    return layers + [("head_ctc", model.dense1 if isinstance(model, TFLipNet) else model.fc)]


@contextlib.contextmanager
def step_marks(model: torch.nn.Module) -> Iterator[None]:
    """The step's layer marks on `model` while the block runs on the
    calling thread (`utils.profiling.mark`): a forward pre-hook on each
    marked layer marks its `.fwd` and passes its input through
    `mark_backward`, so the gradient reaching that input marks the previous
    layer's `.bwd`; the step's own marks (`gather`, `head_ctc.bwd`,
    `reduce`, `update`, `tail`) are placed only inside the block. The hooks
    are removed when the block ends: the modules are shared (the sync
    scorer's `ConvStack`), and export, serving and the detector see no
    mark. A graph captured inside the block keeps its marks."""
    layers = _marked_layers(model)
    handles = []
    for i, (name, module) in enumerate(layers):
        prev = layers[i - 1][0] if i else None

        def hook(_module, args, name=name, prev=prev):
            if torch._C._current_graph_task_id() != -1:
                return None  # remat's recompute, inside the layer's backward span
            x = args[0]
            profiling.mark(f"{name}.fwd", x.device)
            if prev is not None and x.requires_grad:
                return (profiling.mark_backward(x, f"{prev}.bwd"), *args[1:])
            return None

        handles.append(module.register_forward_pre_hook(hook))
    was_on = getattr(_marking, "on", False)
    _marking.on = True
    try:
        yield
    finally:
        _marking.on = was_on
        for h in handles:
            h.remove()


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], lr: float,
               generator: Optional[torch.Generator] = None,
               grad_clip_norm: float = 1.0, remat: bool = False,
               reducer: Optional[GradientReducer] = None, mesh: Optional[Mesh] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update: CTC loss of the training forward (dropout masks from
    `generator`; `remat` recomputes the blocks in the backward), backward,
    (under a mesh the data group's all-reduce through `reducer`,) clip to
    `grad_clip_norm`, Adam at `lr`, in the deterministic step scope. Returns
    (loss, pre-clip global gradient norm) as device scalars; on one device
    nothing here waits for it."""
    with train_scope():
        optimizer.zero_grad(set_to_none=True)
        set_learning_rate(optimizer, lr)
        return _update(model, optimizer, batch, generator, grad_clip_norm, remat, reducer,
                       mesh)


def eval_step(model: torch.nn.Module,
              batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, log_probs) of the inference forward, in the step scope."""
    with train_scope(), torch.no_grad():
        log_probs = model(batch["video"])
        return lipnet_ctc_loss(model, log_probs, batch), log_probs


@dataclass
class TrainState:
    """What a training run carries: the model, its optimizer and the number
    of optimizer steps taken (step s draws its dropout masks from the
    trainer's generator reseeded with (seed, s)); under a mesh of ranks the
    reducer of its gradients."""

    model: torch.nn.Module  # a LipNet or a TFLipNet
    optimizer: torch.optim.Adam
    step: int = 0
    reducer: Optional[GradientReducer] = None


class LipNetTrainer:
    """Host training loop over device steps. Loaders are iterables of
    batches (dicts as `LipNetBatcher` yields them, or numpy), or whole-epoch
    plans from `LipNetBatcher.scan_plan`."""

    # How often train_epoch polls the stop_check callback (in batches).
    PREEMPT_CHECK_EVERY = 16
    # At most this many steps in flight before the host reads a loss back.
    LAG = 4

    def __init__(self, config: AvsyncConfig, device=None, log: Optional[Logger] = None,
                 mesh: Optional[Mesh] = None):
        """`mesh`: the ranks' mesh; by default the config's `mesh_shape` over
        the process group when it has more than one rank, else none. The
        device defaults to the rank's (`multihost.initialize`)."""
        if mesh is None and multihost.is_multiprocess():
            mesh = mesh_from_shape(config.train.mesh_shape)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.config = config
        if device is None and multihost.rank_device() is not None:
            device = multihost.rank_device()
        self.device = resolve_device(device)
        self.log = log or Logger(None, console=True)
        self.current_lr = float(config.train.learning_rate)
        self.dropout_gen = torch.Generator(device=self.device)
        self.train_losses: list = []
        self.val_losses: list = []
        self.lr_history: list = []
        self.epoch_seconds: list = []  # wall seconds per completed epoch
        self._preempted = False
        self._programs: Dict[Tuple[int, int], EpochProgram] = {}

    # -- state -------------------------------------------------------------
    def init_state(self, model: Optional[torch.nn.Module] = None) -> TrainState:
        """A fresh state around `model`, or around a new model of the
        configured family and geometry with weights drawn from the training
        seed."""
        if model is None:
            d = self.config.data
            model = make_lipnet(self.config.model, (d.img_height, d.img_width),
                                generator=torch.Generator().manual_seed(self.config.train.seed))
            model.to(self.device)
        reducer = None
        if self.mesh is not None:
            shard_model(model, self.mesh)  # every rank drew the same weights
            reducer = GradientReducer(model.parameters(), self.mesh)
        return TrainState(model, make_optimizer(model.parameters(), self.current_lr), 0,
                          reducer)

    def load_state(self, state: TrainState, payload: dict) -> None:
        """A snapshot's whole tensors (`CheckpointManager.restore`) into the
        state: this rank's shards of the sharded leaves and their moments."""
        model_sd, opt_sd = payload["model_state_dict"], payload["optimizer_state_dict"]
        if self.mesh is not None and self.mesh.model_size > 1:
            spec = self.mesh.param_spec
            names = [n for n, _ in state.model.named_parameters()]
            model_sd = {k: shard_rows(v, self.mesh) if spec.get(k) is not None else v
                        for k, v in model_sd.items()}
            opt_sd = copy.deepcopy(opt_sd)
            for i, st in opt_sd["state"].items():
                if spec.get(names[int(i)]) is not None:
                    for key in ("exp_avg", "exp_avg_sq"):
                        st[key] = shard_rows(st[key], self.mesh)
        state.model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(opt_sd)
        state.step = int(payload.get("step", 0))

    def full_state(self, state: TrainState) -> Tuple[dict, dict]:
        """(model, optimizer) state dicts with every shard gathered whole;
        every rank must call it (a collective under a model axis)."""
        model_sd = state.model.state_dict()
        opt_sd = state.optimizer.state_dict()
        if self.mesh is None or self.mesh.model_size == 1:
            return model_sd, opt_sd
        spec = self.mesh.param_spec
        names = [n for n, _ in state.model.named_parameters()]
        opt_sd = dict(opt_sd, state={
            i: {k: (multihost.all_gather(v, 0, self.mesh.model_group)
                    if k in ("exp_avg", "exp_avg_sq") and spec.get(names[int(i)]) is not None
                    else v) for k, v in st.items()}
            for i, st in opt_sd["state"].items()})
        return multihost.get_global(model_sd, self.mesh), opt_sd

    def _step_generator(self, step: int) -> torch.Generator:
        seed = self.config.train.seed * 1_000_003 + step
        if self.mesh is not None:  # each data rank its own masks
            seed = seed * self.mesh.data_size + self.mesh.data_index
        return self.dropout_gen.manual_seed(seed)

    # -- epoch loops ---------------------------------------------------------
    def train_epoch(self, state: TrainState, loader: Iterable,
                    stop_check: Optional[Callable[[], bool]] = None,
                    metrics_writer=None) -> Tuple[TrainState, float]:
        """One pass over the loader; returns the mean training loss.

        Losses stay on the device until LAG steps later, so the host keeps
        enqueueing while the device works; reading a loss LAG steps back
        bounds the batches in flight (and surfaces a failing step within
        LAG steps). The epoch-end drain is the device sync. `stop_check` is
        polled every PREEMPT_CHECK_EVERY batches. `metrics_writer` gets each
        step's loss, gradient norm and rate."""
        state.model.train()
        pending, losses = [], []
        cfg = self.config.train

        def drain_one():
            loss, gnorm, step = pending[len(losses)]
            losses.append(float(loss))
            if metrics_writer is not None:
                metrics_writer.write(step, loss=losses[-1], grad_norm=float(gnorm),
                                     lr=self.current_lr)

        with step_marks(state.model):
            for batch in loader:
                if (stop_check is not None and pending
                        and len(pending) % self.PREEMPT_CHECK_EVERY == 0 and stop_check()):
                    if hasattr(loader, "close"):
                        loader.close()  # release the prefetch worker and decode pool
                    break
                _mark("gather", self.device)
                loss, gnorm = train_step(state.model, state.optimizer,
                                         device_batch(batch, self.device), self.current_lr,
                                         self._step_generator(state.step), cfg.grad_clip_norm,
                                         cfg.remat, state.reducer, self.mesh)
                state.step += 1
                pending.append((loss, gnorm, state.step))
                if len(pending) - len(losses) > self.LAG:
                    drain_one()
        while len(losses) < len(pending):
            drain_one()
        return state, sum(losses) / max(len(losses), 1)

    def _plan_batch(self, plan: Dict, prog: EpochProgram) -> Dict[str, torch.Tensor]:
        _mark("gather", prog.counter.device)
        row = prog.row("plan")
        return {"video": plan["gather"](row),
                "labels": plan["labels"].index_select(0, row),
                "label_lengths": plan["lengths"].index_select(0, row)}

    def _plan_step(self, state: TrainState, plan: Dict, prog: EpochProgram) -> None:
        """One step of a whole-epoch program, all on the device: batch row
        `counter` of the plan, gathered from the cache, through `_update`;
        its loss and gradient norm into the program's buffers."""
        cfg = self.config.train
        with train_scope():
            loss, gnorm = _update(state.model, state.optimizer, self._plan_batch(plan, prog),
                                  self.dropout_gen, cfg.grad_clip_norm, cfg.remat,
                                  state.reducer, self.mesh)
        _mark("tail", prog.counter.device)
        prog.put("loss", loss)
        prog.put("grad_norm", gnorm)
        prog.counter.add_(1)

    def _plan_forward_backward(self, state: TrainState, plan: Dict, prog: EpochProgram) -> None:
        """The data-parallel program's first part: forward and backward of
        the rank's columns of the plan row into the reducer's buffer."""
        with train_scope():
            _forward_backward(state.model, self._plan_batch(plan, prog), self.dropout_gen,
                              self.config.train.remat, state.reducer)

    def _plan_apply(self, state: TrainState, prog: EpochProgram) -> None:
        """Its last part, after the all-reduce: the mean gradients back,
        clip, Adam, the loss and norm into the program's buffers."""
        with train_scope():
            loss = state.reducer.unpack()  # put() copies it
            gnorm = _apply_update(state.model, state.optimizer, self.config.train.grad_clip_norm,
                                  self.mesh)
        _mark("tail", prog.counter.device)
        prog.put("loss", loss)
        prog.put("grad_norm", gnorm)
        prog.counter.add_(1)

    def train_epoch_scanned(self, state: TrainState, plan: Dict,
                            metrics_writer=None) -> Tuple[TrainState, float]:
        """One epoch over a `LipNetBatcher.scan_plan` plan through an
        `EpochProgram`: on the card a CUDA graph of the train step replayed
        S times, no host work per step beyond the replay and the dropout
        reseed; on the CPU the eager loop of the same step. The graph is
        kept for later epochs of the same (B, S).
        Losses and gradient norms are read once, at the epoch's end. The
        call is span `avsync_torch.train.plan_call` (S, B), its read of the
        losses `avsync_torch.train.read_losses`; its steps carry the layer
        marks (`step_marks`)."""
        state.model.train()
        idx = np.asarray(plan["idx"])
        S, B = idx.shape
        prog = self._programs.get((B, S))
        if prog is None:
            prog = self._programs[(B, S)] = EpochProgram(self.device, {
                "plan": torch.zeros((S, B), dtype=torch.long, device=self.device),
                "loss": torch.zeros((S,), dtype=torch.float32, device=self.device),
                "grad_norm": torch.zeros((S,), dtype=torch.float32, device=self.device)})
        step0 = state.step

        def before():
            self._step_generator(state.step)
            state.step += 1

        key = lambda: fingerprint(state.optimizer, plan["video"], plan["labels"],  # noqa: E731
                                  plan["lengths"], [] if state.reducer is None
                                  else [state.reducer.flat])
        graph_ok = self.device.type == "cuda" and (self.mesh is None
                                                   or self.mesh.model_size == 1)
        zero_grad = lambda: state.optimizer.zero_grad(set_to_none=True)  # noqa: E731
        with profiling.span("avsync_torch.train.plan_call", S=S, B=B), step_marks(state.model):
            set_learning_rate(state.optimizer, self.current_lr)
            prog.buffers["plan"].copy_(torch.from_numpy(idx).long())
            if state.reducer is None:
                prog.run(S, lambda: self._plan_step(state, plan, prog), before, graph_ok, key,
                         zero_grad=zero_grad, generator=self.dropout_gen)
            else:  # split at the reduction: graph, all-reduce, graph
                prog.run(S, lambda: self._plan_forward_backward(state, plan, prog), before,
                         graph_ok, key, zero_grad=zero_grad, generator=self.dropout_gen,
                         reduce=state.reducer.reduce,
                         finish=lambda: self._plan_apply(state, prog))
            with profiling.span("avsync_torch.train.read_losses"):
                losses = prog.buffers["loss"].cpu().numpy()  # the epoch-end device sync
                gnorms = (prog.buffers["grad_norm"].cpu().numpy() if metrics_writer is not None
                          else None)
        if metrics_writer is not None:
            for i, (loss, gnorm) in enumerate(zip(losses, gnorms)):
                metrics_writer.write(step0 + i + 1, loss=float(loss), grad_norm=float(gnorm),
                                     lr=self.current_lr)
        return state, sum(float(loss) for loss in losses) / S

    def _global_mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean of the data ranks' losses (equal rows per rank)."""
        if self.mesh is None or self.mesh.data_size == 1:
            return loss
        loss = loss.detach().reshape(1).clone()
        multihost.all_reduce(loss, group=self.mesh.data_group)
        return loss[0] / self.mesh.data_size

    def validate(self, state: TrainState, loader: Iterable) -> float:
        state.model.eval()
        total, n = 0.0, 0
        for batch in loader:
            loss, _ = eval_step(state.model, device_batch(batch, self.device))
            total += float(self._global_mean(loss))
            n += 1
        return total / max(n, 1)

    # -- full run --------------------------------------------------------------
    def _run_epoch_source(self, state: TrainState, src, stop_check) -> Tuple[TrainState, float]:
        if isinstance(src, dict) and "idx" in src:
            return self.train_epoch_scanned(state, src)
        return self.train_epoch(state, src, stop_check=stop_check)

    def _snapshot(self, state: TrainState) -> dict:
        return {"model": copy.deepcopy(state.model.state_dict()),
                "optimizer": copy.deepcopy(state.optimizer.state_dict()),
                "step": state.step}

    def _save(self, ckpt: CheckpointManager, label: int, state: TrainState, metrics: dict):
        """Every rank calls it; whole tensors, written by rank 0."""
        model_sd, opt_sd = self.full_state(state)
        ckpt.save(label, model_sd, opt_sd,
                  config=self.config, metrics=metrics,
                  losses={"train": list(self.train_losses), "val": list(self.val_losses)},
                  optimizer_steps=state.step)

    def _load_history(self, history_path: str, start_epoch: int) -> None:
        """Carry an interrupted run's history, cut to its completed epochs."""
        try:
            with open(history_path) as f:
                h = json.load(f)
        except (OSError, ValueError):
            return  # unreadable prior history: start the lists fresh
        self.train_losses = list(h.get("loss", []))[:start_epoch]
        self.val_losses = list(h.get("val_loss", []))[:start_epoch]
        self.lr_history = list(h.get("lr", []))[:start_epoch]
        self.epoch_seconds = list(h.get("epoch_seconds", []))[:start_epoch]
        self.epoch_seconds += [None] * (len(self.train_losses) - len(self.epoch_seconds))

    def train(self, train_loader_fn: Callable[[], Iterable],
              val_loader_fn: Callable[[], Iterable], epochs: Optional[int] = None,
              checkpoint_dir: Optional[str] = None, state: Optional[TrainState] = None,
              lr_schedule: Optional[Callable[[int, float], float]] = None,
              early_stopping_patience: Optional[int] = None,
              example_fn: Optional[Callable[[TrainState, int], None]] = None,
              history_path: Optional[str] = None, start_epoch: int = 0,
              profile_dir: Optional[str] = None) -> TrainState:
        """Full run; the loader fns are called once per epoch. The train
        loader fn may return a whole-epoch plan (`LipNetBatcher.scan_plan`)
        in place of an iterable of batches: that epoch runs as one program
        (`train_epoch_scanned`), which is not stopped mid-epoch.

        `epochs` is the TOTAL budget: a resumed run passes `start_epoch`, the
        epochs already completed, and epoch numbers, the LR schedule (fast-
        forwarded through the completed epochs) and checkpoint labels stay
        absolute. Checkpoints every `checkpoint_every` epochs and a final
        snapshot labelled one past the last epoch reached, each with
        `epochs_completed` in its metrics (plus `preempted` or
        `early_stopped`). SIGTERM stops at the next batch boundary that
        polls, after which the final snapshot is written. With `profile_dir`
        the run's second epoch (its first when it has one) is traced into
        that directory (`utils.profiling.trace`): from the second epoch on,
        a cached corpus replays the epoch program."""
        cfg = self.config.train
        epochs = epochs if epochs is not None else cfg.epochs
        ckpt = CheckpointManager(checkpoint_dir or cfg.checkpoint_dir)
        stop_logged = [False]

        def stop_now() -> bool:
            # every rank votes at the same boundary: a SIGTERM to any rank
            # stops all of them there
            stop = (multihost.any_process_flagged(self._preempted) if self.mesh is not None
                    else self._preempted)
            if stop and not stop_logged[0]:
                stop_logged[0] = True
                self.log.log("preemption signal observed: checkpointing and stopping")
            return stop

        tb_train = tb_val = None
        if cfg.tensorboard and multihost.is_main():
            from avsync_torch.utils.tb import SummaryWriter

            stamp = time.strftime("%Y%m%d-%H%M%S")
            tb_train = SummaryWriter(os.path.join(cfg.log_dir, stamp, "train"))
            tb_val = SummaryWriter(os.path.join(cfg.log_dir, stamp, "validation"))
            self.log.log(f"TensorBoard events -> {cfg.log_dir}/{stamp}")

        if state is None:
            state = self.init_state()
        if start_epoch >= epochs:
            self.log.log(f"Epoch budget already met ({start_epoch}/{epochs}); nothing to train")
        elif start_epoch:
            self.log.log(f"Resuming at epoch {start_epoch + 1}/{epochs}...")
        else:
            self.log.log(f"Starting training for {epochs} epochs...")
        if start_epoch and lr_schedule is not None:
            for e in range(1, start_epoch + 1):  # the schedule is multiplicative
                self.current_lr = float(lr_schedule(e - 1, self.current_lr))
        if start_epoch and history_path and not self.train_losses and os.path.exists(history_path):
            self._load_history(history_path, start_epoch)

        t0 = time.time()
        best_val, best, stall = float("inf"), None, 0
        final_epoch = completed = start_epoch
        early_stopped = False
        with sigterm_flag(self):
            for epoch in range(start_epoch + 1, epochs + 1):
                if stop_now():
                    break
                final_epoch = epoch
                if lr_schedule is not None:
                    self.current_lr = float(lr_schedule(epoch - 1, self.current_lr))
                te = time.time()
                src = train_loader_fn()
                if profile_dir is not None and epoch == min(start_epoch + 2, epochs):
                    from avsync_torch.utils.profiling import trace

                    with trace(profile_dir):
                        state, train_loss = self._run_epoch_source(state, src, stop_now)
                    self.log.log(f"profiler trace of epoch {epoch} -> {profile_dir}")
                else:
                    state, train_loss = self._run_epoch_source(state, src, stop_now)
                if stop_now():
                    self.train_losses.append(train_loss)
                    self.log.log(f"Preempted during epoch {epoch} "
                                 f"(train_loss={train_loss:.4f}); checkpointing")
                    break
                val_loss = self.validate(state, val_loader_fn())
                completed = epoch
                self.train_losses.append(train_loss)
                self.val_losses.append(val_loss)
                self.lr_history.append(self.current_lr)
                self.epoch_seconds.append(round(time.time() - te, 3))
                self.log.log(f"Epoch {epoch}/{epochs} | train_loss={train_loss:.4f} "
                             f"val_loss={val_loss:.4f} | lr={self.current_lr:.2e} | "
                             f"time={format_time(time.time() - te)}")
                if tb_train is not None:
                    tb_train.add_scalar("epoch_loss", train_loss, epoch)
                    tb_train.add_scalar("epoch_lr", self.current_lr, epoch)
                    tb_train.flush()
                    tb_val.add_scalar("epoch_loss", val_loss, epoch)
                    tb_val.flush()
                if example_fn is not None:
                    example_fn(state, epoch)
                if epoch % cfg.checkpoint_every == 0:
                    self._save(ckpt, epoch, state, {"train_loss": train_loss,
                                                    "val_loss": val_loss,
                                                    "epochs_completed": epoch})
                    self.log.log(f"Saved checkpoint: epoch_{epoch}")
                if early_stopping_patience is not None:
                    if val_loss < best_val:
                        best_val, stall, best = val_loss, 0, self._snapshot(state)
                    else:
                        stall += 1
                        if stall >= early_stopping_patience:
                            self.log.log(f"Early stopping at epoch {epoch} (no val "
                                         f"improvement for {stall} epochs); restoring "
                                         "best weights")
                            state.model.load_state_dict(best["model"])
                            state.optimizer.load_state_dict(best["optimizer"])
                            state.step = best["step"]
                            early_stopped = True
                            break
            # the final snapshot, inside the handler's scope so that a second
            # SIGTERM cannot kill the write; a relaunch whose budget is met
            # writes none
            if start_epoch < epochs:
                final = {"epochs_completed": completed}
                if stop_logged[0]:
                    final["preempted"] = True
                if early_stopped:
                    final["early_stopped"] = True  # --resume auto: the run is done
                self._save(ckpt, final_epoch + 1, state, final)
        if tb_train is not None:
            tb_train.close()
            tb_val.close()
        if history_path and multihost.is_main():
            with open(history_path, "w") as f:
                json.dump({"loss": self.train_losses, "val_loss": self.val_losses,
                           "lr": self.lr_history, "epoch_seconds": self.epoch_seconds},
                          f, indent=2)
        self.log.log(f"Training completed in {format_time(time.time() - t0)}. Model saved.")
        return state

    def plot_losses(self, out_path: str = "training_history.png") -> bool:
        """Loss-curve artifact (`trainer.py:159-170`), drawn by rank 0;
        matplotlib is optional: without it nothing is drawn and this returns
        False."""
        if not multihost.is_main():
            return False
        try:
            import matplotlib
        except ImportError:
            self.log.log("matplotlib is not installed: no loss plot")
            return False

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(10, 5))
        plt.plot(self.train_losses, label="Training Loss")
        plt.plot(self.val_losses, label="Validation Loss")
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.title("Training and Validation Loss")
        plt.legend()
        plt.grid(True)
        plt.savefig(out_path)
        plt.close()
        return True
