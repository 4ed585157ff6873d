"""Rank bodies for the port's multi-device tests (tests/test_torch_parallel.py,
tests/test_torch_context_parallel.py, tests/test_torch_trainer.py,
tests/test_torch_detector.py).

Each function runs in every rank of a gloo group on the CPU that
`avsync_torch.parallel.multihost.spawn` starts, and writes what the test
compares into `out/<name>_<rank>.pt`. Nothing here imports jax: the tests
hand in numpy inputs made from a seed (and the JAX package's weights, already
in the port's layout) and compare the results with the JAX package in the
pytest process.
"""

from __future__ import annotations

import os

import numpy as np
import torch

TINY = dict(vocab_size=39, hidden_dim=8, conv_channels=(2, 3, 4),
            conv_kernels=((3, 5, 5), (3, 5, 5), (3, 3, 3)), dropout_rate=0.0,
            use_pallas_gru=True, fused_conv_pool=True)
LR = 1e-3


def lipnet_config(family: str = "pytorch", T: int = 12, compute_dtype: str = "float32"):
    from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig

    model = dict(TINY, compute_dtype=compute_dtype)
    if family == "tf":
        model.update(family="tf", conv_kernels=((3, 3, 3),) * 3)
    return AvsyncConfig(model=ModelConfig(**model),
                        data=DataConfig(img_height=16, img_width=32, max_video_length=T,
                                        batch_size=8),
                        train=TrainConfig(learning_rate=LR, seed=7))


def synth_batch(seed: int, B: int = 8, T: int = 12, L: int = 6, vocab: int = 37) -> dict:
    """tests/test_train_parallel.py's batch: feasible labels of length 2..L."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, vocab, size=(B, L)).astype(np.int32)
    lengths = rng.integers(2, L + 1, size=(B,)).astype(np.int32)
    for b in range(B):
        labels[b, lengths[b]:] = 0
    return {"video": rng.random((B, T, 16, 32, 1)).astype(np.float32), "labels": labels,
            "label_lengths": lengths}


def _save(out: str, name: str, rank: int, obj) -> None:
    torch.save(obj, os.path.join(out, f"{name}_{rank}.pt"))


def _trainer(cfg, mesh, weights=None):
    """A trainer over `mesh` and its state from `weights` (a whole state
    dict), sharded as the mesh says."""
    from avsync_torch.models import make_lipnet
    from avsync_torch.train.lipnet_trainer import LipNetTrainer
    from avsync_torch.utils.logging import Logger

    tr = LipNetTrainer(cfg, device="cpu", log=Logger(None, console=False), mesh=mesh)
    d = cfg.data
    model = make_lipnet(cfg.model, (d.img_height, d.img_width),
                        generator=torch.Generator().manual_seed(cfg.train.seed))
    if weights is not None:
        model.load_state_dict(weights)
    return tr, tr.init_state(model)


def _local(batch: dict, mesh) -> dict:
    from avsync_torch.parallel import multihost

    rows = multihost.local_rows(len(batch["labels"]), mesh)
    return {k: v[rows] for k, v in batch.items()}


def dp_steps(rank: int, out: str, name: str, shape, weights, batch, family="pytorch",
             steps: int = 3, grads: bool = False, compute_dtype: str = "float32") -> None:
    """`steps` train steps on the global `batch` over a mesh of `shape`: the
    losses, each step's local parameters (for the replicas' bits), the whole
    parameters after the last step, the Adam moments' shapes and, with
    `grads`, the first step's reduced pre-clip gradients, whole."""
    from avsync_torch.parallel import multihost
    from avsync_torch.parallel.mesh import mesh_from_shape
    from avsync_torch.train.lipnet_trainer import _forward_backward, device_batch, train_step

    cfg = lipnet_config(family, T=batch["video"].shape[1], compute_dtype=compute_dtype)
    mesh = mesh_from_shape(shape)
    tr, st = _trainer(cfg, mesh, weights)
    local = device_batch(_local(batch, mesh), tr.device)
    res = {"mesh": {"shape": mesh.devices_shape, "axes": mesh.axis_names,
                    "data_index": mesh.data_index, "model_index": mesh.model_index}}
    if grads:
        st.optimizer.zero_grad(set_to_none=True)
        _forward_backward(st.model, local, None, False, st.reducer)
        st.reducer.reduce()
        st.reducer.unpack()
        res["grads"] = multihost.get_global(
            {n: p.grad.clone() for n, p in st.model.named_parameters()}, mesh)
    losses, per_step = [], []
    for s in range(steps):
        loss, _ = train_step(st.model, st.optimizer, local, LR, tr._step_generator(s),
                             cfg.train.grad_clip_norm, False, st.reducer, tr.mesh)
        st.step += 1
        losses.append(float(loss))
        per_step.append({n: p.detach().clone() for n, p in st.model.named_parameters()})
    full, opt = tr.full_state(st)
    res.update(losses=losses, per_step=per_step, full=full,
               moments={n: tuple(st.optimizer.state[p]["exp_avg"].shape)
                        for n, p in st.model.named_parameters()},
               full_moments={k: tuple(v["exp_avg"].shape) for k, v in opt["state"].items()},
               spec=dict(mesh.param_spec))
    _save(out, name, rank, res)


def dp_program(rank: int, out: str, weights, n_clips: int = 32, S: int = 4) -> None:
    """The data-parallel epoch program (split at the reduction) against the
    data-parallel loop over the same plan, from the same state: losses,
    parameters and Adam state."""
    from avsync_torch.parallel.mesh import make_mesh
    from avsync_torch.parallel import multihost

    cfg = lipnet_config()
    mesh = make_mesh((2, 1))
    cache = torch.from_numpy(np.random.default_rng(5).random((n_clips, 12, 16, 32, 1))
                             .astype(np.float32))
    lab = synth_batch(6, B=n_clips)
    labels = torch.from_numpy(lab["labels"]).long()
    lengths = torch.from_numpy(lab["label_lengths"]).long()
    order = np.random.default_rng(9).permutation(n_clips)[:S * 8].reshape(S, 8)
    rows = multihost.local_rows(8, mesh)
    plan = {"video": cache, "gather": lambda r: cache.index_select(0, r), "labels": labels,
            "lengths": lengths, "idx": order[:, rows].astype(np.int32)}
    results = {}
    for path in ("loop", "program"):
        tr, st = _trainer(cfg, mesh, weights)
        if path == "loop":
            batches = [{"video": cache[order[s, rows]].numpy(),
                        "labels": lab["labels"][order[s, rows]],
                        "label_lengths": lab["label_lengths"][order[s, rows]]}
                       for s in range(S)]
            st, mean = tr.train_epoch(st, batches)
        else:
            st, mean = tr.train_epoch_scanned(st, plan)
        results[path] = {"mean": mean, "step": st.step,
                         "params": {n: p.detach().clone()
                                    for n, p in st.model.named_parameters()},
                         "adam": {n: {k: v.clone() for k, v in st.optimizer.state[p].items()}
                                  for n, p in st.model.named_parameters()}}
    _save(out, "program", rank, results)


def detector_epochs(rank: int, out: str, params, bank_arrays, cfg_json: str,
                    epochs) -> None:
    """Detector training epochs over a (2, 1) mesh from the JAX package's
    initial weights: per epoch (n_videos, seed, batch size), the metrics; the
    parameters after the last."""
    from avsync_torch.config import AvsyncConfig
    from avsync_torch.features import FeatureBank
    from avsync_torch.parallel.mesh import make_mesh
    from avsync_torch.train.detector_trainer import DetectorTrainer
    from avsync_torch.utils.logging import Logger

    cfg = AvsyncConfig.from_json(cfg_json)
    tr = DetectorTrainer(cfg, device="cpu", log=Logger(None, console=False),
                         mesh=make_mesh((2, 1)))
    bank = FeatureBank(*(torch.from_numpy(a) for a in bank_arrays))
    st = tr.init_state(bank.visual.shape[1] + 2 * cfg.audio.n_mfcc, params=params)
    res = []
    for n_videos, seed, B in epochs:
        st, m = tr.run_epoch(st, bank, n_videos, seed=seed, batch_size=B)
        res.append({"loss": m["loss"], "probs": m["probs"], "labels": m["labels"]})
    _save(out, "detector", rank, {"epochs": res, "state": st.model.state_dict(),
                                  "step": st.step})


def cp_chain(rank: int, out: str, name: str, gi, w_hh, b_hh) -> None:
    """`cp_gru_recurrence` over the world: this rank's chunk of gi in, its
    chunk of the output saved."""
    from avsync_torch.parallel import multihost
    from avsync_torch.parallel.context import cp_gru_recurrence

    n = multihost.world_size()
    T = gi.shape[1] // n
    local = torch.from_numpy(gi[:, rank * T:(rank + 1) * T]).contiguous()
    y = cp_gru_recurrence(None, local, torch.from_numpy(w_hh), torch.from_numpy(b_hh))
    _save(out, name, rank, y)


def cp_chain_grad(rank: int, out: str, name: str, gi, w_hh, b_hh, cot) -> None:
    """The chain's backward over the world: sum(y * cot) of this rank's
    chunk, differentiated; this rank's dgi chunk and its dw_hh and db_hh
    (reduced over the ranks) saved, with its forward output."""
    from avsync_torch.parallel import multihost
    from avsync_torch.parallel.context import cp_gru_recurrence

    n = multihost.world_size()
    T = gi.shape[1] // n
    part = slice(rank * T, (rank + 1) * T)
    local = torch.from_numpy(gi[:, part]).contiguous().requires_grad_()
    w, b = (torch.from_numpy(a).requires_grad_() for a in (w_hh, b_hh))
    y = cp_gru_recurrence(None, local, w, b)
    (y * torch.from_numpy(cot[:, part])).sum().backward()
    _save(out, name, rank, {"y": y.detach(), "dgi": local.grad, "dw": w.grad, "db": b.grad})


def build_trainers(rank: int, out: str) -> None:
    """Both trainers on a (2, 1) mesh of two CPU ranks: what each took."""
    from avsync_torch.config import AvsyncConfig, TrainConfig
    from avsync_torch.train.detector_trainer import DetectorTrainer
    from avsync_torch.train.lipnet_trainer import LipNetTrainer
    from avsync_torch.utils.logging import Logger

    cfg = AvsyncConfig(train=TrainConfig(mesh_shape=(2, 1)))
    quiet = Logger(None, console=False)
    t = LipNetTrainer(cfg, device="cpu", log=quiet)
    d = DetectorTrainer(cfg, device="cpu", log=quiet)
    st = d.init_state(8)
    _save(out, "build", rank, {"lipnet": t.mesh.devices_shape, "detector": d.mesh.devices_shape,
                               "data_index": d.mesh.data_index,
                               "reducer": st.reducer is not None})


def world2(rank: int, out: str, inputs: dict) -> None:
    """Every two-rank scenario of tests/test_torch_parallel.py in one group."""
    dp_steps(rank, out, "dp2", (2, 1), inputs["weights"], inputs["batch"], grads=True)
    dp_program(rank, out, inputs["weights"])
    detector_epochs(rank, out, *inputs["detector"])


def bf16_world2(rank: int, out: str, inputs: dict) -> None:
    """tests/test_torch_bf16.py: DP (2, 1) train steps under bf16 compute."""
    dp_steps(rank, out, "bf16_dp2", (2, 1), inputs["weights"], inputs["batch"], grads=True,
             compute_dtype="bfloat16")


def world4(rank: int, out: str, inputs: dict) -> None:
    """Every four-rank scenario: DP (4, 1), TP (2, 2) and (1, 4), the
    hierarchical (2, 2, 1), the TF family at (4, 1) and (2, 2)."""
    for shape in ((4, 1), (2, 2), (1, 4), (2, 2, 1)):
        dp_steps(rank, out, "x".join(map(str, shape)), shape, inputs["weights"],
                 inputs["batch"], steps=2)
    for shape in ((4, 1), (2, 2)):
        dp_steps(rank, out, "tf" + "x".join(map(str, shape)), shape, inputs["tf_weights"],
                 inputs["tf_batch"], family="tf", steps=2)
