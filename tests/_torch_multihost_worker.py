"""Worker for tests/test_torch_multihost.py: one process of a two-process run.

Run as:  RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
         python tests/_torch_multihost_worker.py <corpus> <partial_corpus> <out_dir>

Each process joins the group from torchrun's variables
(`avsync_torch.parallel.multihost.initialize()`, gloo on the CPU), trains
the tiny LipNet over a (2, 1) mesh in both pipeline modes, as a scanned
epoch with a checkpoint round trip, through a preemption drill on a (1, 2)
tensor-parallel mesh, and over a partial device cache, then prints one
`RESULT <json>` line. `run_losses` and `run_partial_cache` also run in the
test's own process, on one device, for the single-controller comparison.
Nothing here imports jax.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tiny_cfg(corpus: str, device_cache: str, **data):
    from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig

    d = dict(data_path=corpus, batch_size=8, img_width=32, img_height=16, max_video_length=24,
             max_label_length=12, device_cache=device_cache)
    d.update(data)
    return AvsyncConfig(
        model=ModelConfig(vocab_size=39, hidden_dim=8, conv_channels=(2, 3, 4),
                          conv_kernels=((3, 5, 5), (3, 5, 5), (3, 3, 3)), dropout_rate=0.0,
                          use_pallas_gru=True, fused_conv_pool=True),
        data=DataConfig(**d), train=TrainConfig(learning_rate=1e-3, seed=7))


def _setup(cfg, mesh_shape):
    from avsync_torch.data.grid import GridDataSource
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.parallel import multihost
    from avsync_torch.parallel.mesh import mesh_from_shape
    from avsync_torch.train.lipnet_trainer import LipNetTrainer
    from avsync_torch.utils.logging import Logger

    mesh = mesh_from_shape(mesh_shape) if multihost.is_multiprocess() else None
    batcher = LipNetBatcher(GridDataSource(cfg.data.data_path), cfg, device="cpu", mesh=mesh)
    trainer = LipNetTrainer(cfg, device="cpu", log=Logger(None, console=False), mesh=mesh)
    return batcher, trainer


def run_losses(corpus: str, mode: str) -> list:
    """Two epochs, streamed or over the device cache ('on': built at the
    first epoch); the epoch losses."""
    batcher, trainer = _setup(_tiny_cfg(corpus, "on" if mode == "cache" else "off"), (2, 1))
    state = trainer.init_state()
    losses = []
    for epoch in range(2):
        state, loss = trainer.train_epoch(state, batcher.epoch(shuffle=True, seed=epoch))
        losses.append(float(loss))
    return losses


def run_scan(corpus: str, ckpt_dir: str) -> dict:
    """Two whole-epoch programs over the full cache, then a checkpoint save
    (rank 0 writes) and restore (every rank reads): the losses and the
    round trip's largest error."""
    from avsync_torch.utils.checkpoint import CheckpointManager

    batcher, trainer = _setup(_tiny_cfg(corpus, "on"), (2, 1))
    state = trainer.init_state()
    losses = []
    for epoch in range(2):
        plan = batcher.scan_plan(shuffle=True, seed=epoch)
        assert plan is not None and plan["idx"].shape == (2, 4), "a full cache, 4 rows a rank"
        state, loss = trainer.train_epoch_scanned(state, plan)
        losses.append(float(loss))
    mgr = CheckpointManager(ckpt_dir)
    trainer._save(mgr, 1, state, {})
    payload, _ = mgr.restore(1)
    err = max(float((payload["model_state_dict"][k] - v).abs().max())
              for k, v in state.model.state_dict().items())
    return {"losses": losses, "ckpt_err": err}


def run_preempt(corpus: str, rank: int, ckpt_dir: str) -> dict:
    """SIGTERM to rank 0 only, after epoch 2, on a (1, 2) tensor-parallel
    mesh: the vote must stop both ranks before epoch 3, and the final
    snapshot holds whole tensors that load into one model."""
    import dataclasses
    import os as _os
    import signal

    from avsync_torch.models import make_lipnet
    from avsync_torch.utils.checkpoint import CheckpointManager

    cfg = _tiny_cfg(corpus, "off")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_every=100))
    batcher, trainer = _setup(cfg, (1, 2))

    def signal_rank0_at_2(state, epoch):
        if epoch == 2 and rank == 0:
            _os.kill(_os.getpid(), signal.SIGTERM)

    trainer.train(lambda: batcher.epoch(shuffle=True, seed=0),
                  lambda: batcher.epoch(shuffle=False, seed=0), epochs=30,
                  checkpoint_dir=ckpt_dir, example_fn=signal_rank0_at_2)
    mgr = CheckpointManager(ckpt_dir)
    latest = mgr.latest_step()
    payload, meta = mgr.restore(latest)
    whole = make_lipnet(cfg.model, (16, 32))
    whole.load_state_dict(payload["model_state_dict"])  # whole tensors, not shards
    return {"epochs_run": len(trainer.train_losses), "ckpt_latest": latest,
            "preempted_meta": bool(meta["metrics"].get("preempted", False))}


def run_partial_cache(corpus: str) -> dict:
    """A 1 MB cache budget over 288 kB clips: 3 of 16 clips cached, the rest
    streamed each epoch; the losses, the cached count and each epoch's
    decodes on this process."""
    cfg = _tiny_cfg(corpus, "auto", img_width=64, img_height=48, device_cache_budget_mb=1,
                    device_cache_dtype="float32")
    batcher, trainer = _setup(cfg, (2, 1))
    counts = {"n": 0}
    decode = batcher._decode_clip

    def counting(path):
        counts["n"] += 1
        return decode(path)

    batcher._decode_clip = counting
    state = trainer.init_state()
    losses, decodes = [], []
    for epoch in range(3):
        counts["n"] = 0
        state, loss = trainer.train_epoch(state, batcher.epoch(shuffle=True, seed=epoch))
        losses.append(float(loss))
        decodes.append(counts["n"])
    return {"losses": losses, "n_cached": int(batcher._device_cache["n_cached"]),
            "epoch_decodes": decodes}


def main() -> None:
    corpus, partial, out = sys.argv[1:4]
    from avsync_torch.parallel import multihost

    rank = multihost.initialize(device="cpu")  # RANK, WORLD_SIZE, MASTER_* from the env
    assert multihost.is_multiprocess() and multihost.world_size() == 2
    res = {"rank": rank, "world": multihost.world_size(), "backend": multihost.backend(),
           "stream": run_losses(corpus, "stream"), "cache": run_losses(corpus, "cache"),
           "scan": run_scan(corpus, os.path.join(out, "scan_ckpt")),
           "preempt": run_preempt(corpus, rank, os.path.join(out, "preempt_ckpt")),
           "partial": run_partial_cache(partial)}
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
