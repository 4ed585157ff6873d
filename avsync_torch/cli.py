"""Command line of the port (port of `avsync/cli.py`: train, test, infer).

    python -m avsync_torch.cli train --data_path data --epochs 50 --export_pth lipnet.pth
    python -m avsync_torch.cli test --data_path data --checkpoint lipnet.pth
    python -m avsync_torch.cli infer clip.npy --checkpoint lipnet.pth

Every command runs on the card unless `--device cpu` is given. `train` and
`test` build the JAX package's default LipNet (or the `--config` JSON's)
with both kernel flags on unless the config file turns them off; they run
with TF32 off for cuDNN and cuBLAS, as the JAX reference computes in fp32.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
from typing import List, Optional, Sequence

from avsync_torch.config import AvsyncConfig, ModelConfig


def _config(path: Optional[str]) -> AvsyncConfig:
    if path is None:
        return AvsyncConfig()
    with open(path) as f:
        return AvsyncConfig.from_json(f.read())


def _config_from_args(args) -> AvsyncConfig:
    """The `--config` JSON (or the defaults with both kernel flags on), then
    the command line's scalars over it."""
    base = _config(args.config) if args.config else AvsyncConfig(
        model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True))

    def arg(name, fallback):
        v = getattr(args, name, None)
        return fallback if v is None else v

    return dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, data_path=args.data_path,
                                 batch_size=arg("batch_size", base.data.batch_size)),
        train=dataclasses.replace(
            base.train, epochs=arg("epochs", base.train.epochs),
            learning_rate=arg("lr", base.train.learning_rate),
            seed=arg("seed", base.train.seed),
            checkpoint_dir=arg("checkpoint_dir", base.train.checkpoint_dir),
            quick_test=bool(getattr(args, "quick_test", False)) or base.train.quick_test),
    )


def _no_tf32() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _evaluate(model, cfg: AvsyncConfig, batcher, source, out_json: str, device,
              num_print: int = 5) -> dict:
    """Greedy-decode the split, print a few samples, write CER/WER/accuracy
    JSON (`utils.py:38-86`, `train.py:916-942`)."""
    from avsync_torch import text as textlib
    from avsync_torch.eval import evaluate_transcripts
    from avsync_torch.train.lipnet_trainer import device_batch, eval_step

    model.eval()
    preds: List[str] = []
    targets: List[str] = []
    for batch in batcher.epoch(shuffle=False, drop_last=False):
        _, log_probs = eval_step(model, device_batch(batch, device))
        for d in textlib.decode_batch(log_probs[: batch["valid"]]):
            idx = len(preds)
            preds.append(d)
            targets.append(source.samples[idx].text)
            if idx < num_print:
                print(f"\nSample {idx + 1}:")
                print(f"True text: {targets[-1]}")
                print(f"Predicted text: {d}")
    results = evaluate_transcripts(preds, targets)
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nTest results: {results} -> {out_json}")
    return results


def cmd_train(args) -> int:
    from avsync_torch.compat import save_lipnet_pth
    from avsync_torch.data.grid import GridDataSource, check_data_structure, split_speakers
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.train.lipnet_trainer import LipNetTrainer, keras_lr_schedule
    from avsync_torch.utils.checkpoint import CheckpointManager

    _no_tf32()
    cfg = _config_from_args(args)
    speakers = args.speakers or check_data_structure(cfg.data.data_path)
    if not speakers:
        print(f"ERROR: no usable speakers under {cfg.data.data_path}")
        return 1
    train_sp, val_sp, test_sp = split_speakers(speakers, cfg.data.split)
    print(f"Speakers: train={train_sp} val={val_sp} test={test_sp}")
    trainer = LipNetTrainer(cfg, device=args.device)
    sources = {name: GridDataSource(cfg.data.data_path, sp)
               for name, sp in (("train", train_sp), ("val", val_sp), ("test", test_sp))}
    batchers = {name: LipNetBatcher(src, cfg, device=trainer.device)
                for name, src in sources.items()}

    if cfg.train.quick_test:
        # smoke mode (`main.py:154-167`): one batch through the forward pass
        batch = batchers["train"].first_batch()
        state = trainer.init_state()
        out = state.model(batch["video"])
        print(f"quick_test: input {tuple(batch['video'].shape)} -> output {tuple(out.shape)}")
        return 0

    example_fn = None
    if args.show_examples:
        from avsync_torch import text as textlib
        from avsync_torch.train.lipnet_trainer import device_batch, eval_step

        ex_batches = {name: batchers[name].first_batch() for name in ("train", "val")}

        def example_fn(state, epoch):
            # per-epoch qualitative decode (ProduceExample, `train.py:552-608`)
            for name, b in ex_batches.items():
                _, lp = eval_step(state.model, device_batch(b, trainer.device))
                print(f"[{name} examples, epoch {epoch}]")
                for i, p in enumerate(textlib.decode_batch(lp[:2])):
                    print(f"  original:   {sources[name].samples[i].text}")
                    print(f"  prediction: {p}")

    state, start_epoch = None, 0
    resume_dir = args.resume
    if resume_dir == "auto":
        if CheckpointManager(cfg.train.checkpoint_dir).latest_step() is None:
            resume_dir = None
            print("resume=auto: no snapshots yet — starting fresh")
        else:
            resume_dir = cfg.train.checkpoint_dir
    if resume_dir:
        payload, meta = CheckpointManager(resume_dir).restore()
        state = trainer.init_state()
        state.model.load_state_dict(payload["model_state_dict"])
        state.optimizer.load_state_dict(payload["optimizer_state_dict"])
        state.step = int(payload.get("step", 0))
        if args.resume == "auto":
            # --epochs is a TOTAL budget: credit the epochs COMPLETED (from
            # the snapshot's metrics; the step counter would over-credit a
            # mid-epoch preemption), or none left after an early stop
            metrics = meta.get("metrics", {})
            done = metrics.get("epochs_completed")
            if done is None:
                done = state.step // max(1, len(sources["train"]) // cfg.data.batch_size)
            start_epoch = min(int(done), cfg.train.epochs)
            if metrics.get("early_stopped"):
                print("resume=auto: previous run early-stopped — treating the epoch "
                      "budget as met")
                start_epoch = cfg.train.epochs
        print(f"Resumed from {resume_dir} at step {state.step} "
              f"(epochs completed: {start_epoch})")

    # a fresh shuffle order per epoch, seeds continuing the ABSOLUTE epoch
    # sequence on resume (the JAX CLI's rule: a fresh run spends seed index
    # 0 on its template draw, so epoch e shuffles with seed + e either way)
    epoch_seq = itertools.count(start_epoch + 1 if state is not None else 1)

    def train_source():
        return batchers["train"].epoch(shuffle=True, seed=cfg.train.seed + next(epoch_seq))

    state = trainer.train(
        train_source, lambda: batchers["val"].epoch(shuffle=False), state=state,
        checkpoint_dir=cfg.train.checkpoint_dir,
        lr_schedule=keras_lr_schedule if args.lr_schedule == "keras" else None,
        early_stopping_patience=args.early_stopping, example_fn=example_fn,
        history_path=os.path.join(cfg.train.checkpoint_dir, "history.json"),
        start_epoch=start_epoch)
    trainer.plot_losses(os.path.join(cfg.train.checkpoint_dir, "training_history.png"))
    if args.export_pth:
        save_lipnet_pth(state.model.state_dict(), args.export_pth)
        print(f"Exported reference-format checkpoint to {args.export_pth}")
    _evaluate(state.model, cfg, batchers["test"], sources["test"],
              os.path.join(cfg.train.checkpoint_dir, "test_results.json"), trainer.device)
    return 0


def _load_state_dict(checkpoint: str):
    """A reference `.pth` (either layout) or a port checkpoint directory
    (its latest snapshot)."""
    from avsync_torch.compat import load_pth
    from avsync_torch.utils.checkpoint import CheckpointManager

    if os.path.isdir(checkpoint):
        payload, _ = CheckpointManager(checkpoint).restore()
        return payload["model_state_dict"]
    return load_pth(checkpoint)


def cmd_test(args) -> int:
    from avsync_torch.data.grid import GridDataSource, check_data_structure, split_speakers
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.models.lipnet import LipNet
    from avsync_torch.predictor import resolve_device

    if args.beam and args.beam > 1:
        raise NotImplementedError("beam search is not ported yet")
    _no_tf32()
    cfg = _config_from_args(args)
    device = resolve_device(args.device)
    speakers = args.speakers or check_data_structure(cfg.data.data_path)
    _, _, test_sp = split_speakers(speakers, cfg.data.split)
    src = GridDataSource(cfg.data.data_path, test_sp)
    d = cfg.data
    model = LipNet(cfg.model, img_hw=(d.img_height, d.img_width))
    model.load_state_dict(_load_state_dict(args.checkpoint))
    model.to(device)
    _evaluate(model, cfg, LipNetBatcher(src, cfg, device=device), src,
              args.output or "test_results.json", device)
    return 0


def cmd_infer(args) -> int:
    from avsync_torch.predictor import LipReader
    from avsync_torch.text import parse_align_text

    reader = LipReader(checkpoint=args.checkpoint, config=_config(args.config),
                       device=args.device)
    pred = reader.predict(args.video)
    print(f"Predicted: {pred}")
    base = os.path.splitext(args.video)[0]
    for ext in (".align", ".txt"):
        if os.path.exists(base + ext):
            with open(base + ext) as f:
                print(f"Ground truth: {parse_align_text(f.read())}")
            break
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m avsync_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--data_path", type=str, default="./data")
        sp.add_argument("--speakers", nargs="*", default=None)
        sp.add_argument("--seed", type=int, default=None)
        sp.add_argument("--config", type=str, default=None,
                        help="AvsyncConfig JSON file (geometry, model, kernel flags)")
        sp.add_argument("--batch_size", type=int, default=None)
        sp.add_argument("--device", default=None,
                        help="torch device; default: the GPU (fails without one)")

    t = sub.add_parser("train", help="LipNet CTC training")
    common(t)
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--checkpoint_dir", type=str, default=None)
    t.add_argument("--quick_test", action="store_true")
    t.add_argument("--export_pth", type=str, default=None,
                   help="also write a reference-format .pth")
    t.add_argument("--show_examples", action="store_true",
                   help="decode a few samples each epoch (ProduceExample)")
    t.add_argument("--lr_schedule", choices=["none", "keras"], default="none",
                   help="'keras' = flat->halving->exp decay (train.py:611-618)")
    t.add_argument("--early_stopping", type=int, default=None,
                   help="patience in epochs; restores best weights")
    t.add_argument("--resume", type=str, default=None,
                   help="checkpoint dir to resume from (model, optimizer, step), or "
                        "'auto' to pick up from --checkpoint_dir when it has snapshots "
                        "(--epochs then counts as a TOTAL budget across relaunches)")
    t.set_defaults(func=cmd_train)

    te = sub.add_parser("test", help="evaluate CER/WER on the test split")
    common(te)
    te.add_argument("--checkpoint", type=str, required=True,
                    help=".pth file or a port checkpoint directory")
    te.add_argument("--output", type=str, default=None)
    te.add_argument("--beam", type=int, default=0,
                    help="CTC beam width (0 = greedy; beam search is not ported)")
    te.set_defaults(func=cmd_test)

    inf = sub.add_parser("infer", help="transcribe one .npy clip")
    inf.add_argument("video", help="(T, H, W) .npy clip, native size or 50x100 crops")
    inf.add_argument("--checkpoint", required=True, help="reference LipNet .pth")
    inf.add_argument("--config", default=None, help="AvsyncConfig JSON file")
    inf.add_argument("--device", default=None,
                     help="torch device; default: the GPU (fails without one)")
    inf.set_defaults(func=cmd_infer)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
