"""Command line of the port (port of `avsync/cli.py`: train, test, infer,
quantize, export, serve, misalign-train, misalign-eval, misalign-demo).

    python -m avsync_torch.cli train --data_path data --epochs 50 --export_pth lipnet.pth
    python -m avsync_torch.cli test --data_path data --checkpoint lipnet.pth [--beam 4]
        [--quantize int8]
    python -m avsync_torch.cli infer clip.mpg --checkpoint lipnet.pth [--roi_mode variance]
        [--beam 4] [--quantize int8]
    python -m avsync_torch.cli quantize --data_path data --checkpoint lipnet.pth --out qscales.npz
    python -m avsync_torch.cli export --checkpoint lipnet.pth --batch_sizes 1,2,4,8
    python -m avsync_torch.cli serve --checkpoint lipnet.pth --detector_checkpoint det.pth
    python -m avsync_torch.cli serve --checkpoint lipnet.pth --quantize int8 --qscales qscales.npz
    python -m avsync_torch.cli serve --artifact lipnet_serving.zip
    python -m avsync_torch.cli misalign-train --data_path data --checkpoint lipnet.pth
    python -m avsync_torch.cli misalign-eval --data_path data --checkpoint lipnet.pth
    python -m avsync_torch.cli misalign-demo --data_path data --checkpoint lipnet.pth
        --detector_checkpoint det.pth --output_dir demo_output --seed 0

`--model_family tf` runs the TF-family LipNet (Conv3D 128/256/64 + 3xBiLSTM,
blank-last CTC over its own vocabulary, 46x140 standardized crops) through
train, test, infer, quantize, export and serve; it reads its weights from
the port's checkpoint directories (a reference `.pth` holds the PyTorch
family). Every command runs on the card unless `--device cpu` is given.
`train`, `test` and `quantize` build the JAX package's default LipNet (or
the `--config` JSON's) with both LipNet kernel flags on, the `misalign-*` commands with conv1's
and the MFCC stage's (`fused_conv_pool`, `AudioConfig.use_pallas`), `serve`
and `export` with all three, unless the config file turns them off; all run
with TF32 off for cuDNN and cuBLAS, as the JAX reference computes in fp32.
Without `--config` the compute dtype follows the JAX CLI's backend-tuned
defaults: bfloat16 and `packed_conv` on the card (int8 serving then ends its
blocks in the bf16 epilogue), float32 with `--device cpu`; an explicit
`--compute_dtype` or `--packed_conv` wins, and a config file's values are
kept. The TF family computes in float32 whatever the dtype, as the JAX
CLI's TF commands do (`models.make_lipnet`). The resolved config is the JAX
CLI's field for field but for the kernel flags (`_config_from_args`): in
particular `--seed` (default 42), and on `train` `--checkpoint_dir`
(default ./checkpoints) and `--quick_test`, win over a `--config` file's.

Multi-device (`avsync_torch/parallel/`, one process per device):
`train`, `test` and `misalign-train` on a host with n > 1 cards start their
ranks themselves (`train` and `test`: a ('data', 'model') mesh whose data
axis is the gcd of the batch and the cards a model group leaves;
`misalign-train`: every card), as the JAX package's single controller
drives all its devices; with one card they start none. `--device cpu` with a `--config` whose `mesh_shape` has more
than one device starts that many gloo ranks on the CPU. `train
--distributed` joins a group that torchrun (or any launcher setting RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) started, one process
per card on each host. `serve --dp N` serves a replica per card (0: every
card).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time
from typing import List, Optional, Sequence

from avsync_torch.config import (AudioConfig, AvsyncConfig, DataConfig, DetectorConfig,
                                 ModelConfig, TrainConfig)


def _config(path: Optional[str]) -> AvsyncConfig:
    if path is None:
        return AvsyncConfig()
    with open(path) as f:
        return AvsyncConfig.from_json(f.read())


def _runs_on_card(args) -> bool:
    """Whether the command's device resolves to a card: `--device` when
    given, else whether there is a GPU (`predictor.resolve_device` takes it,
    and without one the command fails; the JAX CLI asks its default
    backend)."""
    import torch

    dev = getattr(args, "device", None)
    return torch.device(dev).type == "cuda" if dev else torch.cuda.is_available()


def _tuned_perf_defaults(args):
    """(compute_dtype, packed_conv, remat) with the JAX CLI's backend-tuned
    defaults (`avsync/cli.py:112-130`): bf16 and packed_conv when the
    command runs on a card, float32 and no packed_conv on the CPU, remat
    off. Explicit flags always win."""
    dtype = getattr(args, "compute_dtype", None)
    packed = getattr(args, "packed_conv", None)
    remat = getattr(args, "remat", None)
    if dtype is None or packed is None:
        accel = _runs_on_card(args)
        if dtype is None:
            dtype = "bfloat16" if accel else "float32"
        if packed is None:
            packed = accel
    return dtype, bool(packed), bool(remat) if remat is not None else False


# The kernel flags a command turns on when no --config is given (a config
# file's own flags are kept): `use_pallas_gru` (K2/K3), `fused_conv_pool`
# (K1/K4) and `audio.use_pallas` (K5). They name implementations, so they
# are the only fields where the port's config differs from the JAX CLI's.
LIPNET_KERNELS = ("use_pallas_gru", "fused_conv_pool")
SERVING_KERNELS = ("use_pallas_gru", "fused_conv_pool", "use_pallas")
DETECTOR_KERNELS = ("fused_conv_pool", "use_pallas")


def _config_from_args(args, kernels: Sequence[str] = LIPNET_KERNELS) -> AvsyncConfig:
    """The JAX CLI's config of a command line, field for field
    (`avsync/cli.py:134-257`), then, without --config, the port's `kernels`.

    With --config the file is the base and the command line's scalars go
    over it; the perf flags only when given (a file's compute_dtype and
    packed_conv are deliberate choices). `--seed` (default 42) and, on
    `train`, `--checkpoint_dir` (default ./checkpoints) and `--quick_test`
    always win over the file, as the JAX CLI's defaults do; `--log_dir`
    wins when given (misalign-train's defaults to 'logs'). Without --config
    every field is the JAX CLI's default, the perf flags from
    `_tuned_perf_defaults`. `--model_family tf` over a config of the other
    family (or without one) also takes the TF stack's conv widths (128, 256,
    64) and its 46x140 standardized crops (`train.py:88-89,266-273,505-521`)."""
    def arg(name, fallback):
        v = getattr(args, name, None)
        return fallback if v is None else v

    family = getattr(args, "model_family", None)
    tf_family = family == "tf"
    if getattr(args, "config", None):
        base = _config(args.config)
        model_kw = {"family": arg("model_family", base.model.family),
                    "compute_dtype": arg("compute_dtype", base.model.compute_dtype),
                    "packed_conv": arg("packed_conv", base.model.packed_conv)}
        data_kw = {"data_path": getattr(args, "data_path", base.data.data_path),
                   "batch_size": arg("batch_size", base.data.batch_size),
                   "roi_mode": arg("roi_mode", base.data.roi_mode),
                   "roi_host": arg("roi_host", base.data.roi_host),
                   "device_cache": arg("device_cache", base.data.device_cache)}
        if tf_family and base.model.family != "tf":
            model_kw["conv_channels"] = (128, 256, 64)
            data_kw.update(img_width=140, img_height=46, standardize_clips=True)
        det, tr = base.detector, base.train
        return dataclasses.replace(
            base,
            model=dataclasses.replace(base.model, **model_kw),
            data=dataclasses.replace(base.data, **data_kw),
            detector=dataclasses.replace(
                det, hidden_dim=arg("hidden_dim", det.hidden_dim),
                max_shift_frames=arg("max_shift_frames", det.max_shift_frames),
                num_negative_samples=arg("num_negatives", det.num_negative_samples),
                batch_size=arg("batch_size", det.batch_size), epochs=arg("epochs", det.epochs),
                lr=arg("lr", det.lr), weight_decay=arg("weight_decay", det.weight_decay)),
            train=dataclasses.replace(
                tr, remat=arg("remat", tr.remat), epochs=arg("epochs", tr.epochs),
                learning_rate=arg("lr", tr.learning_rate),
                seed=getattr(args, "seed", tr.seed),
                checkpoint_dir=getattr(args, "checkpoint_dir", tr.checkpoint_dir),
                quick_test=getattr(args, "quick_test", tr.quick_test),
                tensorboard=arg("tensorboard", tr.tensorboard), log_dir=arg("log_dir", tr.log_dir),
                checkpoint_every=arg("checkpoint_every", tr.checkpoint_every)))
    compute_dtype, packed_conv, remat = _tuned_perf_defaults(args)
    return AvsyncConfig(
        data=DataConfig(
            data_path=getattr(args, "data_path", "./data"), batch_size=arg("batch_size", 8),
            img_width=140 if tf_family else 100, img_height=46 if tf_family else 50,
            standardize_clips=tf_family, roi_mode=arg("roi_mode", "heuristic"),
            roi_host=bool(arg("roi_host", False)), device_cache=arg("device_cache", "auto")),
        model=ModelConfig(
            family=family or "pytorch", compute_dtype=compute_dtype, packed_conv=packed_conv,
            use_pallas_gru="use_pallas_gru" in kernels,
            fused_conv_pool="fused_conv_pool" in kernels),
        audio=AudioConfig(sample_rate=arg("sample_rate", 16000), n_mfcc=arg("n_mfcc", 20),
                          use_pallas="use_pallas" in kernels),
        detector=DetectorConfig(
            hidden_dim=arg("hidden_dim", 256), max_shift_frames=arg("max_shift_frames", 15),
            num_negative_samples=arg("num_negatives", 1), lr=arg("lr", 1e-3),
            weight_decay=arg("weight_decay", 1e-5), batch_size=arg("batch_size", 32),
            epochs=arg("epochs", 20)),
        train=TrainConfig(
            learning_rate=arg("lr", 1e-4), remat=remat, epochs=arg("epochs", 50),
            seed=getattr(args, "seed", 42),
            checkpoint_dir=getattr(args, "checkpoint_dir", "./checkpoints"),
            log_dir=arg("log_dir", "logs"), quick_test=getattr(args, "quick_test", False),
            tensorboard=arg("tensorboard", False), checkpoint_every=arg("checkpoint_every", 10)))


def _serving_config(args) -> AvsyncConfig:
    """`export` and `serve`: the command line's config with the three kernel
    flags of the serving paths."""
    return _config_from_args(args, SERVING_KERNELS)


def _detector_config_from_args(args) -> AvsyncConfig:
    """The `misalign-*` commands: the command line's config with conv1's and
    the MFCC stage's kernel flags."""
    return _config_from_args(args, DETECTOR_KERNELS)


# `--distributed` on another command than train: the JAX package's refusal
DISTRIBUTED_TRAIN_ONLY = (
    "ERROR: --distributed supports the 'train' subcommand only — the misalignment pipeline, "
    "eval and serving are single-controller by design (see avsync_torch/parallel/multihost.py)")


def _no_tf32() -> None:
    """TF32 off for cuDNN and cuBLAS, and cuBLAS's bf16 products reduced in
    float32, for the whole process (as `ops/conv.fp32_step` for a scope)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False


def _evaluate(model, cfg: AvsyncConfig, batcher, source, out_json: str, device,
              num_print: int = 5, beam_width: int = 0,
              quantize: Optional[str] = None, mesh=None) -> Optional[dict]:
    """Decode the split (greedy, or beam search for beam_width > 1), print a
    few samples, write CER/WER/accuracy JSON (`utils.py:38-86`,
    `train.py:916-942`).

    `quantize='int8'` runs the conv stack in int8 (`ops/quant.py`),
    calibrated on the first eval batch: the preprocessed distribution the
    whole split sees.

    Under a `mesh` of ranks the batcher gives this rank its rows of each
    batch; the log-probs are gathered over the data group in the batch's
    order, and rank 0 decodes them and writes the JSON (the others return
    None). int8 calibrates on the whole first batch, gathered, so every
    rank has the single process's scales."""
    import torch

    from avsync_torch import text as textlib
    from avsync_torch.eval import evaluate_transcripts
    from avsync_torch.ops.quant import make_int8_forward, quantize_lipnet
    from avsync_torch.parallel import multihost
    from avsync_torch.train.lipnet_trainer import device_batch, eval_step

    decode = textlib.family_decoder(cfg.model.family)
    model.eval()
    qfwd = make_int8_forward(cfg.model) if quantize == "int8" else None
    qparams = None
    preds: List[str] = []
    targets: List[str] = []
    done = 0  # samples of the split in the batches so far

    def whole(t):  # the batch's rows from every data rank, in order
        return t if mesh is None else multihost.all_gather(t.contiguous(), 0, mesh.data_group)

    for batch in batcher.epoch(shuffle=False, drop_last=False):
        dbatch = device_batch(batch, device)
        if qfwd is not None:
            with torch.inference_mode():
                if qparams is None:
                    qparams = quantize_lipnet(model, [whole(dbatch["video"])])
                log_probs = qfwd(qparams, dbatch["video"])
        else:
            _, log_probs = eval_step(model, dbatch)
        log_probs = whole(log_probs)
        valid = min(log_probs.shape[0], len(source.samples) - done)
        done += valid
        if not multihost.is_main():
            continue  # rank 0 decodes
        for d in decode(log_probs[:valid], beam_width=beam_width):
            idx = len(preds)
            preds.append(d)
            targets.append(source.samples[idx].text)
            if idx < num_print:
                print(f"\nSample {idx + 1}:")
                print(f"True text: {targets[-1]}")
                print(f"Predicted text: {d}")
    if not multihost.is_main():
        return None
    results = evaluate_transcripts(preds, targets)
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nTest results: {results} -> {out_json}")
    return results


def _ranks_to_start(args, cfg: AvsyncConfig, whole_host: bool) -> int:
    """How many ranks a command starts itself: on the card, one per card
    of the fitted mesh (`whole_host`: every card) where the host has more
    than one; on the CPU (`--device cpu`), the config's `mesh_shape` when it
    names more than one device; else 1 (run here)."""
    import math

    import torch

    from avsync_torch.parallel.mesh import fit_mesh_shape

    if getattr(args, "distributed", False):
        return 1
    dev = torch.device(args.device) if args.device else None
    if dev is not None and dev.type == "cpu":
        shape = tuple(cfg.train.mesh_shape)
        return math.prod(shape) if all(n > 0 for n in shape) else 1
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n <= 1:
        return 1
    if whole_host:
        return n
    d, m = fit_mesh_shape(cfg.data.batch_size, cfg.train.mesh_shape, n)
    return d * m


def _rank_main(rank: int, args) -> None:
    """A started rank: the command's body over the process group; only
    rank 0 writes to the console."""
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    code = args.func(args)
    if code:
        raise SystemExit(code)


def _start_ranks(args, world: int) -> int:
    from avsync_torch.parallel import multihost

    kind = "cpu" if args.device and args.device.startswith("cpu") else "cuda"
    print(f"starting {world} ranks ({kind}{', gloo' if kind == 'cpu' else ''})", flush=True)
    multihost.spawn(_rank_main, world, (args,), device=kind)
    return 0


def cmd_train(args) -> int:
    from avsync_torch.parallel import multihost

    cfg = _config_from_args(args)
    if not multihost.is_multiprocess():
        world = _ranks_to_start(args, cfg, whole_host=False)
        if world > 1:
            return _start_ranks(args, world)
    return _train(args, cfg)


def _train(args, cfg: AvsyncConfig) -> int:
    from avsync_torch.compat import save_lipnet_pth
    from avsync_torch.data.grid import GridDataSource, check_data_structure, split_speakers
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.parallel import multihost
    from avsync_torch.predictor import load_lipnet
    from avsync_torch.train.lipnet_trainer import LipNetTrainer, keras_lr_schedule
    from avsync_torch.utils.checkpoint import CheckpointManager

    _no_tf32()
    if args.export_pth and cfg.model.family == "tf":
        raise ValueError("--export_pth writes the reference PyTorch-family .pth; a 'tf' model "
                         "is read from its checkpoint directory (--checkpoint_dir)")
    device = args.device
    if multihost.rank_device() is not None:
        device = multihost.rank_device()  # the rank's own card
    trainer = LipNetTrainer(cfg, device=device)  # refuses what the port does not run
    if trainer.mesh is not None:
        print(f"mesh {trainer.mesh.shape} over {trainer.mesh.size} ranks "
              f"({multihost.backend()})", flush=True)
    speakers = args.speakers or check_data_structure(cfg.data.data_path)
    if not speakers:
        print(f"ERROR: no usable speakers under {cfg.data.data_path}")
        return 1
    train_sp, val_sp, test_sp = split_speakers(speakers, cfg.data.split)
    print(f"Speakers: train={train_sp} val={val_sp} test={test_sp}")
    sources = {name: GridDataSource(cfg.data.data_path, sp)
               for name, sp in (("train", train_sp), ("val", val_sp), ("test", test_sp))}
    batchers = {name: LipNetBatcher(src, cfg, device=trainer.device, mesh=trainer.mesh)
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
        decode = textlib.family_decoder(cfg.model.family)

        def example_fn(state, epoch):
            # per-epoch qualitative decode (ProduceExample, `train.py:552-608`)
            for name, b in ex_batches.items():
                _, lp = eval_step(state.model, device_batch(b, trainer.device))
                print(f"[{name} examples, epoch {epoch}]")
                for i, p in enumerate(decode(lp[:2])):
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
        trainer.load_state(state, payload)
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
        # one seed per epoch for both paths, so the order is the same whether
        # the epoch runs as a program over the device cache or streams
        seed = cfg.train.seed + next(epoch_seq)
        plan = batchers["train"].scan_plan(shuffle=True, seed=seed)
        if plan is not None:
            return plan
        return batchers["train"].epoch(shuffle=True, seed=seed)

    state = trainer.train(
        train_source, lambda: batchers["val"].epoch(shuffle=False), state=state,
        checkpoint_dir=cfg.train.checkpoint_dir,
        lr_schedule=keras_lr_schedule if args.lr_schedule == "keras" else None,
        early_stopping_patience=args.early_stopping, example_fn=example_fn,
        history_path=os.path.join(cfg.train.checkpoint_dir, "history.json"),
        start_epoch=start_epoch, profile_dir=args.profile_dir)
    trainer.plot_losses(os.path.join(cfg.train.checkpoint_dir, "training_history.png"))
    model, test_batcher = state.model, batchers["test"]
    if trainer.mesh is not None:
        # rank 0 exports and tests the whole model on its own card
        whole, _ = trainer.full_state(state)
        if not multihost.is_main():
            return 0
        model = load_lipnet(cfg, whole, trainer.device)
        test_batcher = LipNetBatcher(sources["test"], cfg, device=trainer.device)
    if args.export_pth:
        save_lipnet_pth(model.state_dict(), args.export_pth)
        print(f"Exported reference-format checkpoint to {args.export_pth}")
    _evaluate(model, cfg, test_batcher, sources["test"],
              os.path.join(cfg.train.checkpoint_dir, "test_results.json"), trainer.device)
    return 0


def cmd_test(args) -> int:
    """CER/WER of the test split. On a host with several cards (or on the
    CPU with a `mesh_shape` of several devices) it starts its ranks as
    `train` does, each taking its rows of every batch of the config's mesh
    (the model whole on every rank); rank 0 decodes and writes the JSON."""
    from avsync_torch.data.grid import GridDataSource, check_data_structure, split_speakers
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.parallel import multihost
    from avsync_torch.parallel.mesh import mesh_from_shape
    from avsync_torch.predictor import load_lipnet, lipnet_state, resolve_device

    cfg = _config_from_args(args)
    if not multihost.is_multiprocess():
        world = _ranks_to_start(args, cfg, whole_host=False)
        if world > 1:
            return _start_ranks(args, world)
    _no_tf32()
    mesh = None
    device = args.device
    if multihost.is_multiprocess():
        mesh = mesh_from_shape(cfg.train.mesh_shape)
        device = multihost.rank_device()  # the rank's own card
    device = resolve_device(device)
    speakers = args.speakers or check_data_structure(cfg.data.data_path)
    _, _, test_sp = split_speakers(speakers, cfg.data.split)
    src = GridDataSource(cfg.data.data_path, test_sp)
    model = load_lipnet(cfg, lipnet_state(cfg, args.checkpoint), device)
    if mesh is not None:
        print(f"test over {mesh.size} ranks, mesh {mesh.shape} ({multihost.backend()})",
              flush=True)
    _evaluate(model, cfg, LipNetBatcher(src, cfg, device=device, mesh=mesh), src,
              args.output or "test_results.json", device, beam_width=args.beam,
              quantize=args.quantize, mesh=mesh)
    return 0


def cmd_infer(args) -> int:
    from avsync_torch.predictor import LipReader
    from avsync_torch.text import family_decoder, parse_align_text

    # an int8 reader calibrates lazily on its first input: this clip
    reader = LipReader(checkpoint=args.checkpoint,
                       config=_config_from_args(args, kernels=()),
                       device=args.device, quantize=args.quantize)
    log_probs = reader._logprobs(reader._prepare(reader._load(args.video)))
    pred = family_decoder(reader.cfg.model.family)(log_probs, beam_width=args.beam)[0]
    print(f"Predicted: {pred}")
    base = os.path.splitext(args.video)[0]
    for ext in (".align", ".txt"):
        if os.path.exists(base + ext):
            with open(base + ext) as f:
                print(f"Ground truth: {parse_align_text(f.read())}")
            break
    return 0


# ---------------------------------------------------------------------------
# quantize / export / serve
# ---------------------------------------------------------------------------

def cmd_quantize(args) -> int:
    """Export int8 calibration scales for serving: the f32 conv stack runs
    over the first --n_calib clips of --data_path (the preprocessing serving
    runs) and the per-layer input scales go to an `.npz` with the JAX
    package's keys, so either package's `serve --quantize int8 --qscales`
    (or `LipReader(calibration_scales=...)`) quantizes at load time."""
    import numpy as np

    from avsync_torch.data.grid import GridDataSource
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.ops.quant import calibrate_conv_input_scales
    from avsync_torch.predictor import load_lipnet, lipnet_state, resolve_device

    _no_tf32()
    cfg = _config_from_args(args)
    device = resolve_device(args.device)
    d = cfg.data
    model = load_lipnet(cfg, lipnet_state(cfg, args.checkpoint), device)
    src = GridDataSource(d.data_path, args.speakers or None)
    if len(src) == 0:
        print(f"ERROR: no clips under {d.data_path}")
        return 1
    batches, seen = [], 0
    for batch in LipNetBatcher(src, cfg, device=device).epoch(shuffle=False, drop_last=False):
        batches.append(batch["video"][: batch["valid"]])
        seen += int(batch["valid"])
        if seen >= args.n_calib:
            break
    scales = calibrate_conv_input_scales(model, batches)
    np.savez(args.out, input_scales=scales, family=cfg.model.family,
             n_calibration_clips=seen, checkpoint=os.path.abspath(args.checkpoint))
    print(f"calibrated {len(scales)} conv layers on {seen} clips -> {args.out}")
    print(f"input_scales: {scales.tolist()}")
    return 0


def cmd_export(args) -> int:
    """Trace the serving computation (preprocess, forward and greedy decode,
    or the sync-scoring pipeline; weights baked in) into one artifact through
    torch.export (avsync_torch/export.py)."""
    from avsync_torch.export import export_sync_scorer, export_transcriber

    _no_tf32()
    cfg = _serving_config(args)
    geom = None
    if args.frame_geometry:
        h, w = (int(v) for v in args.frame_geometry.lower().split("x"))
        geom = (h, w)
    buckets = None
    if args.batch_sizes:
        # the JAX command's messages, on stdout, and its exit code 2
        try:
            buckets = [int(v) for v in args.batch_sizes.split(",")]
        except ValueError:
            print("--batch_sizes must be a comma-separated list of positive ints, "
                  f"got {args.batch_sizes!r}")
            return 2
        if any(b <= 0 for b in buckets):
            print(f"--batch_sizes entries must be positive, got {args.batch_sizes!r}")
            return 2
    if args.detector_checkpoint:
        art = export_sync_scorer(args.detector_checkpoint, args.checkpoint, cfg,
                                 num_shifts=args.shifts_per_request, frame_geometry=geom,
                                 device=args.device, batch_sizes=buckets)
    else:
        art = export_transcriber(args.checkpoint, cfg, frame_geometry=geom, device=args.device,
                                 batch_sizes=buckets)
    art.save(args.out)
    m = art.meta
    bdesc = "b symbolic" if art.batch_sizes is None else f"static buckets {art.batch_sizes}"
    print(f"exported {args.out}: kind={m['kind']} family={m['family']} frames=(b, "
          f"{m['frame_shape'][0]}, {m['frame_shape'][1]}, {m['frame_shape'][2]}) uint8 "
          f"({bdesc}), roi={m['roi']}, device={m['device']}")
    return 0


def cmd_serve(args) -> int:
    """The serving daemon: a LipReader (and a MisalignmentScorer), or
    exported artifacts, behind dynamic batchers and the HTTP surface
    (avsync_torch/serving.py)."""
    from avsync_torch.serving import (ArtifactSyncScoreService, ArtifactTranscribeService,
                                      AvsyncServer, SyncScoreService, TranscribeService)

    _no_tf32()
    if args.artifact:
        if args.checkpoint or args.detector_checkpoint:
            raise SystemExit("--artifact serves the exported program; do not also pass "
                             "--checkpoint/--detector_checkpoint (bake them in with `export`)")
        if args.quantize or args.qscales or args.dp != 1:
            raise SystemExit("--quantize/--qscales/--dp do not apply to --artifact serving: "
                             "the artifact's computation is fixed at export time")
        from avsync_torch.export import load_exported

        transcriber = scorer = None
        for path in args.artifact:
            art = load_exported(path)
            kind = art.meta.get("kind", "transcriber")
            if kind == "transcriber" and transcriber is None:
                transcriber = ArtifactTranscribeService(art, max_batch=args.max_batch,
                                                        max_wait_ms=args.max_wait_ms)
            elif kind == "sync_scorer" and scorer is None:
                scorer = ArtifactSyncScoreService(art, max_batch=args.max_batch,
                                                  max_wait_ms=args.max_wait_ms)
            elif kind in ("transcriber", "sync_scorer"):
                raise SystemExit(f"two {kind} artifacts given")
            else:
                raise SystemExit(f"unknown artifact kind {kind!r} in {path}")
            print(f"loaded artifact {path}: kind={kind} device={art.meta['device']}", flush=True)
        services = [svc.warmup for svc in (transcriber, scorer) if svc is not None]
        label = "avsync_torch artifact serving"
    else:
        if not args.checkpoint:
            raise SystemExit("need --checkpoint (live) or --artifact (exported)")
        from avsync_torch.predictor import MisalignmentScorer

        cfg = _serving_config(args)
        # without --qscales an int8 reader calibrates on its first real batch
        # (warm-up's dummy frames never calibrate it); the sync scorer stays f32
        transcriber = TranscribeService(
            serving_reader(args, cfg),
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, transport=args.transport)
        scorer = None
        if args.detector_checkpoint:
            scorer = SyncScoreService(
                MisalignmentScorer(args.detector_checkpoint, args.checkpoint, config=cfg,
                                   device=args.device),
                max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
        services = [svc.warmup for svc in (transcriber, scorer) if svc is not None]
        label = "avsync_torch serving"
    if args.warmup:
        t0 = time.time()
        for warm in services:
            warm()
        print(f"warmup: batch buckets 1..{args.max_batch} in {time.time() - t0:.1f}s",
              flush=True)
    server = AvsyncServer(transcriber, scorer, host=args.host, port=args.port,
                          max_body_bytes=args.max_body_mb * 1024 * 1024)
    host, port = server.address[0], server.address[1]
    print(f"{label} on http://{host}:{port} (max_batch={args.max_batch}, "
          f"max_wait_ms={args.max_wait_ms})", flush=True)
    print("endpoints: GET /healthz /v1/stats; POST /v1/transcribe /v1/sync_score", flush=True)
    return _serve_loop(server)


def dp_devices(args) -> List[str]:
    """The devices `serve --dp` may take: every card, or the one CPU."""
    import torch

    from avsync_torch.predictor import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cpu":
        return ["cpu"]
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def serving_reader(args, cfg: AvsyncConfig):
    """The live daemon's LipReader: with `--dp N` (0: every device) a
    replica on each of N devices, the batch's rows split over them."""
    from avsync_torch.predictor import LipReader

    devices = None
    if args.dp != 1:
        avail = dp_devices(args)
        n = len(avail) if args.dp == 0 else args.dp
        if n < 1 or n > len(avail):
            raise SystemExit(f"--dp {args.dp}: this host has {len(avail)} device(s) to serve "
                             "on")
        if n > 1:
            devices = avail[:n]
            print(f"data-parallel serving over {n} devices: {', '.join(devices)}", flush=True)
    return LipReader(checkpoint=args.checkpoint, config=cfg, device=args.device,
                     quantize=args.quantize, calibration_scales=args.qscales, devices=devices)


def _serve_loop(server) -> int:
    import signal

    def _term(signum, frame):  # SIGTERM takes the same graceful path as ^C
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nshutting down", flush=True)
        # a repeated SIGTERM (supervisors resend) must not abort the drain;
        # a second ^C still force-quits
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        server.shutdown()
    return 0


# ---------------------------------------------------------------------------
# misalign-train / misalign-eval
# ---------------------------------------------------------------------------

# Clips per chunk of the eval sweep: one chunk's (clips, frames, bins) power
# spectrogram is the sweep's largest intermediate (254 MB at 512 clips).
_SWEEP_CLIP_CHUNK = 512


def _bank_cache_path(cfg: AvsyncConfig, video_paths, checkpoint, cache_dir):
    """(path, key) of a cached FeatureBank, or (None, key) without a cache
    directory. The key fingerprints what the bank is a function of: the
    ordered clips with their (size, mtime), the frozen LipNet checkpoint's,
    the geometry and the audio settings (as the JAX package's), and the
    port's (C, H, W) order of the visual statistics, so a bank the JAX
    package wrote into the same directory ((H, W, C) order) never loads."""
    import hashlib

    def stat(p):
        try:
            st = os.stat(p)
            return [p, st.st_size, st.st_mtime_ns]
        except OSError:
            return [p, -1, -1]

    d = cfg.data
    key_doc = {
        "videos": [stat(p) for p in video_paths],
        "checkpoint": stat(checkpoint) if checkpoint else None,
        "audio": [cfg.audio.sample_rate, cfg.audio.n_mfcc, cfg.audio.max_audio_samples],
        "fps": cfg.detector.default_fps,
        "geometry": [d.img_height, d.img_width, d.max_video_length, d.roi_mode, d.roi_host,
                     d.standardize_clips],
        "model": [cfg.model.family, tuple(cfg.model.conv_channels), cfg.model.compute_dtype,
                  cfg.model.packed_conv],
        "visual_order": "chw",
    }
    key = hashlib.sha256(json.dumps(key_doc, sort_keys=True).encode()).hexdigest()
    if not cache_dir:
        return None, key
    return os.path.join(cache_dir, f"bank_{key[:16]}.npz"), key


def _build_bank(cfg: AvsyncConfig, src, model, video_paths, device, checkpoint=None,
                cache_dir=None):
    """The FeatureBank of an ordered list of clips of `src`, through the
    `.npz` cache in `cache_dir` when one is given."""
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.data.video import get_video_fps, load_audio_for_video
    from avsync_torch.features import build_feature_bank, load_feature_bank, save_feature_bank
    from avsync_torch.ops.audio import resample_host

    cache_path, key = _bank_cache_path(cfg, video_paths, checkpoint, cache_dir)
    if cache_path is not None:
        bank = load_feature_bank(cache_path, key, device)
        if bank is not None:
            return bank
    clips = LipNetBatcher(src.subset(video_paths), cfg, device=device).epoch(
        shuffle=False, drop_last=False)
    audio_list, fps_list = [], []
    for p in video_paths:
        a, sr = load_audio_for_video(p, cfg.audio.sample_rate)
        if sr != cfg.audio.sample_rate:
            a = resample_host(a, sr, cfg.audio.sample_rate)
        audio_list.append(a)
        fps_list.append(get_video_fps(p, cfg.detector.default_fps))
    bank = build_feature_bank(model, clips, audio_list, fps_list, cfg)
    if cache_path is not None:
        save_feature_bank(cache_path, bank, key)
    return bank


def _plot_roc(labels, probs, out_path: str) -> bool:
    """ROC artifact (`misalignment_detection_train.py:283-296`); matplotlib
    is optional: without it (or with one class only) nothing is drawn."""
    import numpy as np

    from avsync_torch.eval import auroc, roc_curve

    labels = np.asarray(labels)
    if labels.size == 0 or len(np.unique(labels)) < 2:
        return False
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fpr, tpr, _ = roc_curve(labels, probs)
    plt.figure(figsize=(6, 6))
    plt.plot(fpr, tpr, label=f"ROC AUC = {auroc(labels, probs):.3f}")
    plt.plot([0, 1], [0, 1], "k--")
    plt.xlabel("False Positive Rate")
    plt.ylabel("True Positive Rate")
    plt.legend(loc="lower right")
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()
    return True


def cmd_misalign_train(args) -> int:
    """Detector training; on an n-card host (or `--device cpu` with a
    config mesh of n devices) over n data-parallel ranks it starts itself,
    each building the whole feature bank and training on its rows."""
    from avsync_torch.parallel import multihost

    cfg = _detector_config_from_args(args)
    if not multihost.is_multiprocess():
        world = _ranks_to_start(args, cfg, whole_host=True)
        if world > 1:
            return _start_ranks(args, world)
    return _misalign_train(args)


def _misalign_train(args) -> int:
    import random
    import time
    from datetime import datetime

    import numpy as np

    from avsync_torch.compat import save_detector_pth
    from avsync_torch.data.grid import GridDataSource, discover_speakers, split_videos
    from avsync_torch.parallel import multihost
    from avsync_torch.parallel.mesh import make_mesh
    from avsync_torch.predictor import (load_lipnet, lipnet_state, refuse_tf_detector,
                                        resolve_device)
    from avsync_torch.train.detector_trainer import DetectorTrainer
    from avsync_torch.utils.logging import Logger, format_time

    _no_tf32()
    refuse_tf_detector(_detector_config_from_args(args))
    device = resolve_device(multihost.rank_device() or args.device)
    # one folder for every rank: rank 0's clock names it
    log_folder = multihost.broadcast_object(os.path.join(
        args.log_dir, f"misalignment_{datetime.now().strftime('%Y%m%d_%H%M%S')}"))
    os.makedirs(log_folder, exist_ok=True)
    logger = Logger(os.path.join(log_folder, "training.log"), console=args.verbose)
    t0 = time.time()
    logger.log("=" * 60)
    logger.log("Misalignment Detection Training")
    logger.log("=" * 60)
    logger.log(f"Log folder: {log_folder}")
    logger.log(f"Arguments: {vars(args)}")

    cfg = _detector_config_from_args(args)
    random.seed(cfg.train.seed)
    np.random.seed(cfg.train.seed)
    speakers = args.speakers or discover_speakers(cfg.data.data_path)
    src = GridDataSource(cfg.data.data_path, speakers)
    video_paths = [s.video_path for s in src.samples]
    if args.max_samples:
        random.shuffle(video_paths)
        video_paths = video_paths[:args.max_samples]
    logger.log(f"Using {len(video_paths)} videos from {len(speakers)} speakers")
    print(f"Using {len(video_paths)} videos")

    lipnet = load_lipnet(cfg, lipnet_state(cfg, args.checkpoint), device)
    train_p, val_p, test_p = split_videos(video_paths, seed=cfg.train.seed)
    logger.log(f"Train: {len(train_p)}, Val: {len(val_p)}, Test: {len(test_p)}")
    banks = {name: _build_bank(cfg, src, lipnet, paths, device, checkpoint=args.checkpoint,
                               cache_dir=args.bank_cache)
             for name, paths in (("train", train_p), ("val", val_p), ("test", test_p))}
    logger.log("Feature banks built (on the device)")

    input_dim = banks["train"].visual.shape[1] + 2 * cfg.audio.n_mfcc
    det_cfg = {"sample_rate": cfg.audio.sample_rate, "n_mfcc": cfg.audio.n_mfcc,
               "max_shift_frames": cfg.detector.max_shift_frames}

    def save(state, path):
        if multihost.is_main():  # the replicas are equal: rank 0 writes
            save_detector_pth(state.model.state_dict(), path, input_dim,
                              cfg.detector.hidden_dim, det_cfg)

    mesh = make_mesh((-1, 1)) if multihost.is_multiprocess() else None
    trainer = DetectorTrainer(cfg, device=device, log=logger, mesh=mesh)
    state, summary = trainer.train(
        banks["train"], len(train_p), banks["val"], len(val_p), save_every=args.save_every,
        save_fn=lambda st, epoch: save(st, os.path.join(log_folder,
                                                        f"checkpoint_epoch_{epoch}.pth")))

    logger.log("")
    logger.log("Evaluating on test set...")
    _, test_m = trainer.run_epoch(state, banks["test"], len(test_p), seed=cfg.train.seed + 999,
                                  train=False)
    logger.log(f"Test -> loss: {test_m['loss']:.4f}, acc: {test_m['acc']:.3f}, "
               f"auc: {test_m['auc']:.3f}")
    for path in (os.path.join(log_folder, os.path.basename(args.detector_checkpoint)),
                 args.detector_checkpoint):
        save(state, path)
    roc_path = os.path.join(log_folder, "roc.png")
    if multihost.is_main() and _plot_roc(test_m["labels"], test_m["probs"], roc_path):
        logger.log(f"ROC saved to {roc_path}")
    else:
        logger.log("no ROC plot (matplotlib missing or one class only)")
    logger.log("")
    logger.log("=" * 60)
    logger.log("Training completed!")
    logger.log(f"Total time: {format_time(time.time() - t0)}")
    logger.log(f"Best val AUC: {summary['best_val_auc']:.3f}")
    logger.log(f"Test AUC: {test_m['auc']:.3f}")
    logger.log(f"Model saved to: {args.detector_checkpoint}")
    logger.log(f"Logs saved to: {log_folder}")
    logger.log("=" * 60)
    logger.close()
    print(f"Done. Best val AUC {summary['best_val_auc']:.3f}, test AUC {test_m['auc']:.3f}. "
          f"Logs: {log_folder}")
    return 0


def cmd_misalign_eval(args) -> int:
    """Score every clip aligned and shifted by +-s frames for each magnitude
    s in [min_shift, max_shift], and report the AUROC per magnitude and
    overall (the sliding-shift evaluation of BASELINE.json)."""
    import numpy as np
    import torch

    from avsync_torch.compat import load_detector_pth
    from avsync_torch.data.grid import GridDataSource, discover_speakers
    from avsync_torch.eval import auroc
    from avsync_torch.features import gather_features
    from avsync_torch.models.detector import MisalignmentDetector
    from avsync_torch.ops.conv import fp32_step
    from avsync_torch.predictor import (load_lipnet, lipnet_state, refuse_tf_detector,
                                        resolve_device)

    _no_tf32()
    cfg = _detector_config_from_args(args)
    refuse_tf_detector(cfg)
    device = resolve_device(args.device)
    det_state, meta = load_detector_pth(args.detector_checkpoint)
    detector = MisalignmentDetector(det_state["classifier.0.weight"].shape[1],
                                    int(meta.get("hidden_dim", cfg.detector.hidden_dim)),
                                    generator=torch.Generator())
    detector.load_state_dict(det_state)
    detector.to(device).eval()
    lipnet = load_lipnet(cfg, lipnet_state(cfg, args.checkpoint), device)

    speakers = args.speakers or discover_speakers(cfg.data.data_path)
    src = GridDataSource(cfg.data.data_path, speakers)
    paths = [s.video_path for s in src.samples]
    if args.max_samples:
        paths = paths[:args.max_samples]
    bank = _build_bank(cfg, src, lipnet, paths, device, checkpoint=args.checkpoint,
                       cache_dir=args.bank_cache)
    n = len(paths)

    rng = np.random.default_rng(cfg.train.seed)
    mags = list(range(args.min_shift, args.max_shift + 1))
    rows = [np.zeros(n, np.int32)]  # the aligned row first, then one sign draw per magnitude
    for s in mags:
        rows.append(rng.choice([-1, 1], size=n).astype(np.int32) * s)
    shift_rows = torch.from_numpy(np.stack(rows)).to(device)
    idx = torch.arange(n, device=device)
    parts = []
    with fp32_step(), torch.inference_mode():
        for c0 in range(0, n, _SWEEP_CLIP_CHUNK):
            sub = idx[c0:c0 + _SWEEP_CLIP_CHUNK]
            parts.append(torch.stack([
                torch.sigmoid(detector(gather_features(bank, sub, row[c0:c0 + len(sub)],
                                                       cfg.audio)))
                for row in shift_rows]))
    scored = torch.cat(parts, dim=1).cpu().numpy()
    aligned = scored[0]
    results = {str(s): auroc(np.r_[np.ones(n), np.zeros(n)], np.r_[aligned, shifted])
               for s, shifted in zip(mags, scored[1:])}
    overall = auroc(np.r_[np.ones(n), np.zeros(n * len(mags))], scored.reshape(-1))
    out = {"auroc_by_shift": results, "overall_auroc": overall, "num_clips": n}
    print(json.dumps(out, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
    return 0


# ---------------------------------------------------------------------------
# misalign-demo
# ---------------------------------------------------------------------------

def cmd_misalign_demo(args) -> int:
    """For each speaker: one clip and one shift drawn from `--seed` (the JAX
    command's draws, in its order), the detector's score of the clip aligned
    and shifted, and the two annotated copies written under
    `<output_dir>/<speaker>/` (`demo.export_demo`). A speaker that fails is
    reported and skipped (`misalignment_detection_demo.py:355-358`)."""
    import random

    import torch

    from avsync_torch.compat import load_detector_pth
    from avsync_torch.data.grid import GridDataSource, discover_speakers
    from avsync_torch.data.video import decode_video_gray, get_video_fps, load_audio_for_video
    from avsync_torch.demo import export_demo
    from avsync_torch.features import gather_features
    from avsync_torch.models.detector import MisalignmentDetector
    from avsync_torch.ops.audio import resample_host
    from avsync_torch.ops.conv import fp32_step
    from avsync_torch.predictor import (load_lipnet, lipnet_state, refuse_tf_detector,
                                        resolve_device)

    _no_tf32()
    cfg = _detector_config_from_args(args)
    refuse_tf_detector(cfg)
    device = resolve_device(args.device)
    det_state, meta = load_detector_pth(args.detector_checkpoint)
    detector = MisalignmentDetector(det_state["classifier.0.weight"].shape[1],
                                    int(meta.get("hidden_dim", cfg.detector.hidden_dim)),
                                    generator=torch.Generator())
    detector.load_state_dict(det_state)
    detector.to(device).eval()
    # configured by the checkpoint (`misalignment_detection_demo.py:311-315`):
    # as the JAX command, a fresh AudioConfig of its rate and MFCC count (the
    # other fields at their defaults), here with the command's kernel flag
    saved = meta.get("config", {})
    cfg = dataclasses.replace(cfg, audio=AudioConfig(
        sample_rate=int(saved.get("sample_rate", cfg.audio.sample_rate)),
        n_mfcc=int(saved.get("n_mfcc", cfg.audio.n_mfcc)), use_pallas=cfg.audio.use_pallas))
    lipnet = load_lipnet(cfg, lipnet_state(cfg, args.checkpoint), device)

    speakers = args.speakers or discover_speakers(cfg.data.data_path)
    src = GridDataSource(cfg.data.data_path, speakers)
    rng = random.Random(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    for speaker in speakers:
        # every GRID layout roots a speaker's files under <data_path>/<speaker>/
        prefix = os.path.join(cfg.data.data_path, speaker) + os.sep
        vids = [s.video_path for s in src.samples if s.video_path.startswith(prefix)]
        if not vids:
            continue
        try:
            video_path = rng.choice(vids)
            shift = rng.randint(args.min_shift, args.max_shift)
            if rng.random() < 0.5:
                shift = -shift
            bank = _build_bank(cfg, src, lipnet, [video_path], device)
            with fp32_step(), torch.inference_mode():
                feats = gather_features(bank, torch.zeros(2, dtype=torch.long, device=device),
                                        torch.tensor([0, shift], device=device), cfg.audio)
                s_aligned, s_mis = (float(x) for x in torch.sigmoid(detector(feats)).cpu())
            frames = decode_video_gray(video_path)
            a, sr = load_audio_for_video(video_path, cfg.audio.sample_rate)
            if sr != cfg.audio.sample_rate:
                a = resample_host(a, sr, cfg.audio.sample_rate)
            p1, p2 = export_demo(frames, a, cfg.audio.sample_rate, get_video_fps(video_path),
                                 shift, s_aligned, s_mis,
                                 os.path.join(args.output_dir, speaker), scale=args.scale)
            print(f"{speaker}: {os.path.basename(video_path)} shift={shift:+d} "
                  f"aligned={s_aligned:.3f} misaligned={s_mis:.3f} -> {p1}, {p2}")
        except Exception as e:  # one speaker's failure does not stop the others
            print(f"{speaker}: demo generation failed: {e}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m avsync_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    # The JAX CLI's options on every command (`avsync/cli.py:1249-1514`), and
    # `--device`. `infer` takes --roi_mode, --roi_host and --distributed too
    # (the JAX infer has none of them): its ROI mode for a native clip, and
    # the refusal of --distributed that every command but train gives.
    def common(sp, speakers=True):
        sp.add_argument("--data_path", type=str, default="./data")
        if speakers:
            sp.add_argument("--speakers", nargs="*", default=None)
        sp.add_argument("--seed", type=int, default=42,
                        help="default 42; wins over a --config file's train.seed")
        sp.add_argument("--config", type=str, default=None,
                        help="AvsyncConfig JSON file (geometry, model, kernel flags)")
        sp.add_argument("--device", default=None,
                        help="torch device; default: the GPU (fails without one)")
        sp.add_argument("--model_family", choices=["pytorch", "tf"], default=None,
                        help="model stack: pytorch (Conv3D+BiGRU, blank 0, the default) or "
                             "tf (Conv3D 128/256/64 + 3xBiLSTM, blank last; over a pytorch "
                             "config it also switches to 46x140 standardized crops)")
        sp.add_argument("--roi_mode", choices=["heuristic", "detector", "variance", "model"],
                        default=None,
                        help="mouth ROI of native-size frames: fixed fractions / host cascade "
                             "/ temporal-variance box on the device / learned localizer on the "
                             "device (its box falls back to the heuristic crop when it "
                             "captures below-average motion)")
        sp.add_argument("--roi_host", action=argparse.BooleanOptionalAction, default=None,
                        help="run the ROI crop on the host CPU and ship uint8 crops to the "
                             "device (16x fewer bytes than 288x360 frames); the same program "
                             "as the device path")
        sp.add_argument("--distributed", action="store_true",
                        help="train only: join a process group that torchrun started (RANK, "
                             "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), one process "
                             "per card on every host; run the same command everywhere")
        sp.add_argument("--compute_dtype", choices=["float32", "bfloat16"], default=None,
                        help="compute dtype of the convs (the int8 blocks' epilogue under "
                             "--quantize int8), the recurrent layers' products and the head "
                             "(parameters stay float32). Default without --config: bfloat16 "
                             "on the card, float32 with --device cpu, as the JAX CLI tunes "
                             "it per backend; a --config file's value is kept")
        sp.add_argument("--packed_conv", action=argparse.BooleanOptionalAction, default=None,
                        help="the JAX package's lane-packed conv form; the port computes the "
                             "same convolutions either way. Default without --config: on "
                             "for the card, off for the CPU")
        sp.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                        help="recompute each conv block and BiGRU layer in the backward "
                             "(less activation memory, the same numbers)")

    t = sub.add_parser("train", help="LipNet CTC training")
    common(t)
    t.add_argument("--batch_size", type=int, default=None)
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--checkpoint_dir", type=str, default="./checkpoints",
                   help="default ./checkpoints; wins over a --config file's")
    t.add_argument("--quick_test", action="store_true",
                   help="one batch through the forward, then exit; wins over a --config "
                        "file's")
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
    t.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run's second epoch (its "
                        "first when it has one) into this directory (trace.json)")
    t.add_argument("--log_dir", type=str, default=None,
                   help="log directory (default 'logs', or the --config value)")
    t.add_argument("--checkpoint_every", type=int, default=None,
                   help="epochs between periodic checkpoints (default 10)")
    t.add_argument("--tensorboard", action="store_true", default=None,
                   help="write TensorBoard event files (train/ + validation/ under "
                        "--log_dir)")
    t.add_argument("--device_cache", choices=["auto", "on", "off"], default=None,
                   help="keep the preprocessed corpus in device memory from epoch 2 on "
                        "('auto', the default, when it fits the budget; 'on' from epoch "
                        "1); a fully cached epoch then runs as one CUDA-graph program")
    t.set_defaults(func=cmd_train)

    te = sub.add_parser("test", help="evaluate CER/WER on the test split")
    common(te)
    te.add_argument("--checkpoint", type=str, required=True,
                    help=".pth file or a port checkpoint directory")
    te.add_argument("--batch_size", type=int, default=None)
    te.add_argument("--output", type=str, default=None)
    te.add_argument("--beam", type=int, default=0,
                    help="CTC beam width (0 = greedy, the reference decode)")
    te.add_argument("--quantize", choices=["int8"], default=None,
                    help="run the conv stack in int8 (ops/quant.py, calibrated on the first "
                         "eval batch)")
    te.set_defaults(func=cmd_test)

    inf = sub.add_parser("infer", help="transcribe one clip")
    common(inf, speakers=False)
    inf.add_argument("video", help="a container file (GRID's .mpg, .mp4, .avi) or a (T, H, W) "
                                   ".npy clip, native size or 50x100 crops")
    inf.add_argument("--checkpoint", required=True,
                     help=".pth file or a port checkpoint directory")
    inf.add_argument("--beam", type=int, default=0,
                     help="CTC beam width (0 = greedy, the reference decode)")
    inf.add_argument("--quantize", choices=["int8"], default=None,
                     help="int8 conv stack, calibrated on this clip")
    inf.set_defaults(func=cmd_infer)

    q = sub.add_parser("quantize", help="export int8 calibration scales for serving")
    common(q)
    q.add_argument("--checkpoint", type=str, required=True,
                   help=".pth file or a port checkpoint directory")
    q.add_argument("--out", type=str, default="qscales.npz",
                   help="output .npz (input_scales and their provenance)")
    q.add_argument("--n_calib", type=int, default=16,
                   help="clips to calibrate on (absmax only grows with clips; a few "
                        "representative ones suffice)")
    q.add_argument("--batch_size", type=int, default=None)
    q.set_defaults(func=cmd_quantize)

    ex = sub.add_parser("export", help="serving artifact through torch.export (preprocess, "
                                       "forward and CTC decode, weights baked in)")
    common(ex)
    ex.add_argument("--checkpoint", type=str, required=True,
                    help=".pth file or a port checkpoint directory")
    ex.add_argument("--out", type=str, default="lipnet_serving.zip",
                    help="the artifact: a zip of torch.export programs and their meta")
    ex.add_argument("--frame_geometry", type=str, default=None,
                    help="HxW of the client's frames; default: the model's geometry "
                         "(pre-cropped clips); any other bakes the heuristic mouth ROI in")
    ex.add_argument("--detector_checkpoint", type=str, default=None,
                    help="export the sync-scoring pipeline (this detector and the "
                         "--checkpoint LipNet) instead of the transcriber")
    ex.add_argument("--shifts_per_request", type=int, default=1,
                    help="K of the sync-scorer artifact (static per program)")
    ex.add_argument("--batch_sizes", type=str, default=None,
                    help="comma-separated static batch buckets (e.g. '1,2,4,8'): one static "
                         "program per size instead of one with a symbolic batch")
    ex.set_defaults(func=cmd_export)

    sv = sub.add_parser("serve", help="HTTP serving daemon with dynamic batching")
    common(sv)
    sv.add_argument("--checkpoint", type=str, default=None,
                    help=".pth file or a port checkpoint directory")
    sv.add_argument("--detector_checkpoint", type=str, default=None,
                    help="also serve /v1/sync_score from this detector")
    sv.add_argument("--artifact", action="append", default=None,
                    help="serve from an `export` artifact instead of a checkpoint (repeat for "
                         "a transcriber and a sync scorer); no model code is loaded")
    sv.add_argument("--host", type=str, default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8777, help="0: a free port the OS chooses")
    sv.add_argument("--max_batch", type=int, default=8,
                    help="dynamic batching: max rows per device batch")
    sv.add_argument("--max_wait_ms", type=float, default=10.0,
                    help="dynamic batching: max extra latency a lone request waits for "
                         "batchmates")
    sv.add_argument("--max_body_mb", type=int, default=256,
                    help="refuse request bodies larger than this (413) before reading them")
    sv.add_argument("--dp", type=int, default=1,
                    help="data-parallel serving over N cards (0 = all): a replica of the "
                         "weights per card, made once; each batch's rows split over them")
    sv.add_argument("--quantize", choices=["int8"], default=None,
                    help="int8 conv stack for /v1/transcribe (see `quantize`)")
    sv.add_argument("--qscales", type=str, default=None,
                    help="calibration scales .npz from `quantize` (either package's); "
                         "without it, int8 calibrates on the first request")
    sv.add_argument("--warmup", action="store_true",
                    help="run every batch bucket before binding the port (kernel builds, "
                         "cuDNN plans) so the first request pays steady-state latency")
    sv.add_argument("--transport", choices=["raw", "f32"], default="raw",
                    help="'raw' ships uint8 frames and preprocesses each batch on the device; "
                         "'f32' preprocesses per request")
    sv.set_defaults(func=cmd_serve)

    def detector_inputs(sp):
        sp.add_argument("--checkpoint", type=str, default="lipnet_final.pth",
                        help="frozen LipNet: reference .pth or a port checkpoint directory")
        sp.add_argument("--detector_checkpoint", type=str, default="misalignment_detector.pth")
        sp.add_argument("--max_samples", type=int, default=None)
        sp.add_argument("--bank_cache", type=str, default=None,
                        help="directory for persisted FeatureBanks (keyed by corpus and "
                             "checkpoint fingerprints); repeat runs over an unchanged "
                             "corpus skip the feature extraction")

    m = sub.add_parser("misalign-train", help="train the misalignment detector")
    common(m)
    detector_inputs(m)
    m.add_argument("--batch_size", type=int, default=None)
    m.add_argument("--epochs", type=int, default=None)
    m.add_argument("--lr", type=float, default=None)
    m.add_argument("--weight_decay", type=float, default=None)
    m.add_argument("--hidden_dim", type=int, default=None)
    m.add_argument("--max_shift_frames", type=int, default=None)
    m.add_argument("--num_negatives", type=int, default=None)
    m.add_argument("--sample_rate", type=int, default=None)
    m.add_argument("--n_mfcc", type=int, default=None)
    m.add_argument("--log_dir", type=str, default="logs")
    m.add_argument("--verbose", action="store_true")
    m.add_argument("--save_every", type=int, default=5)
    m.set_defaults(func=cmd_misalign_train)

    e = sub.add_parser("misalign-eval", help="sliding-shift AUROC sweep over a corpus")
    common(e)
    detector_inputs(e)
    e.add_argument("--min_shift", type=int, default=5)
    e.add_argument("--max_shift", type=int, default=20)
    e.add_argument("--output", type=str, default=None)
    e.set_defaults(func=cmd_misalign_eval)

    d = sub.add_parser("misalign-demo", help="export annotated demo videos")
    common(d)
    d.add_argument("--checkpoint", type=str, default="lipnet_final.pth",
                   help="frozen LipNet: reference .pth or a port checkpoint directory")
    d.add_argument("--detector_checkpoint", type=str, default="misalignment_detector.pth")
    d.add_argument("--output_dir", type=str, default="demo_output")
    d.add_argument("--min_shift", type=int, default=5)
    d.add_argument("--max_shift", type=int, default=20)
    d.add_argument("--scale", type=int, default=1)
    d.set_defaults(func=cmd_misalign_demo)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "distributed", False):
        if args.command != "train":
            print(DISTRIBUTED_TRAIN_ONLY, file=sys.stderr)
            return 2
        import torch.distributed as dist

        from avsync_torch.parallel import multihost

        # before any device work: the group, the rank's card, the backend
        rank = multihost.initialize(device="cpu" if args.device == "cpu" else "cuda")
        print(f"multi-process: rank {rank} of {multihost.world_size()} on "
              f"{multihost.rank_device()} ({multihost.backend()})", flush=True)
        if rank != 0:
            sys.stdout = open(os.devnull, "w")
        try:
            return args.func(args)
        finally:
            dist.destroy_process_group()
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
