#!/usr/bin/env python3
"""Train the mouth localizer on the synthetic corpus and write its bundle.

    python3 scripts/torch_train_localizer.py [steps] [out.npz] [--device cpu] [--seed 0]

The port's counterpart of `scripts/train_localizer.py`, with the same
command line: 1500 steps of supervised box regression at B=128
(`avsync_torch.train.localizer_trainer`) on the card unless `--device`
names another, then the weights written with
`avsync_torch.models.localizer.save_params` to `out.npz`, or, without it,
to the port's bundle `avsync_torch/models/localizer_weights.npz`. The file
has the JAX package's layout, so either package loads it
(`load_bundled_or_none(path=...)` in the port). Prints the dataset's size,
the loss and validation IoU every 200 steps, the final validation IoU, and
the full inference path's boxes (raw frames -> boxes) beside the true boxes
on four training frames, and the JAX package's accuracy gates of the
bundled weights (tests/test_localizer.py:54-123) on the trained ones.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=1500)
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--device", default=None, help="the card when not given (cpu to run there)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from avsync_torch.models.localizer import (WEIGHTS_FILE, load_localizer, localize_frames,
                                               save_params)
    from avsync_torch.predictor import resolve_device
    from avsync_torch.train.localizer_trainer import (accuracy_gates, build_dataset,
                                                      train_localizer)

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    print("generating training set...", flush=True)
    data = build_dataset(args.seed)
    print(f"dataset: train={len(data.x_train)} val={len(data.x_val)} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    state, history = train_localizer(args.steps, seed=args.seed, device=dev, data=data,
                                     log=lambda line: print(line, flush=True))
    print(f"final val IoU: {history[-1]['val_iou']:.3f}")
    out = args.out or WEIGHTS_FILE
    save_params(state, out)
    print(f"saved -> {os.path.relpath(out, ROOT) if args.out is None else out}")

    # sanity: the full inference path (raw frames -> boxes) on the trained weights
    with torch.no_grad():
        chk = localize_frames(load_localizer(state, dev),
                              torch.from_numpy(data.sample_frames).to(dev)).cpu().numpy()
    print("sample boxes:", np.round(chk, 3).tolist())
    print("truth boxes: ", np.round(data.sample_boxes, 3).tolist())
    gates, failed = accuracy_gates(load_localizer(state, dev), dev)
    print(f"the JAX package's accuracy gates (tests/test_localizer.py:54-123): "
          f"{json.dumps(gates)}; failed: {failed or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
