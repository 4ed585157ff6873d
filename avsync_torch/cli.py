"""Command line of the port: `python -m avsync_torch.cli infer clip.npy --checkpoint x.pth`.

Port of `avsync/cli.py:cmd_infer` for `.npy` clips and reference `.pth`
checkpoints. Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from avsync_torch.config import AvsyncConfig


def _config(path: Optional[str]) -> AvsyncConfig:
    if path is None:
        return AvsyncConfig()
    with open(path) as f:
        return AvsyncConfig.from_json(f.read())


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
