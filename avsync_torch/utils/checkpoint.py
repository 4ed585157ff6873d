"""`.pth` training checkpoints with the config embedded (the port's
counterpart of the JAX package's Orbax `avsync/utils/checkpoint.py`).

One file per snapshot, `<root>/epoch_<step>.pth`, in the reference
trainer's layout (`trainer.py:144-156`, SURVEY.md):

    {"epoch": step, "model_state_dict": ..., "optimizer_state_dict": ...,
     "losses": {"train": [...], "val": [...]},
     "step": optimizer steps taken, "config": AvsyncConfig JSON,
     "metrics": {...}}

so `compat.load_pth` (and the reference's own loaders) read the weights
straight from it, and any tool can rebuild the model from the config
alone. A snapshot is written to a temporary file and renamed into place, so
a crash mid-save never leaves a half-written step behind. Under a process
group every rank calls `save` with the same whole tensors: rank 0 writes,
then all ranks meet in a barrier, so a `restore` that follows on any rank
reads the finished file. `max_to_keep` keeps the newest steps only, as the
JAX manager's Orbax option (None, the default, keeps every one).

The JAX package's Orbax directories are read where JAX runs, by
`scripts/orbax_to_torch.py`, which writes them as such a directory.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from avsync_torch.parallel import multihost

_NAME = re.compile(r"^epoch_(\d+)\.pth$")


class CheckpointManager:
    """save(step, ...) / latest_step() / restore(step) over one directory;
    after a save, the oldest snapshots beyond `max_to_keep` are deleted."""

    def __init__(self, root: str, max_to_keep: Optional[int] = None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be None or >= 1, got {max_to_keep}")
        self.root = os.path.abspath(root)
        self.max_to_keep = max_to_keep
        os.makedirs(self.root, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"epoch_{step}.pth")

    def save(self, step: int, model_state: Dict[str, torch.Tensor],
             optimizer_state: Optional[Dict[str, Any]] = None, config=None,
             metrics: Optional[Dict[str, Any]] = None,
             losses: Optional[Dict[str, List[float]]] = None,
             optimizer_steps: int = 0) -> str:
        """Write snapshot `step`, replacing one of the same step (tensors
        keep their device; `restore` and `compat.load_pth` map them to the
        CPU). Rank 0 writes, then deletes the oldest snapshots beyond
        `max_to_keep`; every rank returns after both."""
        dst = self.path(step)
        if not multihost.is_main():
            multihost.barrier()
            return dst
        payload = {
            "epoch": step,
            "model_state_dict": dict(model_state),
            "optimizer_state_dict": optimizer_state,
            "losses": losses or {"train": [], "val": []},
            "step": int(optimizer_steps),
            "config": config.to_json() if config is not None else None,
            "metrics": {k: (v.item() if hasattr(v, "item") else v)
                        for k, v in (metrics or {}).items()},
        }
        tmp = f"{dst}.{os.getpid()}.tmp"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, dst)
            if self.max_to_keep is not None:
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self.path(old))
        finally:
            multihost.barrier()
        return dst

    def all_steps(self) -> List[int]:
        steps = (_NAME.match(n) for n in os.listdir(self.root))
        return sorted(int(m.group(1)) for m in steps if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(payload, meta) of snapshot `step`, the latest when None; meta is
        {"config": dict or None, "metrics": dict}, as the JAX manager's."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        payload = torch.load(self.path(step), map_location="cpu", weights_only=False)
        cfg = payload.get("config")
        meta = {"config": json.loads(cfg) if cfg else None,
                "metrics": payload.get("metrics") or {}}
        return payload, meta

