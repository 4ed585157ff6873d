#!/usr/bin/env python3
"""Convert a JAX package checkpoint directory (Orbax, written by
`avsync.utils.checkpoint.CheckpointManager`: `train --checkpoint_dir`) into
a port checkpoint directory (`avsync_torch.utils.checkpoint`):

    python3 scripts/orbax_to_torch.py SRC_DIR DST_DIR [--step N]

It runs where JAX and Orbax run (the port imports neither): it restores
step N (the latest by default), carries the params of either LipNet family
through the port's weight bridges (`avsync_torch.compat.lipnet_params_from_jax`,
`tflipnet_params_from_jax`, as `predictor.lipnet_state` picks them by the
embedded config's family), the optax Adam moments (`mu`, `nu`, `count`),
where the snapshot holds them, through the same transforms into torch
Adam's `exp_avg`, `exp_avg_sq` and `step`, and writes `DST_DIR/epoch_<N>.pth`
with the embedded config and metrics. Every port command that reads a
checkpoint directory reads the result: `train --resume`, `test`, `infer`,
`quantize`, `export`, `serve`.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _adam_state(tree: Any) -> Optional[dict]:
    """The {'count', 'mu', 'nu'} node of a restored optax state (an
    `optax.chain`'s tuple restores as a list), or None."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for sub in tree:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def convert(src: str, dst: str, step: Optional[int] = None) -> str:
    """Write step `step` (the latest when None) of the Orbax directory `src`
    as `dst/epoch_<step>.pth`; returns its path."""
    import numpy as np
    import torch

    from avsync.utils.checkpoint import CheckpointManager as OrbaxManager
    from avsync_torch.config import AvsyncConfig
    from avsync_torch.models import make_lipnet
    from avsync_torch.predictor import lipnet_state
    from avsync_torch.train.lipnet_trainer import make_optimizer
    from avsync_torch.utils.checkpoint import CheckpointManager

    orbax = OrbaxManager(src)
    try:
        step = orbax.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {src}")
        state, meta = orbax.restore(step)
    finally:
        orbax.close()
    cfg = AvsyncConfig.from_dict(meta["config"]) if meta.get("config") else AvsyncConfig()

    def host(tree):
        import jax

        return jax.tree.map(np.asarray, tree)

    model = make_lipnet(cfg.model, (cfg.data.img_height, cfg.data.img_width),
                        generator=torch.Generator())
    model.load_state_dict(lipnet_state(cfg, params=host(state["params"])))
    optimizer_state = None
    adam = _adam_state(state.get("opt_state"))
    if adam is not None:
        mu = lipnet_state(cfg, params=host(adam["mu"]))
        nu = lipnet_state(cfg, params=host(adam["nu"]))
        count = float(np.asarray(adam["count"]))
        opt = make_optimizer(model.parameters(), cfg.train.learning_rate)
        for name, p in model.named_parameters():
            opt.state[p] = {"step": torch.tensor(count), "exp_avg": mu[name].clone(),
                            "exp_avg_sq": nu[name].clone()}
        optimizer_state = opt.state_dict()
    return CheckpointManager(dst).save(
        step, model.state_dict(), optimizer_state, config=cfg, metrics=meta.get("metrics"),
        optimizer_steps=int(np.asarray(state.get("step", 0))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the JAX package's Orbax checkpoint directory")
    ap.add_argument("dst", help="the port checkpoint directory to write into")
    ap.add_argument("--step", type=int, default=None, help="the step to convert (the latest)")
    args = ap.parse_args(argv)
    print(f"wrote {convert(args.src, args.dst, args.step)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
