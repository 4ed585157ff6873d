"""The numbers that decide `correct`, each beside its limit.

Training: each checked step's loss, the first gradient as the optimizer got
it and the parameters' change after the checked steps, against the plain
reference's. A leaf's gap is the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger; the number compared is the worst leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.

Serving: the widest gap, over a sample of the answered requests, by which a
served transcript's frames lie below the reference's best
(`reference.transcript_gap`), and over the rows of the batches kept for the
check, by which the token the program's log-probs put first at a frame lies
below the reference's best there (`token_gap`), and the largest difference
between those log-probs and the reference's (`logprob_err`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import torch


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys=None) -> Dict[str, float]:
    """Each leaf's gap of norms over max(its reference norm, the median's)."""
    keys = list(want) if keys is None else list(keys)
    med = _median([want[k] for k in keys])
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}


def train_readings(params0, program: dict, ref: dict) -> Dict[str, float]:
    """Of one run (see the module): `loss_rel` (the worst checked step's
    relative loss gap), `loss_rel_first` (the first step's), `grad_gap`
    (the worst leaf's), `update_gap` (the worst leaf's) and
    `update_gap_median` (the median leaf's)."""
    steps = [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"])]
    g_ref = _norms(ref["first_grad"])
    grads = leaf_gaps(_norms(program["first_grad"]), g_ref)
    med = _median(list(g_ref.values()))
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    d_prog = _norms({k: program["params"][k].double() - params0[k].double() for k in moved})
    d_ref = _norms({k: ref["params"][k].double() - params0[k].double() for k in moved})
    updates = leaf_gaps(d_prog, d_ref, moved)
    return {"loss_rel": max(steps), "loss_rel_first": steps[0], "grad_gap": max(grads.values()),
            "update_gap": max(updates.values()), "update_gap_median": _median(updates.values()),
            "left_out": [k for k in g_ref if k not in moved],
            "worst_grad_leaf": max(grads, key=grads.get),
            "worst_update_leaf": max(updates, key=updates.get), "loss_rel_steps": steps}


def train_checks(limits: dict, readings: dict) -> List[Check]:
    """The numbers the cell's limits name, each beside its limit."""
    return [Check(k, float(readings[k]), float(v)) for k, v in limits.items()]


def token_gap(want: torch.Tensor, got: torch.Tensor) -> float:
    """The widest gap, over rows and frames, by which the token that `got`
    puts first lies below the best of the reference's log-probs `want`."""
    first = got.argmax(dim=-1, keepdim=True)
    return float((want.max(dim=-1).values - want.gather(-1, first).squeeze(-1)).max())


def logprob_err(want: torch.Tensor, got: torch.Tensor) -> float:
    """The largest difference of any log-prob from the reference's."""
    return float((got.float() - want.float()).abs().max())
