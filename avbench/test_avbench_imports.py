"""Nothing the harness runs imports JAX or the JAX package: after the
harness and a cell's set-up, no module whose top-level name (the part
before the first dot, compared whole) is jax, jaxlib, flax, optax, orbax or
avsync is loaded. `avsync_torch` is another name and passes."""

from __future__ import annotations

import subprocess
import sys

import pytest

from avbench.harness import spec

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
import avbench.run as run
from avbench.harness import spec
from avbench.harness import compare, program, readers, reference, trace, traffic, work
import avbench.control, avbench.sweep
bench = spec.benchmark()
for m in bench["per_layer"]:
    spec.metric(m["name"])
for w in bench["workloads"]:
    spec.kind(spec.workload(w["name"])["kind"])
cfg = dict(spec.config("lipnet"), frames=4, img_height=8, img_width=16, conv_channels=[2, 3, 4],
           hidden_dim=4)

class Ctx:
    config = cfg
    cell = dict(spec.workload("lipnet.train"), batch=2, corpus_clips=8)
    seed = 3
    device = __import__("torch").device("cpu")

from avbench.kinds import train
train.Setup(Ctx)
assert "avsync_torch" in sys.modules
print("forbidden=" + ",".join(run.forbidden_modules()))
"""


def test_no_forbidden_module_after_the_harness_and_a_set_up():
    proc = subprocess.run([sys.executable, "-c", PROBE.format(root=str(spec.ROOT))],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "forbidden="


@pytest.mark.parametrize("name,caught", [("jax", True), ("jax.numpy", True), ("jaxlib", True),
                                         ("flax.linen", True), ("optax", True),
                                         ("orbax.checkpoint", True), ("avsync", True),
                                         ("avsync.models", True), ("avsync_torch", False),
                                         ("avsync_torch.models", False), ("jaxtyping", False),
                                         ("avbench", False)])
def test_names_are_compared_whole(monkeypatch, name, caught):
    import avbench.run as run

    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in run.forbidden_modules()) is caught
