"""The program's own spans (`utils/profiling`: `span`, `spans`, `mark`,
`marks`, `mark_backward`) and the layer marks the LipNet trainer places in its step
(`train/lipnet_trainer.step_marks`), on the CPU at a tiny width; the last
test, marked `cuda`, profiles a captured plan on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import contextlib
import re
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
from avsync_torch.models.lipnet import ConvStack
from avsync_torch.parallel.mesh import GradientReducer
from avsync_torch.train import lipnet_trainer
from avsync_torch.train.lipnet_trainer import SPAN_MARKS, LipNetTrainer, step_marks
from avsync_torch.utils import profiling
from avsync_torch.utils.logging import Logger

FWD = {"pytorch": ["conv1", "conv2", "conv3", "gru1", "gru2", "head_ctc"],
       "tf": ["conv1", "conv2", "conv3", "lstm1", "lstm2", "lstm3", "head_ctc"]}


def step_order(family, reduce=False):
    """The documented marks of one step, in stream order (`reduce` under
    data parallelism)."""
    fwd = FWD[family]
    return (["gather"] + [f"{n}.fwd" for n in fwd] + [f"{n}.bwd" for n in reversed(fwd)]
            + ["reduce"] * reduce + ["update", "tail"])


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.SpanRecorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def _cfg(family, dropout=0.5, H=16, W=32, channels=(2, 3, 4), hidden=8, remat=False):
    return AvsyncConfig(
        data=DataConfig(img_height=H, img_width=W, max_video_length=8, batch_size=2,
                        max_label_length=4),
        model=ModelConfig(family=family, hidden_dim=hidden, conv_channels=channels,
                          dropout_rate=dropout, use_pallas_gru=True, fused_conv_pool=True),
        train=TrainConfig(learning_rate=1e-3, seed=7, remat=remat))


def _plan(device="cpu", S=3, B=2, N=8, H=16, W=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    video = torch.rand(N, 8, H, W, 1, generator=g).to(device)
    labels = torch.randint(1, 27, (N, 4), generator=g).to(device)
    return {"video": video, "gather": lambda row: video.index_select(0, row), "labels": labels,
            "lengths": torch.full((N,), 4, device=device),
            "idx": np.arange(S * B).reshape(S, B) % N}


def _trainer(family, device="cpu", **kw):
    trainer = LipNetTrainer(_cfg(family, **kw), device=device, log=Logger(None, console=False))
    return trainer, trainer.init_state()


def _marks(rec):
    assert all(s.name.startswith(profiling.MARK_PREFIX) for s in rec.marks())
    assert not any(s.name.startswith(profiling.MARK_PREFIX) for s in rec.spans())
    return rec.marks()


def _batch(seed=0):
    return {"video": np.random.default_rng(seed).random((2, 8, 16, 32, 1), dtype=np.float32),
            "labels": np.full((2, 4), 3), "label_lengths": np.full((2,), 4)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", ["pytorch", "tf"])
def test_eager_steps_mark_their_layers_in_stream_order(recorder, family, remat):
    """The documented order; under remat a block's recompute, inside the
    backward, marks nothing (it falls into the block's `.bwd` span)."""
    trainer, state = _trainer(family, remat=remat)
    trainer.train_epoch_scanned(state, _plan(S=3))
    got = _marks(recorder)
    per_step = step_order(family)
    assert [s.name[len(profiling.MARK_PREFIX):] for s in got] == per_step * 3
    # every mark's parent is the plan call, the backward marks too
    assert {s.parent for s in got} == {"avsync_torch.train.plan_call"}
    names = [s.name for s in recorder.spans()]
    assert names == ["avsync_torch.train.read_losses", "avsync_torch.train.plan_call"]
    call = recorder.spans()[-1]
    assert call.attrs == {"S": 3, "B": 2} and call.parent is None
    assert recorder.spans()[0].parent == "avsync_torch.train.plan_call"
    # the per-batch loop marks the same layers (no tail: it puts nothing)
    recorder._marks.clear()
    trainer.train_epoch(state, [_batch()])
    assert [s.name[len(profiling.MARK_PREFIX):] for s in _marks(recorder)] == per_step[:-1]


@pytest.mark.parametrize("family", ["pytorch", "tf"])
def test_marks_change_no_bit(monkeypatch, family):
    """Losses, gradients and parameters after 3 steps (dropout on), with and
    without the layer marks."""
    def run():
        torch.manual_seed(0)
        trainer, state = _trainer(family)
        _, loss = trainer.train_epoch_scanned(state, _plan(S=3))
        return loss, {k: (p.detach().clone(), p.grad.clone())
                      for k, p in state.model.named_parameters()}

    marked = run()
    monkeypatch.setattr(lipnet_trainer, "step_marks", lambda model: contextlib.nullcontext())
    plain = run()
    assert marked[0] == plain[0]
    for k, (p, g) in marked[1].items():
        assert torch.equal(p, plain[1][k][0]), k
        assert torch.equal(g, plain[1][k][1]), k


def test_no_hook_is_left_and_other_paths_record_no_mark(recorder):
    trainer, state = _trainer("pytorch", dropout=0.0)
    trainer.train_epoch_scanned(state, _plan(S=2))
    model = state.model
    assert all(not m._forward_pre_hooks and not m._forward_hooks for m in model.modules())
    before = len(_marks(recorder))
    assert before > 0
    x = torch.rand(2, 8, 16, 32, 1)
    ConvStack(model).eval().conv_features(x)
    model.eval()
    with torch.no_grad():
        model(x)
    ep = torch.export.export(model, (x,))
    assert "BackwardMark" not in str(ep.graph)
    ep.module()(x)
    assert len(_marks(recorder)) == before
    # a bare train step (the smoke's and the scripts' timed step) marks nothing
    lipnet_trainer.train_step(model.train(), state.optimizer,
                              lipnet_trainer.device_batch(_batch(), "cpu"), 1e-3)
    assert len(_marks(recorder)) == before
    # a failing step removes the hooks too
    with pytest.raises(RuntimeError):
        with step_marks(model):
            raise RuntimeError("step failed")
    assert all(not m._forward_pre_hooks for m in model.modules())
    # and leaves the step's own marks off
    lipnet_trainer.train_step(model, state.optimizer,
                              lipnet_trainer.device_batch(_batch(), "cpu"), 1e-3)
    assert len(_marks(recorder)) == before


def test_the_data_parallel_step_marks_its_reduction(recorder, monkeypatch):
    """The split program (body, the eager all-reduce, finish) on the CPU
    with a reducer over a data group of one: the all-reduce runs after the
    `reduce` mark and before `update`, so no layer's span holds it."""
    trainer, state = _trainer("pytorch")
    state.reducer = GradientReducer(state.model.parameters(),
                                    SimpleNamespace(data_size=1, data_group=None))
    seen = []
    monkeypatch.setattr(state.reducer, "reduce", lambda: seen.append(
        recorder.marks()[-1].name[len(profiling.MARK_PREFIX):]))
    trainer.train_epoch_scanned(state, _plan(S=2))
    assert seen == ["reduce"] * 2
    got = [s.name[len(profiling.MARK_PREFIX):] for s in _marks(recorder)]
    assert got == step_order("pytorch", reduce=True) * 2


def test_host_spans_outlive_many_marks(monkeypatch):
    """Marks have a ring of their own: steps that mark far more than the
    ring holds push out older marks, never the host spans."""
    rec = profiling.SpanRecorder(size=64)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    trainer, state = _trainer("pytorch")
    trainer.train_epoch_scanned(state, _plan(S=6))  # 15 marks a step
    trainer.train_epoch(state, [_batch(i) for i in range(6)])
    assert len(rec.marks()) == 64
    assert [s.name for s in rec.spans()] == ["avsync_torch.train.read_losses",
                                             "avsync_torch.train.plan_call"]


def test_the_kernels_are_the_span_list():
    src = Path(profiling.MARK_SOURCE).read_text()
    listed = src[src.index("#define AVS_SPAN_MARKS(X)"):src.index("#define AVS_DEFINE_MARK")]
    kernels = re.findall(r"X\((\w+)\)", listed)
    assert kernels == [profiling.mark_kernel(n)[len("avs_mark__"):] for n in SPAN_MARKS]
    assert list(profiling.mark_ids()) == kernels
    assert len(set(kernels)) == len(kernels)
    assert "extern \"C\" __global__ void avs_mark__##name()" in src


def test_the_step_layers_are_marked():
    for family, fwd in FWD.items():
        trainer, state = _trainer(family)
        layers = [n for n, _ in lipnet_trainer._marked_layers(state.model)]
        assert layers == fwd
        assert all(f"{n}.fwd" in SPAN_MARKS and f"{n}.bwd" in SPAN_MARKS for n in layers)
    with pytest.raises(KeyError):
        profiling.mark("conv9.fwd", "cpu")


def test_mark_backward_is_a_view_that_marks_in_the_backward(recorder):
    x = torch.rand(3, 4, requires_grad=True)
    with profiling.span("avsync_torch.test.outer"):
        y = profiling.mark_backward(x * 2, "conv1.bwd")
    assert y._base is not None and y.data_ptr() == y._base.data_ptr()
    assert _marks(recorder) == []
    y.sum().backward()
    (m,) = _marks(recorder)
    assert m.name == "avsync_torch.mark.conv1.bwd" and m.parent == "avsync_torch.test.outer"
    assert torch.equal(x.grad, torch.full((3, 4), 2.0))


def test_the_ring_is_bounded():
    rec = profiling.SpanRecorder()
    n = profiling.RING_SIZE
    for i in range(n + 36):
        with rec.span("avsync_torch.test", i=i):
            rec.mark("gather" if i % 2 else "tail", "cpu")
    got = rec.spans()
    assert len(got) == n and got[0].attrs == {"i": 36} and got[-1].attrs == {"i": n + 35}
    marks = rec.marks()
    assert len(marks) == n and marks[-1].name == profiling.MARK_PREFIX + "gather"
    assert marks[0].name == profiling.MARK_PREFIX + "tail"


def test_two_threads_record_into_one_ring():
    rec = profiling.SpanRecorder()
    start = threading.Barrier(2)

    def work(tag):
        start.wait(timeout=30)
        for i in range(2000):
            with rec.span(f"avsync_torch.test.{tag}"):
                with rec.span(f"avsync_torch.test.{tag}.inner", i=i):
                    pass

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    got = rec.spans()
    assert len(got) == 8000
    for tag in ("a", "b"):
        inner = [s for s in got if s.name == f"avsync_torch.test.{tag}.inner"]
        assert [s.attrs["i"] for s in inner] == list(range(2000))
        assert {s.parent for s in inner} == {f"avsync_torch.test.{tag}"}
        assert len({s.thread for s in inner}) == 1
    assert len({s.thread for s in got}) == 2


def test_a_span_is_a_profiler_range_while_the_profiler_records(recorder):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("avsync_torch.test.traced"):
            torch.ones(4).add_(1)
    assert "avsync_torch.test.traced" in {e.name for e in prof.events()}
    with profiling.span("avsync_torch.test.untraced"):
        pass
    assert [s.name for s in recorder.spans()] == ["avsync_torch.test.traced",
                                                  "avsync_torch.test.untraced"]


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the marks are CUDA kernels")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", ["pytorch", "tf"])
def test_a_replayed_plan_keeps_its_marks(card, recorder, family, remat):
    """One S=4 plan captured (two eager steps, the capture, two replays),
    then a second call profiled: four replayed steps, each with its marks in
    the eager steps' order, and >= 99% of the call's device time inside
    them (from a step's gather mark to the next one, or past the last).
    Under remat the captured recompute marks nothing either."""
    from torch.profiler import ProfilerActivity, profile

    trainer, state = _trainer(family, device=card, H=50, W=100, channels=None, hidden=64,
                              remat=remat)
    plan = _plan(card, S=4, B=8, N=32, H=50, W=100)
    trainer.train_epoch_scanned(state, plan)
    eager = [s.name[len(profiling.MARK_PREFIX):] for s in _marks(recorder)
             if s.parent == "avsync_torch.train.warmup_step"]
    assert eager == step_order(family) * 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch_scanned(state, plan)
        torch.cuda.synchronize()
    events = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)), key=lambda e: e[1])
    names = {profiling.mark_kernel(n): n for n in SPAN_MARKS}
    order = [names[n] for n, _, _ in events if n in names]
    assert order == step_order(family) * 4
    first = next(a for n, a, _ in events if n == profiling.mark_kernel("gather"))
    busy = sum(b - a for _, a, b in events)
    inside = sum(b - a for _, a, b in events if a >= first)
    assert inside >= 0.99 * busy
    # the program's read of the losses encloses the device end of the call
    (read,) = [e for e in prof.events() if e.name == "avsync_torch.train.read_losses"
               and e.device_type == torch.autograd.DeviceType.CPU]
    assert read.time_range.start <= events[-1][2] <= read.time_range.end
