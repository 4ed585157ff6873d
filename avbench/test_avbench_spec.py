"""The benchmark's files: found by name, and held to the format's rules."""

from __future__ import annotations

import json

import pytest

from avbench.harness import spec


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_every_cell_config_and_metric_is_a_file_found_by_name(bench):
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert c["file"] == f"avbench/configs/{c['name']}.json"
        assert (cfg["name"], cfg["source"], cfg["reduced"]) == \
            (c["name"], c["source"], c["reduced"])
    for w in bench["workloads"]:
        cell = spec.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["why"]) == \
            (w["config"], w["traffic"], w["why"])
        assert spec.kind(cell["kind"]).run
    for m in bench["per_layer"]:
        mod = spec.metric(m["name"])
        assert (mod.LAYER, mod.MOVES, mod.SOURCE) == (m["layer"], m["moves"], m["source"])


def test_every_metric_file_loads():
    names = sorted(p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py"))
    assert names
    for name in names:
        mod = spec.metric(name)
        assert mod.MOVES == "train_samples_per_s"
        assert mod.SOURCE in ("device_trace", "program_span", "program_counter", "host_clock")


def test_each_cell_reports_what_its_per_layer_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        reported = {m["name"] for m in spec.metrics_of(bench, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.metrics_of(bench, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in reported
            assert e2e[m["moves"]]["source"] in ("host_clock", "device_trace")


def test_format_rules(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in bench["end_to_end"]} <= {
        "train_samples_per_s", "serve_p95_ms", "serve_requests_per_s", "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    order = ["lipnet.train", "lipnet_tf.train", "lipnet.serve", "lipnet_tf.serve"]
    assert [w["name"] for w in bench["workloads"]] == order[:len(bench["workloads"])]
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert all(len(w["why"]) <= 200 for w in bench["workloads"])
    assert bench["paths"] == ["avbench"] and bench["command"] == ["python3", "avbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    with open(spec.ROOT / "BENCHMARK.json", "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", ".a", "-a", "é", "x" * 65, ""])
def test_names_with_forbidden_characters_are_refused(name):
    with pytest.raises(spec.SpecError):
        spec.check_name(name, "test")


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "", "x" * 17, "a,b"])
def test_units_with_forbidden_characters_are_refused(unit):
    with pytest.raises(spec.SpecError):
        spec.check_unit(unit, "test")


@pytest.mark.parametrize("good", ["samples/s", "%", "ms", "requests/s", "s"])
def test_the_benchmarks_units_pass(good):
    assert spec.check_unit(good, "test") == good


def test_a_missing_file_is_named(tmp_path, monkeypatch):
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    with pytest.raises(spec.SpecError, match="missing file"):
        spec.workload("no.such.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(
        {"configs": [], "workloads": [{"name": "a b", "config": "c", "traffic": "t"}],
         "end_to_end": [], "per_layer": []}))
    with pytest.raises(spec.SpecError):
        spec.benchmark(tmp_path)
