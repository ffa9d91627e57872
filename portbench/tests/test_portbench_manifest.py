"""The manifest and the data files the harness finds by name."""

import ast
import json
import re

import pytest

from portbench import harness

M = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in M["paths"])
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its 43200 s
    assert 1200 + 2 * (M["run_seconds"] + 60) + 24 * (14 * (M["run_seconds"] + 60) + 180) <= 43200


def test_names_units_and_text_fields():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and not (group == "per_layer"
                                                               and key == "source"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    assert len(names) == len(set(names))
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in M["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_and_metrics_are_reported(cell):
    spec = harness.cell_spec(cell)
    assert spec.traffic["driver"] and (harness.BENCH / "drivers"
                                       / f"{spec.traffic['driver']}.py").is_file()
    assert (harness.BENCH / "reference" / f"{spec.config['family']}.py").is_file()
    reported = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and spec.per_layer
    for m in spec.per_layer:
        assert m["moves"] in E2E and m["moves"] in reported, (m["name"], cell)
    assert set(spec.cell["limits"]) and all(v is not None for v in spec.cell["limits"].values())


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("portbench/") and data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"] and any(w["config"] == conf["name"]
                                                        for w in M["workloads"])


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(metric):
    tree = ast.parse(harness.metric_file(metric["name"]).read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body)
    for cell in metric["workloads"]:
        assert cell in CELLS
    layers = {m["layer"] for m in M["per_layer"]}
    assert metric["layer"] in layers


def test_no_metric_reads_zero_for_an_empty_trace():
    run = harness.Run(harness.cell_spec(CELLS[0]), 1, 1.0, True, None, 0.0)
    for m in M["per_layer"]:
        if m["source"] == "device_trace":
            assert harness.metric_reader(m["name"])(run) is None


@pytest.mark.parametrize("file,key", [("traffic/serve_batch.json", "clients"),
                                      ("traffic/train.json", "optimizer.kind"),
                                      ("traffic/synth_slices.json", "noise_kind"),
                                      ("configs/unet_s.json", "master_dtype")])
def test_a_key_nothing_reads_is_refused(monkeypatch, file, key):
    # a setting no driver honours would measure something else than its file says
    real = harness._json

    def with_key(path):
        data = real(path)
        if path == harness.BENCH / file:
            head, _, leaf = key.rpartition(".")
            (data[head] if head else data)[leaf] = 8
        return data

    monkeypatch.setattr(harness, "_json", with_key)
    with pytest.raises(ValueError, match=key):
        harness.cell_spec("unet_s.train" if "train" in file else "unet_s.serve_batch")


def test_a_reader_serves_every_metric_of_its_stem():
    assert harness.metric_file("device_ms.train").name == "device_ms.py"
    assert harness.metric_file("device_idle_pct.interactive").name == "device_idle_pct.py"
    assert harness.metric_file("mfu_pct.train").name == "mfu_pct.train.py"
