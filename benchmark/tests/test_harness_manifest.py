"""The benchmark's files agree with each other and with the contract's
rules, and nothing in it reaches for JAX."""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.flops import layers

BENCH = Path(harness.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_file(name):
    wl = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    assert NAME.match(name) and NAME.match(wl["traffic"])
    assert (BENCH / "configs" / f"{wl['config']}.json").exists()
    assert (BENCH / "traffic" / f"{wl['generator']}.py").exists()
    assert wl["chips"] in (1, 4)
    assert line_ok(wl["why"])
    assert "end_to_end" not in wl  # BENCHMARK.json says what a cell reports


def test_manifest_cells_match_files():
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    assert set(cells) <= set(WORKLOADS)
    for name, cell in cells.items():
        wl = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
        for key in ("config", "traffic", "chips", "why"):
            assert cell[key] == wl[key], (name, key)
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in configs.values():
        conf = json.loads((BENCH.parent / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert line_ok(c["source"]) and line_ok(c["why"])


def test_names_and_units():
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    names += [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", sorted(m["name"] for m in MANIFEST["per_layer"]))
def test_every_layer_metric_has_a_reader(name):
    mod = harness.load_reader(name)
    assert callable(mod.read)
    # what BENCHMARK.json says of the metric is said there only
    for key in ("LAYER", "UNIT", "BETTER", "SOURCE", "MOVES", "WORKLOADS"):
        assert not hasattr(mod, key), (name, key)
    entry = {m["name"]: m for m in MANIFEST["per_layer"]}[name]
    assert line_ok(entry["layer"])
    assert entry["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_reader_is_a_metric():
    files = {p.stem for p in (BENCH / "metrics").glob("*.py")
             if not p.name.startswith("_")}
    assert files == {m["name"] for m in MANIFEST["per_layer"]}


@pytest.mark.parametrize("cell", sorted(w["name"] for w in MANIFEST["workloads"]))
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e, layer = harness.cell_metrics(MANIFEST, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer
    assert all(m["moves"] in names for m in layer)
    wl = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    if wl["generator"] == "train":
        assert wl["params"]["rate_metric"] in names


def test_layer_metrics_list_only_cells_that_report_what_they_move():
    for m in MANIFEST["per_layer"]:
        for cell in m["workloads"]:
            e2e, _ = harness.cell_metrics(MANIFEST, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)


def test_cell_metrics_follow_the_manifest():
    manifest = {
        "end_to_end": [
            {"name": "rate", "unit": "1/s", "workloads": ["a", "b"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            {"name": "listed", "unit": "%", "moves": "rate",
             "workloads": ["a"]},
            {"name": "every", "unit": "ms", "moves": "rate"}]}
    e2e, layer = harness.cell_metrics(manifest, "b")
    assert [m["name"] for m in e2e] == ["rate", "setup_s"]
    assert [m["name"] for m in layer] == ["every"]
    e2e, layer = harness.cell_metrics(manifest, "c")
    assert [m["name"] for m in e2e] == ["setup_s"] and layer == []


class _Run:
    name = "chp3d-f32.offline-b32"
    trace = None
    setup_s = 12.5

    def __init__(self):
        self.e2e_metrics, self.layer_metrics = harness.cell_metrics(
            MANIFEST, self.name)
        self.e2e = {}


def test_a_metric_that_reads_nothing_is_named(capsys):
    run = _Run()
    metrics, unread = harness.per_layer(run)
    assert metrics == {}
    assert unread == [m["name"] for m in run.layer_metrics]
    err = capsys.readouterr().err
    assert all(f"{n}: its reader found nothing" in err for n in unread)


def test_end_to_end_holds_the_generator_to_the_manifest():
    run = _Run()
    with pytest.raises(ValueError, match="frames_per_s"):
        harness.end_to_end(run)
    run.e2e = {"frames_per_s": 140.0}
    assert harness.end_to_end(run) == {
        "frames_per_s": {"value": 140.0, "unit": "frames/s"},
        "setup_s": {"value": 12.5, "unit": "s"}}
    run.e2e["latency_p50_ms"] = 13.0
    with pytest.raises(ValueError):
        harness.end_to_end(run)


def test_frozen_flop_tables():
    gflop = {k: round(v / 1e9, 2) for k, v in layers.cascade_flops().items()}
    assert gflop == {"HandSegNet": 61.30, "PoseNet": 60.32,
                     "Prior+Viewpoint": 0.20}
    assert round(layers.frame_flops() / 1e9, 2) == 121.82
    assert round(layers.posenet_train_flops() / 1e9, 2) == 180.75


def test_inputs_are_deterministic_in_the_seed():
    seed = 2 ** 31 + 123
    cpu = torch.device("cpu")
    a = inputs.make_frames(seed, 3, (24, 32), cpu)
    assert np.array_equal(a, inputs.make_frames(seed, 3, (24, 32), cpu))
    assert not np.array_equal(a, inputs.make_frames(seed + 1, 3, (24, 32),
                                                    cpu))
    r = inputs.make_records(seed, 2, cpu)
    assert r.tobytes() == inputs.make_records(seed, 2, cpu).tobytes()
    w1 = inputs.make_weights(seed, cpu, scopes=("PosePrior",))
    w2 = inputs.make_weights(seed, cpu, scopes=("PosePrior",))
    assert all(np.array_equal(w1["PosePrior"][k]["weights"],
                              w2["PosePrior"][k]["weights"])
               for k in w1["PosePrior"])
    assert np.array_equal(inputs.sample_rows(seed, 100, 7),
                          inputs.sample_rows(seed, 100, 7))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    top = set(_imports(path))
    assert not top & {"jax", "jaxlib", "flax", "hand3d_tpu"}
    if "reference" in path.parts:
        assert "hand3d_tpu_torch" not in top
