"""The harness's data: cells, configurations, traffic and metrics found by
name, BENCHMARK.json in step with them, the import rule, the card rule, and
sound runs on the CPU at a small size."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import make_pool

ROOT = Path(harness.ROOT)
REPO = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench_json() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", harness.workloads())
def test_every_cell_loads(name):
    c = harness.cell(name)
    assert c["chips"] in (1, 4)
    assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    assert harness.driver(c["config_data"]["family"]).Program
    assert set(c["config_data"]["limits"]) and all(
        isinstance(v, (int, float)) for v in c["config_data"]["limits"].values())
    mix = c["traffic_data"]
    assert mix["frames"] == "bgr" and mix["batch"] > 0


def test_benchmark_json_matches_the_files():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    # the files and the entries name the same cells, configurations and metrics
    for c in b["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (REPO / c["file"]).is_file()
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}
    assert {w["name"] for w in b["workloads"]} == set(harness.workloads())
    assert {c["name"] for c in b["configs"]} == {
        p.stem for p in (ROOT / "configs").glob("*.json")}
    for w in b["workloads"]:
        c = harness.cell(w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            c["config"], c["traffic"], c["chips"], c["why"])
    for kind in ("end_to_end", "per_layer"):
        readers = harness.readers(kind)
        assert {m["name"] for m in b[kind]} == set(readers)
        for m in b[kind]:
            assert m["unit"] == readers[m["name"]].UNIT


def test_names_and_units_use_the_allowed_characters():
    b = bench_json()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for kind in ("end_to_end", "per_layer") for m in b[kind]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for kind in ("end_to_end", "per_layer") for m in b[kind])
    for m in b["end_to_end"] + b["per_layer"]:
        assert m["better"] in ("lower", "higher")
    for path in ROOT.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(REPO))), path


def test_each_layer_metric_moves_a_metric_its_cells_report():
    b = bench_json()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    layers = {m["layer"] for m in b["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
    for cell in cells:
        assert any(cell in set(m.get("workloads", cells)) for m in b["per_layer"])


def test_bounds_follow_the_rules():
    b = bench_json()
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s: 2 + 14 runs a cell, each
    # run_seconds + 60 s, 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = len(b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, cells // 4)


def _small(traffic: str, **kw) -> dict:
    mix = harness.load("traffic", traffic)
    mix.update(kw)
    return mix


def test_the_pool_repeats_from_a_seed_and_differs_between_seeds():
    mix = _small("gtsdb_b32", height=96, width=160, batch=2, pool_batches=2)
    a, b, c = make_pool(mix, 2**31 + 5), make_pool(mix, 2**31 + 5), make_pool(mix, 7)
    assert len(a) == 2 and a[0].shape == (2, 96, 160, 3) and a[0].dtype == np.uint8
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], a[1])


def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        bad = _imported_tops(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_loaded_module_check_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "opencv_traffic_sign_detector_tpu_torch.x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "opencv_traffic_sign_detector_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["jaxlib", "opencv_traffic_sign_detector_tpu"]


def test_the_command_exits_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command would run the cell")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mser_tuned.gtsdb_b32", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "is_available" in out.stderr


def test_a_new_cell_is_a_file_of_its_own(tmp_path, monkeypatch):
    copy = tmp_path / "benchmark"
    for kind in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(ROOT / kind, copy / kind)
    (copy / "workloads" / "mser_tuned.dummy_b8.json").write_text(json.dumps(
        {"config": "mser_tuned", "traffic": "gtsdb_b32", "chips": 1, "why": "a test"}))
    monkeypatch.setattr(harness, "ROOT", copy)
    assert "mser_tuned.dummy_b8" in harness.workloads()
    c = harness.cell("mser_tuned.dummy_b8")
    assert c["config_data"]["family"] == "mser" and c["traffic_data"]["batch"] == 32
    assert set(harness.readers("per_layer")) >= {
        m["name"] for m in bench_json()["per_layer"]}


@pytest.mark.parametrize("name,traffic,kw", [
    ("mser_tuned.gtsdb_b32", "gtsdb_b32", {"height": 400, "width": 680}),
    ("mser_tuned.hd1080_b32", "hd1080_b32", {"height": 272, "width": 480}),
])
def test_a_sound_run_on_the_cpu_is_correct(name, traffic, kw):
    mix = _small(traffic, batch=2, pool_batches=1, **kw)
    out = harness.run_cell(name, 2**31 + 11, 0.05, False, 0.0, device="cpu", traffic=mix)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert list(out)[-1] == "checks" and out["metrics"]["setup_s"]["unit"] == "s"
