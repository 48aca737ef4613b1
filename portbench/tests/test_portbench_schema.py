"""``BENCHMARK.json`` against the benchmark contract's shape, and the last
line a run prints."""

import json
import re

import pytest

from portbench.catalog import variants
from portbench.run import run_cell
from portbench.tests.conftest import DEVICE, ROOT, SEED

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for e in SPEC[group]:
        assert set(e) <= KEYS[group] and NAME.match(e["name"]), e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_cells_and_metrics_refer_to_what_exists():
    configs = {c["name"]: c for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for c in configs.values():
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/configs/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert NAME.match(w["traffic"])
    assert {w["config"] for w in SPEC["workloads"]} == set(configs)
    bounds = {m["name"]: m["bound"] for m in SPEC["end_to_end"]}
    assert bounds["setup_s"] <= 0.25 and all(0.01 <= b <= 0.25 for b in bounds.values())
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert any((ROOT / "portbench" / "layer_metrics" / f"{n}.py").is_file()
                   for n in variants(m["name"])), m["name"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in cells:
        reported = {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny, cell, trace):
    out = run_cell(tiny, cell, SEED, 0.3, trace, DEVICE)["result"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in tiny.metrics(kind, cell)}
    assert out["metrics"] and set(out["metrics"]) <= set(allowed)
    for name, m in out["metrics"].items():
        assert m["unit"] == allowed[name] and isinstance(m["value"], float)
    if not trace:
        assert set(out["metrics"]) == set(allowed)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)
