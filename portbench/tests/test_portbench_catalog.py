"""A configuration, a traffic mix and a per-layer metric are each a new file
and a new entry: the harness finds them by name, with no file edited."""

import json

from portbench.catalog import Catalog, variants
from portbench.run import run_cell
from portbench.tests.conftest import DEVICE, SEED, make_tiny


def test_new_files_are_found_by_name(tmp_path):
    cat = make_tiny(tmp_path)
    root, bench = cat.root, cat.dir
    cfg = json.loads((root / "portbench/configs/haploformer-flagship.json").read_text())
    cfg["sampler"]["batch_size"] = 4
    (bench / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "new_mix.json").write_text(json.dumps(
        {"loop": "chain", "n_chain": 2, "n_batches": 3, "warmup_calls": 1,
         "checked_calls": 1, "profile_calls": 1, "replay_calls": 1}))
    (bench / "layer_metrics" / "calls_per_s.new.py").write_text(
        "def read(rec):\n    c = rec['counts']\n    return c['calls'] / c['window_s']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "new-config", "source": "https://example.org/x",
                            "file": "portbench/configs/new-config.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "new-cell", "config": "new-config",
                              "traffic": "new_mix", "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"]
         if m["name"] == "chain_windows_per_s")["workloads"].append("new-cell")
    spec["per_layer"].append({"name": "calls_per_s.new", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "sampler chain",
                              "moves": "chain_windows_per_s", "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cat = Catalog(root, bench)
    plain = run_cell(cat, "new-cell", SEED, 0.2, False, DEVICE)["result"]
    assert plain["correct"] and set(plain["metrics"]) == {"chain_windows_per_s", "setup_s"}
    traced = run_cell(cat, "new-cell", SEED, 0.2, True, DEVICE)["result"]
    assert traced["correct"] and traced["metrics"]["calls_per_s.new"]["value"] > 0
    assert traced["attempted"] > 0


def test_a_variant_is_read_as_its_quantity(tmp_path):
    """``<name>.<variant>`` with no file of its own is read by ``<name>``'s
    reader, and an end-to-end one takes the loop's value of ``<name>``."""
    cat = make_tiny(tmp_path)
    root = cat.root
    spec = json.loads((root / "BENCHMARK.json").read_text())
    e2e = next(m for m in spec["end_to_end"] if m["name"] == "chain_windows_per_s")
    spec["end_to_end"].append(dict(e2e, name="chain_windows_per_s.other", bound=0.2))
    spec["per_layer"].append({"name": "chain_mfu.other", "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "sampler chain",
                              "moves": "chain_windows_per_s.other",
                              "workloads": ["flagship-chain"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cat = Catalog(root, cat.dir)
    assert variants("a.b.c") == ["a.b.c", "a.b", "a"]
    assert cat.reader("chain_mfu.other").__doc__ == cat.reader("chain_mfu").__doc__
    plain = run_cell(cat, "flagship-chain", SEED, 0.2, False, DEVICE)["result"]["metrics"]
    assert plain["chain_windows_per_s.other"] == plain["chain_windows_per_s"]
    traced = run_cell(cat, "flagship-chain", SEED, 0.2, True, DEVICE)["result"]["metrics"]
    assert traced["chain_mfu.other"] == traced["chain_mfu"]
