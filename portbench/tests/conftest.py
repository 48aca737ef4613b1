"""A tiny copy of the benchmark, runnable on the CPU in seconds: the cells of
``BENCHMARK.json`` at toy widths, state and traffic (the harness's look for
a card is skipped by calling ``run_cell`` on the CPU)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.catalog import Catalog  # noqa: E402

TINY_MODEL = {"d_model": 32, "num_heads": 2, "num_layers": 1}
TINY_SAMPLER = {"seq_length": 64, "batch_size": 8, "max_variants_per_window": 2}
TINY_DEPLOYMENT = {"chromosomes": {"chrA": 50_000, "chrB": 30_000}, "n_donors": 4,
                   "snv_per_bp": 0.02, "n_regions": 300}
#: toy-size limits, from ``readings.py`` at this size over a dozen seeds:
#: bf16 on the CPU against float32 reads under half of each (0.0234, 0.0143,
#: 0.0085, 0.0014), the fp8 control 0.039-0.059 on ``grad_sign_share`` and
#: half a batch 1.0 on ``row_grad_gap``
TINY_LIMITS = {"grad_gap": 0.05, "row_grad_gap": 0.3, "grad_sign_share": 0.02, "change_gap": 0.2}
TINY_TRAFFIC = {
    "fused_train": {"log_every": 5, "checked_steps": 3, "warmup_steps": 6, "profile_steps": 2,
                    "host_steps": 3},
    "chain_16x256": {"n_chain": 3, "n_batches": 2, "warmup_calls": 1, "checked_calls": 2,
                     "profile_calls": 1, "replay_calls": 2},
}
SEED = 2**31 + 12345
DEVICE = torch.device("cpu")


def make_tiny(root: Path) -> Catalog:
    """A checkout-like tree at ``root``: ``BENCHMARK.json`` and a copy of
    ``portbench/`` with every configuration and mix cut to toy size."""
    bench = root / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("tests", "_cache", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["model"].update(TINY_MODEL)
        cfg["sampler"].update(TINY_SAMPLER)
        cfg["deployment"] = TINY_DEPLOYMENT
        cfg["limits"] = TINY_LIMITS
        (root / c["file"]).write_text(json.dumps(cfg))
    for name, params in TINY_TRAFFIC.items():
        path = bench / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(params)
        path.write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Catalog(root, bench)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Catalog:
    return make_tiny(tmp_path_factory.mktemp("tiny"))
