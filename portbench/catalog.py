"""Everything the harness knows about a cell, found by name.

``BENCHMARK.json`` (at the checkout's root) names the cells, their
configuration and traffic, and the metrics.  Each configuration is
``configs/<config>.json``, each traffic mix ``traffic/<traffic>.json`` (its
``loop`` names the generator in ``loops/`` that reads it), and each
per-layer metric a reader ``layer_metrics/<metric>.py`` whose ``read(rec)``
returns a number, or None where the run has nothing for it to read.  A new
cell, configuration, mix or metric is a new file and a new entry; no file
here changes.

A metric named ``<name>.<variant>`` is the quantity ``<name>`` under a name
of its own: an end-to-end one for cells whose runs spread differently and
need a bound of their own, a per-layer one for cells that report another
end-to-end metric.  With no reader of its own, it is read by ``<name>``'s
(an end-to-end one takes the value the loop gives ``<name>``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def variants(name: str) -> list[str]:
    """``name``, then ``name`` with each trailing ``.<variant>`` taken off:
    ``a.b.c`` gives ``a.b.c``, ``a.b``, ``a``."""
    parts = name.split(".")
    return [".".join(parts[:i]) for i in range(len(parts), 0, -1)]


def value_of(name: str, values: dict):
    """The value a loop gives metric ``name`` or the quantity it is a
    variant of."""
    for n in variants(name):
        if n in values:
            return values[n]
    raise KeyError(f"the loop gives no value for {name!r}")


class Catalog:
    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, kind: str, cell: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
        return [m for m in self.bench[kind] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """``read(rec)`` of ``layer_metrics/<metric>.py``, or of the first
        file found with a trailing ``.<variant>`` taken off the name."""
        name = next((n for n in variants(metric)
                     if (self.dir / "layer_metrics" / f"{n}.py").is_file()), metric)
        path = self.dir / "layer_metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
