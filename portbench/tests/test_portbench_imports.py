"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program; no benchmark file reads the JAX-era bench."""

import json
import os
import subprocess
import sys
import textwrap

from portbench.run import FORBIDDEN, forbidden_modules
from portbench.tests.conftest import ROOT


def _in_child(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_tiny_run_loads_no_jax(tmp_path):
    got = _in_child(f"""
        import json, sys
        from pathlib import Path
        import torch
        from portbench.tests.conftest import make_tiny
        from portbench.run import run_cell, forbidden_modules
        cat = make_tiny(Path({str(tmp_path)!r}))
        for cell in ("scaled-fused-train", "flagship-chain"):
            assert run_cell(cat, cell, 7, 0.2, False, torch.device("cpu"))["result"]["correct"]
        print(json.dumps({{"bad": forbidden_modules(),
                          "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
    """)
    assert got["bad"] == []
    assert "haplohyped_tpu_torch" in got["top"] and not set(got["top"]) & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    got = _in_child("""
        import json, sys
        import portbench.reference.sampler, portbench.reference.haploformer
        import portbench.counts, portbench.weights, portbench.state, portbench.checks
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert not {"haplohyped_tpu_torch", "haplohyped_tpu", "jax"} & set(got)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "haplohyped_tpu_torch.x", sys)
    monkeypatch.setitem(sys.modules, "jaxy", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    monkeypatch.setitem(sys.modules, "haplohyped_tpu", sys)
    assert forbidden_modules() == ["haplohyped_tpu", "jaxlib"]


def test_no_benchmark_file_reads_the_jax_bench():
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for word in ("bench.py", "benchmarks/", "BENCH_", "import jax", "haplohyped_tpu."):
            assert word not in text, (path, word)
