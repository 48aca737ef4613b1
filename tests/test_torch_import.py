"""The PyTorch port stands alone: no JAX, nothing of ``haplohyped_tpu``,
and no click (the card's machine has none; the port's CLIs are argparse).

Imports are checked in a subprocess, because this test session imports JAX
in-process (``tests/conftest.py``).  The sources of the port and of
``chip_smoke.py`` are also scanned for such imports.
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "haplohyped_tpu_torch"
#: JAX and the JAX package; click, because the card's machine has none and
#: the port's CLIs are argparse
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "haplohyped_tpu", "click")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_leaves_jax_out():
    code = textwrap.dedent("""
        import importlib, json, pkgutil, sys
        import haplohyped_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.splitlines()[-1])
    for name in ("data.sampler", "ops.window_kernel", "ops.decode_kernel", "ops.vcf_decode",
                 "ops.threefry", "ops.draw_kernel",
                 "hostio.native", "hostio.vcf", "hostio.tabix", "hostio.bcf",
                 "pipeline.vcf_to_h5", "storage.fastwrite",
                 "ops.window_lab", "tools.window_kernel_lab", "models.haploformer",
                 "models.train", "core.profiling", "utils.bitpack", "utils.common_utils",
                 "utils.malloc_tune", "hostio.fai", "hostio.fasta", "ops.onehot", "ops.pack",
                 "data.haplotype_dataset", "pipeline.fasta_encoder", "pipeline.doctor",
                 "pipeline.main", "ops.vcf_tokenize", "ops.vcf_stream", "hostio.bgzf",
                 "hostio.writer", "hostio.variants", "parse_vcf", "version", "parallel",
                 "parallel.distributed", "parallel.mesh", "parallel.collectives",
                 "parallel.genome_shard", "parallel.sharded_convert"):
        assert f"haplohyped_tpu_torch.{name}" in res["imported"]
    bad = [m for m in res["modules"] if _forbidden(m)]
    assert bad == []
    # h5py is imported only where a file is read or written
    assert "h5py" not in res["modules"]


def test_native_code_comes_from_the_ports_build_dir():
    """No source of the port loads the JAX package's prebuilt libraries."""
    for path in _sources():
        assert "haplohyped_tpu/_native" not in path.read_text(), path
        assert '"_native"' not in path.read_text(), path


def _sources():
    # the git-ignored build directory holds outputs, not sources
    files = sorted(
        p for p in PORT.rglob("*.py") if "_build" not in p.relative_to(PORT).parts
    ) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("args", [[]] + [["--phase", p] for p in (
    "single_pass", "tokenizer", "reference", "parallel", "long_windows", "batchnorm_gelu",
    "rms_norm")],
    ids=lambda a: " ".join(a) or "all")
def test_chip_smoke_refuses_to_run_without_a_card(tmp_path, args):
    """Without CUDA the smoke script, whole or one phase, exits non-zero and
    prints no result; alone in a directory (without the package) it fails
    too."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "chip_smoke.py", *args], cwd=cwd, capture_output=True,
            text=True, timeout=120, env=os.environ | {"PYTHONPATH": ""},
        )
        assert out.returncode != 0, cwd
        assert '"ok"' not in out.stdout, cwd
        if cwd == ROOT:
            assert "needs an NVIDIA card" in out.stderr, out.stderr
