"""``examples/torch/01``-``04`` run on the CPU (``--device cpu``; 02 with
``--steps 3``) through the PyTorch port alone.  Each runs in a subprocess
with a ``sitecustomize`` that refuses any import of JAX or of the JAX
package (in the example and in every process it starts), under a timeout of
at most 120 s, with its temporary files under the test's directory."""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
NO_JAX = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "haplohyped_tpu"):
                raise ImportError(f"a PyTorch port example imported {name}")
            return None

    sys.meta_path.insert(0, _NoJax())
""")

EXAMPLES = {
    "01_basic_pipeline": ([], "donor "),
    "02_device_sampler_training": (["--steps", "3"], "trained 3 steps on cpu"),
    "03_sharded_conversion": ([], "variant counts: [1000, 1000, 1000]"),
    "04_multihost_conversion": ([], "smoke OK: merged counts [1000, 1000, 1000]"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu_without_jax(name, tmp_path):
    guard = tmp_path / "guard"
    guard.mkdir()
    (guard / "sitecustomize.py").write_text(NO_JAX)
    (tmp_path / "tmp").mkdir()
    env = dict(os.environ, PYTHONPATH=str(guard), TMPDIR=str(tmp_path / "tmp"))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(var, None)
    args, expect = EXAMPLES[name]
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"), "--device", "cpu", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert expect in out.stdout, out.stdout[-2000:]
    assert "imported jax" not in out.stderr


def test_the_guard_refuses_jax(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(NO_JAX)
    out = subprocess.run([sys.executable, "-c", "import jax"], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)), timeout=60)
    assert out.returncode != 0 and "a PyTorch port example imported jax" in out.stderr
