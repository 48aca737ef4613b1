"""The port's doctor, umbrella CLI, malloc tuning and profiling hooks.

On a machine without a card the doctor's card and ``nvcc`` checks report ✗,
so the tests assert on the names of every check and on the host checks.
"""

import ctypes
import ctypes.util
import os
import sys
import tomllib

import pytest
import torch

from haplohyped_tpu_torch.core.profiling import annotate, trace
from haplohyped_tpu_torch.pipeline import doctor
from haplohyped_tpu_torch.pipeline import main as cli
from haplohyped_tpu_torch.pipeline import vcf_to_h5
from haplohyped_tpu_torch.utils import malloc_tune

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CHECKS = ("native hostio", "blosc filter", "h5py/HDF5", "decode sanity")


def test_doctor_runs_every_check():
    checks = doctor.run_checks()
    assert [c[0] for c in checks] == list(doctor.CHECKS)
    status = {name: (ok, detail) for name, ok, detail in checks}
    for name in HOST_CHECKS:
        assert status[name][0], (name, status[name][1])
    if not torch.cuda.is_available():
        assert not status["cuda card"][0] and "is_available" in status["cuda card"][1]
        assert not status["nvcc kernels"][0]


def test_doctor_cli_reports_and_sets_the_exit_code(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: every check may pass")
    with pytest.raises(SystemExit) as exc:
        cli.main(["doctor"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "✓ native hostio" in out and "✗ cuda card" in out
    assert "all checks passed" not in out


def test_umbrella_cli_subcommands(capsys):
    assert list(cli.COMMANDS) == ["vcf_to_h5", "fasta_encoder", "doctor", "faidx"]
    with pytest.raises(SystemExit) as exc:
        cli.main(["nope"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        cli.main(["vcf_to_h5", "--help"])
    assert exc.value.code == 0 and "--cohort_name" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main([])


def test_console_script_is_declared():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["haplohyped_torch"] == "haplohyped_tpu_torch.pipeline.main:main"


def test_tune_malloc_is_idempotent():
    first = malloc_tune.tune_malloc()
    assert malloc_tune.tune_malloc() == first
    if sys.platform.startswith("linux") and ctypes.util.find_library("c"):
        assert first


def test_prefault_arena_covers_the_largest_request():
    malloc_tune.tune_malloc()
    base = malloc_tune._prefaulted_bytes
    t = malloc_tune.prefault_arena(base + (8 << 20))
    assert t is not None
    t.join(timeout=60)
    assert not t.is_alive()
    assert malloc_tune._prefaulted_bytes == base + (8 << 20)
    assert malloc_tune.prefault_arena(base + (4 << 20)) is None  # already covered
    assert malloc_tune.prefault_arena(base + (9 << 20), background=False) is None
    assert malloc_tune._prefaulted_bytes == base + (9 << 20)
    assert isinstance(malloc_tune.enable_thp(), bool)


@pytest.mark.parametrize("gz_bytes,want", [(0, None), (1024, 64 << 20), (20 << 20, 200 << 20)])
def test_converter_tunes_malloc_at_construction(tmp_path, monkeypatch, gz_bytes, want):
    """As the JAX constructor: ``tune_malloc()``, then a prefault of ten
    times the inputs' compressed bytes, at least 64 MiB and at most 1.5 GiB."""
    calls = []
    monkeypatch.setattr(vcf_to_h5, "tune_malloc", lambda: calls.append("tune"))
    monkeypatch.setattr(vcf_to_h5, "prefault_arena", calls.append)
    if gz_bytes:
        with open(tmp_path / "chr22.filtered.vcf.gz", "wb") as f:
            f.truncate(gz_bytes)
    samples = tmp_path / "s.txt"
    samples.write_text("a\n")
    vcf_to_h5.VCFtoHDF5Converter("c", str(tmp_path), str(tmp_path / "o"), str(samples), 1, 1,
                                 chromosomes=[21, 22], device="cpu")
    assert calls == (["tune"] if want is None else ["tune", want])


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        with annotate("hh_region"):
            torch.ones(16).sum()
    assert os.path.exists(tmp_path / "t" / "trace.json")
    assert "hh_region" in {e.key for e in prof.key_averages()}
    with trace(None) as prof:
        assert prof is None
    with trace("") as prof:
        assert prof is None
