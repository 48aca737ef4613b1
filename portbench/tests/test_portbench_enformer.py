"""The Enformer cell at toy size on the CPU: its run, its checks and its
result line.  The model against the reference, the readers and the frozen
FLOP count have their tests in ``tests/test_torch_enformer.py`` and
``tests/test_torch_tracing.py``."""

import json

import pytest

from portbench.catalog import Catalog
from portbench.run import run_cell
from portbench.tests.conftest import DEVICE, ROOT, SEED, TINY_DEPLOYMENT, make_tiny

CELL = "enformer-pair-train"
#: the published model at toy widths: 64 channels, 2 blocks of 2 heads,
#: 8,192-bp windows (64 tokens), 32 target bins, 7 tracks
TINY_ENFORMER = {"channels": 64, "num_transformer_layers": 2, "num_heads": 2, "key_size": 8,
                 "value_size": 32, "num_relative_position_features": 12, "divisible_by": 16,
                 "sequence_length": 8192, "target_length": 32}
TINY_HEADS = {"human": 7}
#: toy-size limits: bf16 on the CPU against float32 reads under half of
#: each over 16 seeds (at most 0.088, 0.016, 0.056 and 0.0096; the batch
#: norms' scales and biases take the largest gradient gaps)
TINY_LIMITS = {"grad_gap": 0.2, "row_grad_gap": 0.05, "grad_sign_share": 0.12, "change_gap": 0.03}
#: the cell's per-layer metrics that read the host's clock, and so read on
#: the CPU too
HOST_CLOCK = ("train_mfu", "sample_ms.train", "step_host_ms.train")
TINY_MIX = {"log_every": 2, "checked_steps": 3, "warmup_steps": 4, "profile_steps": 2,
            "host_steps": 2}


def _config() -> dict:
    return json.loads((ROOT / "portbench/configs/enformer-human-196k.json").read_text())


def make_tiny_enformer(root) -> Catalog:
    """The benchmark's tiny tree with the Enformer configuration and mix at
    toy size."""
    cat = make_tiny(root)
    cfg = _config()
    cfg["model"].update(TINY_ENFORMER)
    cfg["heads"] = TINY_HEADS
    cfg["sampler"] = {"seq_length": 8192, "batch_size": 2, "max_variants_per_window": 512}
    cfg["deployment"] = TINY_DEPLOYMENT
    cfg["limits"] = TINY_LIMITS
    (cat.root / "portbench/configs/enformer-human-196k.json").write_text(json.dumps(cfg))
    path = cat.dir / "traffic" / "enformer_train.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY_MIX}))
    return Catalog(cat.root, cat.dir)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Catalog:
    return make_tiny_enformer(tmp_path_factory.mktemp("tiny_enformer"))


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_at_toy_size(tiny, trace):
    out = run_cell(tiny, CELL, SEED, 0.3, trace, DEVICE)["result"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"windows", "nonfinite_losses", "grad_gap", "row_grad_gap",
                                  "grad_sign_share", "change_gap"}
    metrics = out["metrics"]
    if trace:
        # the CPU has no device clock: only the host-clock metrics read
        assert set(metrics) == set(HOST_CLOCK)
        assert 0 < metrics["train_mfu"]["value"] < 100
        assert all(metrics[k]["value"] > 0 for k in HOST_CLOCK)
    else:
        assert set(metrics) == {"train_windows_per_s", "train_step_ms_p95", "setup_s"}
    json.dumps(out)


def test_grad_gap_leaves_out_the_leaves_the_gradient_does_not_move():
    """A leaf whose reference gradient is round-off (a conv bias before a
    batch norm) reads a large gap and is left out; a fault in a moved leaf
    is seen, against the median leaf's norm."""
    from portbench.loops.enformer_train import moved_grad_gap

    ref = {"grad": {"a": 1.0, "b": 2.0, "c": 4.0, "bias": 1e-9}}
    prog = {"grad": {"a": 1.01, "b": 2.0, "c": 4.0, "bias": 0.5}}
    assert moved_grad_gap(prog, ref) == (pytest.approx(0.01 / 1.5), "a")
    prog["grad"]["c"] = 4.0 * 1.3
    assert moved_grad_gap(prog, ref) == (pytest.approx(0.3), "c")

