"""A run with the timed path broken underneath comes out not correct, once
for each fault its cell can have; the control (the reference one precision
below, put in the program's place) comes out not correct too."""

import pytest
import torch

from portbench import faults
from portbench.checks import Check, train_gaps
from portbench.loops.chain import call_key
from portbench.loops.fused_train import reference_steps
from portbench.reference import sampler as rs
from portbench.run import run_cell
from portbench.state import make_state
from portbench.tests.conftest import DEVICE, SEED

TRAIN = ["scaled-fused-train"]


@pytest.mark.parametrize("cell", TRAIN + ["flagship-chain"])
def test_sound_runs_are_correct(tiny, cell):
    assert run_cell(tiny, cell, SEED, 0.2, False, DEVICE)["result"]["correct"]


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "token"])
def test_train_faults_are_caught(tiny, cell, fault):
    with faults.planted(fault):
        out = run_cell(tiny, cell, SEED, 0.2, False, DEVICE)
    assert out["result"]["correct"] is False, out["result"]["checks"]


@pytest.mark.parametrize("fault", ["chain_unlinked", "chain_half", "chain_answer"])
def test_chain_faults_are_caught(tiny, fault):
    with faults.planted(fault):
        out = run_cell(tiny, "flagship-chain", SEED, 0.2, False, DEVICE)
    assert out["result"]["correct"] is False, out["result"]["checks"]


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("seed", [3, 4_000_000_019, 2**31 + 7])
def test_the_fp8_control_is_not_correct(tiny, cell, seed):
    cfg = tiny.config(tiny.cell(cell)["config"])
    from portbench import weights
    from portbench.reference import haploformer as rh

    state = make_state(cfg["deployment"], seed, DEVICE)
    init = weights.make(rh.param_specs(cfg["model"], cfg["sampler"]["seq_length"]), seed, DEVICE)
    _, ref = reference_steps(cfg, state, seed, 3, init, DEVICE)
    _, low = reference_steps(cfg, state, seed, 3, init, DEVICE, precision="fp8")
    checks = [Check(k, v, cfg["limits"][k]) for k, (v, _) in train_gaps(low, ref).items()]
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("seed", [3, 4_000_000_019, 2**31 + 7])
def test_the_threefry12_control_is_not_correct(tiny, seed):
    cfg = tiny.config("haploformer-flagship")
    mix = tiny.traffic("chain_16x256")
    s = cfg["sampler"]
    state = make_state(cfg["deployment"], seed, DEVICE)
    args = (mix["n_chain"], mix["n_batches"], s["batch_size"], s["seq_length"],
            s["max_variants_per_window"], DEVICE)
    for i in range(2):
        key = tuple(int(w) for w in call_key(seed, i))
        assert rs.chain(state, key, *args).digest != rs.chain(state, key, *args, rounds=12).digest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flagship-chain", "scaled-fused-train"])
def test_a_short_run_on_the_card(cell):
    """One short run of the real cell through ``run.py``'s command line."""
    import json
    import subprocess
    import sys

    from portbench.tests.conftest import ROOT

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(SEED), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
