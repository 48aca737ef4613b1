"""Readings that the Enformer cell's limits of ``correct`` are set from, on
the card, at the cell's own size: ``readings.py``'s train readings for the
``enformer_train`` loop.  The benchmark's own runs do not run it.

    python3 portbench/readings_enformer.py --workload enformer-pair-train \\
        --seeds 1,2,... [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

Each seed's numbers of ``checks.py::train_gaps`` for the program's first
steps against the float32 reference (``grad_gap`` over the moved leaves, as
the loop compares it, and ``grad_gap_all`` over every leaf), the per-step loss gaps, the first
gradient's norm before the clip, the median and worst change over the leaves
the gradient moves, and the five leaves whose first gradient's norm differs
most (with the cosine of the program's gradient against the reference's);
the control is the fp8 reference (``reference/enformer.py``); the fault is
half of each batch left out (the program trains on the first window pair,
its targets cut alike).  One JSON line a reading on standard output.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _seeds(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def _print(**kw) -> None:
    print(json.dumps(kw), flush=True)


@contextlib.contextmanager
def half_batch():
    """The train step on the first half of the batch's rows and targets."""
    from haplohyped_tpu_torch.models import train as train_mod

    original = train_mod._train_step

    def half(state, hap1, hap2, n_variants, mesh=None, targets=None):
        h = hap1.shape[0] // 2
        return original(state, hap1[:h], hap2[:h], n_variants[:h], mesh, targets=targets[:h])

    train_mod._train_step = half
    try:
        yield
    finally:
        train_mod._train_step = original


def gaps(prog: dict, ref: dict) -> dict:
    from portbench.checks import TINY_GRAD, _leaf_gaps, _worst, loss_gaps, train_gaps
    from portbench.loops.enformer_train import moved_grad_gap

    g = train_gaps(prog, ref)
    out_all = g["grad_gap"]
    g["grad_gap"] = moved_grad_gap(prog, ref)
    out = {k: v[0] for k, v in g.items()} | {f"{k}_where": v[1] for k, v in g.items()}
    out["loss_gaps"] = loss_gaps(prog, ref)
    med = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= TINY_GRAD * med]
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    out["change_worst_moved"] = list(_worst(change))
    grad = _leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))
    worst = sorted(grad, key=grad.get, reverse=True)[:5]

    def cos(k):
        a, b = (v[k].detach().double().flatten().cpu() for v in (prog["grad_vec"], ref["grad_vec"]))
        return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))

    out["grad_worst"] = [{"leaf": k, "gap": grad[k], "ref_over_median": ref["grad"][k] / med,
                          "cos": cos(k)} for k in worst]
    out["grad_gap_all"] = list(out_all)
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="enformer-pair-train")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    import torch

    from haplohyped_tpu_torch.models.train import make_fused_train_step
    from portbench import common, weights
    from portbench.catalog import Catalog
    from portbench.loops import enformer_train as loop
    from portbench.reference import enformer as ref_model
    from portbench.run import Ctx
    from portbench.state import make_state

    catalog = Catalog(ROOT)
    cell = catalog.cell(args.workload)
    cfg, mix = catalog.config(cell["config"]), catalog.traffic(cell["traffic"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ctx = Ctx(cfg, mix, 0, 0, False, dev, time.perf_counter())
    s, m = cfg["sampler"], cfg["model"]
    B, n = s["batch_size"], mix["checked_steps"]
    seeds, control, faults = (_seeds(a) for a in (args.seeds, args.control_seeds,
                                                  args.fault_seeds))
    for seed in sorted(set(seeds) | set(control) | set(faults)):
        t0 = time.perf_counter()
        state = make_state(cfg["deployment"], seed, dev)
        init = weights.make(ref_model.param_specs(m, cfg["heads"]), seed, dev)
        with ctx.reference_precision():
            want, ref = loop.reference_steps(cfg, state, seed, n, init, dev)
        t_ref = time.perf_counter() - t0
        todo = ([("program", None)] if seed in seeds else []) + (
            [("half_batch", half_batch)] if seed in faults else [])
        for what, fault in todo:
            sampler = common.sampler(state, cfg, seed, dev)
            ts = loop.program_model(cfg, init, seed, dev)

            def targets(step, batch):
                return loop.targets_at(seed, step, B, m["target_length"],
                                       ref_model.tracks(cfg["heads"]), dev)

            fused = make_fused_train_step(sampler, targets=targets)
            with fault() if fault else contextlib.nullcontext():
                ts, prog, seen = loop.first_steps(n, sampler, ts, init, fused)
            diff = sum(int((g.cpu().long() != w.cpu().long()).sum()) if g.shape == w.shape
                       else w.numel() for got, r in zip(seen, want) for g, w in zip(got, r))
            _print(cell_seed=seed, reading=what, windows=diff, program_losses=prog["losses"],
                   reference_losses=ref["losses"], grad_norm_before_clip=ref[
                       "grad_norm_before_clip"], overflowed=[int((w.overflow > 0).sum())
                                                            for w in want], **gaps(prog, ref))
            ts = fused = sampler = None
            common.release(dev)
        if seed in control:
            t1 = time.perf_counter()
            with ctx.reference_precision():
                _, low = loop.reference_steps(cfg, state, seed, n, init, dev, precision="fp8")
            low["output_grads"] = {k: v.cpu() for k, v in low["output_grads"].items()}
            _print(cell_seed=seed, reading="control_fp8", program_losses=low["losses"],
                   control_s=time.perf_counter() - t1, **gaps(low, ref))
        state = want = ref = None
        common.release(dev)
        common.log(f"seed {seed}: {time.perf_counter() - t0:.2f} s (reference {t_ref:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
