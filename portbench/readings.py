"""Readings that the limits of ``correct`` are set from, on the card, at a
cell's own size: the program's numbers over many seeds, the control's (the
reference in a lower precision put in the program's place) and the planted
faults' over a few, in one process.  The benchmark's own runs do not run it.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

Train cells: each seed's numbers of ``checks.py::train_gaps`` for the
program's first steps against the float32 reference, the per-step loss
gaps, the median and worst change over every leaf the gradient moves, and,
for the program, a look at the four leaves whose change differs most (each
step's gradient and update on both sides); the control is the fp8
reference (``reference/haploformer.py``); the fault is half of each batch
left out (the program trains on the first half).
Chain cells: the digests of the first calls of each seed from the reference
with threefry cut to 12 rounds against the reference's: every one must
differ.  One JSON line a reading on standard output.
"""

from __future__ import annotations

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


def train_readings(cfg, mix, seeds, control, faults, dev, ctx) -> None:
    from haplohyped_tpu_torch.models.train import make_fused_train_step
    from portbench import common, weights
    from portbench import faults as faults_mod
    from portbench.checks import TINY_GRAD, _leaf_gaps, _worst, loss_gaps, row_grad_gaps, train_gaps
    from portbench.loops.fused_train import _program_model, first_steps, reference_steps
    from portbench.reference import haploformer as ref_model
    from portbench.state import make_state

    s = cfg["sampler"]
    L, B, n = s["seq_length"], s["batch_size"], mix["checked_steps"]

    def steps_gaps(prog, ref):
        gaps = train_gaps(prog, ref)
        out = {k: v[0] for k, v in gaps.items()} | {f"{k}_where": v[1] for k, v in gaps.items()}
        out["loss_gap"] = loss_gaps(prog, ref)[0]
        for k in ("losses", "reg", "ce"):
            out[f"{k}_gap_steps"] = [abs(p - r) / abs(r) for p, r in zip(prog[k], ref[k])]
        # the change over every leaf the gradient moves, for the record
        g_med = statistics.median(ref["grad"].values())
        moved = [k for k, g in ref["grad"].items() if g >= TINY_GRAD * g_med]
        change = _leaf_gaps(prog["change"], ref["change"], moved)
        out["change_median"] = statistics.median(change.values())
        out["change_worst_moved"] = list(_worst(change))
        out["row_grad_gaps"] = row_grad_gaps(prog["output_grads"], ref["output_grads"])
        if "steps" in prog:
            out["look"] = [look(k, prog, ref, v) for k, v in
                           sorted(change.items(), key=lambda kv: -kv[1])[:4]]
        return out

    def look(k, prog, ref, gap):
        """One leaf's steps on both sides: gradient and update norms, the
        cosine of the program's against the reference's and of each step's
        against the first, the first gradient against the later ones, and
        the share of its elements whose update the two sides take in
        opposite signs."""
        def cos(a, b):
            a, b = a.double().flatten(), b.double().flatten().to(a.device)
            return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))

        rg = [st[0][k].cpu() for st in ref["steps"]]
        ru = [st[1][k].cpu() for st in ref["steps"]]
        pg = [st[0][k] for st in prog["steps"]]
        pu = [st[1][k] for st in prog["steps"]]
        return {"leaf": k, "numel": rg[0].numel(), "change_gap": gap,
                "first_grad_over_later": float(rg[0].norm() / max(g.norm() for g in rg[1:])),
                "ref_grad_norm": [float(g.norm()) for g in rg],
                "prog_grad_norm": [float(g.norm()) for g in pg],
                "cos_grad_prog_ref": [cos(a, b) for a, b in zip(pg, rg)],
                "cos_ref_grad_to_first": [cos(g, rg[0]) for g in rg],
                "ref_update_norm": [float(u.norm()) for u in ru],
                "prog_update_norm": [float(u.norm()) for u in pu],
                "cos_update_prog_ref": [cos(a, b) for a, b in zip(pu, ru)],
                "cos_ref_update_to_first": [cos(u, ru[0]) for u in ru],
                "sign_flip_share_update": [float(((a > 0) != (b.to(a.device) > 0)).double().mean())
                                           for a, b in zip(pu, ru)],
                "ref_change": ref["change"][k], "prog_change": prog["change"][k]}

    for seed in sorted(set(seeds) | set(control) | set(faults)):
        t0 = time.perf_counter()
        state = make_state(cfg["deployment"], seed, dev)
        init = weights.make(ref_model.param_specs(cfg["model"], L), seed, dev)
        with ctx.reference_precision():
            want, ref = reference_steps(cfg, state, seed, n, init, dev, keep_steps=True)
        todo = ([("program", None)] if seed in seeds else []) + (
            [("half_batch", "half_batch")] if seed in faults else [])
        for what, fault in todo:
            sampler = common.sampler(state, cfg, seed, dev)
            t1 = time.perf_counter()
            ts = _program_model(cfg, L, B, init, dev)
            t_model = time.perf_counter() - t1
            fused = make_fused_train_step(sampler)
            with faults_mod.planted(fault):
                ts, prog, seen = first_steps(n, sampler, ts, init, fused,
                                             keep_steps=fault is None)
            diff = sum(int((g.cpu().long() != w.cpu().long()).sum()) if g.shape == w.shape
                       else w.numel() for got, r in zip(seen, want) for g, w in zip(got, r))
            _print(cell_seed=seed, reading=what, windows=diff, model_s=t_model,
                   program_losses=prog["losses"], reference_losses=ref["losses"],
                   **steps_gaps(prog, ref))
            ts = fused = sampler = None
            common.release(dev)
        if seed in control:
            with ctx.reference_precision():
                _, low = reference_steps(cfg, state, seed, n, init, dev, precision="fp8")
            _print(cell_seed=seed, reading="control_fp8", program_losses=low["losses"],
                   **steps_gaps(low, ref))
        state = None
        common.release(dev)
        common.log(f"seed {seed}: {time.perf_counter() - t0:.2f} s")


def chain_readings(cfg, mix, control, dev) -> None:
    from portbench.loops.chain import call_key
    from portbench.reference import sampler as ref_sampler
    from portbench.state import make_state

    s = cfg["sampler"]
    for seed in control:
        state = make_state(cfg["deployment"], seed, dev)
        differ = 0
        n = mix["checked_calls"]
        for i in range(n):
            key = tuple(int(w) for w in call_key(seed, i))
            args = (state, key, mix["n_chain"], mix["n_batches"], s["batch_size"],
                    s["seq_length"], s["max_variants_per_window"], dev)
            differ += ref_sampler.chain(*args).digest != ref_sampler.chain(*args, rounds=12).digest
        _print(cell_seed=seed, reading="control_threefry12", digests_differ=differ, of=n)
        state = None


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    import torch

    from portbench.catalog import Catalog
    from portbench.run import Ctx

    catalog = Catalog(ROOT)
    cell = catalog.cell(args.workload)
    cfg, mix = catalog.config(cell["config"]), catalog.traffic(cell["traffic"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ctx = Ctx(cfg, mix, 0, 0, False, dev, time.perf_counter())
    if mix["loop"] == "fused_train":
        train_readings(cfg, mix, _seeds(args.seeds), _seeds(args.control_seeds),
                       _seeds(args.fault_seeds), dev, ctx)
    else:
        chain_readings(cfg, mix, _seeds(args.control_seeds), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
