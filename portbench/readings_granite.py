"""Readings that the Granite hybrid cell's limits of ``correct`` are set
from, on the card, at the cell's own size: ``readings_enformer.py``'s train
readings for the ``hybrid_lm_train`` loop.  The benchmark's own runs do not
run it.

    python3 portbench/readings_granite.py --workload granite-hybrid-pair-train \\
        --seeds 1,2,... [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

Each seed's numbers of ``checks.py::train_gaps`` for the program's first
steps against the float32 reference (``grad_gap`` over the moved leaves, as
the loop compares it, and over every leaf), the per-step loss gaps, the
first gradient's norm before the clip and the five leaves whose first
gradient's norm differs most; the control is the fp8 reference
(``reference/granite_hybrid.py``); the fault is half of the batch left out:
the window pair's second sequence dropped (the program trains on a batch of
the first haplotype alone).  The two haplotypes of a window differ at its
heterozygous sites only, so half a batch moves the mean gradient little;
the row gradients, whose second sequence's rows the program then lacks,
read it.  One JSON line a reading on standard output.
"""

from __future__ import annotations

import contextlib
import json
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
    """The train step on the first sequence of the window pair alone."""
    from haplohyped_tpu_torch.models import train as train_mod

    original = train_mod._train_step

    def half(state, hap1, hap2, n_variants, mesh=None, targets=None):
        return original(state, hap1, hap2[:0], n_variants, mesh, targets=targets)

    train_mod._train_step = half
    try:
        yield
    finally:
        train_mod._train_step = original


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="granite-hybrid-pair-train")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    import torch

    from haplohyped_tpu_torch.models.train import make_fused_train_step
    from portbench import common
    from portbench.catalog import Catalog
    from portbench.loops import hybrid_lm_train as loop
    from portbench.readings_enformer import gaps
    from portbench.reference import granite_hybrid as ref_model
    from portbench.run import Ctx
    from portbench.state import make_state

    catalog = Catalog(ROOT)
    cell = catalog.cell(args.workload)
    cfg, mix = catalog.config(cell["config"]), catalog.traffic(cell["traffic"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ctx = Ctx(cfg, mix, 0, 0, False, dev, time.perf_counter())
    n = mix["checked_steps"]
    mcfg = loop.model_config(cfg)
    seeds, control, faults = (_seeds(a) for a in (args.seeds, args.control_seeds,
                                                  args.fault_seeds))
    for seed in sorted(set(seeds) | set(control) | set(faults)):
        t0 = time.perf_counter()
        state = make_state(cfg["deployment"], seed, dev)
        init = ref_model.init(cfg["model"], seed, dev)
        with ctx.reference_precision():
            want, ref = loop.reference_steps(cfg, state, seed, n, init, dev)
        t_ref = time.perf_counter() - t0
        todo = ([("program", None)] if seed in seeds else []) + (
            [("half_batch", half_batch)] if seed in faults else [])
        for what, fault in todo:
            sampler = common.sampler(state, cfg, seed, dev)
            ts = loop.program_model(cfg, mcfg, init, seed, dev)
            fused = make_fused_train_step(sampler)
            with fault() if fault else contextlib.nullcontext():
                ts, prog, seen = loop.first_steps(n, sampler, ts, init, fused)
            diff = sum(int((g.cpu().long() != w.cpu().long()).sum()) if g.shape == w.shape
                       else w.numel() for got, r in zip(seen, want) for g, w in zip(got, r))
            _print(cell_seed=seed, reading=what, windows=diff, program_losses=prog["losses"],
                   reference_losses=ref["losses"],
                   grad_norm_before_clip=ref["grad_norm_before_clip"], **gaps(prog, ref))
            ts = fused = sampler = prog = None
            common.release(dev)
        if seed in control:
            t1 = time.perf_counter()
            with ctx.reference_precision():
                _, low = loop.reference_steps(cfg, state, seed, n, init, dev, precision="fp8")
            _print(cell_seed=seed, reading="control_fp8", program_losses=low["losses"],
                   control_s=time.perf_counter() - t1, **gaps(low, ref))
            low = None
        state = want = ref = None
        common.release(dev)
        common.log(f"seed {seed}: {time.perf_counter() - t0:.2f} s (reference {t_ref:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
