"""Readings that the Nemotron-H hybrid cell's limits of ``correct`` are set
from, on the card, at the cell's own size: ``readings_granite.py``'s train
readings for the ``moe_hybrid_lm_train`` loop, with ``route_mismatch_share``
and the faults the MoE layer and the grouped kernels can make.  The
benchmark's own runs do not run it.

    python3 portbench/readings_nemotron.py --workload nemotron-moe-pair-train \\
        --seeds 1,2,... [--control-seeds 1,2] [--fault-seeds 1,2] [--faults a,b]

Each seed's numbers of ``loops/moe_hybrid_lm_train.py::checks`` for the
program's first steps against the float32 reference routed by the
program's selections, the per-step loss gaps, the first gradient's norm
before the clip and the five leaves whose first gradient's norm differs
most.  The control is the fp8 reference (``reference/nemotron_h.py``)
routing by its own selections, against the float32 reference routed by
them.  The faults (:data:`FAULTS`) are the program with one piece of the
model's arithmetic done wrong:

- ``half_batch``: the window pairs' second haplotypes dropped;
- ``bias_ignored``: the router selects by its scores alone;
- ``softmax_router``: softmax scores in place of the sigmoid;
- ``no_renorm``: the selected scores not renormalised over the slots;
- ``scale_one``: the slot weights not scaled by ``routed_scaling_factor``;
- ``expert_dropped``: the first held expert's slots add nothing;
- ``scan_one_group``: every head of the scan reads the first group's ``B``
  and ``C``;
- ``norm_whole_row``: the mixers' gated norm over the whole row, not each
  group.

One JSON line a reading on standard output.
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
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def half_batch():
    """The train step on the first haplotype of each window pair alone."""
    from haplohyped_tpu_torch.models import train as train_mod

    original = train_mod._train_step

    def half(state, hap1, hap2, n_variants, mesh=None, targets=None):
        return original(state, hap1, hap2[:0], n_variants, mesh, targets=targets)

    return _patched(train_mod, "_train_step", half)


def bias_ignored():
    from haplohyped_tpu_torch.models import moe

    select = moe.select
    return _patched(moe, "select", lambda s, bias, k: select(s, bias * 0, k))


def softmax_router():
    import torch
    import torch.nn.functional as F

    from haplohyped_tpu_torch.models import moe

    def softmax(x, weight):
        return torch.softmax(F.linear(x.to(weight.dtype), weight), dim=-1)

    return _patched(moe, "router_scores", softmax)


def no_renorm():
    from haplohyped_tpu_torch.models import moe

    return _patched(moe, "slot_weights", lambda s, chosen, scale: s.gather(1, chosen) * scale)


def scale_one():
    from haplohyped_tpu_torch.models import moe

    weights = moe.slot_weights
    return _patched(moe, "slot_weights", lambda s, chosen, scale: weights(s, chosen, 1.0))


def expert_dropped():
    import torch

    from haplohyped_tpu_torch.models import moe

    linear = moe.grouped_linear

    def dropped(x, weight, counts, offs):
        y = linear(x, weight, counts, offs)
        keep = torch.arange(y.shape[0], device=y.device) >= counts[0]
        return y * keep[:, None].to(y.dtype)

    return _patched(moe, "grouped_linear", dropped)


def scan_one_group():
    from haplohyped_tpu_torch.models import hybrid_layers

    scan = hybrid_layers.ssd_scan

    def first_group(x, dt, A, B, C, D, chunk):
        return scan(x, dt, A, B[:, :, :1].contiguous(), C[:, :, :1].contiguous(), D, chunk)

    return _patched(hybrid_layers, "ssd_scan", first_group)


def norm_whole_row():
    from haplohyped_tpu_torch.models import hybrid_layers

    norm = hybrid_layers.rms_norm
    return _patched(hybrid_layers, "rms_norm",
                    lambda x, w, eps, gate=None, group=None: norm(x, w, eps, gate))


#: the faults, by name: each a context under which the program computes wrong
FAULTS = {f.__name__: f for f in (half_batch, bias_ignored, softmax_router, no_renorm, scale_one,
                                  expert_dropped, scan_one_group, norm_whole_row)}


def numbers(cfg: dict, prog: dict, ref: dict, windows: int = 0) -> dict:
    """Every number the loop compares, by name, and the readings around
    them."""
    from portbench.loops import moe_hybrid_lm_train as loop
    from portbench.readings_enformer import gaps

    out = gaps(prog, ref)
    out["route_mismatch_share"] = loop.route_mismatch_share(
        prog["selections"], ref["own"], cfg["model"]["n_routed_experts"])
    failed = [c.name for c in loop.checks(cfg, prog, ref, windows, 0, 0, 1) if not c.ok]
    return out | {"failed": failed}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="nemotron-moe-pair-train")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default=",".join(FAULTS))
    args = p.parse_args(argv)
    import torch

    from haplohyped_tpu_torch.models.train import make_fused_train_step
    from portbench import common
    from portbench.catalog import Catalog
    from portbench.loops import moe_hybrid_lm_train as loop
    from portbench.reference import nemotron_h as ref_model
    from portbench.run import Ctx
    from portbench.state import make_state

    catalog = Catalog(ROOT)
    cell = catalog.cell(args.workload)
    cfg, mix = catalog.config(cell["config"]), catalog.traffic(cell["traffic"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ctx = Ctx(cfg, mix, 0, 0, False, dev, time.perf_counter())
    n = mix["checked_steps"]
    mcfg = loop.model_config(cfg)
    seeds, control, fault_seeds = (_seeds(a) for a in (args.seeds, args.control_seeds,
                                                       args.fault_seeds))
    faults = [f for f in args.faults.split(",") if f]
    for seed in sorted(set(seeds) | set(control) | set(fault_seeds)):
        t0 = time.perf_counter()
        state = make_state(cfg["deployment"], seed, dev)
        init = ref_model.init(cfg["model"], seed, dev)
        todo = ([("program", None)] if seed in seeds else []) + (
            [(f, FAULTS[f]) for f in faults] if seed in fault_seeds else [])
        for what, fault in todo:
            sampler = common.sampler(state, cfg, seed, dev)
            ts = loop.program_model(cfg, mcfg, init, seed, dev)
            fused = make_fused_train_step(sampler)
            with fault() if fault else contextlib.nullcontext():
                ts, prog, seen = loop.first_steps(n, sampler, ts, init, fused)
            ts = fused = sampler = None
            common.release(dev)
            t1 = time.perf_counter()
            with ctx.reference_precision():
                want, ref = loop.reference_steps(cfg, state, seed, n, init, dev,
                                                 selections=prog["selections"])
            diff = sum(int((g.cpu().long() != w.cpu().long()).sum()) if g.shape == w.shape
                       else w.numel() for got, r in zip(seen, want) for g, w in zip(got, r))
            _print(cell_seed=seed, reading=what, windows=diff, program_losses=prog["losses"],
                   reference_losses=ref["losses"], reference_s=time.perf_counter() - t1,
                   grad_norm_before_clip=ref["grad_norm_before_clip"],
                   **numbers(cfg, prog, ref, diff))
            prog = ref = want = None
            common.release(dev)
        if seed in control:
            t1 = time.perf_counter()
            with ctx.reference_precision():
                _, low = loop.reference_steps(cfg, state, seed, n, init, dev, precision="fp8")
                _, ref = loop.reference_steps(cfg, state, seed, n, init, dev,
                                              selections=low["used"])
            low["selections"] = low["used"]
            _print(cell_seed=seed, reading="control_fp8", program_losses=low["losses"],
                   control_s=time.perf_counter() - t1, **numbers(cfg, low, ref))
            low = ref = None
        state = None
        common.release(dev)
        common.log(f"seed {seed}: {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
