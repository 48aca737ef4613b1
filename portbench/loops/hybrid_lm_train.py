"""The Granite hybrid's training loop: ``make_fused_train_step(sampler)`` in
a closed loop, as ``loops/enformer_train.py`` runs Enformer's.

One trainer calls the next step when the last returns; sampling step ``i``
feeds train step ``i``, whose loss is the next-base cross-entropy over the
batch's own windows (both haplotypes of each).  The loss is fetched to the
host every ``log_every`` steps.  The mix file gives:

- ``log_every``: steps between loss fetches;
- ``checked_steps``: the first steps, the ones the reference follows;
- ``warmup_steps``: steps before the window, the checked ones included;
- ``profile_steps``: steps under the profiler in a traced run (right after
  set-up);
- ``host_steps``: in a traced run after the window, steps under the
  program's ``recording()`` (each span's device ms a step, and the scan's
  calls a step, which divide its spans' time), then sampler calls timed to
  a synchronize and train steps whose host enqueue time is read, as
  ``loops/fused_train.py`` times them.

Set-up builds one train state from the benchmark's weights
(``reference/granite_hybrid.py::init``) and hands it, after the checked and
warm-up steps, to the window.  The reference follows the checked steps in
float32 from the same weights and windows.  ``row_grad_gap`` compares the
loss's gradient with respect to the head's input (the final norm's output),
row by row, as the first step's backward takes it.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import common, counts_granite, trace
from portbench.checks import Check, loss_gaps, mismatches, train_gaps
from portbench.loops.enformer_train import moved_grad_gap
from portbench.reference import granite_hybrid as ref_model
from portbench.reference import sampler as ref_sampler
from portbench.state import make_state

#: the row gradient ``row_grad_gap`` compares: the head's input
OUTPUT = "hidden"


def model_config(cfg: dict):
    """The program's configuration: the file's ``model`` with its
    ``optimizer``'s settings."""
    from haplohyped_tpu_torch.models.granite_hybrid import GraniteHybridConfig

    o = cfg["optimizer"]
    return GraniteHybridConfig(**cfg["model"], adam_betas=tuple(o["betas"]), adam_eps=o["eps"],
                               weight_decay=o["weight_decay"],
                               clip_global_norm=o["clip_global_norm"])


def program_model(cfg: dict, mcfg, init: dict, seed: int, device):
    """The program's train state for the configuration, its leaves set to
    the benchmark's weights."""
    from haplohyped_tpu_torch.models.train import create_train_state

    s = cfg["sampler"]
    shape = torch.empty((s["batch_size"], s["seq_length"]), dtype=torch.int8, device=device)
    ts = create_train_state(mcfg, (shape, shape), learning_rate=cfg["optimizer"]["learning_rate"],
                            seed=seed, device=device)
    named = dict(ts.model.named_parameters())
    if sorted(named) != sorted(init):
        raise RuntimeError(f"the model's leaves {sorted(named)} are not the reference's")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(init[k])
    return ts


def first_steps(n: int, sampler, ts, init: dict, fused) -> tuple:
    """The first ``n`` steps of ``fused`` from ``ts``, through the window's
    own call and feed, sampling steps ``0 .. n - 1``.  Returns ``(ts, prog,
    seen)``: the state, the program's readings (each step's loss; each
    leaf's first gradient, clipped, worked out from AdamW's first moment
    after one step, and its norm; the first step's gradient with respect to
    the head's input; each leaf's change norm after the ``n`` steps) and the
    batches it drew."""
    seen = []
    batch_at = sampler.batch_at

    def kept(step, *a, **k):
        b = batch_at(step, *a, **k)
        seen.append(tuple(t.clone() for t in (b.hap1_codes, b.hap2_codes, b.n_variants,
                                               b.overflow)))
        return b

    rows: dict = {}

    def on_forward(module, args, out):
        out.register_hook(lambda g: rows.__setitem__(OUTPUT, g.detach().float().cpu()))

    sampler.batch_at = kept
    losses, grad_vec = [], {}
    named = dict(ts.model.named_parameters())
    hook = ts.model.norm.register_forward_hook(on_forward)
    try:
        for i in range(n):
            ts, m = fused(ts, i)
            losses.append(float(m["loss"]))
            if i == 0:
                hook.remove()
                st = ts.optimizer.state
                beta1 = ts.optimizer.param_groups[0]["betas"][0]
                grad_vec = {k: (st[p]["exp_avg"] / (1 - beta1)).cpu()
                            for k, p in named.items() if "exp_avg" in st.get(p, {})}
    finally:
        hook.remove()
        del sampler.batch_at
    change = {k: float((p.detach() - init[k]).float().norm()) for k, p in named.items()}
    prog = {"losses": losses, "grad": {k: float(v.norm()) for k, v in grad_vec.items()},
            "grad_vec": grad_vec, "output_grads": rows, "change": change}
    return ts, prog, seen


def reference_steps(cfg: dict, state, seed: int, n: int, init: dict, device,
                    precision: str = "float32") -> tuple:
    """The reference's batches of sampling steps ``0 .. n - 1`` and its ``n``
    training steps from ``init`` on them: ``(windows, readings)``."""
    s = cfg["sampler"]
    want = [ref_sampler.batch(state, seed, i, s["batch_size"], s["seq_length"],
                              s["max_variants_per_window"], device) for i in range(n)]
    return want, ref_model.train(cfg["model"], cfg["optimizer"], init,
                                 [(w.hap1, w.hap2) for w in want], precision)


def _ssd_calls():
    from haplohyped_tpu_torch.ops.ssd_scan import ssd_scan

    return ssd_scan.forward_calls, ssd_scan.backward_calls


def run(ctx) -> dict:
    # the model first: a program without it fails here, before any set-up
    from haplohyped_tpu_torch.core.profiling import recording
    from haplohyped_tpu_torch.models.train import make_fused_train_step, make_train_step

    cfg, mix, dev, split = ctx.cfg, ctx.mix, ctx.device, ctx.split
    mcfg = model_config(cfg)
    s, m = cfg["sampler"], cfg["model"]
    L, B = s["seq_length"], s["batch_size"]
    split("build", common.build_kernels, dev)
    state = split("state", make_state, cfg["deployment"], ctx.seed, dev)
    sampler = split("sampler_index", common.sampler, state, cfg, ctx.seed, dev)
    init = split("weights", ref_model.init, m, ctx.seed, dev)
    ts = split("model", program_model, cfg, mcfg, init, ctx.seed, dev)
    fused = make_fused_train_step(sampler)

    def checked():
        nonlocal ts
        ts, prog, seen = first_steps(mix["checked_steps"], sampler, ts, init, fused)
        return prog, seen

    prog, seen = split("checked_steps", checked)
    log_every = mix["log_every"]
    fetched = []

    def step(i):
        nonlocal ts
        ts, mt = fused(ts, i)
        if (i + 1) % log_every == 0:
            fetched.append(mt["loss"].item())

    def warm():
        for i in range(mix["checked_steps"], mix["warmup_steps"]):
            step(i)
        common.sync(dev)

    split("warmup", warm)
    next_step = mix["warmup_steps"]
    setup_s = time.perf_counter() - ctx.t0
    common.log(split.line())

    rec: dict = {"spans": {}, "counts": {}}
    if ctx.trace:
        first = next_step
        rec["profile"] = trace.capture(lambda i: step(first + i), mix["profile_steps"],
                                       lambda: common.sync(dev))
        next_step += mix["profile_steps"]

    # the window
    fetched.clear()
    marks = common.Marks(dev)
    common.sync(dev)
    marks.mark()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < ctx.seconds:
        step(next_step + steps)
        marks.mark()
        steps += 1
    common.sync(dev)
    window_s = time.perf_counter() - t0
    next_step += steps
    peak = common.memory_peak(dev)
    gaps = marks.gaps_ms()
    nonfinite = sum(not math.isfinite(x) for x in fetched)
    common.log(f"window: {steps} steps of B={B} in {window_s:.4f} s, "
               f"{steps * B / window_s:.4f} windows/s; step ms p10/50/90/95/99/max "
               + "/".join(f"{common.percentile(gaps, q):.3f}" for q in (10, 50, 90, 95, 99, 100))
               + f"; {len(fetched)} losses fetched, last {fetched[-1] if fetched else None}")
    rec["counts"] |= {"steps": steps, "window_s": window_s,
                      "flops_per_step": counts_granite.train_flops_per_step(m, B, L)}
    for k in ("fwd", "bwd"):
        rec["counts"] |= {f"ssd_{k}_bytes": counts_granite.ssd_bytes(m, B, L, k),
                          f"ssd_{k}_flops": counts_granite.ssd_flops(m, B, L, k)}

    if ctx.trace:
        c0 = _ssd_calls()
        with recording() as r:
            for i in range(mix["host_steps"]):
                step(next_step + i)
        c1 = _ssd_calls()
        next_step += mix["host_steps"]
        spans = rec["spans"]
        spans["program"] = {k: v["device_ms"] for k, v in r.totals().items()}
        spans["program_steps"] = mix["host_steps"]
        rec["counts"] |= {"ssd_fwd_calls_a_step": (c1[0] - c0[0]) / mix["host_steps"],
                          "ssd_bwd_calls_a_step": (c1[1] - c0[1]) / mix["host_steps"]}
        spans["batch_at_s"] = []
        for i in range(mix["host_steps"]):
            common.sync(dev)
            t = time.perf_counter()
            sampler.batch_at(next_step + i)
            common.sync(dev)
            spans["batch_at_s"].append(time.perf_counter() - t)
        next_step += mix["host_steps"]
        b = sampler.batch_at(next_step)
        train = make_train_step()
        spans["step_enqueue_s"] = []
        for _ in range(mix["host_steps"]):
            common.sync(dev)
            t = time.perf_counter()
            ts = train(ts, b.hap1, b.hap2, b.n_variants)[0]
            spans["step_enqueue_s"].append(time.perf_counter() - t)
        common.sync(dev)
        b = train = None
        common.log(f"scan calls a step: {rec['counts']['ssd_fwd_calls_a_step']} forward, "
                   f"{rec['counts']['ssd_bwd_calls_a_step']} backward")

    # the reference, once the program's state is gone
    ts = fused = sampler = None
    common.release(dev)
    with ctx.reference_precision():
        want, ref = reference_steps(cfg, state, ctx.seed, mix["checked_steps"], init, dev)
    diff = mismatches((g, w) for got, r_ in zip(seen, want) for g, w in zip(got, r_))
    if len(seen) != len(want):
        diff += 1
    gaps_ = train_gaps(prog, ref) | {"grad_gap": moved_grad_gap(prog, ref)}
    lim = cfg["limits"]
    checks = [Check("windows", diff, 0, f"{len(seen)} batches of {B}"),
              Check("nonfinite_losses", nonfinite, 0, f"{len(fetched)} fetched")]
    checks += [Check(k, v, lim[k], where) for k, (v, where) in gaps_.items()]
    common.log(f"program losses {prog['losses']}, reference {ref['losses']}; gaps (logged, "
               f"not compared) {', '.join(f'{g:.3g}' for g in loss_gaps(prog, ref))}; "
               f"first gradient norm before the clip {ref['grad_norm_before_clip']:.6g}")
    return {
        "setup_s": setup_s,
        "end_to_end": {
            "train_windows_per_s": steps * B / window_s,
            "train_step_ms_p95": common.percentile(gaps, 95),
        },
        "attempted": steps, "failed": nonfinite, "memory_peak_bytes": peak,
        "checks": checks, "rec": rec,
    }
