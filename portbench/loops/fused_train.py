"""The training loop users run: ``make_fused_train_step(sampler)`` in a
closed loop, as ``train_on_sampler`` runs it.

One trainer calls the next step when the last returns; sampling step ``i``
feeds train step ``i``, so every step trains on windows of its own.  The
loss is fetched to the host every ``log_every`` steps.  The mix file gives:

- ``log_every``: steps between loss fetches;
- ``checked_steps``: the first steps, the ones the reference follows;
- ``warmup_steps``: steps before the window, the checked ones included;
- ``profile_steps``: steps under the profiler in a traced run (right after
  set-up: the profiler loses device ops as a process ages);
- ``host_steps``: steps whose host enqueue time is read, and sampler calls
  timed to a synchronize, in a traced run after the window.

Set-up builds one train state from the benchmark's weights and hands it,
after the checked and warm-up steps, to the window.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import common, counts, trace, weights
from portbench.checks import Check, loss_gaps, mismatches, train_gaps
from portbench.reference import haploformer as ref_model
from portbench.reference import sampler as ref_sampler
from portbench.state import make_state

#: the model's outputs whose gradient ``row_grad_gap`` compares row by row
OUTPUTS = ("variant_count", "base_logits")


def _program_model(cfg: dict, L: int, B: int, init: dict, device):
    from haplohyped_tpu_torch.models.haploformer import HaploFormerConfig
    from haplohyped_tpu_torch.models.train import create_train_state

    shape = torch.empty((B, L), dtype=torch.int8, device=device)
    ts = create_train_state(HaploFormerConfig(**cfg["model"]), (shape, shape),
                            learning_rate=cfg["optimizer"]["learning_rate"], seed=0,
                            device=device)
    named = dict(ts.model.named_parameters())
    if sorted(named) != sorted(init):
        raise RuntimeError(f"the model's leaves {sorted(named)} are not the reference's")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(init[k])
    return ts


def _norms(tensors: dict) -> dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def first_steps(n: int, sampler, ts, init: dict, fused, keep_steps: bool = False) -> tuple:
    """The first ``n`` steps of ``fused`` from ``ts``, through the window's own
    call and feed, sampling steps ``0 .. n - 1``.  Returns ``(ts, prog,
    seen)``: the state, the program's readings (each step's loss; each leaf's
    first gradient, worked out from AdamW's first moment after one step, on
    the host, and its norm; the first step's gradient with respect to the
    model's outputs, row by row, as its backward takes it, on the host; each
    leaf's change norm after the ``n`` steps) and the batches it drew.  With ``keep_steps``,
    ``prog["steps"]`` holds each step's ``(grads, updates)`` on the host."""
    seen = []
    batch_at = sampler.batch_at

    def kept(step, *a, **k):
        b = batch_at(step, *a, **k)
        seen.append(tuple(t.clone() for t in (b.hap1_codes, b.hap2_codes, b.n_variants,
                                               b.overflow)))
        return b

    rows: dict = {}

    def on_forward(module, args, out):
        for k in OUTPUTS:
            out[k].register_hook(lambda g, k=k: rows.__setitem__(k, g.detach().float().cpu()))

    sampler.batch_at = kept
    metrics, grad_vec, steps = [], {}, []
    named = dict(ts.model.named_parameters())
    hook = ts.model.register_forward_hook(on_forward)
    try:
        for i in range(n):
            before = {k: p.detach().clone() for k, p in named.items()} if keep_steps else None
            ts, m = fused(ts, i)
            metrics.append(m)
            if i == 0:
                hook.remove()
                st = ts.optimizer.state
                beta1 = ts.optimizer.param_groups[0]["betas"][0]
                grad_vec = {k: (st[p]["exp_avg"] / (1 - beta1)).cpu()
                            for k, p in named.items() if "exp_avg" in st.get(p, {})}
            if keep_steps:
                steps.append(({k: p.grad.cpu() for k, p in named.items() if p.grad is not None},
                              {k: (p.detach() - before[k]).cpu() for k, p in named.items()}))
    finally:
        hook.remove()
        del sampler.batch_at
    change = _norms({k: p.detach() - init[k] for k, p in named.items()})
    prog = {k: [float(m[name]) for m in metrics]
            for k, name in (("losses", "loss"), ("reg", "reg"), ("ce", "ce"))}
    prog |= {"grad": _norms(grad_vec), "grad_vec": grad_vec, "output_grads": rows,
             "change": change}
    return ts, prog | ({"steps": steps} if keep_steps else {}), seen


def reference_steps(cfg: dict, state, seed: int, n: int, init: dict, device,
                    precision: str = "float32", keep_steps: bool = False) -> tuple:
    """The reference's batches of sampling steps ``0 .. n - 1`` and its ``n``
    training steps from ``init``: ``(windows, readings)``."""
    s = cfg["sampler"]
    want = [ref_sampler.batch(state, seed, i, s["batch_size"], s["seq_length"],
                              s["max_variants_per_window"], device) for i in range(n)]
    return want, ref_model.train(cfg["model"], cfg["optimizer"], init,
                                 [(w.hap1, w.hap2, w.n_variants) for w in want], precision,
                                 keep_steps)


def run(ctx) -> dict:
    from haplohyped_tpu_torch.models.train import make_fused_train_step, make_train_step

    cfg, mix, dev, split = ctx.cfg, ctx.mix, ctx.device, ctx.split
    s = cfg["sampler"]
    L, B = s["seq_length"], s["batch_size"]
    split("build", common.build_kernels, dev)
    state = split("state", make_state, cfg["deployment"], ctx.seed, dev)
    sampler = split("sampler_index", common.sampler, state, cfg, ctx.seed, dev)
    specs = ref_model.param_specs(cfg["model"], L)
    init = split("weights", weights.make, specs, ctx.seed, dev)
    ts = split("model", _program_model, cfg, L, B, init, dev)
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
        ts, m = fused(ts, i)
        if (i + 1) % log_every == 0:
            fetched.append(m["loss"].item())

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
               + "; "
               f"{len(fetched)} losses fetched, last {fetched[-1] if fetched else None}")
    flops = counts.train_flops_per_step(cfg["model"], B, L)
    rec["counts"] = {"steps": steps, "window_s": window_s, "flops_per_step": flops}

    if ctx.trace:
        spans = rec["spans"]
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

    # the reference, once the program's state is gone
    ts = fused = sampler = None
    common.release(dev)
    with ctx.reference_precision():
        want, ref = reference_steps(cfg, state, ctx.seed, mix["checked_steps"], init, dev)
    diff = mismatches((g, w) for got, r in zip(seen, want) for g, w in zip(got, r))
    if len(seen) != len(want):
        diff += 1
    gaps_ = train_gaps(prog, ref)
    lim = cfg["limits"]
    checks = [Check("windows", diff, 0, f"{len(seen)} batches of {B}"),
              Check("nonfinite_losses", nonfinite, 0, f"{len(fetched)} fetched")]
    checks += [Check(k, v, lim[k], where) for k, (v, where) in gaps_.items()]
    common.log(f"program losses {prog['losses']}, reference {ref['losses']}; gaps (logged, "
               f"not compared) {', '.join(f'{g:.3g}' for g in loss_gaps(prog, ref))}")
    return {
        "setup_s": setup_s,
        "end_to_end": {
            "train_windows_per_s": steps * B / window_s,
            "train_step_ms_p95": common.percentile(gaps, 95),
        },
        "attempted": steps, "failed": nonfinite, "memory_peak_bytes": peak,
        "checks": checks, "rec": rec,
    }
