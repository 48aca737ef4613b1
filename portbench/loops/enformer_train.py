"""Enformer's training loop: ``make_fused_train_step(sampler, targets=...)``
in a closed loop, as ``loops/fused_train.py`` runs HaploFormer's.

One trainer calls the next step when the last returns; sampling step ``i``
feeds train step ``i``, and the step's targets, ``(B, target_length,
tracks)`` log-normal track values ``exp(N(0, 1))``, are drawn on the device
from a generator keyed by (seed, step) inside the fused step, where a
deployment reads its tracks per donor and region.  The loss is fetched to
the host every ``log_every`` steps.  The mix file gives:

- ``log_every``: steps between loss fetches;
- ``checked_steps``: the first steps, the ones the reference follows;
- ``warmup_steps``: steps before the window, the checked ones included;
- ``profile_steps``: steps under the profiler in a traced run (right after
  set-up); their batches' SNVs give the window kernel's bytes;
- ``host_steps``: in a traced run after the window, steps under the
  program's ``recording()`` (each span's device ms a step), then sampler
  calls timed to a synchronize and train steps whose host enqueue time is
  read, as ``loops/fused_train.py`` times them.

Set-up builds one train state from the benchmark's weights (the train
state's dropout generator seeded with the run's seed) and hands it, after
the checked and warm-up steps, to the window.  The reference
(``reference/enformer.py``) follows the checked steps in float32 from the
same weights, windows, targets and dropout masks.  ``grad_gap`` takes the
leaves ``change_gap`` takes (:func:`moved_grad_gap`).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from portbench import common, counts, counts_enformer, trace, weights
from portbench.checks import (
    TINY_GRAD,
    Check,
    _leaf_gaps,
    _worst,
    loss_gaps,
    mismatches,
    train_gaps,
)
from portbench.reference import enformer as ref_model
from portbench.reference import sampler as ref_sampler
from portbench.state import make_state

#: the model's output whose gradient ``row_grad_gap`` compares row by row
OUTPUT = "rates"


def targets_at(seed: int, step: int, B: int, bins: int, tracks: int, device) -> torch.Tensor:
    """Step ``step``'s targets: ``(B, bins, tracks)`` float32 ``exp(N(0, 1))``
    from a generator on ``device`` keyed by (seed, step)."""
    g = torch.Generator(device=device).manual_seed((seed % 2**32) << 31 | step % 2**31)
    return torch.randn((B, bins, tracks), generator=g, device=device).exp_()


def program_model(cfg: dict, init: dict, seed: int, device):
    """The program's train state for the configuration, its leaves set to
    the benchmark's weights, its dropout generator seeded with ``seed``."""
    from haplohyped_tpu_torch.models.enformer import EnformerConfig
    from haplohyped_tpu_torch.models.train import create_train_state

    m, s = cfg["model"], cfg["sampler"]
    shape = torch.empty((s["batch_size"], s["seq_length"]), dtype=torch.int8, device=device)
    ts = create_train_state(EnformerConfig(**m, heads=cfg["heads"]), (shape, shape),
                            learning_rate=cfg["optimizer"]["learning_rate"], seed=seed,
                            device=device)
    named = dict(ts.model.named_parameters())
    if sorted(named) != sorted(init):
        raise RuntimeError(f"the model's leaves {sorted(named)} are not the reference's")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(init[k])
    return ts


def moved_grad_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """``grad_gap`` (each leaf's first-gradient gap over its reference norm
    or the median leaf's, whichever is larger) at its worst over the leaves
    whose first reference gradient is at least ``TINY_GRAD`` of the median
    leaf's, the leaves ``change_gap`` takes.  A conv bias that feeds a batch
    norm has a true gradient of 0, so its gap is round-off over the median
    leaf's norm, reads tens of times any moved leaf's on a sound run, and
    would hide a fault in one of them."""
    med = statistics.median(ref["grad"].values())
    gaps = _leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))
    return _worst({k: g for k, g in gaps.items() if ref["grad"][k] >= TINY_GRAD * med})


def _norms(tensors: dict) -> dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def first_steps(n: int, sampler, ts, init: dict, fused, keep_steps: bool = False) -> tuple:
    """The first ``n`` steps of ``fused`` from ``ts``, through the window's
    own call and feed, sampling steps ``0 .. n - 1``.  Returns ``(ts, prog,
    seen)``: the state, the program's readings (each step's loss; each
    leaf's first gradient, clipped, worked out from Adam's first moment
    after one step, on the host, and its norm; the first step's gradient
    with respect to the pair's rates, as its backward takes it; each leaf's
    change norm after the ``n`` steps) and the batches it drew.  With
    ``keep_steps``, ``prog["steps"]`` holds each step's ``(grads, updates)``
    on the host (the gradients clipped)."""
    seen = []
    batch_at = sampler.batch_at

    def kept(step, *a, **k):
        b = batch_at(step, *a, **k)
        seen.append(tuple(t.clone() for t in (b.hap1_codes, b.hap2_codes, b.n_variants,
                                               b.overflow)))
        return b

    rows: dict = {}

    def on_forward(module, args, out):
        out[OUTPUT].register_hook(lambda g: rows.__setitem__(OUTPUT, g.detach().float().cpu()))

    sampler.batch_at = kept
    losses, grad_vec, steps = [], {}, []
    named = dict(ts.model.named_parameters())
    hook = ts.model.register_forward_hook(on_forward)
    try:
        for i in range(n):
            before = {k: p.detach().clone() for k, p in named.items()} if keep_steps else None
            ts, m = fused(ts, i)
            losses.append(float(m["loss"]))
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
    prog = {"losses": losses, "grad": _norms(grad_vec), "grad_vec": grad_vec,
            "output_grads": rows, "change": change}
    return ts, prog | ({"steps": steps} if keep_steps else {}), seen


def reference_steps(cfg: dict, state, seed: int, n: int, init: dict, device,
                    precision: str = "float32", keep_steps: bool = False) -> tuple:
    """The reference's batches of sampling steps ``0 .. n - 1`` and its ``n``
    training steps from ``init`` on them and their targets: ``(windows,
    readings)``.  Stages are recomputed in the backward on a card."""
    s, m = cfg["sampler"], cfg["model"]
    B = s["batch_size"]
    want = [ref_sampler.batch(state, seed, i, B, s["seq_length"],
                              s["max_variants_per_window"], device) for i in range(n)]
    tracks = ref_model.tracks(cfg["heads"])
    batches = [(w.hap1, w.hap2, targets_at(seed, i, B, m["target_length"], tracks, device))
               for i, w in enumerate(want)]
    return want, ref_model.train(m, cfg["heads"], cfg["optimizer"], init, batches, seed, device,
                                 precision, keep_steps, checkpoint=device.type == "cuda")


def run(ctx) -> dict:
    from haplohyped_tpu_torch.core.profiling import recording
    from haplohyped_tpu_torch.models.enformer import Enformer  # noqa: F401 (fails fast without it)
    from haplohyped_tpu_torch.models.train import make_fused_train_step, make_train_step

    cfg, mix, dev, split = ctx.cfg, ctx.mix, ctx.device, ctx.split
    s, m = cfg["sampler"], cfg["model"]
    L, B, K = s["seq_length"], s["batch_size"], s["max_variants_per_window"]
    bins, tracks = m["target_length"], ref_model.tracks(cfg["heads"])
    split("build", common.build_kernels, dev)
    state = split("state", make_state, cfg["deployment"], ctx.seed, dev)
    sampler = split("sampler_index", common.sampler, state, cfg, ctx.seed, dev)
    init = split("weights", weights.make, ref_model.param_specs(m, cfg["heads"]), ctx.seed, dev)
    ts = split("model", program_model, cfg, init, ctx.seed, dev)
    #: the profiled steps' ``n_variants``, for the window kernel's bytes
    profiled: list | None = None

    def targets(step_idx, batch):
        if profiled is not None:
            profiled.append(batch.n_variants)
        return targets_at(ctx.seed, step_idx, B, bins, tracks, dev)

    fused = make_fused_train_step(sampler, targets=targets)

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
    snvs = None
    if ctx.trace:
        first = next_step
        profiled = []
        rec["profile"] = trace.capture(lambda i: step(first + i), mix["profile_steps"],
                                       lambda: common.sync(dev))
        snvs = sum(int(nv.clamp(max=K).sum()) for nv in profiled) / len(profiled)
        profiled = None
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
    rec["counts"] = {"steps": steps, "window_s": window_s,
                     "flops_per_step": counts_enformer.train_flops_per_step(m, cfg["heads"], B)}
    if snvs is not None:
        rec["counts"]["window_bytes"] = counts.link_bytes(B, L, snvs)

    if ctx.trace:
        with recording() as r:
            for i in range(mix["host_steps"]):
                step(next_step + i)
        next_step += mix["host_steps"]
        spans = rec["spans"]
        spans["program"] = {k: v["device_ms"] for k, v in r.totals().items()}
        spans["program_steps"] = mix["host_steps"]
        spans["batch_at_s"] = []
        for i in range(mix["host_steps"]):
            common.sync(dev)
            t = time.perf_counter()
            sampler.batch_at(next_step + i)
            common.sync(dev)
            spans["batch_at_s"].append(time.perf_counter() - t)
        next_step += mix["host_steps"]
        b = sampler.batch_at(next_step)
        y = targets_at(ctx.seed, next_step, B, bins, tracks, dev)
        train = make_train_step()
        spans["step_enqueue_s"] = []
        for _ in range(mix["host_steps"]):
            common.sync(dev)
            t = time.perf_counter()
            ts = train(ts, b.hap1, b.hap2, b.n_variants, targets=y)[0]
            spans["step_enqueue_s"].append(time.perf_counter() - t)
        common.sync(dev)
        b = y = train = None

    # the reference, once the program's state is gone
    ts = fused = sampler = None
    common.release(dev)
    with ctx.reference_precision():
        want, ref = reference_steps(cfg, state, ctx.seed, mix["checked_steps"], init, dev)
    diff = mismatches((g, w) for got, r_ in zip(seen, want) for g, w in zip(got, r_))
    if len(seen) != len(want):
        diff += 1
    overflowed = sum(int((w.overflow > 0).sum()) for w in want)
    gaps_ = train_gaps(prog, ref) | {"grad_gap": moved_grad_gap(prog, ref)}
    lim = cfg["limits"]
    checks = [Check("windows", diff, 0, f"{len(seen)} batches of {B}; {overflowed} windows "
                    f"overflowed K={K}"),
              Check("nonfinite_losses", nonfinite, 0, f"{len(fetched)} fetched")]
    checks += [Check(k, v, lim[k], where) for k, (v, where) in gaps_.items()]
    common.log(f"program losses {prog['losses']}, reference {ref['losses']}; gaps (logged, "
               f"not compared) {', '.join(f'{g:.3g}' for g in loss_gaps(prog, ref))}; "
               f"first gradient norm before the clip {ref['grad_norm_before_clip']:.6g}; "
               f"{overflowed} of {len(want) * B} checked windows overflowed K={K}")
    return {
        "setup_s": setup_s,
        "end_to_end": {
            "train_windows_per_s": steps * B / window_s,
            "train_step_ms_p95": common.percentile(gaps, 95),
        },
        "attempted": steps, "failed": nonfinite, "memory_peak_bytes": peak,
        "checks": checks, "rec": rec,
    }
