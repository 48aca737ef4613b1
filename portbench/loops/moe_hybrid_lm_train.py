"""The Nemotron-H hybrid's training loop: ``make_fused_train_step(sampler)``
in a closed loop, as ``loops/hybrid_lm_train.py`` runs the Granite hybrid's.

One trainer calls the next step when the last returns; sampling step ``i``
feeds train step ``i``, whose loss is the next-base cross-entropy over the
batch's own windows (both haplotypes of each).  The loss is fetched to the
host every ``log_every`` steps.  The mix file's keys are the Granite loop's.

Set-up builds one train state from the benchmark's weights and router
biases (``reference/nemotron_h.py::init``) and hands it, after the checked
and warm-up steps, to the window.  The checked steps record the program's
selections, layer by layer; the reference follows them in float32 from the
same weights and windows, routing by those selections and recomputing their
weights from its own scores, and makes its own beside them.

The checks are the Granite cell's four train numbers, each routed expert
of a stacked leaf (``experts.up_proj``, ``experts.down_proj``) counted as a
leaf of its own (``reference/nemotron_h.py::split_experts``), and
``route_mismatch_share``: the share of the checked steps' (token, slot)
pairs whose expert is not among the reference's own selection for the
token.

The train FLOPs a step (``train_mfu``) count the held experts' products at
the window's own ``moe.held_slots`` a step.  A traced run's ``recording()``
block after the window also counts the held experts' product calls (the
span ``hh.moe.experts``: a MoE call that routes no slot here runs none) and
held slots, for ``experts_fwd_roofline.nemotron``.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from portbench import common, counts_nemotron, trace
from portbench.checks import Check, loss_gaps, mismatches, train_gaps
from portbench.loops.enformer_train import moved_grad_gap
from portbench.loops.hybrid_lm_train import _ssd_calls
from portbench.reference import nemotron_h as ref_model
from portbench.reference import sampler as ref_sampler
from portbench.state import make_state


def model_config(cfg: dict):
    """The program's configuration: the file's ``model`` with its
    ``optimizer``'s settings."""
    from haplohyped_tpu_torch.models.nemotron_h import NemotronHConfig

    o = cfg["optimizer"]
    return NemotronHConfig(**cfg["model"], adam_betas=tuple(o["betas"]), adam_eps=o["eps"],
                           weight_decay=o["weight_decay"], clip_global_norm=o["clip_global_norm"])


def program_model(cfg: dict, mcfg, init: dict, seed: int, device):
    """The program's train state for the configuration, its leaves and
    router biases set to the benchmark's."""
    from haplohyped_tpu_torch.models.train import create_train_state

    s = cfg["sampler"]
    shape = torch.empty((s["batch_size"], s["seq_length"]), dtype=torch.int8, device=device)
    ts = create_train_state(mcfg, (shape, shape), learning_rate=cfg["optimizer"]["learning_rate"],
                            seed=seed, device=device)
    state = ts.model.state_dict()
    if sorted(state) != sorted(init):
        raise RuntimeError(f"the model's state {sorted(state)} is not the reference's")
    with torch.no_grad():
        for k, t in state.items():
            t.copy_(init[k])
    return ts


@contextlib.contextmanager
def recorded_selections(into: list):
    """Each MoE forward's selection appended to ``into`` (on the host)."""
    from haplohyped_tpu_torch.models import moe

    select = moe.select

    def record(scores, bias, top_k):
        out = select(scores, bias, top_k)
        into.append(out.detach().cpu())
        return out

    moe.select = record
    try:
        yield
    finally:
        moe.select = select


def first_steps(n: int, sampler, ts, init: dict, fused) -> tuple:
    """The first ``n`` steps of ``fused`` from ``ts``, through the window's
    own call and feed, sampling steps ``0 .. n - 1``.  Returns ``(ts, prog,
    seen)``: the state, the program's readings (each step's loss; each
    leaf's first gradient, clipped, worked out from AdamW's first moment
    after one step, and its norm, the experts' stacks split; the first
    step's gradient with respect to the head's input; each leaf's change norm
    after the ``n`` steps; each step's selections by layer) and the batches
    it drew."""
    seen = []
    batch_at = sampler.batch_at
    layers = [i for i, layer in enumerate(ts.model.layers) if layer.kind == "moe"]

    def kept(step, *a, **k):
        b = batch_at(step, *a, **k)
        seen.append(tuple(t.clone() for t in (b.hap1_codes, b.hap2_codes, b.n_variants,
                                               b.overflow)))
        return b

    rows: dict = {}

    def on_forward(module, args, out):
        out.register_hook(lambda g: rows.__setitem__("hidden", g.detach().float().cpu()))

    sampler.batch_at = kept
    losses, grad_vec, selections = [], {}, []
    named = dict(ts.model.named_parameters())
    hook = ts.model.norm_f.register_forward_hook(on_forward)
    try:
        for i in range(n):
            got: list = []
            with recorded_selections(got):
                ts, m = fused(ts, i)
            selections.append(dict(zip(layers, got)))
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
    grad_vec = ref_model.split_experts(grad_vec)
    change = ref_model.split_experts({k: (p.detach() - init[k]).float()
                                      for k, p in named.items()})
    prog = {"losses": losses, "grad": {k: float(v.norm()) for k, v in grad_vec.items()},
            "grad_vec": grad_vec, "output_grads": rows,
            "change": {k: float(v.norm()) for k, v in change.items()},
            "selections": selections}
    return ts, prog, seen


def reference_steps(cfg: dict, state, seed: int, n: int, init: dict, device,
                    precision: str = "float32", selections: list | None = None) -> tuple:
    """The reference's batches of sampling steps ``0 .. n - 1`` and its ``n``
    training steps from ``init`` on them, routed by ``selections`` (None:
    its own): ``(windows, readings)``, the experts' stacks split."""
    s = cfg["sampler"]
    want = [ref_sampler.batch(state, seed, i, s["batch_size"], s["seq_length"],
                              s["max_variants_per_window"], device) for i in range(n)]
    out = ref_model.train(cfg["model"], cfg["optimizer"], init,
                          [(w.hap1, w.hap2) for w in want], precision, selections)
    out["grad_vec"] = ref_model.split_experts(out["grad_vec"])
    out["grad"] = {k: float(v.norm()) for k, v in out["grad_vec"].items()}
    return want, out


def route_mismatch_share(got: list, want: list, n_experts: int) -> float:
    """The share of the (token, slot) pairs of ``got`` (a step's
    ``{layer: (tokens, k)}``) whose expert is not among ``want``'s for the
    token; a step or layer ``got`` lacks counts every slot of ``want``'s."""
    bad = total = 0
    for g_step, w_step in zip(got + [{}] * (len(want) - len(got)), want):
        for layer, w in w_step.items():
            g = g_step.get(layer)
            total += w.numel()
            bad += w.numel() if g is None or g.shape != w.shape else \
                ref_model.mismatched_slots(g, w, n_experts)
    return bad / max(total, 1)


def checks(cfg: dict, prog: dict, ref: dict, windows: int, nonfinite: int, n_fetched: int,
           B: int) -> list[Check]:
    """The cell's checks against the configuration's limits."""
    lim = cfg["limits"]
    gaps_ = train_gaps(prog, ref) | {"grad_gap": moved_grad_gap(prog, ref)}
    share = route_mismatch_share(prog["selections"], ref["own"], cfg["model"]["n_routed_experts"])
    out = [Check("windows", windows, 0, f"{len(prog['losses'])} batches of {B}"),
           Check("nonfinite_losses", nonfinite, 0, f"{n_fetched} fetched")]
    out += [Check(k, v, lim[k], where) for k, (v, where) in gaps_.items()]
    out.append(Check("route_mismatch_share", share, lim["route_mismatch_share"],
                     f"{len(prog['selections'])} steps"))
    return out


def _moe_counts():
    from haplohyped_tpu_torch.models.moe import moe

    return moe.calls, moe.held_slots


def run(ctx) -> dict:
    # the model first: a program without it fails here, before any set-up
    from haplohyped_tpu_torch.core.profiling import recording
    from haplohyped_tpu_torch.models.nemotron_h import NemotronHConfig  # noqa: F401
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
    held0 = _moe_counts()[1]
    marks.mark()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < ctx.seconds:
        step(next_step + steps)
        marks.mark()
        steps += 1
    common.sync(dev)
    window_s = time.perf_counter() - t0
    held = (_moe_counts()[1] - held0) / max(steps, 1)
    next_step += steps
    peak = common.memory_peak(dev)
    gaps = marks.gaps_ms()
    nonfinite = sum(not math.isfinite(x) for x in fetched)
    common.log(f"window: {steps} steps of B={B} in {window_s:.4f} s, "
               f"{steps * B / window_s:.4f} windows/s; step ms p10/50/90/95/99/max "
               + "/".join(f"{common.percentile(gaps, q):.3f}" for q in (10, 50, 90, 95, 99, 100))
               + f"; {held:.1f} held slots a step; {len(fetched)} losses fetched, last "
               f"{fetched[-1] if fetched else None}")
    rec["counts"] |= {"steps": steps, "window_s": window_s, "held_slots_a_step": held,
                      "flops_per_step": counts_nemotron.train_flops_per_step(m, B, L, held)}
    for k in ("fwd", "bwd"):
        rec["counts"] |= {f"ssd_{k}_bytes": counts_nemotron.ssd_bytes(m, B, L, k),
                          f"ssd_{k}_flops": counts_nemotron.ssd_flops(m, B, L, k)}

    if ctx.trace:
        c0, e0 = _ssd_calls(), _moe_counts()
        with recording() as r:
            for i in range(mix["host_steps"]):
                step(next_step + i)
        c1, e1 = _ssd_calls(), _moe_counts()
        next_step += mix["host_steps"]
        spans = rec["spans"]
        spans["program"] = {k: v["device_ms"] for k, v in r.totals().items()}
        spans["program_steps"] = mix["host_steps"]
        # a call whose tokens all went to experts held elsewhere runs no
        # products: the held slots a call are over the calls that ran them
        calls = r.totals().get("hh.moe.experts", {}).get("calls", 0)
        slots = (e1[1] - e0[1]) / max(calls, 1)
        rec["counts"] |= {"ssd_fwd_calls_a_step": (c1[0] - c0[0]) / mix["host_steps"],
                          "ssd_bwd_calls_a_step": (c1[1] - c0[1]) / mix["host_steps"],
                          "experts_calls": calls,
                          "experts_fwd_flops": counts_nemotron.experts_flops(m, slots),
                          "experts_fwd_bytes": counts_nemotron.experts_bytes(m, slots)}
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
                   f"{rec['counts']['ssd_bwd_calls_a_step']} backward; {e1[0] - e0[0]} MoE "
                   f"calls, {calls} with held slots, {slots:.1f} held slots a call of those")

    # the reference, once the program's state is gone
    ts = fused = sampler = None
    common.release(dev)
    with ctx.reference_precision():
        want, ref = reference_steps(cfg, state, ctx.seed, mix["checked_steps"], init, dev,
                                    selections=prog["selections"])
    diff = mismatches((g, w) for got, r_ in zip(seen, want) for g, w in zip(got, r_))
    if len(seen) != len(want):
        diff += 1
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
        "checks": checks(cfg, prog, ref, diff, nonfinite, len(fetched), B), "rec": rec,
    }
