"""The Nemotron-H hybrid on the card: one training step of the main path
with what its kernels and its MoE layers count, the MoE layer against its
plain form, and the held experts' grouped products' time.

``chip_smoke.py`` phase 23 runs :func:`nemotron_step` on the main path,
``NemotronH(NemotronHConfig())``, and holds it to
:func:`check_nemotron_step`; then :func:`moe_compare` and
:func:`experts_times` at the benchmark cell's size: 32,768 tokens, 16 of 128
experts held.
"""

from __future__ import annotations

import math

import torch

from haplohyped_tpu_torch.models import moe as M
from haplohyped_tpu_torch.models.nemotron_h import NemotronH, NemotronHConfig
from haplohyped_tpu_torch.ops.rms_norm import rms_norm
from haplohyped_tpu_torch.ops.ssd_scan import ssd_scan
from haplohyped_tpu_torch.tools.granite_step_check import RMS_COUNTERS, SSD_COUNTERS

#: the cell's step: 2 window pairs (4 sequences) of 8,192 bases
NEMOTRON_L, NEMOTRON_PAIRS = 8192, 2
#: the largest gap of the MoE layer's output and of each gradient from its
#: plain form's, as a share of the plain form's norm: the layer's products
#: are bf16 (2^-9 of each value) where the plain form keeps float32, so they
#: differ by a few tenths of a percent; a lost slot or a wrong weight moves
#: a share of order 1e-1 or more
MOE_TOLERANCE = 0.02
#: the card's dense bf16 peak and its memory's bandwidth (H100 SXM)
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nemotron_step(seed: int, length: int = NEMOTRON_L, pairs: int = NEMOTRON_PAIRS) -> dict:
    """One bf16 forward and backward of ``NemotronH(NemotronHConfig())`` on
    ``pairs`` window pairs of ``length`` bases, the scan's, the norms' and
    the MoE layers' counters reset to 0 just before it.  Returns those
    counters, the loss, the step's memory peak and what the step should
    read."""
    cfg = NemotronHConfig()
    model = NemotronH(cfg, seed, device="cuda").train()
    gen = torch.Generator(device="cuda").manual_seed(seed + 25)
    h1, h2 = (torch.randint(0, 5, (pairs, length), generator=gen,
                            device="cuda").to(torch.int8) for _ in range(2))
    for c in SSD_COUNTERS:
        setattr(ssd_scan, c, 0)
    for c in RMS_COUNTERS:
        setattr(rms_norm, c, 0)
    M.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = model.loss(h1, h2)[0]
    loss.backward()
    torch.cuda.synchronize()
    kinds = cfg.layer_types
    out = {"length": length, "pairs": pairs, "tokens": 2 * pairs * length,
           "mixers": kinds.count("mamba"), "moe_layers": kinds.count("moe"),
           # each layer's norm, the final norm and each mixer's gated norm
           "norms": len(kinds) + 1 + kinds.count("mamba"),
           "ssd_scan": {c: getattr(ssd_scan, c) for c in SSD_COUNTERS},
           "rms_norm": {c: getattr(rms_norm, c) for c in RMS_COUNTERS},
           "moe": {c: getattr(M.moe, c) for c in M.COUNTERS},
           "top_k": cfg.num_experts_per_tok, "loss": loss.item(),
           "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    del model, loss
    torch.cuda.empty_cache()
    return out


def check_nemotron_step(step: dict) -> None:
    """Raise unless :func:`nemotron_step`'s reading is the main path's:
    each Mamba-2 mixer calls the scan once forward and once backward (3 + 5
    launches), each norm the norms' kernels once each way (the mixers' gated),
    each MoE layer routes every token's ``top_k`` slots and computes some
    of them here, and the loss is finite."""
    mixers, norms, moes = step["mixers"], step["norms"], step["moe_layers"]
    ssd, rms, moe = step["ssd_scan"], step["rms_norm"], step["moe"]
    _check(ssd["forward_calls"] == ssd["backward_calls"] == mixers,
           f"{ssd['forward_calls']} forward and {ssd['backward_calls']} backward scan calls "
           f"for {mixers} Mamba-2 mixers")
    _check(ssd["launches"] == 8 * mixers, f"{ssd['launches']} scan launches for {mixers} mixers")
    _check(rms["forward_calls"] == rms["backward_calls"] == norms,
           f"{rms['forward_calls']} forward and {rms['backward_calls']} backward norm calls "
           f"for {norms} norms")
    _check(rms["gated_calls"] == mixers, f"{rms['gated_calls']} gated calls for {mixers} mixers")
    _check(rms["launches"] == 3 * norms, f"{rms['launches']} norm launches for {norms} norms")
    _check(moe["calls"] == moes, f"{moe['calls']} MoE calls for {moes} MoE layers")
    _check(moe["token_slots"] == moes * step["tokens"] * step["top_k"],
           f"{moe['token_slots']} token slots routed")
    _check(0 < moe["held_slots"] < moe["token_slots"], f"{moe['held_slots']} held slots")
    _check(math.isfinite(step["loss"]), f"loss {step['loss']}")


def moe_inputs(seed: int, tokens: int = NEMOTRON_PAIRS * 2 * NEMOTRON_L) -> tuple:
    """One MoE layer of ``NemotronHConfig()`` (16 of 128 experts held) on the
    card, its router bias ``N(0, 0.02^2)``, and a bf16 input of ``tokens``
    rows at a normed activation's scale and an output gradient."""
    cfg = NemotronHConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    layer = M.MoE(cfg.hidden_size, cfg.n_routed_experts, cfg.num_experts_per_tok,
                  cfg.moe_intermediate_size, cfg.moe_shared_expert_intermediate_size,
                  cfg.routed_scaling_factor, cfg.experts_held, cfg.compute_dtype, gen,
                  cfg.router_bias_update_rate).cuda()
    with torch.no_grad():
        layer.e_score_correction_bias.normal_(0, 0.02, generator=gen)
    x = torch.randn(1, tokens, cfg.hidden_size, generator=gen, device="cuda")
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    return layer, x.to(torch.bfloat16), dy.to(torch.bfloat16)


def moe_plain(layer: M.MoE, x: torch.Tensor) -> torch.Tensor:
    """The layer's equations in float32 from the same weights, one held
    expert at a time (the same selection: the router is float32 on both
    sides)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    s = M.router_scores(xf, layer.gate.weight)
    chosen = M.select(s, layer.e_score_correction_bias, layer.top_k)
    w = M.slot_weights(s, chosen, layer.scale)
    out = torch.zeros_like(xf)
    for e in range(layer.count):
        hit = chosen == layer.first + e
        tok = hit.any(-1).nonzero()[:, 0]
        we = (w * hit).sum(-1)[tok]
        h = M.relu2(xf[tok] @ layer.experts.up_proj[e].t())
        out = out.index_add(0, tok, (h @ layer.experts.down_proj[e].t()) * we[:, None])
    sh = layer.shared_experts
    h = M.relu2(xf @ sh.up_proj.weight.t())
    return (out + h @ sh.down_proj.weight.t()).view(x.shape)


def moe_compare(seed: int) -> dict:
    """The layer against :func:`moe_plain`: the output, the input's and
    every leaf's gradient within :data:`MOE_TOLERANCE` of the plain form's
    norm.  Returns the gaps and the held experts' row counts."""
    layer, x, dy = moe_inputs(seed)
    leaves = [p for _, p in layer.named_parameters()]
    names = [n for n, _ in layer.named_parameters()]
    gaps = {}
    runs = []
    for fn, cast in ((layer, lambda t: t), (lambda t: moe_plain(layer, t), lambda t: t.float())):
        xi = cast(x).detach().requires_grad_()
        M.reset_counters()
        y = fn(xi)
        grads = torch.autograd.grad(y, [xi] + leaves, cast(dy))
        runs.append(dict(zip(["out", "x"] + names, [y.detach()] + list(grads))))
        if len(runs) == 1:
            slots = {c: getattr(M.moe, c) for c in M.COUNTERS}
    got, want = runs
    for k in want:
        gaps[k] = float((got[k].float() - want[k]).norm() / want[k].norm())
        _check(gaps[k] <= MOE_TOLERANCE, f"moe {k} is {gaps[k]:.3g} of the plain form's norm "
                                         f"away, over {MOE_TOLERANCE}")
    del layer, runs
    torch.cuda.empty_cache()
    return {"gaps": gaps, "counters": slots}


def experts_bound(rows: int, hidden: int, width: int, experts: int) -> dict:
    """The held experts' two products of one call's forward, ``rows`` token
    slots over ``experts`` experts: FLOPs (two a multiply-add) and least
    bytes (the gathered bf16 rows read, both float32 weight stacks read once,
    the bf16 hidden activation written and read once, the output written)."""
    flops = 2 * 2 * rows * hidden * width
    nbytes = 2 * rows * hidden + 4 * 2 * experts * width * hidden + 2 * 2 * rows * width \
        + 2 * rows * hidden
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3}


def experts_times(seed: int, device_ms) -> dict:
    """Device ms of the held experts' grouped products and ReLU² of one
    forward at the cell's size (``device_ms(fn, args_list)``, CUDA events,
    10 calls), beside :func:`experts_bound`."""
    layer, x, _ = moe_inputs(seed)
    xf = x.reshape(-1, x.shape[-1])
    with torch.no_grad():
        s = M.router_scores(xf, layer.gate.weight)
        chosen = M.select(s, layer.e_score_correction_bias, layer.top_k)
        pairs, counts, offs = M.held_pairs(chosen, layer.first, layer.count)
        rows = xf[pairs // layer.top_k]
        ex = layer.experts

        def products():  # as the layer's span hh.moe.experts holds them
            h = M.relu2(M.grouped_linear(rows, ex.up_proj.to(torch.bfloat16), counts, offs))
            return M.grouped_linear(h, ex.down_proj.to(torch.bfloat16), counts, offs)

        products()
        ms = device_ms(products, [()] * 10)[0]
    bound = experts_bound(sum(counts), x.shape[-1], ex.up_proj.shape[1], layer.count)
    return {"rows": sum(counts), "ms": ms, **bound, "bound_share": bound["bound_ms"] / ms,
            "tflop_per_s": bound["flops"] / ms / 1e9}
