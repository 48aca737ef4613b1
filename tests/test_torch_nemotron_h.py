"""The Nemotron-H hybrid (``models/nemotron_h.py``) on the CPU against its
plain reference (``portbench/reference/nemotron_h.py``) on seeded weights
at a small size: the published stage-1 layer pattern ``MEMEM*EMEMEM*`` at
hidden 64, 8 routed experts in two shares of 4 (top 3), Mamba-2 in 2 groups
with chunks of 16 (so the 50-token windows' last chunk is short), a
128-row vocabulary.  Also one fused step on a CPU sampler with its spans and
counters, the router biases' update through the train seam, and the
refusals.

This module imports no JAX, so it can be collected on the card's machine.

Tolerances (float32 on the CPU; the two sides differ in the order of sums
only: the scan's chunked form against the paper's segment-sum form, SDPA
against a masked softmax, the grouped experts against one expert at a
time, the head in chunks against whole logits):

- the loss: ``1e-5`` relative;
- gradients: ``2e-4`` of each leaf's largest value, floored at ``1e-4`` of
  the largest gradient of all;
- the head input's gradient row by row: ``1e-4`` of its norm.
"""

import dataclasses
import math

import pytest
import torch

from haplohyped_tpu_torch.core.profiling import recording
from haplohyped_tpu_torch.models import moe as M
from haplohyped_tpu_torch.models import nemotron_h as N
from haplohyped_tpu_torch.models import train
from haplohyped_tpu_torch.ops.ssd_scan import ssd_scan
from portbench.reference import nemotron_h as ref
from tests.torch_cpu_sampler import cpu_sampler

SMALL = dict(hidden_size=64, moe_intermediate_size=48, moe_shared_expert_intermediate_size=96,
             mamba_num_heads=8, mamba_head_dim=16, ssm_state_size=16, n_groups=2, chunk_size=16,
             num_attention_heads=4, num_key_value_heads=2, head_dim=32, n_routed_experts=8,
             num_experts_per_tok=3, vocab_size=128, token_ids=(5, 6, 7, 8, 9), loss_chunk=40)
CFG = N.NemotronHConfig(**SMALL, experts_held=(0, 4), dtype="float32")
L = 50


def _ref_m(cfg: N.NemotronHConfig) -> dict:
    m = dataclasses.asdict(cfg)
    m["experts_held"] = list(cfg.experts_held)
    return m


def _model(seed: int = 3, cfg=CFG):
    """The program's model with the reference's seeded weights and router
    biases, and them."""
    init = ref.init(_ref_m(cfg), seed, torch.device("cpu"))
    model = N.NemotronH(cfg, seed, device="cpu")
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(set(init) - set(ref.bias_names(_ref_m(cfg))))
    with torch.no_grad():
        for k, t in model.state_dict().items():
            t.copy_(init[k])
    return model, init


def _windows(seed: int, B: int = 1):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(0, 5, (B, L), generator=g).to(torch.int8) for _ in range(2))


def _selections(monkeypatch) -> dict:
    """Record each MoE layer's selection (the program's call order is the
    layers' order)."""
    got = []
    select = M.select

    def record(scores, bias, top_k):
        out = select(scores, bias, top_k)
        got.append(out.detach().clone())
        return out

    monkeypatch.setattr(M, "select", record)
    return got


def test_published_sizes():
    full = N.NemotronHConfig()
    assert full.layer_types == ("mamba", "moe", "mamba", "moe", "mamba", "attention", "moe",
                                "mamba", "moe", "mamba", "moe", "mamba", "attention")
    assert full.mamba.width == 4096 and full.mamba.conv_dim == 4096 + 2 * 8 * 128
    assert (full.n_groups, full.chunk_size, full.head_dim) == (8, 128, 128)
    specs = ref.param_specs(_ref_m(full))
    sizes = {}
    for name, shape, _, _ in specs:
        key = name.split(".")[1] if name.startswith("layers.") else name
        sizes[key] = sizes.get(key, 0) + math.prod(shape)
    kinds = N.NemotronHConfig().layer_types
    per = {k: sizes[str(kinds.index(k))] for k in ("mamba", "moe", "attention")}
    # with its norm: 38.74 M a Mamba-2 layer, 179.95 M a MoE layer (16
    # experts of 9.98 M, the shared expert 19.96 M, the router 0.34 M),
    # 23.40 M an attention layer; 44.04 M each the embedding and the head
    assert per == {"mamba": 38_744_896, "moe": 179_948_160, "attention": 23_399_040}
    assert sizes["embed_tokens.weight"] == sizes["lm_head.weight"] == 16384 * 2688
    assert sum(sizes.values()) == 1_267_091_328
    with pytest.raises(ValueError, match="groups"):
        N.NemotronHConfig(n_groups=3)
    with pytest.raises(ValueError, match="share"):
        N.NemotronH(dataclasses.replace(CFG, experts_held=(6, 4)), 0, device="cpu")


def test_leaves_are_the_references():
    model = N.NemotronH(CFG, 0, device="cpu")
    want = {n: s for n, s, _, _ in ref.param_specs(_ref_m(CFG))}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    assert [n for n, _ in model.named_buffers() if "bias" in n] == ref.bias_names(_ref_m(CFG))


@pytest.mark.parametrize("held", [(0, 4), (4, 4)], ids=["share0", "share1"])
def test_loss_and_every_gradient_match_the_reference(monkeypatch, held):
    cfg = dataclasses.replace(CFG, experts_held=held)
    model, init = _model(cfg=cfg)
    h1, h2 = _windows(5)
    rows = {}

    def on_forward(module, args, out):
        out.register_hook(lambda g: rows.__setitem__("hidden", g))

    model.norm_f.register_forward_hook(on_forward)
    sel = _selections(monkeypatch)
    loss, aux = train.loss_fn(model, h1, h2, None)
    assert aux == {}
    loss.backward()
    m = _ref_m(cfg)
    layers = [i for i, k in enumerate(cfg.layer_types) if k == "moe"]
    given = dict(zip(layers, sel))
    names = set(ref.bias_names(m))
    p = {k: v.clone().requires_grad_(True) for k, v in init.items() if k not in names}
    bias = {k: init[k] for k in names}
    model_ref = ref.Model(m)
    toks = ref.tokens(m, h1, h2)
    want_loss, hns, own = 0.0, [], []
    n = toks.shape[0] * (L - 1)
    for s in range(toks.shape[0]):
        model_ref.given = {i: g[s * L: (s + 1) * L] for i, g in given.items()}
        hn = model_ref.hidden(p, bias, toks[s: s + 1])
        hn.retain_grad()
        part = model_ref.loss_sum(p, hn, toks[s: s + 1]) / n
        part.backward()
        want_loss += float(part.detach())
        hns.append(hn.grad)
        own.append(dict(model_ref.own))
    # float32 on both sides: the reference's own selection is the program's
    for i in layers:
        mine = torch.cat([o[i] for o in own])
        assert ref.mismatched_slots(given[i], mine, cfg.n_routed_experts) == 0
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    top = max(float(v.grad.abs().max()) for v in p.values())
    for k, param in model.named_parameters():
        want = p[k].grad
        tol = max(2e-4 * float(want.abs().max()), 1e-4 * top)
        assert float((param.grad - want).abs().max()) <= tol, k
    want_rows = torch.cat(hns)
    assert float((rows["hidden"] - want_rows).norm() / want_rows.norm()) <= 1e-4


def test_a_fused_step_trains_and_moves_the_router_biases():
    sampler = cpu_sampler(L=L, batch_size=1, seed=3)
    first = sampler.sample()
    state = train.create_train_state(CFG, (first.hap1, first.hap2), 3e-4, seed=1,
                                     device="cpu")
    groups = state.optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [0.1, 0.0]
    fused = train.make_fused_train_step(sampler)
    moes = state.model.moe_layers()
    before = [m.e_score_correction_bias.clone() for m in moes]
    calls = (ssd_scan.forward_calls, ssd_scan.backward_calls)
    M.reset_counters()
    with recording() as rec:
        state, metrics = fused(state, 0)
    mambas = CFG.layer_types.count("mamba")
    assert (ssd_scan.forward_calls - calls[0], ssd_scan.backward_calls - calls[1]) == (mambas,
                                                                                       mambas)
    tokens, k = 2 * L, CFG.num_experts_per_tok
    assert M.moe.calls == 5 and M.moe.token_slots == 5 * tokens * k
    assert 0 < M.moe.held_slots < M.moe.token_slots
    totals = rec.totals()
    assert totals["hh.nemotron.mamba"]["calls"] == 6 and totals["hh.nemotron.moe"]["calls"] == 5
    assert totals["hh.nemotron.attention"]["calls"] == 2
    # the route's two spans a call: before and after the wait for the held counts
    assert totals["hh.moe.route"]["calls"] == 10
    for name in ("hh.moe.experts", "hh.moe.combine", "hh.moe.shared"):
        assert totals[name]["calls"] == 5, name
    assert totals["hh.nemotron.embed"]["calls"] == totals["hh.nemotron.head_loss"]["calls"] == 1
    rows = rec.rows()
    moe_row = next(r for r in rows if r["name"] == "hh.moe.route")
    assert rows[moe_row["parent"]]["name"] == "hh.nemotron.moe"
    assert state.step == 1 and abs(float(metrics["loss"]) - math.log(CFG.vocab_size)) < 0.5
    # each bias moved by the rate, in the sign of (mean load - its load)
    for m, b in zip(moes, before):
        step = (m.e_score_correction_bias - b) / CFG.router_bias_update_rate
        assert set(step.round().tolist()) <= {-1.0, 0.0, 1.0} and step.abs().sum() > 0
        assert float(m.load.abs().sum()) == 0


def test_the_train_path_refuses_a_mesh():
    x = torch.zeros((1, L), dtype=torch.int8)
    with pytest.raises(ValueError, match="one device"):
        train.create_train_state(CFG, (x, x), device="cpu", mesh=object())
