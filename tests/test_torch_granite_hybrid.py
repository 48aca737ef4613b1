"""The Granite hybrid (``models/granite_hybrid.py``) on the CPU against its
plain reference (``portbench/reference/granite_hybrid.py``) on seeded
weights at a small size: the published layer pattern (attention at 5 of
10) at hidden 64, a 512-row vocabulary and 80-token windows, in chunks of
32 so the last one is short.  Also the chunked head-and-loss against
``F.cross_entropy`` on whole logits, one fused step on a CPU sampler, the
spans and the scan's counters a step, and the train seam's refusals.

This module imports no JAX, so it can be collected on the card's machine.

Tolerances (float32 on the CPU; the two sides differ in the order of sums
only: the scan's chunked form against the paper's segment-sum form, SDPA
against a masked softmax, the head in chunks against whole logits):

- the loss: ``1e-5`` relative;
- gradients: ``2e-4`` of each leaf's largest value, floored at ``1e-4`` of
  the largest gradient of all (a leaf such as a norm's weight sums
  thousands of rows, whose float32 round-off reaches a few ``1e-6`` of
  its largest entries);
- the head input's gradient row by row: ``1e-4`` of its norm.
"""

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from haplohyped_tpu_torch.core.profiling import recording
from haplohyped_tpu_torch.models import granite_hybrid as G
from haplohyped_tpu_torch.models import train
from haplohyped_tpu_torch.ops.ssd_scan import ssd_scan
from portbench.reference import granite_hybrid as ref
from tests.torch_cpu_sampler import cpu_sampler

SMALL = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16,
             mamba_chunk_size=32, vocab_size=512, loss_chunk=48)
CFG = G.GraniteHybridConfig(**SMALL, dtype="float32")
OPT = {"learning_rate": 3e-4, "betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 0.1,
       "clip_global_norm": 1.0}
L = 80


def _ref_m(cfg: G.GraniteHybridConfig) -> dict:
    m = dataclasses.asdict(cfg)
    m["layer_types"] = list(cfg.layer_types)
    return m


def _model(seed: int = 3, cfg=CFG):
    """The program's model with the reference's seeded weights, and them."""
    init = ref.init(_ref_m(cfg), seed, torch.device("cpu"))
    model = G.GraniteHybrid(cfg, seed, device="cpu")
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(init)
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(init[k])
    return model, init


def _windows(seed: int, B: int = 1):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(0, 5, (B, L), generator=g).to(torch.int8) for _ in range(2))


def test_published_sizes():
    full = G.GraniteHybridConfig()
    assert full.layer_types == ("mamba",) * 5 + ("attention",) + ("mamba",) * 4
    assert (full.hidden_size, full.mamba_width, full.conv_dim) == (2048, 4096, 4352)
    assert full.mamba_n_heads * full.mamba_d_head == 4096 and full.mamba_d_state == 128
    assert full.vocab_size == 100352 and full.mamba_chunk_size == 256
    assert full.attention_multiplier == 1 / 64 and full.logits_scaling == 8
    specs = ref.param_specs(_ref_m(full))
    n = sum(math.prod(s) for _, s, _, _ in specs)
    assert n == 9 * 76_182_976 + 60_821_504 + 205_520_896 + 2048  # 951.99 M
    with pytest.raises(ValueError, match="group"):
        G.GraniteHybridConfig(mamba_n_groups=2)


def test_leaves_are_the_references():
    model = G.GraniteHybrid(CFG, 0, device="cpu")
    want = {n: s for n, s, _, _ in ref.param_specs(_ref_m(CFG))}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want


def test_loss_and_every_gradient_match_the_reference():
    model, init = _model()
    h1, h2 = _windows(5)
    rows = {}

    def on_forward(module, args, out):
        out.register_hook(lambda g: rows.__setitem__("hidden", g))

    model.norm.register_forward_hook(on_forward)
    loss, aux = train.loss_fn(model, h1, h2, None)
    assert aux == {}
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    m = ref.Model(_ref_m(CFG))
    toks = ref.tokens(_ref_m(CFG), h1, h2)
    want_loss, hns = 0.0, []
    n = toks.shape[0] * (L - 1)
    for s in range(toks.shape[0]):
        hn = m.hidden(p, toks[s: s + 1])
        hn.retain_grad()
        part = m.loss_sum(p, hn, toks[s: s + 1]) / n
        part.backward()
        want_loss += float(part.detach())
        hns.append(hn.grad)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    top = max(float(v.grad.abs().max()) for v in p.values())
    for k, param in model.named_parameters():
        want = p[k].grad
        tol = max(2e-4 * float(want.abs().max()), 1e-4 * top)
        assert float((param.grad - want).abs().max()) <= tol, k
    want_rows = torch.cat(hns)
    assert float((rows["hidden"] - want_rows).norm() / want_rows.norm()) <= 1e-4


def test_the_chunked_head_loss_is_the_whole_logits_cross_entropy():
    g = torch.Generator().manual_seed(0)
    h = torch.randn(103, 16, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(50, 16, generator=g, dtype=torch.float64, requires_grad=True)
    t = torch.randint(0, 50, (103,), generator=g)
    for chunk in (1, 10, 103, 500):
        loss = G.ChunkedHeadLoss.apply(h, w, t, 8.0, chunk)
        (2.5 * loss).backward()
        got = (float(loss.detach()), h.grad.clone(), w.grad.clone())
        h.grad = w.grad = None
        want = F.cross_entropy((h @ w.t()) / 8.0, t)
        (2.5 * want).backward()
        # float64: only the order of sums differs
        assert got[0] == pytest.approx(float(want), rel=1e-12)
        torch.testing.assert_close(got[1], h.grad, rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(got[2], w.grad, rtol=1e-10, atol=1e-12)
        h.grad = w.grad = None


def test_a_fused_step_trains_on_the_windows_own_next_bases():
    sampler = cpu_sampler(L=L, batch_size=1, seed=3)
    first = sampler.sample()
    state = train.create_train_state(CFG, (first.hap1, first.hap2), 3e-4, seed=1,
                                     device="cpu")
    assert isinstance(state.optimizer, torch.optim.AdamW) and state.generator is None
    groups = state.optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [0.1, 0.0]
    assert all(p.dim() >= 2 for p in groups[0]["params"])
    assert all(p.dim() < 2 for p in groups[1]["params"])
    fused = train.make_fused_train_step(sampler)
    before = [p.detach().clone() for p in state.model.parameters()]
    calls = (ssd_scan.forward_calls, ssd_scan.backward_calls)
    with recording() as rec:
        state, metrics = fused(state, 0)
    mambas = CFG.layer_types.count("mamba")
    assert (ssd_scan.forward_calls - calls[0], ssd_scan.backward_calls - calls[1]) == (mambas,
                                                                                       mambas)
    totals = rec.totals()
    assert totals["hh.granite.mamba"]["calls"] == 9 and totals["hh.granite.attention"]["calls"] == 1
    assert totals["hh.granite.mlp"]["calls"] == 10
    assert totals["hh.granite.embed"]["calls"] == totals["hh.granite.head_loss"]["calls"] == 1
    forward = next(r for r in rec.rows() if r["name"] == "hh.train.forward")
    for name in ("hh.granite.embed", "hh.granite.mamba", "hh.granite.head_loss"):
        row = next(r for r in rec.rows() if r["name"] == name)
        assert row["parent"] is not None
    assert forward["parent"] is not None
    assert state.step == 1 and math.isfinite(float(metrics["loss"]))
    # a random model predicts about uniformly over the 512 rows
    assert abs(float(metrics["loss"]) - math.log(512)) < 0.5
    assert all(not torch.equal(a, p) for a, p in zip(before, state.model.parameters()))


def test_the_clip_scales_the_gradient():
    model, _ = _model(seed=4, cfg=dataclasses.replace(CFG, clip_global_norm=1e-3))
    x = _windows(1)
    state = train.TrainState(model, model.make_optimizer(3e-4), 0)
    state, _ = train._train_step(state, *x, None)
    norm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters()))
    assert float(norm) == pytest.approx(1e-3, rel=1e-4)


def test_the_train_path_refuses_a_mesh():
    x = torch.zeros((1, L), dtype=torch.int8)
    with pytest.raises(ValueError, match="one device"):
        train.create_train_state(CFG, (x, x), device="cpu", mesh=object())


def test_no_tensor_holds_all_the_logits():
    """Every tensor a step makes with a vocabulary-sized dimension holds at
    most ``max(loss_chunk, hidden_size)`` rows of it: the chunks' logits and
    the tied table and its gradient, never the 158 x 512 logits whole."""
    model, _ = _model()
    h1, h2 = _windows(2)
    V, rows = CFG.vocab_size, max(CFG.loss_chunk, CFG.hidden_size)
    seen = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen.extend(tuple(t.shape) for t in tree_leaves(out) if isinstance(t, torch.Tensor))
            return out

    with Shapes():
        loss, _ = train.loss_fn(model, h1, h2, None)
        loss.backward()
    wide = [sh for sh in seen if V in sh]
    assert (CFG.loss_chunk, V) in wide  # the chunks' logits were made
    assert all(math.prod(sh) // V <= rows for sh in wide), max(wide, key=math.prod)
