"""The mixture-of-experts layer (``models/moe.py``) on the CPU, in float64
where a sum's order is all that differs.

- The share test: the layer cut into shares of its experts, each share's
  output less the shared expert's, plus the shared expert once, is the uncut
  layer's output.
- The router: the bias enters the selection and not the weights; the
  weights are renormalised over the token's slots and scaled by
  ``routed_scaling``.
- No slot is dropped: an expert that every token picks computes every
  token's row.
- The bias update: DeepSeek-V3's rule, ``b += rate * sign(mean load -
  load)``, from the loads of the forwards since the last update.
- The counters.
"""

import pytest
import torch

from haplohyped_tpu_torch.models import moe as M

D, E, K, F_, FS = 16, 8, 3, 12, 20
#: DeepSeek-V3's bias update rate
RATE = 1e-3


def _layer(held=(0, E), seed=0, dtype=torch.float64) -> M.MoE:
    g = torch.Generator().manual_seed(seed)
    layer = M.MoE(D, E, K, F_, FS, 2.5, held, dtype, g, RATE).double()
    with torch.no_grad():
        layer.e_score_correction_bias.copy_(0.05 * torch.randn(E, generator=g,
                                                               dtype=torch.float64))
    return layer


def _cut(full: M.MoE, held: tuple) -> M.MoE:
    """A layer holding experts ``held`` of ``full``, with its weights."""
    part = _layer(held)
    first, count = held
    with torch.no_grad():
        part.gate.weight.copy_(full.gate.weight)
        part.e_score_correction_bias.copy_(full.e_score_correction_bias)
        part.experts.up_proj.copy_(full.experts.up_proj[first: first + count])
        part.experts.down_proj.copy_(full.experts.down_proj[first: first + count])
        for k in ("up_proj", "down_proj"):
            getattr(part.shared_experts, k).weight.copy_(getattr(full.shared_experts, k).weight)
    return part


def _x(n=2, T=30, seed=1):
    return torch.randn(n, T, D, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64)


def _shared(layer: M.MoE, x: torch.Tensor) -> torch.Tensor:
    sh = layer.shared_experts
    return sh.down_proj(M.relu2(sh.up_proj(x)))


def _dense(layer: M.MoE, x: torch.Tensor) -> torch.Tensor:
    """The layer's equations token by token, every held expert's output
    weighted by its slot (zero where not selected)."""
    xf = x.reshape(-1, D)
    s = torch.sigmoid(xf @ layer.gate.weight.t())
    chosen = torch.topk(s + layer.e_score_correction_bias, K, dim=-1).indices
    w = s.gather(1, chosen)
    w = w / w.sum(-1, keepdim=True) * 2.5
    out = _shared(layer, xf).clone()
    for e in range(layer.count):
        ex = layer.first + e
        we = (w * (chosen == ex)).sum(-1, keepdim=True)
        h = M.relu2(xf @ layer.experts.up_proj[e].t())
        out = out + we * (h @ layer.experts.down_proj[e].t())
    return out.view(x.shape)


@pytest.mark.parametrize("shares", [[(0, 4), (4, 4)], [(0, 3), (3, 1), (4, 4)],
                                    [(k, 1) for k in range(E)]], ids=["halves", "uneven", "ones"])
def test_the_shares_add_up_to_the_uncut_layer(shares):
    full = _layer()
    x = _x()
    want = full(x)
    got = _shared(full, x)
    for held in shares:
        part = _cut(full, held)
        got = got + part(x) - _shared(part, x)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(want, _dense(full, x), rtol=1e-12, atol=1e-12)


def test_the_bias_selects_and_does_not_weigh():
    layer = _layer()
    x = _x()
    xf = x.reshape(-1, D)
    s = M.router_scores(xf, layer.gate.weight)
    biased = M.select(s, layer.e_score_correction_bias, K)
    plain = M.select(s, torch.zeros(E, dtype=s.dtype), K)
    assert not torch.equal(biased.sort(-1).values, plain.sort(-1).values)
    # the weights are the unbiased scores at the selection, renormalised, x 2.5
    w = M.slot_weights(s, biased, 2.5)
    raw = s.gather(1, biased)
    torch.testing.assert_close(w, raw / raw.sum(-1, keepdim=True) * 2.5, rtol=1e-12, atol=0)
    torch.testing.assert_close(w.sum(-1), torch.full((xf.shape[0],), 2.5, dtype=w.dtype),
                               rtol=1e-12, atol=0)
    # a large bias on one expert makes every token select it, at its unbiased weight
    bias = torch.zeros(E, dtype=s.dtype)
    bias[5] = 10.0
    chosen = M.select(s, bias, K)
    assert bool((chosen == 5).any(-1).all())
    w = M.slot_weights(s, chosen, 2.5)
    at5 = (w * (chosen == 5)).sum(-1)
    torch.testing.assert_close(at5, s[:, 5] / s.gather(1, chosen).sum(-1) * 2.5)


def test_no_slot_is_dropped_when_one_expert_takes_every_token():
    layer = _layer(held=(2, 3))
    with torch.no_grad():
        layer.e_score_correction_bias.zero_()
        layer.e_score_correction_bias[3] = 10.0  # held: every token's slot
    x = _x(n=3, T=40)
    M.reset_counters()
    out = layer(x)
    torch.testing.assert_close(out, _dense(layer, x), rtol=1e-12, atol=1e-12)
    assert M.moe.max_held_expert_slots == 120 and M.moe.held_slots >= 120
    assert M.moe.calls == 1 and M.moe.token_slots == 120 * K


def test_the_bias_update_is_deepseek_v3s_rule():
    layer = _layer()
    before = layer.e_score_correction_bias.clone()
    x1, x2 = _x(seed=1), _x(seed=2)
    load = torch.zeros(E, dtype=torch.float64)
    for x in (x1, x2):
        s = M.router_scores(x.reshape(-1, D), layer.gate.weight)
        chosen = M.select(s, layer.e_score_correction_bias, K)
        load += torch.bincount(chosen.flatten(), minlength=E)
        layer(x)
    torch.testing.assert_close(layer.load.double(), load, rtol=0, atol=0)
    layer.update_bias()
    step = torch.sign(load.mean() - load) * RATE
    torch.testing.assert_close(layer.e_score_correction_bias, before + step, rtol=0, atol=1e-15)
    assert float(layer.load.abs().sum()) == 0


def test_the_counters_count_a_forward():
    layer = _layer(held=(0, 4))
    x = _x(n=2, T=25)
    M.reset_counters()
    layer(x)
    s = M.router_scores(x.reshape(-1, D), layer.gate.weight)
    chosen = M.select(s, layer.e_score_correction_bias, K)
    per = torch.bincount(chosen.flatten(), minlength=E)[:4]
    assert (M.moe.calls, M.moe.token_slots) == (1, 50 * K)
    assert M.moe.held_slots == int(per.sum())
    assert M.moe.max_held_expert_slots == int(per.max())
    assert M.moe.empty_held_experts == int((per == 0).sum())


def test_a_share_that_is_not_one_is_refused():
    g = torch.Generator().manual_seed(0)
    for held in [(6, 4), (-1, 2), (0, 0)]:
        with pytest.raises(ValueError, match="share"):
            M.MoE(D, E, K, F_, FS, 2.5, held, torch.float64, g, RATE)
