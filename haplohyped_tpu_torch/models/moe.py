"""A mixture-of-experts layer with a sigmoid router, a shared expert and
ReLU² experts, of which a card holds a share: Nemotron-H's MoE (model type
``nemotron_h``), the port's first layer that routes tokens.

For each token ``x`` (a row of ``(n, T, hidden)``), in this order:

- **Router.** ``s = sigmoid(x W_r^T)`` in float32 over all ``n_routed``
  experts, on every card.
- **Selection.** The top ``top_k`` of ``s + e_score_correction_bias``.
- **Weights.** The unbiased ``s`` at the selected experts, over their sum
  plus 1e-20, times ``routed_scaling``.
- **Routed part.** For each selected expert this card holds, ``w *
  down(relu(up(x))^2)``.  A slot routed to an expert held elsewhere adds
  nothing here; no code stands in for the other cards or their exchange.
  No slot is dropped: there is no capacity.
- **Shared part.** ``shared_down(relu(shared_up(x))^2)`` once for every
  token.

The layer holds experts ``experts_held = (first, count)`` of the
``n_routed``: their ``up`` and ``down`` matrices stacked, ``(count, width,
hidden)`` and ``(count, hidden, width)``.  Its forward sorts the held
(token, slot) pairs by expert and runs the ``count`` experts' products as
grouped products over their row counts: on a card ``torch._grouped_mm`` (one
launch a product for all the experts, no loop over them), on the CPU a loop
of plain products.  The weighted rows are added back into their tokens in
float32 (``index_add``) onto the shared expert's output, and the sum rounded
once to the compute dtype.  The router's weight and the selection
are float32; every expert product is in the compute dtype.

``e_score_correction_bias`` is a float32 buffer, not a parameter.  Each
forward adds the step's selections over all ``n_routed`` experts to the
buffer ``load``; :meth:`MoE.update_bias`, which the train step calls after
each optimiser step, moves each expert's bias by ``bias_update_rate`` in the
sign of (mean load - its load) and clears ``load``: DeepSeek-V3's
auxiliary-loss-free balancing (arXiv:2412.19437, §2.1.2; its rate there is
1e-3).  No auxiliary loss is added.

One synchronize a forward: the held experts' row counts are read on the
host, which sizes the gather of their rows; the shared expert is enqueued
before the wait, so the card runs it meanwhile.  Counters on :func:`moe`, the
forward: ``moe.calls``, ``moe.token_slots`` (tokens x ``top_k``, over all
``n_routed`` experts), ``moe.held_slots`` (the slots this card computes),
``moe.max_held_expert_slots`` (the busiest held expert of any call since
the counters were reset) and ``moe.empty_held_experts`` (held experts that
got no slot, summed over calls).  Spans (``core/profiling.py``):
``hh.moe.route`` (router, selection, weights and the sort; after the wait,
the gather: two spans a call),
``hh.moe.experts`` (the grouped products and ReLU²), ``hh.moe.combine``
(the weighted scatter back into the tokens) and ``hh.moe.shared``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from haplohyped_tpu_torch.core.profiling import annotate
from haplohyped_tpu_torch.models.hybrid_layers import Linear, _normal


def router_scores(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``sigmoid(x W_r^T)`` in the (float32) weight's dtype: ``(tokens,
    n_routed)``."""
    return torch.sigmoid(F.linear(x.to(weight.dtype), weight))


def select(scores: torch.Tensor, bias: torch.Tensor, top_k: int) -> torch.Tensor:
    """The ``top_k`` experts of ``scores + bias`` a token, int64 ``(tokens,
    top_k)``."""
    return torch.topk(scores + bias, top_k, dim=-1, sorted=False).indices


def slot_weights(scores: torch.Tensor, chosen: torch.Tensor, scale: float) -> torch.Tensor:
    """The unbiased scores at ``chosen``, renormalised over the token's
    slots and scaled: float32 ``(tokens, top_k)``."""
    w = scores.gather(1, chosen)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scale


def expert_order(chosen: torch.Tensor, first: int, count: int) -> tuple:
    """The (token, slot) pairs of ``chosen`` ``(tokens, k)`` as flat indices
    sorted by expert, those of experts ``first .. first + count - 1`` first
    (stable: in token order within an expert), and each of those experts'
    count, on the device."""
    local = chosen.flatten() - first
    key = torch.where((local >= 0) & (local < count), local, count)
    order = torch.sort(key, stable=True).indices
    return order, torch.bincount(key, minlength=count + 1)[:count]


def held_pairs(chosen: torch.Tensor, first: int, count: int) -> tuple:
    """:func:`expert_order`'s held pairs, each held expert's count on the host
    and their int32 ends on the device."""
    order, per = expert_order(chosen, first, count)
    counts = per.tolist()
    return order[: sum(counts)], counts, per.cumsum(0).to(torch.int32)


def _to_host(t: torch.Tensor):
    """``t``'s values as a list, read later: on a card a copy into pinned
    memory now and a wait on its event when called, so the device has the
    work enqueued in between to run while the host waits."""
    if not t.is_cuda:
        return t.tolist
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def read() -> list:
        done.synchronize()
        return host.tolist()

    return read


def relu2(h: torch.Tensor) -> torch.Tensor:
    return F.relu(h).square()


def grouped_linear(x: torch.Tensor, weight: torch.Tensor, counts: list[int],
                   offs: torch.Tensor) -> torch.Tensor:
    """``x W_e^T`` for each expert ``e``'s rows: ``x`` ``(rows, d_in)`` in
    expert order, ``counts[e]`` rows each (``offs`` their int32 ends on the
    device), ``weight`` ``(experts, d_out, d_in)`` in ``x``'s dtype."""
    if x.is_cuda:
        return torch._grouped_mm(x, weight.transpose(-2, -1), offs=offs)
    return torch.cat([F.linear(part, w) for part, w in zip(x.split(counts), weight)])


class MoE(nn.Module):
    """The layer (module docstring) on ``(n, T, hidden)``, holding experts
    ``experts_held = (first, count)``; weights drawn from ``g``: the router,
    every expert and the shared expert ``N(0, 0.02^2)``; the bias 0."""

    def __init__(self, hidden: int, n_routed: int, top_k: int, width: int, shared_width: int,
                 routed_scaling: float, experts_held: tuple, dtype: torch.dtype,
                 g: torch.Generator, bias_update_rate: float):
        super().__init__()
        first, count = experts_held
        if not (0 <= first and 0 < count and first + count <= n_routed and top_k <= n_routed):
            raise ValueError(f"experts {first}..{first + count - 1} and top {top_k} of "
                             f"{n_routed}: not a share of the experts")
        self.n_routed, self.top_k, self.scale = n_routed, top_k, routed_scaling
        self.first, self.count, self.dtype = first, count, dtype
        self.bias_update_rate = bias_update_rate
        self.gate = nn.Module()
        self.gate.weight = nn.Parameter(_normal((n_routed, hidden), 0.02, g))
        self.register_buffer("e_score_correction_bias", torch.zeros(n_routed))
        self.register_buffer("load", torch.zeros(n_routed), persistent=False)
        self.experts = nn.Module()
        self.experts.up_proj = nn.Parameter(_normal((count, width, hidden), 0.02, g))
        self.experts.down_proj = nn.Parameter(_normal((count, hidden, width), 0.02, g))
        self.shared_experts = nn.Module()
        self.shared_experts.up_proj = Linear(hidden, shared_width, dtype, g)
        self.shared_experts.down_proj = Linear(shared_width, hidden, dtype, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe(self, x)

    @torch.no_grad()
    def update_bias(self) -> None:
        """Move each expert's bias by the rate in the sign of (mean load -
        its load) over the selections since the last update, and clear the
        load."""
        load = self.load
        self.e_score_correction_bias.add_(torch.sign(load.mean() - load),
                                          alpha=self.bias_update_rate)
        load.zero_()


def moe(layer: MoE, x: torch.Tensor) -> torch.Tensor:
    """``layer``'s forward (module docstring)."""
    n, T, d = x.shape
    xf = x.reshape(n * T, d)
    k, count = layer.top_k, layer.count
    with annotate("hh.moe.route"):
        s = router_scores(xf, layer.gate.weight)
        chosen = select(s, layer.e_score_correction_bias, k)
        w = slot_weights(s, chosen, layer.scale)
        with torch.no_grad():
            layer.load += torch.bincount(chosen.flatten(), minlength=layer.n_routed).float()
            order, per = expert_order(chosen, layer.first, count)
            read_counts = _to_host(per)
    # the shared expert needs no routing: the card runs it while the host
    # waits for the held experts' counts
    with annotate("hh.moe.shared"):
        sh = layer.shared_experts
        shared = sh.down_proj(relu2(sh.up_proj(xf)))
    counts = read_counts()
    held = sum(counts)
    with annotate("hh.moe.route"):
        with torch.no_grad():
            pairs = order[:held]
            tok = pairs // k
            offs = per.cumsum(0).to(torch.int32)
        rows = xf[tok]
        wp = w.flatten()[pairs]
    moe.calls += 1
    moe.token_slots += n * T * k
    moe.held_slots += held
    moe.max_held_expert_slots = max(moe.max_held_expert_slots, max(counts))
    moe.empty_held_experts += counts.count(0)
    out = shared.to(torch.promote_types(layer.dtype, torch.float32))
    if held:
        ex = layer.experts
        with annotate("hh.moe.experts"):
            h = relu2(grouped_linear(rows, ex.up_proj.to(layer.dtype), counts, offs))
            o = grouped_linear(h, ex.down_proj.to(layer.dtype), counts, offs)
        with annotate("hh.moe.combine"):
            out = out.index_add(0, tok, o.to(out.dtype) * wp[:, None])
    return out.to(layer.dtype).view(n, T, d)


def reset_counters() -> None:
    """Set every counter of :func:`moe` to 0."""
    for c in COUNTERS:
        setattr(moe, c, 0)


#: the counters :func:`moe` keeps
COUNTERS = ("calls", "token_slots", "held_slots", "max_held_expert_slots", "empty_held_experts")
reset_counters()
