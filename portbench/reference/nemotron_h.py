"""The Nemotron-H hybrid's plain reference: the forward pass, the next-base
cross-entropy, AdamW with the global gradient norm clipped, the router
biases' update, and three training steps, in float32 plain PyTorch, written
from the published ``config.json`` of ``nvidia/NVIDIA-Nemotron-3-Nano-30B-
A3B-BF16`` (model type ``nemotron_h``), the Mamba-2 paper (Dao and Gu 2024,
*Transformers are SSMs*; its minimal chunked SSD, Listing 1, with groups of
``B`` and ``C``) and DeepSeek-V3's routing (arXiv:2412.19437, §2.1.2).

- Tokens: a window's base codes 0-4 index ``token_ids``; both haplotypes of
  each window are sequences; ``h = E[tokens]``.
- Layer: ``h + mixer(rms(h))``; ``rms(x) = x / sqrt(mean(x^2) + eps) * w``.
  The mixer is the letter of ``hybrid_override_pattern``:
- ``M``, Mamba-2: ``[z, xBC, dt] = W_in x``; ``xBC`` through a causal
  depthwise conv1d (width ``conv_kernel``, bias) and SiLU, split into ``x``
  (``H`` heads of ``P``), ``B``, ``C`` (``n_groups`` groups of ``N``; head
  ``h`` reads group ``h // (H / n_groups)``); ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the SSD in the paper's chunked form
  (chunks of ``chunk_size``), the inter-chunk recurrence as the paper's
  segment-sum product; ``y + D x``; ``rms`` of ``y * silu(z)`` over each
  group's ``H P / n_groups`` columns; ``W_out``.
- ``E``, MoE: scores ``s = sigmoid(x W_r^T)`` over all ``n_routed_experts``;
  each token's ``top_k`` experts by ``s + e_score_correction_bias`` (or the
  ones given); their weights the unbiased ``s`` over their sum plus 1e-20,
  times ``routed_scaling_factor``; for each held expert ``e`` (``first ..
  first + count - 1``) its tokens' ``w down_e(relu(up_e x)^2)``, one expert
  at a time; experts held elsewhere add nothing (tokens given no selection
  route by their own); plus the shared expert
  ``down(relu(up x)^2)``.
- ``*``, attention: ``q`` in ``num_attention_heads``, ``k``, ``v`` in
  ``num_key_value_heads`` heads of ``head_dim`` (query head ``j`` reads key
  head ``j // (heads / key heads)``), causal softmax of ``q k^T /
  sqrt(head_dim)``, no position encoding; blocks of query rows, each
  recomputed in the backward.
- Head: ``rms`` then ``logits = h W_head^T``; the loss the mean
  cross-entropy of each position's logits against the next token, over every
  sequence's ``L - 1`` positions, the whole logits of one sequence at a time.
- AdamW as ``torch.optim.AdamW`` computes it, decay on the leaves of two or
  more dimensions, after every gradient is scaled by ``clip / max(||g||,
  clip)``; then each router bias moves by ``gamma`` in the sign of (mean
  load - the expert's load), the loads counted over the step's selections.

The selection is a step's only decision that is not a smooth function of
the weights: where two experts' biased scores all but tie, one bf16 rounding
flips it.  So :func:`train` takes the selections a program made
(``selections``: a step's ``{layer: (tokens, top_k)}``) and routes by them,
recomputing their weights from its own float32 scores, and reports beside
them the selections it makes of its own (``own``), for the share
that differs.

Sequences go through one at a time, each layer recomputed in the backward
(``torch.utils.checkpoint``), so the reference fits beside nothing else.

``precision="float32"`` is the reference.  ``precision="fp8"`` is the
control, one precision below the configuration's bf16: every value the
program computes in bf16 (each product's operands and result but the
router's, the conv's, the norms' and activations' outputs, the scan's inputs
and output, the attention's probabilities, the residual stream, the logits)
rounded to float8 e4m3 with a per-tensor scale on the way forward, its
gradient to e5m2 on the way back; the router's product and scores, ``dt``,
the state and the log-sum-exp stay float32.  The caller turns TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.granite_hybrid import ATTN_BLOCK, _Fp8, segsum

#: the mixer each letter of ``hybrid_override_pattern`` names
KINDS = {"M": "mamba", "E": "moe", "*": "attention"}
#: the seeded router bias's standard deviation: ignoring it changes about a
#: tenth of the selections at the configuration's widths
ROUTER_BIAS_STD = 0.02


def kinds(m: dict) -> list[str]:
    return [KINDS[c] for c in m["hybrid_override_pattern"]]


def param_specs(m: dict) -> list[tuple[str, tuple, str, int]]:
    """``(name, shape, kind, fan_in)`` of every leaf: kind ``embed`` (``N(0,
    0.02^2)``, every matrix), ``kernel`` (the conv, ``N(0, 1 / width)``),
    ``scale`` (norm weights), ``bias``, or one of Mamba-2's ``dt_bias``,
    ``A_log``, ``D``."""
    d, V = m["hidden_size"], m["vocab_size"]
    H, P, N, G = m["mamba_num_heads"], m["mamba_head_dim"], m["ssm_state_size"], m["n_groups"]
    W = H * P
    conv = W + 2 * G * N
    E, f, fs = m["experts_held"][1], m["moe_intermediate_size"], \
        m["moe_shared_expert_intermediate_size"]
    Hq, Hk, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    out = [("embed_tokens.weight", (V, d), "embed", 0)]
    for i, kind in enumerate(kinds(m)):
        p = f"layers.{i}."
        out.append((p + "norm.weight", (d,), "scale", 0))
        q = p + "mixer."
        if kind == "mamba":
            out += [(q + "dt_bias", (H,), "dt_bias", 0), (q + "A_log", (H,), "A_log", 0),
                    (q + "D", (H,), "D", 0),
                    (q + "in_proj.weight", (W + conv + H, d), "embed", 0),
                    (q + "conv1d.weight", (conv, 1, m["conv_kernel"]), "kernel",
                     m["conv_kernel"]),
                    (q + "conv1d.bias", (conv,), "bias", 0),
                    (q + "norm.weight", (W,), "scale", 0),
                    (q + "out_proj.weight", (d, W), "embed", 0)]
        elif kind == "moe":
            out += [(q + "gate.weight", (m["n_routed_experts"], d), "embed", 0),
                    (q + "experts.up_proj", (E, f, d), "embed", 0),
                    (q + "experts.down_proj", (E, d, f), "embed", 0),
                    (q + "shared_experts.up_proj.weight", (fs, d), "embed", 0),
                    (q + "shared_experts.down_proj.weight", (d, fs), "embed", 0)]
        else:
            out += [(q + "q_proj.weight", (Hq * hd, d), "embed", 0),
                    (q + "k_proj.weight", (Hk * hd, d), "embed", 0),
                    (q + "v_proj.weight", (Hk * hd, d), "embed", 0),
                    (q + "o_proj.weight", (d, Hq * hd), "embed", 0)]
    out += [("norm_f.weight", (d,), "scale", 0), ("lm_head.weight", (V, d), "embed", 0)]
    return out


def bias_names(m: dict) -> list[str]:
    """The router biases' names, one a MoE layer (buffers, not leaves)."""
    return [f"layers.{i}.mixer.e_score_correction_bias"
            for i, kind in enumerate(kinds(m)) if kind == "moe"]


def init(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The starting weights: ``portbench/weights.py`` for the kinds it knows
    (one draw of every element), then from a second generator keyed by the
    seed Mamba-2's own (``A = U[1, 16]``, ``A_log = log A``; ``dt``
    log-uniform in ``[1e-3, 1e-1]`` floored at ``1e-4``, ``dt_bias`` its
    softplus inverse; ``D = 1``) and each router bias ``N(0,
    ROUTER_BIAS_STD^2)``.  The biases are in the dict under
    :func:`bias_names`."""
    from portbench import weights

    specs = param_specs(m)
    known = [(n, s, k if k in ("embed", "kernel", "scale", "bias") else "bias", f)
             for n, s, k, f in specs]
    out = weights.make(known, seed, device)
    g = torch.Generator(device=device).manual_seed((seed % 2**62) ^ (1 << 62))
    for name, shape, kind, _ in specs:
        if kind == "A_log":
            out[name] = torch.log(1 + 15 * torch.rand(shape, generator=g, device=device))
        elif kind == "dt_bias":
            u = torch.rand(shape, generator=g, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp_min(1e-4)
            out[name] = dt + torch.log(-torch.expm1(-dt))
        elif kind == "D":
            out[name] = torch.ones(shape, device=device)
    for name in bias_names(m):
        out[name] = ROUTER_BIAS_STD * torch.randn(m["n_routed_experts"], generator=g,
                                                  device=device)
    return out


def ssd(X, A, B, C, Q: int):
    """The paper's chunked SSD with groups: ``X`` ``(b, T, h, p)`` (``x
    dt``), ``A`` ``(b, T, h)`` (``dt A``), ``B``, ``C`` ``(b, T, g, n)``,
    head ``h`` reading group ``h // (heads / g)``; ``T`` a multiple of
    ``Q``; zero initial state."""
    b, T, h, p = X.shape
    c, G = T // Q, B.shape[2]
    B = B.repeat_interleave(h // G, dim=2)  # (b, T, h, n): each head's group
    C = C.repeat_interleave(h // G, dim=2)
    X = X.reshape(b, c, Q, h, p)
    B, C = B.reshape(b, c, Q, h, -1), C.reshape(b, c, Q, h, -1)
    A = A.reshape(b, c, Q, h).permute(0, 3, 1, 2)  # (b, h, c, Q)
    A_cumsum = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, L, X)
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states, torch.exp(A_cumsum))
    return (Y_diag + Y_off).reshape(b, T, h, p)


class Model:
    """The forward pass over a dict of float32 leaves named as
    ``param_specs``, the router biases in ``bias`` (name to ``(E,)``)."""

    def __init__(self, m: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m = m
        self.q = _Fp8.apply if precision == "fp8" else (lambda x: x)
        #: the selections to route by, ``{layer: (L, top_k)}`` of the
        #: sequence at hand (a layer missing: its own)
        self.given: dict = {}
        #: the selections made of its own, and the ones routed by
        self.own: dict = {}
        self.used: dict = {}

    def _lin(self, x, w):
        q = self.q
        return q(q(x) @ q(w).t())

    def _rms(self, x, w, group=None):
        eps = self.m["layer_norm_epsilon"]
        if group is not None:
            u = x.unflatten(-1, (x.shape[-1] // group, group))
            u = u * torch.rsqrt(u.pow(2).mean(-1, keepdim=True) + eps)
            return self.q(u.flatten(-2) * w)
        return self.q(x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w)

    def _mamba(self, x, p, name):
        m, q = self.m, self.q
        n, T, _ = x.shape
        H, P, N, G = m["mamba_num_heads"], m["mamba_head_dim"], m["ssm_state_size"], \
            m["n_groups"]
        W, k = H * P, m["conv_kernel"]
        conv = W + 2 * G * N
        z, xbc, dt = self._lin(x, p[name + "in_proj.weight"]).split([W, conv, H], dim=-1)
        xbc = q(F.conv1d(xbc.transpose(1, 2), q(p[name + "conv1d.weight"]),
                         q(p[name + "conv1d.bias"]), padding=k - 1, groups=conv)[..., :T])
        xbc = q(F.silu(xbc)).transpose(1, 2)
        xs = xbc[..., :W].reshape(n, T, H, P)
        B = xbc[..., W: W + G * N].reshape(n, T, G, N)
        C = xbc[..., W + G * N:].reshape(n, T, G, N)
        dt = F.softplus(dt + p[name + "dt_bias"])
        A = -torch.exp(p[name + "A_log"])
        Q = m["chunk_size"]
        pad = (-T) % Q
        if pad:
            xs, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xs, dt, B, C))
        y = ssd(xs * dt[..., None], dt * A, B, C, Q)[:, :T]
        y = q(y + xs[:, :T] * p[name + "D"][:, None])
        y = self._rms(y.reshape(n, T, W) * q(F.silu(z)), p[name + "norm.weight"], W // G)
        return self._lin(y, p[name + "out_proj.weight"])

    def _moe(self, x, p, name, bias, layer):
        m, q = self.m, self.q
        n, T, d = x.shape
        xf = q(x.reshape(n * T, d))
        k = m["num_experts_per_tok"]
        first, count = m["experts_held"]
        s = torch.sigmoid(xf @ p[name + "gate.weight"].t())
        with torch.no_grad():
            own = torch.topk(s + bias, k, dim=-1, sorted=False).indices
        self.own[layer] = own
        chosen = self.given.get(layer)
        if chosen is None or chosen.shape != own.shape:  # none given for these tokens
            chosen = own
        self.used[layer] = chosen
        w = s.gather(1, chosen)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * m["routed_scaling_factor"]
        out = torch.zeros_like(xf)
        for e in range(count):
            hit = chosen == first + e  # (tokens, k): at most one slot a token
            tok = hit.any(-1).nonzero()[:, 0]
            if not len(tok):
                continue
            we = (w * hit).sum(-1)[tok]
            h = q(F.relu(self._lin(xf[tok], p[name + "experts.up_proj"][e])).square())
            out = out.index_add(0, tok, self._lin(h, p[name + "experts.down_proj"][e])
                                * we[:, None])
        h = q(F.relu(self._lin(xf, p[name + "shared_experts.up_proj.weight"])).square())
        out = out + self._lin(h, p[name + "shared_experts.down_proj.weight"])
        return q(out).view(n, T, d)

    def _attention(self, x, p, name):
        m, q = self.m, self.q
        n, T, _ = x.shape
        Hq, Hk, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
        qh = self._lin(x, p[name + "q_proj.weight"]).reshape(n, T, Hq, hd).transpose(1, 2)
        kh = self._lin(x, p[name + "k_proj.weight"]).reshape(n, T, Hk, hd).transpose(1, 2)
        vh = self._lin(x, p[name + "v_proj.weight"]).reshape(n, T, Hk, hd).transpose(1, 2)
        kh = kh.repeat_interleave(Hq // Hk, dim=1)
        vh = vh.repeat_interleave(Hq // Hk, dim=1)
        scale = 1 / math.sqrt(hd)

        def block(qb, kh, vh, start):
            rows = torch.arange(start, start + qb.shape[2], device=qb.device)
            mask = rows[:, None] >= torch.arange(T, device=qb.device)[None, :]
            s = (qb @ kh.transpose(-1, -2)) * scale
            w = q(torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1))
            return q(w @ vh)

        outs = [checkpoint(block, qh[:, :, a: a + ATTN_BLOCK], kh, vh, a, use_reentrant=False)
                for a in range(0, T, ATTN_BLOCK)]
        a = torch.cat(outs, dim=2).transpose(1, 2).reshape(n, T, Hq * hd)
        return self._lin(a, p[name + "o_proj.weight"])

    def _layer(self, h, p, bias, i):
        name, kind = f"layers.{i}.", kinds(self.m)[i]
        x = self._rms(h, p[name + "norm.weight"])
        if kind == "mamba":
            y = self._mamba(x, p, name + "mixer.")
        elif kind == "moe":
            y = self._moe(x, p, name + "mixer.", bias[name + "mixer.e_score_correction_bias"], i)
        else:
            y = self._attention(x, p, name + "mixer.")
        return self.q(h + y)

    def hidden(self, p: dict, bias: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The final norm's output ``(n, L, hidden)``, the head's input."""
        h = self.q(p["embed_tokens.weight"][tokens])
        for i in range(len(kinds(self.m))):
            h = checkpoint(self._layer, h, p, bias, i, use_reentrant=False)
        return self._rms(h, p["norm_f.weight"])

    def loss_sum(self, p: dict, hn: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The summed cross-entropy of one sequence's ``(1, L, d)`` head
        input against its next tokens, over the whole logits."""
        logits = self.q(self.q(hn[0, :-1]) @ self.q(p["lm_head.weight"]).t())
        return F.cross_entropy(logits, tokens[0, 1:], reduction="sum")


def split_experts(leaves: dict) -> dict:
    """``leaves`` with each stack of routed experts (``experts.up_proj``,
    ``experts.down_proj``) cut into its experts, ``<name>.<e>`` each: the
    checks count each expert as a leaf of its own, so a fault in one expert
    is not averaged into fifteen sound ones."""
    out = {}
    for k, v in leaves.items():
        if k.endswith(("experts.up_proj", "experts.down_proj")):
            out |= {f"{k}.{e}": part for e, part in enumerate(v.unbind(0))}
        else:
            out[k] = v
    return out


def tokens(m: dict, hap1: torch.Tensor, hap2: torch.Tensor) -> torch.Tensor:
    table = torch.tensor(m["token_ids"], dtype=torch.int64, device=hap1.device)
    return table[torch.cat([hap1, hap2]).long()]


def mismatched_slots(got: torch.Tensor, want: torch.Tensor, n_experts: int) -> int:
    """(token, slot) pairs of ``got`` ``(tokens, k)`` whose expert is not
    among the token's experts in ``want``."""
    a = torch.zeros(got.shape[0], n_experts, dtype=torch.bool, device=got.device)
    b = torch.zeros_like(a)
    a.scatter_(1, got, True)
    b.scatter_(1, want.to(got.device), True)
    return int((a & ~b).sum())


def train(m: dict, opt: dict, weights: dict, batches: list, precision: str = "float32",
          selections: list | None = None) -> dict:
    """AdamW steps with the clip from ``weights`` (leaves and router biases, as
    :func:`init` makes them) on ``batches`` of ``(hap1, hap2)``, each
    followed by the router biases' update. ``selections``: a step's
    ``{layer: (tokens, top_k)}`` to route by (tokens in the program's order,
    sequence after sequence); None routes by its own. Returns ``losses``;
    ``grad_vec`` (each leaf's first gradient, clipped, as AdamW takes it)
    and ``grad`` (its norm); ``change`` (each leaf's change norm after the
    last step, each routed expert of a stack a leaf of its own:
    :func:`split_experts`); ``output_grads`` (``{"hidden": (2B, L, d)}``:
    the loss's gradient with respect to the first step's head input);
    ``grad_norm_before_clip``; ``used`` and ``own`` (a step's ``{layer:
    (tokens, top_k)}``: the selections routed by and those of its own)."""
    model = Model(m, precision)
    names = set(bias_names(m))
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in weights.items() if k not in names}
    bias = {k: weights[k].detach().clone().float() for k in names}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    lr, (b1, b2), eps = opt["learning_rate"], opt["betas"], opt["eps"]
    wd, clip = opt["weight_decay"], opt["clip_global_norm"]
    gamma, E = m["router_bias_update_rate"], m["n_routed_experts"]
    out = {"losses": [], "used": [], "own": []}
    for t, (h1, h2) in enumerate(batches, start=1):
        toks = tokens(m, h1, h2)
        L = toks.shape[1]
        n = toks.shape[0] * (L - 1)
        given = selections[t - 1] if selections is not None else {}
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        used, own = {}, {}
        total, rows = 0.0, []
        for s in range(toks.shape[0]):
            model.given = {i: g[s * L: (s + 1) * L].to(toks.device) for i, g in given.items()}
            hn = model.hidden(p, bias, toks[s: s + 1])
            loss = model.loss_sum(p, hn, toks[s: s + 1]) / n
            # a held expert no token of the sequence picked has no gradient
            got = torch.autograd.grad(loss, list(p.values()) + [hn], allow_unused=True)
            for k, g in zip(p, got):
                if g is not None:
                    grads[k] += g
            rows.append(got[-1].detach())
            total += float(loss.detach())
            for dst, src in ((used, model.used), (own, model.own)):
                for i, sel in src.items():
                    dst.setdefault(i, []).append(sel.cpu())
            del hn, loss, got
        used = {i: torch.cat(v) for i, v in used.items()}
        out["used"].append(used)
        out["own"].append({i: torch.cat(v) for i, v in own.items()})
        out["losses"].append(total)
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = float(clip / max(float(norm), clip))
        grads = {k: g * scale for k, g in grads.items()}
        if t == 1:
            out["output_grads"] = {"hidden": torch.cat(rows).float().cpu()}
            out["grad_vec"] = grads
            out["grad_norm_before_clip"] = float(norm)
            out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
        with torch.no_grad():
            for k, w in p.items():
                g = grads[k]
                if w.dim() >= 2:
                    w.mul_(1 - lr * wd)
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                w.sub_(lr * (mom[k] / (1 - b1 ** t))
                       / ((vel[k] / (1 - b2 ** t)).sqrt() + eps))
            for i, sel in used.items():
                load = torch.bincount(sel.flatten(), minlength=E).float()
                b = bias[f"layers.{i}.mixer.e_score_correction_bias"]
                b += gamma * torch.sign(load.mean() - load).to(b.device)
        del grads
    change = split_experts({k: w.detach() - weights[k].float() for k, w in p.items()})
    out["change"] = {k: float(v.norm()) for k, v in change.items()}
    out["bias"] = bias
    return out
