"""The Granite hybrid's plain reference: the forward pass, the next-base
cross-entropy, AdamW with the global gradient norm clipped, and three
training steps, in float32 plain PyTorch, written from the published
``config.json`` of ``ibm-granite/granite-4.0-h-micro`` (model type
``granitemoehybrid``) and the Mamba-2 paper (Dao and Gu 2024, *Transformers
are SSMs*; its minimal chunked SSD, Listing 1).

- Tokens: a window's base codes 0-4 index ``token_ids``; both haplotypes of
  each window are sequences; ``h = E[tokens] * embedding_multiplier``.
- Layer: ``h + r mixer(rms(h))``, then ``h + r mlp(rms(h))``; ``rms(x) = x /
  sqrt(mean(x^2) + eps) * w``; ``mlp(x) = W_out (silu(a) * b)``, ``[a, b] =
  W_in x``.
- Mamba-2 mixer: ``[z, xBC, dt] = W_in x``; ``xBC`` through a causal
  depthwise conv1d (width ``mamba_d_conv``, bias) and SiLU, split into ``x``
  (``H`` heads of ``P``), ``B``, ``C`` (one group, ``N`` each); ``dt =
  softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD in the paper's
  chunked form with the inter-chunk recurrence as the paper's segment-sum
  product; ``y + D x``; ``rms(y * silu(z))``; ``W_out``.
- Attention: ``q`` in ``num_attention_heads``, ``k``, ``v`` in
  ``num_key_value_heads`` heads (query head ``j`` reads key head ``j //
  (heads / key heads)``), causal softmax of ``q k^T * attention_multiplier``,
  no position encoding; blocks of query rows, each recomputed in the
  backward, so no ``T x T`` scores of every head are kept.
- Head: ``rms`` then ``logits = h E^T / logits_scaling``; the loss the mean
  cross-entropy of each position's logits against the next token, over both
  sequences' ``L - 1`` positions, the whole logits of one sequence at a time.
- AdamW as ``torch.optim.AdamW`` computes it (decoupled decay ``p (1 - lr
  wd)``, bias-corrected moments, ``eps`` outside the square root), decay on
  the leaves of two or more dimensions, after every gradient is scaled by
  ``clip / max(||g||, clip)``.

Sequences go through one at a time, each layer recomputed in the backward
(``torch.utils.checkpoint``), so the reference fits beside nothing else.

``precision="float32"`` is the reference.  ``precision="fp8"`` is the
control, one precision below the configuration's bf16: every value the
program computes in bf16 (each product's operands and result, the conv's,
the norms' and activations' outputs, the scan's inputs and output, the
attention's probabilities, the residual stream, the logits) rounded to
float8 e4m3 with a per-tensor scale on the way forward, its gradient to
e5m2 on the way back; ``dt``, the state and the log-sum-exp stay float32.
The caller turns TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: query rows of one block of the reference's attention
ATTN_BLOCK = 1024


def param_specs(m: dict) -> list[tuple[str, tuple, str, int]]:
    """``(name, shape, kind, fan_in)`` of every leaf: kind ``embed`` (``N(0,
    0.02^2)``, every matrix), ``kernel`` (the conv, ``N(0, 1 / width)``),
    ``scale`` (norm weights), ``bias``, or one of Mamba-2's ``dt_bias``,
    ``A_log``, ``D``."""
    d, V = m["hidden_size"], m["vocab_size"]
    H, P, N = m["mamba_n_heads"], m["mamba_d_head"], m["mamba_d_state"]
    W = m["mamba_expand"] * d
    conv = W + 2 * m["mamba_n_groups"] * N
    hd = d // m["num_attention_heads"]
    out = [("embed_tokens.weight", (V, d), "embed", 0)]
    for i, kind in enumerate(m["layer_types"]):
        p = f"layers.{i}."
        out.append((p + "input_layernorm.weight", (d,), "scale", 0))
        if kind == "mamba":
            q = p + "mamba."
            out += [(q + "dt_bias", (H,), "dt_bias", 0), (q + "A_log", (H,), "A_log", 0),
                    (q + "D", (H,), "D", 0),
                    (q + "in_proj.weight", (W + conv + H, d), "embed", 0),
                    (q + "conv1d.weight", (conv, 1, m["mamba_d_conv"]), "kernel",
                     m["mamba_d_conv"]),
                    (q + "conv1d.bias", (conv,), "bias", 0),
                    (q + "norm.weight", (W,), "scale", 0),
                    (q + "out_proj.weight", (d, W), "embed", 0)]
        else:
            q = p + "self_attn."
            out += [(q + "q_proj.weight", (m["num_attention_heads"] * hd, d), "embed", 0),
                    (q + "k_proj.weight", (m["num_key_value_heads"] * hd, d), "embed", 0),
                    (q + "v_proj.weight", (m["num_key_value_heads"] * hd, d), "embed", 0),
                    (q + "o_proj.weight", (d, m["num_attention_heads"] * hd), "embed", 0)]
        out += [(p + "post_attention_layernorm.weight", (d,), "scale", 0),
                (p + "shared_mlp.input_linear.weight", (2 * m["intermediate_size"], d), "embed", 0),
                (p + "shared_mlp.output_linear.weight", (d, m["intermediate_size"]), "embed", 0)]
    out.append(("norm.weight", (d,), "scale", 0))
    return out


def init(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The starting weights: ``portbench/weights.py`` for the kinds it knows
    (one draw of every element), then Mamba-2's own from a second generator
    keyed by the seed: ``A = U[1, 16]`` (``A_log = log A``), ``dt`` log-uniform
    in ``[1e-3, 1e-1]`` floored at ``1e-4`` (``dt_bias`` its softplus
    inverse), ``D = 1``."""
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
    return out


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = sum(x[..., j + 1: i + 1])`` for ``j <= i``, else
    ``-inf`` (the paper's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    low = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~low, 0), dim=-2)
    return x.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=x.device).tril(), -torch.inf)


def ssd(X, A, B, C, Q: int):
    """The paper's chunked SSD: ``X`` ``(b, T, h, p)`` (``x dt``), ``A``
    ``(b, T, h)`` (``dt A``), ``B``, ``C`` ``(b, T, n)``; ``T`` a multiple of
    ``Q``; zero initial state."""
    b, T, h, p = X.shape
    c = T // Q
    X = X.reshape(b, c, Q, h, p)
    B, C = B.reshape(b, c, Q, -1), C.reshape(b, c, Q, -1)
    A = A.reshape(b, c, Q, h).permute(0, 3, 1, 2)  # (b, h, c, Q)
    A_cumsum = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))
    Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", C, B, L, X)
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", C, states, torch.exp(A_cumsum))
    return (Y_diag + Y_off).reshape(b, T, h, p)


class Model:
    """The forward pass over a dict of float32 leaves named as ``param_specs``."""

    def __init__(self, m: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m = m
        self.q = _Fp8.apply if precision == "fp8" else (lambda x: x)

    def _lin(self, x, w):
        q = self.q
        return q(q(x) @ q(w).t())

    def _rms(self, x, w):
        return self.q(x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.m["rms_norm_eps"]) * w)

    def _mamba(self, x, p, name):
        m, q = self.m, self.q
        n, T, _ = x.shape
        H, P, N = m["mamba_n_heads"], m["mamba_d_head"], m["mamba_d_state"]
        W, k = m["mamba_expand"] * m["hidden_size"], m["mamba_d_conv"]
        conv = W + 2 * N
        z, xbc, dt = self._lin(x, p[name + "in_proj.weight"]).split([W, conv, H], dim=-1)
        xbc = q(F.conv1d(xbc.transpose(1, 2), q(p[name + "conv1d.weight"]),
                         q(p[name + "conv1d.bias"]), padding=k - 1, groups=conv)[..., :T])
        xbc = q(F.silu(xbc)).transpose(1, 2)
        xs, B, C = xbc[..., :W].reshape(n, T, H, P), xbc[..., W: W + N], xbc[..., W + N:]
        dt = F.softplus(dt + p[name + "dt_bias"])
        A = -torch.exp(p[name + "A_log"])
        Q = m["mamba_chunk_size"]
        pad = (-T) % Q
        if pad:
            xs, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xs, dt, B, C))
        y = ssd(xs * dt[..., None], dt * A, B, C, Q)[:, :T]
        y = q(y + xs[:, :T] * p[name + "D"][:, None])
        y = self._rms(y.reshape(n, T, W) * q(F.silu(z)), p[name + "norm.weight"])
        return self._lin(y, p[name + "out_proj.weight"])

    def _attention(self, x, p, name):
        m, q = self.m, self.q
        n, T, d = x.shape
        Hq, Hk = m["num_attention_heads"], m["num_key_value_heads"]
        hd = d // Hq
        qh = self._lin(x, p[name + "q_proj.weight"]).reshape(n, T, Hq, hd).transpose(1, 2)
        kh = self._lin(x, p[name + "k_proj.weight"]).reshape(n, T, Hk, hd).transpose(1, 2)
        vh = self._lin(x, p[name + "v_proj.weight"]).reshape(n, T, Hk, hd).transpose(1, 2)
        kh = kh.repeat_interleave(Hq // Hk, dim=1)
        vh = vh.repeat_interleave(Hq // Hk, dim=1)
        scale = m["attention_multiplier"]

        def block(qb, kh, vh, start):
            rows = torch.arange(start, start + qb.shape[2], device=qb.device)
            mask = rows[:, None] >= torch.arange(T, device=qb.device)[None, :]
            s = (qb @ kh.transpose(-1, -2)) * scale
            w = q(torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1))
            return q(w @ vh)

        outs = [checkpoint(block, qh[:, :, a: a + ATTN_BLOCK], kh, vh, a, use_reentrant=False)
                for a in range(0, T, ATTN_BLOCK)]
        a = torch.cat(outs, dim=2).transpose(1, 2).reshape(n, T, d)
        return self._lin(a, p[name + "o_proj.weight"])

    def _layer(self, h, p, i):
        m, q = self.m, self.q
        r, name = m["residual_multiplier"], f"layers.{i}."
        x = self._rms(h, p[name + "input_layernorm.weight"])
        if m["layer_types"][i] == "mamba":
            h = q(h + r * self._mamba(x, p, name + "mamba."))
        else:
            h = q(h + r * self._attention(x, p, name + "self_attn."))
        x = self._rms(h, p[name + "post_attention_layernorm.weight"])
        a, b = self._lin(x, p[name + "shared_mlp.input_linear.weight"]).chunk(2, dim=-1)
        y = self._lin(q(F.silu(a) * b), p[name + "shared_mlp.output_linear.weight"])
        return q(h + r * y)

    def hidden(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The final norm's output ``(n, L, hidden)``, the head's input."""
        m = self.m
        h = self.q(p["embed_tokens.weight"][tokens] * m["embedding_multiplier"])
        for i in range(len(m["layer_types"])):
            h = checkpoint(self._layer, h, p, i, use_reentrant=False)
        return self._rms(h, p["norm.weight"])

    def loss_sum(self, p: dict, hn: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The summed cross-entropy of one sequence's ``(1, L, d)`` head
        input against its next tokens, over the whole logits."""
        logits = self.q(self.q(hn[0, :-1]) @ self.q(p["embed_tokens.weight"]).t())
        return F.cross_entropy(logits / self.m["logits_scaling"], tokens[0, 1:], reduction="sum")


def tokens(m: dict, hap1: torch.Tensor, hap2: torch.Tensor) -> torch.Tensor:
    table = torch.tensor(m["token_ids"], dtype=torch.int64, device=hap1.device)
    return table[torch.cat([hap1, hap2]).long()]


def train(m: dict, opt: dict, weights: dict, batches: list, precision: str = "float32",
          keep_steps: bool = False) -> dict:
    """AdamW steps with the clip from ``weights`` on ``batches`` of ``(hap1,
    hap2)``.  Returns ``losses`` (a list a step); ``grad_vec`` (each leaf's
    first gradient, clipped, as AdamW takes it) and ``grad`` (its norm);
    ``change`` (each leaf's change norm after the last step);
    ``output_grads`` (``{"hidden": (2B, L, d)}``: the loss's gradient with
    respect to the first step's head input); ``grad_norm_before_clip``.  With
    ``keep_steps``, ``steps`` holds each step's ``(grads, updates)``."""
    model = Model(m, precision)
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    lr, (b1, b2), eps = opt["learning_rate"], opt["betas"], opt["eps"]
    wd, clip = opt["weight_decay"], opt["clip_global_norm"]
    out = {"losses": []}
    steps = []
    for t, (h1, h2) in enumerate(batches, start=1):
        toks = tokens(m, h1, h2)
        n = toks.shape[0] * (toks.shape[1] - 1)
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        total, rows = 0.0, []
        for s in range(toks.shape[0]):
            hn = model.hidden(p, toks[s: s + 1])
            loss = model.loss_sum(p, hn, toks[s: s + 1]) / n
            got = torch.autograd.grad(loss, list(p.values()) + [hn])
            for k, g in zip(p, got):
                grads[k] += g
            rows.append(got[-1].detach())
            total += float(loss.detach())
            del hn, loss, got
        out["losses"].append(total)
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = float(clip / max(float(norm), clip))
        grads = {k: g * scale for k, g in grads.items()}
        if t == 1:
            out["output_grads"] = {"hidden": torch.cat(rows).float().cpu()}
            out["grad_vec"] = grads
            out["grad_norm_before_clip"] = float(norm)
            out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
        updates = {}
        with torch.no_grad():
            for k, w in p.items():
                g = grads[k]
                before = w.detach().clone() if keep_steps else None
                if w.dim() >= 2:
                    w.mul_(1 - lr * wd)
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                w.sub_(lr * (mom[k] / (1 - b1 ** t))
                       / ((vel[k] / (1 - b2 ** t)).sqrt() + eps))
                if keep_steps:
                    updates[k] = (w - before).cpu()
        if keep_steps:
            steps.append(({k: g.cpu() for k, g in grads.items()}, updates))
        del grads
    out["change"] = {k: float((w.detach() - weights[k].float()).norm()) for k, w in p.items()}
    return out | ({"steps": steps} if keep_steps else {})
