"""Enformer's plain reference: the forward pass, the Poisson loss, Adam with
the global gradient norm clipped, and three training steps, in float32 plain
PyTorch, written from the published equations (Avsec et al. 2021, Nature
Methods 18:1196; ``enformer/enformer.py`` and ``attention_module.py`` of
github.com/google-deepmind/deepmind-research).

- Input: ``(N, L)`` codes one-hot over A, C, G, T (codes 0-3); another code
  gives a zero row.
- ``conv_block(f, w)``: batch norm with the batch's statistics over the
  sequences and positions (biased variance, epsilon 1e-5), scale and
  offset; ``gelu(x) = sigmoid(1.702 x) x``; a SAME ``Conv1D(f, w)`` with a
  bias.
- Stem: ``Conv1D(C/2, 15)``, ``x + conv_block(C/2, 1)(x)``, softmax pooling.
  Tower: for each size ``f`` of the filter list, ``conv_block(f, 5)``, ``x +
  conv_block(f, 1)(x)``, softmax pooling.  Softmax pooling by 2: pairs of
  positions summed under the softmax, over the pair, of ``x @ W`` (per
  channel, no bias).
- Transformer blocks: ``x + drop(MHA(LN(x)))``, ``x + drop(W2 relu(drop(W1
  LN(x) + b1)) + b2)``, layer norms with epsilon 1e-5.  MHA: q, k, v with no
  bias, ``q`` times ``key_size^-0.5``; relative positions ``d = -(T-1) ..
  T-1`` get ``F`` features, ``F/6`` each of ``exp(-ln2 |d| / h)`` (half
  lives ``2^linspace(3, log2 T)``), ``[|d| < 2^k - 1]`` (``k = 1 .. F/6``)
  and the gamma density at ``|d|`` (means ``linspace(T / (F/6), T)``,
  standard deviation ``T / (2 F/6)``, plus 1e-8, each feature over its
  largest value), then the same times ``sign(d)``; positional dropout;
  ``r_k = features W_r``; ``logits[i, j] = (q_i + r_w) . k_j + (q_i + r_r) .
  r_k[j - i + T - 1]`` (an index gather, not the published pad and
  reshape); softmax, attention dropout, ``@ v``, ``Linear(C)`` with a bias.
- Crop ``(T - target) / 2`` tokens from each end; ``conv_block(2C, 1)``,
  dropout, GELU; the head ``Linear(tracks)`` and softplus.
- Loss: ``mean(rate - y log(rate + 1e-7))``.  Adam (bias-corrected moments,
  ``eps`` outside the square root, no weight decay) after scaling every
  gradient by ``clip / max(||g||, clip)``, ``||g||`` over all leaves.

Departures from the published model, as the program makes them: **both
haplotypes** of a window go through the trunk as one batch of ``2B``
sequences, and the window's rate is the mean of its two haplotypes' rates;
**one head**, the human one (the cohort is human); **local batch-norm
statistics**, the batch's own, where the published run synchronised them
over 64 replicas; Adam at its post-warm-up learning rate.

Dropout: the masks are ``torch.rand(shape, generator=g) >= rate`` (kept
values divided by ``1 - rate``) from one generator, seeded as the program
seeds its train state's, drawn per step in the program's order: for each
transformer block the position features ``(2T - 1, F)``, the attention
weights ``(N, H, T, T)``, the attention output ``(N, T, C)``, the MLP
hidden ``(N, T, 2C)`` and output ``(N, T, C)``; then the final pointwise
output ``(N, 2C, target)``.  They are drawn before the step's forward, so a
stage recomputed under ``torch.utils.checkpoint`` (``checkpoint=True``,
which the card's memory needs at full size) sees the same ones.

``precision="float32"`` is the reference.  ``precision="fp8"`` is the
control, one precision below the configuration's bf16: every value computed
in the compute dtype (each matrix product's and convolution's operands and
result, the norms', activations' and pooling's outputs, the softmax, the
residual stream) rounded to float8 e4m3 with a per-tensor scale on the way
forward, and its gradient to e5m2 on the way back; sums accumulate in
float32.  The caller turns TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

EPS = 1e-5
POISSON_EPS = 1e-7


def filter_list(m: dict) -> list[int]:
    """``exponential_linspace_int(C / 2, C, tower_stages, divisible_by)``."""
    start, end, num = m["channels"] // 2, m["channels"], m["tower_stages"]
    base = np.exp(np.log(end / start) / (num - 1))
    return [int(np.round(start * base**i / m["divisible_by"]) * m["divisible_by"])
            for i in range(num)]


def tracks(heads: dict) -> int:
    (n,) = heads.values()
    return n


def param_specs(m: dict, heads: dict) -> list[tuple[str, tuple, str, int]]:
    """``(name, shape, kind, fan_in)`` of every leaf, in the program's order;
    ``kind`` is ``kernel``, ``bias`` or ``scale``."""
    C, H, K, V = m["channels"], m["num_heads"], m["key_size"], m["value_size"]
    R = m["num_relative_position_features"]
    out = []

    def conv(p, w, c_in, c_out):
        out.extend([(p + "kernel", (w, c_in, c_out), "kernel", w * c_in),
                    (p + "bias", (c_out,), "bias", 0)])

    def block(p, w, c_in, c_out):
        out.extend([(p + "norm.scale", (c_in,), "scale", 0), (p + "norm.bias", (c_in,), "bias", 0)])
        conv(p + "conv.", w, c_in, c_out)

    def stage(p, c_in, f, stem):
        if stem:
            conv(p + "conv.", m["stem_width"], c_in, f)
        else:
            block(p + "conv.", m["tower_width"], c_in, f)
        block(p + "pointwise.", 1, f, f)
        out.append((p + "pool.kernel", (f, f), "kernel", f))

    stage("stem.", m["num_channels"], C // 2, True)
    fl = filter_list(m)
    for i, (c_in, f) in enumerate(zip([C // 2] + fl[:-1], fl)):
        stage(f"tower.{i}.", c_in, f, False)
    for i in range(m["num_transformer_layers"]):
        p = f"transformer.{i}."
        out += [(p + "mha_norm.scale", (C,), "scale", 0), (p + "mha_norm.bias", (C,), "bias", 0),
                (p + "attention.r_w_bias", (H, K), "bias", 0),
                (p + "attention.r_r_bias", (H, K), "bias", 0),
                (p + "attention.query.kernel", (C, H * K), "kernel", C),
                (p + "attention.key.kernel", (C, H * K), "kernel", C),
                (p + "attention.value.kernel", (C, H * V), "kernel", C),
                (p + "attention.rel_key.kernel", (R, H * K), "kernel", R),
                (p + "attention.out.kernel", (H * V, C), "kernel", H * V),
                (p + "attention.out.bias", (C,), "bias", 0),
                (p + "mlp_norm.scale", (C,), "scale", 0), (p + "mlp_norm.bias", (C,), "bias", 0),
                (p + "mlp_in.kernel", (C, 2 * C), "kernel", C), (p + "mlp_in.bias", (2 * C,), "bias", 0),
                (p + "mlp_out.kernel", (2 * C, C), "kernel", 2 * C),
                (p + "mlp_out.bias", (C,), "bias", 0)]
    block("final.", 1, C, 2 * C)
    out += [("head.kernel", (2 * C, tracks(heads)), "kernel", 2 * C),
            ("head.bias", (tracks(heads),), "bias", 0)]
    return out


def position_features(T: int, F_: int, device) -> torch.Tensor:
    """``(2T - 1, F)`` features of the distances ``-(T-1) .. T-1``."""
    d = torch.arange(-T + 1, T, dtype=torch.float64, device=device)
    a = d.abs()[:, None]
    n = F_ // 6
    half_life = 2.0 ** torch.linspace(3.0, math.log2(T), n, dtype=torch.float64, device=device)
    expo = torch.exp(-math.log(2.0) * a / half_life)
    mask = (a < 2.0 ** torch.arange(1, n + 1, dtype=torch.float64, device=device) - 1).double()
    mean = torch.linspace(T / n, T, n, dtype=torch.float64, device=device)
    sd = T / (2 * n)
    shape, rate = (mean / sd) ** 2, mean / sd**2
    # the gamma density; every shape is above 1, so it is 0 at x = 0
    log_density = ((shape - 1) * torch.log(a.clamp_min(1e-300)) - rate * a
                   - torch.lgamma(shape) + shape * torch.log(rate))
    gamma = torch.where(a > 0, torch.exp(log_density), 0.0) + 1e-8
    gamma = gamma / gamma.max(dim=0, keepdim=True).values
    f = torch.cat([expo, mask, gamma], dim=1)
    return torch.cat([f, torch.sign(d)[:, None] * f], dim=1).float()


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


def draw_masks(m: dict, g: torch.Generator, N: int, device) -> list[torch.Tensor]:
    """One step's keep masks, in the program's order (the module's docstring)."""
    C, H = m["channels"], m["num_heads"]
    T = m["sequence_length"] // 2 ** (1 + m["tower_stages"])
    R = m["num_relative_position_features"]
    rates = []
    for _ in range(m["num_transformer_layers"]):
        rates += [((2 * T - 1, R), m["positional_dropout_rate"]),
                  ((N, H, T, T), m["attention_dropout_rate"]),
                  ((N, T, C), m["dropout_rate"]), ((N, T, 2 * C), m["dropout_rate"]),
                  ((N, T, C), m["dropout_rate"])]
    rates.append(((N, 2 * C, m["target_length"]), m["final_dropout_rate"]))
    return [torch.rand(shape, generator=g, device=device) >= rate for shape, rate in rates]


class Model:
    """The forward pass over a dict of float32 leaves named as ``param_specs``."""

    def __init__(self, m: dict, precision: str = "float32", checkpoint: bool = False):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m = m
        self.q = _Fp8.apply if precision == "fp8" else (lambda x: x)
        self.checkpoint = checkpoint

    def _run(self, fn, *args):
        if self.checkpoint:
            return _checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # -- layers (x channels-first (N, C, L) in the tower) --
    def _conv(self, x, p, name):
        q = self.q
        w = p[name + "kernel"].permute(2, 1, 0)
        return q(F.conv1d(q(x), q(w), q(p[name + "bias"]), padding="same"))

    def _bn(self, x, p, name):
        mu = x.mean(dim=(0, 2), keepdim=True)
        var = ((x - mu) ** 2).mean(dim=(0, 2), keepdim=True)
        y = (x - mu) / torch.sqrt(var + EPS)
        return self.q(y * p[name + "scale"][:, None] + p[name + "bias"][:, None])

    def _gelu(self, x):
        return self.q(torch.sigmoid(1.702 * x) * x)

    def _block(self, x, p, name):
        return self._conv(self._gelu(self._bn(x, p, name + "norm.")), p, name + "conv.")

    def _pool(self, x, p, name):
        q = self.q
        N, C, L = x.shape
        logits = q(torch.einsum("ncl,co->nol", q(x), q(p[name + "kernel"])))
        w = q(torch.softmax(logits.reshape(N, C, L // 2, 2), dim=-1))
        return q((x.reshape(N, C, L // 2, 2) * w).sum(-1))

    def _stage(self, x, p, name, stem):
        x = self._conv(x, p, name + "conv.") if stem else self._block(x, p, name + "conv.")
        x = self.q(x + self._block(x, p, name + "pointwise."))
        return self._pool(x, p, name + "pool.")

    def _ln(self, x, p, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return self.q((x - mu) / torch.sqrt(var + EPS) * p[name + "scale"] + p[name + "bias"])

    def _dense(self, x, p, name, bias=True):
        q = self.q
        y = q(x) @ q(p[name + "kernel"])
        return q(y + q(p[name + "bias"])) if bias else q(y)

    @staticmethod
    def _drop(x, keep, rate):
        return x * keep / (1 - rate)

    def _attention(self, x, p, name, features, masks):
        m, q = self.m, self.q
        N, T, C = x.shape
        H, K = m["num_heads"], m["key_size"]

        def heads(t):
            return t.reshape(N, T, H, -1).transpose(1, 2)

        qh = q(heads(self._dense(x, p, name + "query.", False)) * K**-0.5)
        k = heads(self._dense(x, p, name + "key.", False))
        v = heads(self._dense(x, p, name + "value.", False))
        pos = features if masks is None else self._drop(features, masks[0],
                                                        m["positional_dropout_rate"])
        r_k = self._dense(pos, p, name + "rel_key.", False).reshape(2 * T - 1, H, K).transpose(0, 1)
        content = q((qh + q(p[name + "r_w_bias"])[:, None]) @ k.transpose(-1, -2))
        rel = q((qh + q(p[name + "r_r_bias"])[:, None]) @ r_k.transpose(-1, -2))  # (N, H, T, 2T-1)
        i = torch.arange(T, device=x.device)
        idx = (i[None, :] - i[:, None] + T - 1).expand(N, H, T, T)
        rel = torch.gather(rel, -1, idx)
        w = q(torch.softmax(q(content + rel), dim=-1))
        if masks is not None:
            w = q(self._drop(w, masks[1], m["attention_dropout_rate"]))
        a = q(w @ v).transpose(1, 2).reshape(N, T, -1)
        return self._dense(a, p, name + "out.")

    def _transformer_block(self, x, p, name, features, masks):
        m, q = self.m, self.q
        r = m["dropout_rate"]
        a = self._attention(self._ln(x, p, name + "mha_norm."), p, name + "attention.",
                            features, masks)
        if masks is not None:
            a = q(self._drop(a, masks[2], r))
        x = q(x + a)
        h = self._dense(self._ln(x, p, name + "mlp_norm."), p, name + "mlp_in.")
        if masks is not None:
            h = q(self._drop(h, masks[3], r))
        h = self._dense(q(torch.relu(h)), p, name + "mlp_out.")
        if masks is not None:
            h = q(self._drop(h, masks[4], r))
        return q(x + h)

    def rates(self, p: dict, hap1, hap2, masks: list | None) -> torch.Tensor:
        """``(B, target, tracks)``: the mean of the two haplotypes' rates;
        ``masks`` from :func:`draw_masks` (None: no dropout)."""
        m = self.m
        B = hap1.shape[0]
        codes = torch.cat([hap1, hap2]).long()
        x = (codes[..., None] == torch.arange(m["num_channels"], device=codes.device)).float()
        x = x.transpose(1, 2)
        x = self._run(lambda t: self._stage(t, p, "stem.", True), x)
        for i in range(m["tower_stages"]):
            x = self._run(lambda t, i=i: self._stage(t, p, f"tower.{i}.", False), x)
        x = x.transpose(1, 2)
        T = x.shape[1]
        features = position_features(T, m["num_relative_position_features"], x.device)
        for i in range(m["num_transformer_layers"]):
            mk = None if masks is None else masks[5 * i: 5 * i + 5]
            x = self._run(lambda t, i=i, mk=mk: self._transformer_block(
                t, p, f"transformer.{i}.", features, mk), x)
        trim = (T - m["target_length"]) // 2
        x = x[:, trim: trim + m["target_length"]].transpose(1, 2)

        def head(t):
            y = self._block(t, p, "final.")
            if masks is not None:
                y = self.q(self._drop(y, masks[-1], m["final_dropout_rate"]))
            y = self._gelu(y).transpose(1, 2)
            return F.softplus(self._dense(y, p, "head."))

        r = self._run(head, x)
        return (r[:B] + r[B:]) / 2


def poisson(rates, targets):
    return (rates - targets * torch.log(rates + POISSON_EPS)).mean()


def train(m: dict, heads: dict, opt: dict, weights: dict, batches: list, seed: int, device,
          precision: str = "float32", keep_steps: bool = False, checkpoint: bool = False):
    """Adam steps with the clip from ``weights`` on ``batches`` of ``(hap1,
    hap2, targets)``, dropout drawn from a generator on ``device`` seeded
    with ``seed``.  Returns a dict: ``losses`` (a list a step); ``grad_vec``
    (each leaf's first gradient, clipped, as Adam takes it) and ``grad`` (its
    norm); ``change`` (each leaf's change norm after the last step);
    ``output_grads`` (the loss's gradient with respect to the first step's
    rates, ``(1 - y / (rate + 1e-7)) / numel``).  With ``keep_steps``,
    ``steps`` holds each step's ``(grads, updates)``."""
    model = Model({**m, "heads": heads}, precision, checkpoint)
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    lr, (b1, b2), eps, clip = (opt["learning_rate"], opt["betas"], opt["eps"],
                               opt["clip_global_norm"])
    g = torch.Generator(device=device).manual_seed(seed)
    out = {"losses": []}
    steps, grad = [], {}
    for t, (h1, h2, y) in enumerate(batches, start=1):
        masks = draw_masks(m, g, 2 * h1.shape[0], device)
        rates = model.rates(p, h1, h2, masks)
        loss = poisson(rates, y)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        out["losses"].append(float(loss.detach()))
        norm = torch.sqrt(sum((gr.double() ** 2).sum() for gr in grads.values()))
        scale = float(clip / max(float(norm), clip))
        grads = {k: gr * scale for k, gr in grads.items()}
        if t == 1:
            r = rates.detach()
            out["output_grads"] = {"rates": (1 - y / (r + POISSON_EPS)) / r.numel()}
            out["grad_vec"] = grads
            out["grad_norm_before_clip"] = float(norm)
            grad = dict(zip(p, torch.stack([gr.norm() for gr in grads.values()]).tolist()))
        del rates, loss, masks
        updates = {}
        with torch.no_grad():
            for k, w in p.items():
                gr = grads[k]
                mom[k].mul_(b1).add_(gr, alpha=1 - b1)
                vel[k].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                step = lr * (mom[k] / (1 - b1 ** t)) / ((vel[k] / (1 - b2 ** t)).sqrt() + eps)
                if keep_steps:
                    updates[k] = -step
                w.sub_(step)
        if keep_steps:
            steps.append((grads, updates))
    change = {k: float((w.detach() - weights[k].float()).norm()) for k, w in p.items()}
    out |= {"grad": grad, "change": change}
    return out | ({"steps": steps} if keep_steps else {})
