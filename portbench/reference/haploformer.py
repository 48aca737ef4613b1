"""HaploFormer's plain reference: the forward pass, the loss, AdamW and three
training steps, in float32 plain PyTorch, written from the model's
definition (``HaploFormerConfig`` of the repository's model, flax's layouts).

- Stem: one-hot the ``(B, L)`` codes over ``num_channels`` (a code outside
  gives a zero row), SAME conv of width ``conv_width`` to ``d/2`` channels,
  tanh-GELU, max pool by ``pool/2``; SAME conv to ``d``, GELU, max pool by 2.
- Add ``pos_embed``; ``num_layers`` pre-norm blocks: ``x + attn(ln1(x))``,
  then ``x + mlp_out(gelu(mlp_in(ln2(x))))``; layer norms with epsilon 1e-6;
  attention with ``num_heads`` heads, no mask, the query divided by
  ``sqrt(head_dim)``.
- Both haplotypes through the same tower; ``pair = ln([m1 + m2, |m1 - m2|])``
  of the towers' token means; ``variant_count`` from ``pair``, per-token
  ``base_logits`` from hap1's tower.
- Loss ``0.01 * mean((count - n_variants)^2) + CE(base_logits, targets)``,
  targets the most frequent channel of each token's ``pool`` bases of hap1
  (ties to the lowest channel).
- AdamW as optax's ``adamw``: bias-corrected moments, ``eps`` outside the
  square root, decoupled weight decay on every leaf.

``precision="float32"`` is the reference.  ``precision="fp8"`` is the
control, the reference computed one precision below the configuration's
bf16: every value the model computes in its compute dtype (each matrix
product's operands and result, each convolution's, the layer norms' and
activations' outputs, the softmax, the residual stream) rounded to float8
e4m3 with a per-tensor scale on the way forward, and its gradient to e5m2
on the way back; sums accumulate in float32, as fp8 tensor cores do.  The
caller turns TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def param_specs(cfg: dict, L: int) -> list[tuple[str, tuple, str, int]]:
    """``(name, shape, kind, fan_in)`` of every leaf, in the model's order;
    ``kind`` is ``kernel``, ``bias``, ``scale`` or ``embed``."""
    d, C, W, H = cfg["d_model"], cfg["num_channels"], cfg["conv_width"], cfg["num_heads"]
    hd, f = d // H, d * cfg["mlp_ratio"]
    out = [("pos_embed", (1, L // cfg["pool"], d), "embed", 0),
           ("stem.conv1.kernel", (W, C, d // 2), "kernel", W * C),
           ("stem.conv1.bias", (d // 2,), "bias", 0),
           ("stem.conv2.kernel", (W, d // 2, d), "kernel", W * d // 2),
           ("stem.conv2.bias", (d,), "bias", 0)]
    for i in range(cfg["num_layers"]):
        p = f"block{i}."
        out += [(p + "ln1.scale", (d,), "scale", 0), (p + "ln1.bias", (d,), "bias", 0)]
        for name in ("query", "key", "value"):
            out += [(p + f"attn.{name}.kernel", (d, H, hd), "kernel", d),
                    (p + f"attn.{name}.bias", (H, hd), "bias", 0)]
        out += [(p + "attn.out.kernel", (H, hd, d), "kernel", d),
                (p + "attn.out.bias", (d,), "bias", 0),
                (p + "ln2.scale", (d,), "scale", 0), (p + "ln2.bias", (d,), "bias", 0),
                (p + "mlp_in.kernel", (d, f), "kernel", d), (p + "mlp_in.bias", (f,), "bias", 0),
                (p + "mlp_out.kernel", (f, d), "kernel", f), (p + "mlp_out.bias", (d,), "bias", 0)]
    out += [("pair_ln.scale", (2 * d,), "scale", 0), ("pair_ln.bias", (2 * d,), "bias", 0),
            ("count_head.kernel", (2 * d, 1), "kernel", 2 * d),
            ("count_head.bias", (1,), "bias", 0),
            ("base_head.kernel", (d, C), "kernel", d), ("base_head.bias", (C,), "bias", 0)]
    return out


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


def _one_hot(codes: torch.Tensor, C: int) -> torch.Tensor:
    """``(..., C)`` float32; a code outside ``[0, C)`` gives a zero row."""
    return (codes.long()[..., None] == torch.arange(C, device=codes.device)).float()


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class Model:
    """The forward pass over a dict of float32 leaves named as ``param_specs``."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        #: rounds a value to the compute precision (nothing in float32)
        self.q = _Fp8.apply if precision == "fp8" else (lambda x: x)

    def _dense(self, x, kernel, bias):
        n_in = x.shape[-1]
        q = self.q
        return q(q(x) @ q(kernel.reshape(n_in, -1)) + q(bias.reshape(-1)))

    def _conv(self, x, kernel, bias):  # x (B, in, L); kernel (W, in, out)
        q = self.q
        return q(F.conv1d(q(x), q(kernel.permute(2, 1, 0)), q(bias), padding="same"))

    def _ln(self, x, scale, bias):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return self.q((x - mu) / torch.sqrt(var + LN_EPS) * scale + bias)

    def _gelu(self, x):
        return self.q(0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3))))

    def tower(self, p: dict, codes: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        C, H = c["num_channels"], c["num_heads"]
        x = _one_hot(codes, C).transpose(1, 2)
        x = F.max_pool1d(self._gelu(self._conv(x, p["stem.conv1.kernel"], p["stem.conv1.bias"])),
                         c["pool"] // 2)
        x = F.max_pool1d(self._gelu(self._conv(x, p["stem.conv2.kernel"], p["stem.conv2.bias"])), 2)
        h = x.transpose(1, 2)
        B, T, d = h.shape
        q = self.q
        h = q(h + q(p["pos_embed"][:, :T]))
        hd = d // H
        for i in range(c["num_layers"]):
            b = f"block{i}."
            y = self._ln(h, p[b + "ln1.scale"], p[b + "ln1.bias"])

            def heads(name):
                t = self._dense(y, p[b + f"attn.{name}.kernel"], p[b + f"attn.{name}.bias"])
                return t.view(B, T, H, hd).transpose(1, 2)

            qh, k, v = q(heads("query") / math.sqrt(hd)), heads("key"), heads("value")
            w = q(torch.softmax(q(qh @ k.transpose(-1, -2)), dim=-1))
            a = q(w @ v).transpose(1, 2).reshape(B, T, d)
            h = q(h + self._dense(a, p[b + "attn.out.kernel"], p[b + "attn.out.bias"]))
            y = self._ln(h, p[b + "ln2.scale"], p[b + "ln2.bias"])
            y = self._gelu(self._dense(y, p[b + "mlp_in.kernel"], p[b + "mlp_in.bias"]))
            h = q(h + self._dense(y, p[b + "mlp_out.kernel"], p[b + "mlp_out.bias"]))
        return h

    def _heads(self, p: dict, hap1, hap2):
        """The two outputs, ``count`` and the base logits, and the logits'
        targets."""
        c = self.cfg
        B = hap1.shape[0]
        h = self.tower(p, torch.cat([hap1, hap2]))
        q = self.q
        m1, m2 = q(h[:B].mean(1)), q(h[B:].mean(1))
        pair = self._ln(q(torch.cat([m1 + m2, (m1 - m2).abs()], -1)),
                        p["pair_ln.scale"], p["pair_ln.bias"])
        count = self._dense(pair, p["count_head.kernel"], p["count_head.bias"])[..., 0]
        logits = self._dense(h[:B], p["base_head.kernel"], p["base_head.bias"])
        T = logits.shape[1]
        C, pool = c["num_channels"], c["pool"]
        oh = _one_hot(hap1[:, : T * pool], C)
        targets = oh.reshape(B, T, pool, C).sum(2).argmax(-1)
        return count, logits, targets

    def loss(self, p: dict, hap1, hap2, n_variants) -> torch.Tensor:
        count, logits, targets = self._heads(p, hap1, hap2)
        B, T, C = logits.shape
        reg = ((count - n_variants.float()) ** 2).mean()
        ce = F.cross_entropy(logits.reshape(B * T, C), targets.reshape(-1))
        return 0.01 * reg + ce, reg, ce

    @torch.no_grad()
    def output_grads(self, p: dict, hap1, hap2, n_variants) -> dict:
        """The loss's gradient with respect to the model's two outputs, row
        by row: ``variant_count`` ``(B,)``, ``0.02 / B * (count -
        n_variants)``, and ``base_logits`` ``(B, T, C)``, ``(softmax -
        onehot) / (B T)``."""
        count, logits, targets = self._heads(p, hap1, hap2)
        B, T, C = logits.shape
        return {"variant_count": 0.02 / B * (count - n_variants.float()),
                "base_logits": (torch.softmax(logits, -1) - F.one_hot(targets, C).float())
                / (B * T)}


def train(cfg: dict, opt: dict, weights: dict, batches: list, precision: str = "float32",
          keep_steps: bool = False):
    """Three (or ``len(batches)``) AdamW steps from ``weights`` on ``batches``
    of ``(hap1, hap2, n_variants)``.  Returns a dict: ``losses``, ``reg``,
    ``ce`` (a list a step); ``grad_vec`` (each leaf's first gradient) and
    ``grad`` (its norm);
    ``change`` (each leaf's change norm after the last step);
    ``output_grads`` (``Model.output_grads`` of the first batch).  With
    ``keep_steps``, ``steps`` holds each step's ``(grads, updates)``."""
    model = Model(cfg, precision)
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    lr, (b1, b2), eps, wd = opt["learning_rate"], opt["betas"], opt["eps"], opt["weight_decay"]
    out = {"losses": [], "reg": [], "ce": []}
    steps, grad = [], {}
    for t, (h1, h2, nv) in enumerate(batches, start=1):
        loss, reg, ce = model.loss(p, h1, h2, nv)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        for k, v in (("losses", loss), ("reg", reg), ("ce", ce)):
            out[k].append(float(v.detach()))
        if t == 1:
            out["output_grads"] = model.output_grads(p, h1, h2, nv)
            out["grad_vec"] = grads
            grad = dict(zip(p, torch.stack([g.norm() for g in grads.values()]).tolist()))
        updates = {}
        with torch.no_grad():
            for k, w in p.items():
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = lr * (m[k] / (1 - b1 ** t)) / ((v2[k] / (1 - b2 ** t)).sqrt() + eps)
                if keep_steps:
                    updates[k] = -(lr * wd) * w - step
                w.mul_(1 - lr * wd).sub_(step)
        if keep_steps:
            steps.append((grads, updates))
    change = {k: float((w.detach() - weights[k].float()).norm()) for k, w in p.items()}
    out |= {"grad": grad, "change": change}
    return out | ({"steps": steps} if keep_steps else {})
