"""The layers the port's hybrid Mamba-2 language models share: the Granite
4.0-H hybrid (``models/granite_hybrid.py``) and the Nemotron-H hybrid
(``models/nemotron_h.py``).

- :class:`Linear`: ``y = x W^T``, a float32 weight used in the compute dtype.
- :class:`RMSNorm`: ``ops/rms_norm.py``, plain or gated, over the row or over
  groups of its columns.
- :class:`Mamba2Mixer`: Mamba-2 (Dao and Gu 2024) as both published configs
  compute it: ``in_proj`` to ``z`` (the mixer's width ``W = heads *
  head_dim``), ``xBC`` (``W + 2 * groups * state``) and ``dt`` (``heads``);
  ``xBC`` through a causal depthwise conv1d of width ``conv`` with a bias,
  then SiLU, split into ``x``, ``B`` and ``C`` (``groups`` of ``state`` each;
  head ``h`` reads group ``h // (heads / groups)``); ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the chunked scan (``ops/ssd_scan.py``,
  float32 state) in chunks of ``chunk``; then ``rmsnorm(y * silu(z)) * w``
  (the gate before the norm, the norm over each group's ``W / groups``
  columns on its own, as both published models' gated norm takes them) and
  ``out_proj``.
- :class:`Attention`: causal grouped-query attention with no position
  encoding through ``F.scaled_dot_product_attention`` (on a card its flash
  path, which never holds the ``T x T`` scores).
- :class:`ChunkedHeadLoss`: the head and the mean cross-entropy a chunk of
  tokens at a time, so no tensor ever holds all the logits.

Cast rules (the port's, as HaploFormer's): float32 parameters; every matrix
product, the conv and the residual stream in the compute dtype; the norms'
statistics and affine, and the mixer's gate before its norm, in float32,
rounded once; ``A_log``, ``dt_bias``, ``D``, ``dt``, the scan's state and the
loss's log-sum-exp in float32.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from haplohyped_tpu_torch.ops.rms_norm import rms_norm
from haplohyped_tpu_torch.ops.ssd_scan import ssd_scan


@dataclass(frozen=True)
class MambaShape:
    """A Mamba-2 mixer's sizes."""

    hidden: int
    heads: int
    head_dim: int
    state: int
    groups: int
    conv: int
    chunk: int
    eps: float
    dtype: torch.dtype

    @property
    def width(self) -> int:
        return self.heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.width + 2 * self.groups * self.state


def _normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * std


class Linear(nn.Module):
    """``y = x W^T`` with a float32 ``weight`` ``(out, in)``, in the compute dtype."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, g: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_normal((d_out, d_in), 0.02, g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    """``u / sqrt(mean(u^2) + eps) * weight``, ``u = x * silu(gate)`` where
    a gate is given and ``x`` where not, the mean over the row or each
    ``group`` of its columns (``ops/rms_norm.py``): statistics and weight in
    float32, the result in ``x``'s dtype."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor, gate: torch.Tensor | None = None,
                group: int | None = None) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps, gate, group)


class Mamba2Mixer(nn.Module):
    """The Mamba-2 mixer (module docstring), on ``(n, T, hidden)``."""

    def __init__(self, m: MambaShape, g: torch.Generator):
        super().__init__()
        self.m, dt = m, m.dtype
        H, W = m.heads, m.width
        self.in_proj = Linear(m.hidden, W + m.conv_dim + H, dt, g)
        self.conv1d = nn.Module()
        self.conv1d.weight = nn.Parameter(
            _normal((m.conv_dim, 1, m.conv), 1 / math.sqrt(m.conv), g))
        self.conv1d.bias = nn.Parameter(torch.zeros(m.conv_dim))
        # Mamba-2's initialisation: dt log-uniform in [1e-3, 1e-1] (floor
        # 1e-4) through softplus's inverse; A uniform in [1, 16]; D = 1
        u = torch.rand(H, generator=g, device=g.device)
        dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp_min(1e-4)
        self.dt_bias = nn.Parameter(dt0 + torch.log(-torch.expm1(-dt0)))
        self.A_log = nn.Parameter(torch.log(1 + 15 * torch.rand(H, generator=g, device=g.device)))
        self.D = nn.Parameter(torch.ones(H))
        self.norm = RMSNorm(W, m.eps)
        self.out_proj = Linear(W, m.hidden, dt, g)
        #: the gated norm's group of columns
        self.norm_group = W // m.groups

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        m = self.m
        n, T, _ = h.shape
        H, P, N, G, W = m.heads, m.head_dim, m.state, m.groups, m.width
        z, xbc, dt = self.in_proj(h).split([W, m.conv_dim, H], dim=-1)
        k = m.conv
        xbc = F.conv1d(xbc.transpose(1, 2), self.conv1d.weight.to(m.dtype),
                       self.conv1d.bias.to(m.dtype), padding=k - 1, groups=m.conv_dim)[..., :T]
        xbc = F.silu(xbc).transpose(1, 2)  # (n, T, conv_dim)
        x = xbc[..., :W].reshape(n, T, H, P).contiguous()
        B = xbc[..., W: W + G * N].reshape(n, T, G, N).contiguous()
        C = xbc[..., W + G * N:].reshape(n, T, G, N).contiguous()
        dt = F.softplus(dt.float() + self.dt_bias)
        y = ssd_scan(x, dt, -torch.exp(self.A_log), B, C, self.D, m.chunk)
        # the norm takes rows one stride apart: z's are read in place from
        # in_proj's output; y's are copied where the scan cut its padding off
        y = self.norm(y.reshape(n * T, W), gate=z.reshape(n * T, W), group=self.norm_group)
        return self.out_proj(y.view(n, T, W))


class Attention(nn.Module):
    """Causal grouped-query attention with no position encoding, on
    ``(n, T, hidden)``: ``heads`` queries and ``kv_heads`` keys and values
    of ``head_dim``, the scores scaled by ``scale``."""

    def __init__(self, hidden: int, heads: int, kv_heads: int, head_dim: int, scale: float,
                 dtype: torch.dtype, g: torch.Generator):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim, self.scale = heads, kv_heads, head_dim, scale
        self.q_proj = Linear(hidden, heads * head_dim, dtype, g)
        self.k_proj = Linear(hidden, kv_heads * head_dim, dtype, g)
        self.v_proj = Linear(hidden, kv_heads * head_dim, dtype, g)
        self.o_proj = Linear(heads * head_dim, hidden, dtype, g)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        n, T, _ = h.shape
        hd = self.head_dim

        def heads(t, k):
            return t.view(n, T, k, hd).transpose(1, 2)

        q = heads(self.q_proj(h), self.heads)
        k = heads(self.k_proj(h), self.kv_heads)
        v = heads(self.v_proj(h), self.kv_heads)
        flash = sdpa_kernel(SDPBackend.FLASH_ATTENTION) if h.is_cuda else contextlib.nullcontext()
        with flash:
            a = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=self.scale,
                                               enable_gqa=True)
        return self.o_proj(a.transpose(1, 2).reshape(n, T, self.heads * hd))


class ChunkedHeadLoss(torch.autograd.Function):
    """The mean cross-entropy of ``h W^T / scale`` against ``targets``, over
    ``chunk`` rows at a time: ``h`` ``(n, d)`` in the compute dtype, the
    float32 table ``W`` ``(V, d)``, int64 ``targets`` ``(n,)``.  Each chunk's
    logits are a product in ``h``'s dtype taken to float32 (float64 for a
    float64 ``h``) for the log-sum-exp; where a gradient is wanted the forward also takes the
    chunk's gradients (the softmax less the target's one-hot), so no logits
    are kept or recomputed: the backward scales the saved ``dh`` and ``dW``
    by the loss's gradient."""

    @staticmethod
    def forward(ctx, h, weight, targets, scale: float, chunk: int):
        n = h.shape[0]
        w, wide = weight.to(h.dtype), torch.promote_types(h.dtype, torch.float32)
        want = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        total = torch.zeros((), dtype=wide, device=h.device)
        dh = torch.empty_like(h) if want else None
        dW = torch.zeros_like(weight) if want else None
        for a in range(0, n, chunk):
            hc, tc = h[a: a + chunk], targets[a: a + chunk]
            logits = (hc @ w.t()).to(wide).mul_(1.0 / scale)
            lse = torch.logsumexp(logits, dim=-1)
            total += (lse - logits.gather(1, tc[:, None])[:, 0]).sum()
            if want:
                p = logits.sub_(lse[:, None]).exp_()
                p[torch.arange(p.shape[0], device=p.device), tc] -= 1.0
                g = p.mul_(1.0 / (scale * n)).to(h.dtype)
                dh[a: a + chunk] = g @ w
                dW += (g.t() @ hc).to(dW.dtype)
        if want:
            ctx.save_for_backward(dh, dW)
        return total / n

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        dh, dW = ctx.saved_tensors
        return dh * grad.to(dh.dtype), dW * grad, None, None, None
