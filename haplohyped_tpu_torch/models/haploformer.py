"""HaploFormer, the haplotype-pair encoder that the sampler feeds.

The JAX package's ``models/haploformer.py`` in PyTorch, with its public
layout: ``(B, L)`` int8 codes (or ``(B, L, C)`` one-hot) in, a dict of
``pair_embedding``, ``variant_count`` and ``base_logits`` out, all float32.

- a conv stem one-hots the codes and downsamples the window by ``pool``
  into tokens;
- pre-norm transformer blocks (self-attention, GELU MLP);
- the two haplotype towers share weights, so they run as one pass over the
  2B windows of a batch (every op is per window, so this is the same
  function as two passes);
- heads: the pair's variant count, and per-token base logits of hap1.

Layout: between the stem and the heads the tokens are one contiguous,
token-major ``(2B, T, d)`` tensor, and every residual add keeps it so.  Each
``LayerNorm`` then reads a contiguous float32 input, which ``layer_norm``
uses as it is in the forward and the backward; a channels-first view there
would cost a transposing float32 copy in each.

Parameters keep flax's names and layouts (``kernel``/``bias``/``scale``,
conv kernels ``(W, in, out)``, attention kernels ``(d, heads, head_dim)``),
so a flax params tree maps onto ``state_dict`` name for name
(``convert.params_from_flax``).  Every op runs in ``cfg.compute_dtype`` on
float32 parameters, cast where flax casts them (inside each conv, dense and
layer norm, the position embedding, the outputs); no ``torch.autocast``.
No op here is a hand-written kernel: the JAX package leaves this model to
XLA, and the port leaves it to PyTorch's ops.

Tensor parallelism over a mesh's ``model`` axis
(``parallel.mesh.shard_model``) cuts the attention heads and the MLP hidden
dimension: each ``Attention`` and ``Block`` then enters its sharded region
through ``copy_to_group`` and leaves it through ``reduce_over_group``, with
the output projections' biases added once after the sum.  Unsharded, they
compute what they compute without it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.ops.haplotype_window import windows_to_onehot
from haplohyped_tpu_torch.parallel.collectives import copy_to_group, reduce_over_group

#: flax ``nn.LayerNorm``'s epsilon (torch's default is 1e-5)
LN_EPS = 1e-6
#: standard deviation of a unit normal truncated to [-2, 2]: flax's
#: ``truncated_normal`` initialisers divide by it to keep the variance
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class HaploFormerConfig:
    num_channels: int = 5
    d_model: int = 256
    num_heads: int = 8
    num_layers: int = 4
    mlp_ratio: int = 4
    conv_width: int = 9
    pool: int = 8  # sequence downsample factor in the stem (2 conv x pool)
    #: kept for parity with the JAX config; never applied, as the JAX train
    #: step applies the model deterministically
    dropout: float = 0.0
    dtype: str = "bfloat16"  # compute dtype; params stay float32

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: variance ``1 / fan_in``, truncated at two
    standard deviations (inverse CDF of a uniform draw from ``g``)."""
    edge = math.erf(math.sqrt(2))  # the CDF span of [-2, 2]
    u = torch.empty(shape).uniform_(-edge, edge, generator=g)
    return torch.erfinv(u) * (math.sqrt(2 / fan_in) / _TRUNC_STD)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default form


class Dense(nn.Module):
    """flax ``nn.Dense`` and ``nn.DenseGeneral``: a ``kernel`` of shape
    ``in_shape + out_shape`` and a ``bias`` of ``out_shape`` (none with
    ``use_bias=False``), applied to features flattened to ``(...,
    prod(in_shape))``.  ``init_scale`` multiplies the kernel's initial
    standard deviation."""

    def __init__(self, in_shape: tuple, out_shape: tuple, dtype: torch.dtype,
                 g: torch.Generator, use_bias: bool = True, init_scale: float = 1.0):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            _lecun_normal((*in_shape, *out_shape), math.prod(in_shape), g) * init_scale)
        self.bias = nn.Parameter(torch.zeros(out_shape)) if use_bias else None
        #: tensor parallelism over ``tp_group`` (set by ``Attention``/``Block``
        #: ``.tensor_parallel``): a column-sharded projection adds ``bias_rows``
        #: of its full bias, whose gradient the group sums; a row-sharded one
        #: sums its partial products over the group, then adds its bias once
        self.tp_group = None
        self.bias_rows: slice | None = None
        self.row_parallel = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.kernel.reshape(x.shape[-1], -1).to(dt)
        b = self.bias
        if b is None:
            return F.linear(x.to(dt), w.t())
        if self.bias_rows is not None:
            b = copy_to_group(b, self.tp_group)[self.bias_rows]
        b = b.reshape(-1).to(dt)
        if self.row_parallel:
            return reduce_over_group(F.linear(x.to(dt), w.t()), self.tp_group) + b
        return F.linear(x.to(dt), w.t(), b)


class Conv(nn.Module):
    """flax ``nn.Conv`` over length, SAME padding, on channels-first input;
    the kernel keeps flax's ``(W, in, out)`` layout."""

    def __init__(self, c_in: int, c_out: int, width: int, dtype: torch.dtype,
                 g: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(_lecun_normal((width, c_in, c_out), width * c_in, g))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, in, L) -> (B, out, L)
        dt = self.dtype
        w = self.kernel.to(dt).permute(2, 1, 0)  # (out, in, W), as conv1d takes it
        return F.conv1d(x.to(dt), w, self.bias.to(dt), padding="same")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics and affine in float32, the result
    in the compute dtype."""

    def __init__(self, d: int, dtype: torch.dtype, eps: float = LN_EPS):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, self.eps)
        return y.to(self.dtype)


class Attention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` as self-attention with no
    mask: q/k/v projections, the query divided by ``sqrt(head_dim)``
    (rounded to the compute dtype, as flax does), scores, softmax and the
    weighted sum in the compute dtype, then the output projection.  Plain
    matmuls: at T=125 a tower's scores are 16 MB in bf16."""

    def __init__(self, d: int, heads: int, dtype: torch.dtype, g: torch.Generator):
        super().__init__()
        if d % heads:
            raise ValueError(f"d_model={d} is not a multiple of num_heads={heads}")
        self.heads, self.head_dim = heads, d // heads
        self.query = Dense((d,), (heads, self.head_dim), dtype, g)
        self.key = Dense((d,), (heads, self.head_dim), dtype, g)
        self.value = Dense((d,), (heads, self.head_dim), dtype, g)
        self.out = Dense((heads, self.head_dim), (d,), dtype, g)
        self.q_divisor = float(torch.tensor(math.sqrt(self.head_dim)).to(dtype))
        self.tp_group = None

    def tensor_parallel(self, rank: int, size: int, group) -> None:
        """Compute this rank's ``heads // size`` heads, the kernels being cut
        to them already (``parallel.mesh.shard_model``): q/k/v add their
        heads' rows of the full (replicated) biases, and the output
        projection sums its partial products over ``group``."""
        if self.heads % size:
            raise ValueError(f"{self.heads} heads do not divide over {size} model ranks")
        h = self.heads // size
        self.heads = h
        for proj in (self.query, self.key, self.value):
            proj.tp_group, proj.bias_rows = group, slice(rank * h, (rank + 1) * h)
        self.out.tp_group, self.out.row_parallel = group, True
        self.tp_group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, d)
        B, T, _ = x.shape
        if self.tp_group is not None:
            x = copy_to_group(x, self.tp_group)

        def heads(t):  # (B, T, h * hd) -> (B, h, T, hd)
            return t.view(B, T, self.heads, self.head_dim).transpose(1, 2)

        q = heads(self.query(x)) / self.q_divisor
        k, v = heads(self.key(x)), heads(self.value(x))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)  # (B, h, T, T)
        return self.out((w @ v).transpose(1, 2).reshape(B, T, -1))


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, cfg: HaploFormerConfig, g: torch.Generator):
        super().__init__()
        d, dt = cfg.d_model, cfg.compute_dtype
        self.ln1 = LayerNorm(d, dt)
        self.attn = Attention(d, cfg.num_heads, dt, g)
        self.ln2 = LayerNorm(d, dt)
        self.mlp_in = Dense((d,), (d * cfg.mlp_ratio,), dt, g)
        self.mlp_out = Dense((d * cfg.mlp_ratio,), (d,), dt, g)
        self.tp_group = None

    def tensor_parallel(self, rank: int, size: int, group) -> None:
        """The MLP on this rank's slice of the hidden dim (``mlp_in``'s kernel
        and bias and ``mlp_out``'s kernel cut already): ``mlp_out`` sums its
        partial products over ``group``.  The attention is its own module."""
        self.mlp_out.tp_group, self.mlp_out.row_parallel = group, True
        self.tp_group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        if self.tp_group is not None:
            h = copy_to_group(h, self.tp_group)
        return x + self.mlp_out(_gelu(self.mlp_in(h)))


class ConvStem(nn.Module):
    """One-hot, conv, GELU, max pool by ``pool // 2``, conv, GELU, max pool
    by 2 (VALID, floored): ``(B, L)`` codes or ``(B, L, C)`` one-hot to
    ``(B, L // pool, d_model)`` tokens, channels-last at both ends.  The
    tokens come out contiguous: the blocks' residual stream keeps the
    layout of its first operand, this output."""

    def __init__(self, cfg: HaploFormerConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt, W = cfg.d_model, cfg.compute_dtype, cfg.conv_width
        self.conv1 = Conv(cfg.num_channels, d // 2, W, dt, g)
        self.conv2 = Conv(d // 2, d, W, dt, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dt = c.compute_dtype
        if x.ndim == 2:
            # a code outside [0, C) one-hots to a zero row, as jax.nn.one_hot does
            x = windows_to_onehot(x, c.num_channels, dt)
        x = x.to(dt).transpose(1, 2)  # (B, C, L): conv1d is channels-first
        x = F.max_pool1d(_gelu(self.conv1(x)), c.pool // 2)
        x = F.max_pool1d(_gelu(self.conv2(x)), 2)
        return x.transpose(1, 2).contiguous()


class HaploFormer(nn.Module):
    """The model, built for windows of ``seq_length`` (``pos_embed`` holds
    ``seq_length // pool`` tokens, as flax's ``init`` takes them from its
    sample batch).  Parameters are drawn from ``seed`` (an int, or a CPU
    ``torch.Generator``) on the CPU, never from the global generator, then
    moved to ``device``: one seed gives the same model on every device."""

    def __init__(
        self,
        cfg: HaploFormerConfig = HaploFormerConfig(),
        seq_length: int = 1000,
        seed: int | torch.Generator = 0,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        g = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.compute_dtype
        self.stem = ConvStem(cfg, g)
        self.pos_embed = nn.Parameter(
            torch.randn((1, seq_length // cfg.pool, d), generator=g) * 0.02)
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", Block(cfg, g))
        self.pair_ln = LayerNorm(2 * d, dt)
        self.count_head = Dense((2 * d,), (1,), dt, g)
        self.base_head = Dense((d,), (cfg.num_channels,), dt, g)
        self.to(dev)

    def tower(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x)
        n = h.shape[1]
        if n > self.pos_embed.shape[1]:
            raise ValueError(
                f"{n} tokens exceed the {self.pos_embed.shape[1]} this model was built "
                f"for (seq_length // pool); build it for the longer seq_length")
        h = h + self.pos_embed[:, :n].to(self.cfg.compute_dtype)
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"block{i}")(h)
        return h

    def forward(self, hap1: torch.Tensor, hap2: torch.Tensor) -> dict[str, torch.Tensor]:
        """hap1/hap2: ``(B, L)`` int codes or ``(B, L, C)`` one-hot.

        Returns ``pair_embedding`` (B, 2 d_model), ``variant_count`` (B,) and
        ``base_logits`` (B, L // pool, C) of the hap1 tower, float32."""
        B = hap1.shape[0]
        h = self.tower(torch.cat([hap1, hap2]))  # both towers in one pass
        h1, h2 = h[:B], h[B:]
        p1, p2 = h1.mean(dim=1), h2.mean(dim=1)
        pair = self.pair_ln(torch.cat([p1 + p2, (p1 - p2).abs()], dim=-1))  # order-invariant
        count = self.count_head(pair)[..., 0]
        # the product, then the bias, each rounded to the compute dtype, as
        # flax's Dense rounds: on this contiguous h1, F.linear would add the
        # bias inside the product and round once
        head = self.base_head
        base_logits = h1 @ head.kernel.to(h1.dtype) + head.bias.to(h1.dtype)
        return {
            "pair_embedding": pair.float(),
            "variant_count": count.float(),
            "base_logits": base_logits.float(),
        }


def train_flops_per_step(cfg: HaploFormerConfig, B: int, L: int) -> int:
    """Matmul and convolution FLOPs (two a multiply-add) of one train step
    on ``B`` window pairs of length ``L``, counted from the code: conv1 at
    L, conv2 at ``L // (pool // 2)``, each block's q/k/v/out (8 d^2 a token),
    MLP (4 r d^2) and attention (4 T d a token), both towers, the heads,
    and x3 for the forward and the backward.  Elementwise ops, norms and
    the optimiser are left out."""
    d, C, W, r = cfg.d_model, cfg.num_channels, cfg.conv_width, cfg.mlp_ratio
    L1 = L // (cfg.pool // 2)
    T = L1 // 2
    stem = 2 * W * (C * (d // 2) * L + (d // 2) * d * L1)
    block = T * (8 * d * d + 4 * r * d * d + 4 * T * d)
    heads = 2 * T * d * C + 2 * 2 * d  # base head on hap1's tokens, count head
    return 3 * B * (2 * (stem + cfg.num_layers * block) + heads)
