"""Enformer on both haplotypes of a window: the published human trunk and
head, trained on the sampler's variant-aware windows.

Avsec et al. 2021, *Effective gene expression prediction from sequence by
integrating long-range interactions*, Nature Methods 18:1196; the published
code is ``enformer/enformer.py`` and ``enformer/attention_module.py`` of
github.com/google-deepmind/deepmind-research.  Sizes keep the published
names (``EnformerConfig``'s defaults are the published model):

- input: ``(N, L)`` int8 codes, one-hot over A, C, G, T (codes 0-3); N
  (code 4) gives a zero row;
- ``conv_block(f, w)``: batch norm in training mode (batch statistics,
  scale and offset, moving averages at ``batch_norm_decay``), the sigmoid
  GELU ``sigmoid(1.702 x) x``, a SAME ``Conv1D(f, w)`` with a bias;
- stem: ``Conv1D(channels / 2, 15)``, ``Residual(conv_block(channels / 2,
  1))``, ``SoftmaxPooling1D(2)``;
- conv tower: for ``f`` in :func:`exponential_linspace_int`\\ ``(channels /
  2, channels, 6, 128)``: ``conv_block(f, 5)``, ``Residual(conv_block(f,
  1))``, ``SoftmaxPooling1D(2)``: 7 poolings, so one token a 128-bp bin;
- transformer: ``num_transformer_layers`` blocks, ``x + Dropout(MHA(LN(x)))``
  then ``x + Dropout(Linear(C)(ReLU(Dropout(Linear(2C)(LN(x))))))``; the MHA
  has relative positions (:class:`RelativeAttention`);
- ``TargetLengthCrop1D(target_length)``, ``conv_block(2C, 1)``,
  ``Dropout(dropout_rate / 8)``, GELU, then the head ``Linear(tracks)`` and
  softplus.

Departures from the published model, each for this system:

- **both haplotypes**: the two haplotypes of a window pass through the one
  trunk in one pass of ``2B`` sequences, and the window's prediction is the
  mean of the two rates, since a donor's measured track covers both copies;
- **one head**: only the human head (the cohort is human);
- **local batch statistics**: the published run synchronised batch-norm
  statistics over 64 replicas; here each process takes its own batch's.
  The moving averages follow ``torch.nn.functional.batch_norm`` (the
  unbiased variance, no debiasing); training never reads them.

Dropout is on while the module is in training mode and a generator is
given (the train state holds one on the model's device).  Its masks are
``torch.rand(shape, generator=g) >= rate`` (kept values divided by ``1 -
rate``), drawn in this order each forward: for each transformer block, the
relative-position features ``(2T - 1, F)``, the attention weights ``(N,
H, T, T)``, the attention output ``(N, T, C)``, the MLP hidden ``(N, T,
2C)`` and the MLP output ``(N, T, C)``; then the final pointwise output
``(N, 2C, target_length)``.  A reference that draws the same shapes from a
generator seeded alike draws the same masks.

The cast rules are HaploFormer's (``models/haploformer.py``): float32
parameters, every op in ``cfg.compute_dtype``, batch and layer norms with
float32 statistics and affine, the rates float32.  The conv tower runs
channels-first, ``(N, C, L)``; the transformer token-major, ``(N, T, C)``.
No op here is a hand-written kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.core.profiling import annotate
from haplohyped_tpu_torch.models.haploformer import Conv, Dense, LayerNorm, _lecun_normal
from haplohyped_tpu_torch.ops.haplotype_window import windows_to_onehot

#: Sonnet's ``LayerNorm`` and ``BatchNorm`` epsilon
SNT_EPS = 1e-5
#: the Poisson loss's offset inside the log
POISSON_EPS = 1e-7


def exponential_linspace_int(start: int, end: int, num: int, divisible_by: int = 1) -> list[int]:
    """The published ``exponential_linspace_int``: ``num`` sizes from
    ``start`` to ``end`` on a log scale, each rounded to a multiple of
    ``divisible_by``."""
    base = np.exp(np.log(end / start) / (num - 1))
    return [int(np.round(start * base**i / divisible_by) * divisible_by) for i in range(num)]


@dataclass(frozen=True)
class EnformerConfig:
    channels: int = 1536
    num_transformer_layers: int = 11
    num_heads: int = 8
    key_size: int = 64
    #: published: ``channels // num_heads``
    value_size: int = 192
    #: published: ``channels // num_heads``
    num_relative_position_features: int = 192
    stem_width: int = 15
    tower_width: int = 5
    #: conv tower stages; the filter list is ``exponential_linspace_int(
    #: channels // 2, channels, tower_stages, divisible_by)``
    tower_stages: int = 6
    divisible_by: int = 128
    sequence_length: int = 196_608
    target_length: int = 896
    #: output tracks of each head; the port trains one
    heads: dict = field(default_factory=lambda: {"human": 5313})
    dropout_rate: float = 0.4
    attention_dropout_rate: float = 0.05
    positional_dropout_rate: float = 0.01
    #: the final pointwise block's, published as ``dropout_rate / 8``
    final_dropout_rate: float = 0.05
    batch_norm_decay: float = 0.9
    batch_norm_eps: float = SNT_EPS
    layer_norm_eps: float = SNT_EPS
    #: the global gradient norm a train step clips to (None: no clip)
    clip_global_norm: float | None = 0.2
    #: one-hot channels: A, C, G, T
    num_channels: int = 4
    dtype: str = "bfloat16"  # compute dtype; params stay float32

    def __post_init__(self):
        if len(self.heads) != 1:
            raise ValueError(f"the port trains one head, got {sorted(self.heads)}")
        if self.sequence_length % self.bin_size:
            raise ValueError(f"sequence_length={self.sequence_length} is not a multiple of "
                             f"the {self.bin_size}-bp bin")
        if self.filter_list[-1] != self.channels:
            raise ValueError(f"the filter list {self.filter_list} does not end at "
                             f"channels={self.channels}")
        if self.target_length > self.sequence_length // self.bin_size:
            raise ValueError(f"target_length={self.target_length} exceeds the "
                             f"{self.sequence_length // self.bin_size} tokens of a window")

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def filter_list(self) -> list[int]:
        return exponential_linspace_int(self.channels // 2, self.channels, self.tower_stages,
                                        self.divisible_by)

    @property
    def bin_size(self) -> int:
        """bp a token stands for: one halving in the stem, one a tower stage."""
        return 2 ** (1 + self.tower_stages)

    @property
    def num_tracks(self) -> int:
        return next(iter(self.heads.values()))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The published GELU: ``sigmoid(1.702 x) x``."""
    return torch.sigmoid(1.702 * x) * x


def dropout(x: torch.Tensor, rate: float, g: torch.Generator | None) -> torch.Tensor:
    """``x`` with each element kept where ``torch.rand(x.shape, generator=g)
    >= rate``, divided by ``1 - rate``; ``x`` itself without ``g``."""
    if g is None or rate == 0:
        return x
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return x * keep / (1 - rate)


class BatchNorm(nn.Module):
    """Sonnet's ``BatchNorm`` over the channels of ``(N, C, L)``: in training
    mode the batch's statistics (over N and L), in eval mode the moving
    ones; statistics and affine in float32, the result in the input's dtype."""

    def __init__(self, c: int, decay: float, eps: float):
        super().__init__()
        self.decay, self.eps = decay, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("moving_mean", torch.zeros(c))
        self.register_buffer("moving_variance", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.moving_mean, self.moving_variance, self.scale, self.bias,
                            self.training, 1 - self.decay, self.eps)


class ConvBlock(nn.Module):
    """``conv_block(f, w)``: batch norm, GELU, SAME ``Conv1D(f, w)`` with a
    bias, on ``(N, C, L)``."""

    def __init__(self, c_in: int, f: int, width: int, cfg: EnformerConfig, g: torch.Generator):
        super().__init__()
        self.norm = BatchNorm(c_in, cfg.batch_norm_decay, cfg.batch_norm_eps)
        self.conv = Conv(c_in, f, width, cfg.compute_dtype, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(gelu(self.norm(x)))


class SoftmaxPooling(nn.Module):
    """``SoftmaxPooling1D(2)``, per channel: pairs of positions of ``(N, C,
    L)`` summed under the softmax over the pair of ``x @ kernel``; the
    ``(C, C)`` kernel has no bias and starts at ``2 I``."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(2.0 * torch.eye(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, L = x.shape
        logits = torch.matmul(self.kernel.to(self.dtype).t(), x)  # (N, C, L)
        w = torch.softmax(logits.view(N, C, L // 2, 2), dim=-1)
        return (x.view(N, C, L // 2, 2) * w).sum(-1)


class TowerStage(nn.Module):
    """``conv_block(f, w)`` (none in the stem, which has its plain conv
    first), ``Residual(conv_block(f, 1))``, ``SoftmaxPooling1D(2)``."""

    def __init__(self, c_in: int, f: int, cfg: EnformerConfig, g: torch.Generator,
                 stem: bool = False):
        super().__init__()
        if stem:
            self.conv = Conv(c_in, f, cfg.stem_width, cfg.compute_dtype, g)
        else:
            self.conv = ConvBlock(c_in, f, cfg.tower_width, cfg, g)
        self.pointwise = ConvBlock(f, f, 1, cfg, g)
        self.pool = SoftmaxPooling(f, cfg.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return self.pool(x + self.pointwise(x))


def positional_features_exponential(d: torch.Tensor, n: int, seq_length: int,
                                    min_half_life: float = 3.0) -> torch.Tensor:
    """``exp(-ln 2 |d| / h)`` for ``n`` half lives ``h`` from ``2^3`` to
    ``seq_length`` on a log scale; ``(len(d), n)``."""
    max_range = math.log(seq_length) / math.log(2.0)
    half_life = torch.pow(2.0, torch.linspace(min_half_life, max_range, n, dtype=d.dtype,
                                              device=d.device))
    return torch.exp(-math.log(2.0) / half_life * d.abs()[:, None])


def positional_features_central_mask(d: torch.Tensor, n: int) -> torch.Tensor:
    """``1`` where ``|d| < 2^k - 1``, for ``k = 1 .. n``; ``(len(d), n)``."""
    widths = torch.pow(2.0, torch.arange(1, n + 1, dtype=d.dtype, device=d.device)) - 1
    return (widths > d.abs()[:, None]).to(d.dtype)


def positional_features_gamma(d: torch.Tensor, n: int, seq_length: int) -> torch.Tensor:
    """Gamma densities at ``|d|`` of ``n`` means from ``seq_length / n`` to
    ``seq_length``, standard deviation ``seq_length / (2 n)``, plus 1e-8 and
    each over its largest value over ``d``; ``(len(d), n)``."""
    stddev = seq_length / (2 * n)
    mean = torch.linspace(seq_length / n, seq_length, n, dtype=d.dtype, device=d.device)
    concentration = (mean / stddev) ** 2
    rate = mean / stddev**2
    x = d.abs()[:, None]
    log_p = torch.xlogy(concentration - 1, x) - rate * x
    log_p = log_p - (torch.lgamma(concentration) - concentration * torch.log(rate))
    p = torch.exp(log_p) + 1e-8
    return p / p.amax(dim=0, keepdim=True)


def relative_position_features(T: int, n: int, device=None) -> torch.Tensor:
    """``(2T - 1, n)`` float32 features of the distances ``-(T - 1) .. T -
    1``: the exponential, central-mask and gamma bases, ``n / 6`` each, on
    ``|d|``, then the same times ``sign(d)``.  Computed once a length in
    float64: in float32 the gamma density's log terms (up to ``T``'s order
    times ``log T``) cancel to a relative error of 1e-3."""
    if n % 6:
        raise ValueError(f"{n} relative position features do not split over 6 bases")
    d = torch.arange(-T + 1, T, dtype=torch.float64, device=device)
    k = n // 6
    f = torch.cat([positional_features_exponential(d, k, T),
                   positional_features_central_mask(d, k),
                   positional_features_gamma(d, k, T)], dim=-1)
    return torch.cat([f, torch.sign(d)[:, None] * f], dim=-1).float()


def relative_shift(x: torch.Tensor) -> torch.Tensor:
    """``(..., T, 2T - 1)`` logits over distance index to ``(..., T, T)``
    over key position: ``out[i, j] = x[i, j - i + T - 1]``, by the published
    pad, reshape and slice."""
    *lead, t1, t2 = x.shape
    x = torch.cat([x.new_zeros(*lead, t1, 1), x], dim=-1)
    x = x.reshape(*lead, t2 + 1, t1)[..., 1:, :]
    return x.reshape(*lead, t1, t2)[..., : (t2 + 1) // 2]


class RelativeAttention(nn.Module):
    """The published ``MultiheadAttention`` with relative positions: q, k, v
    and the relative keys with no bias, the query scaled by ``key_size^-0.5``,
    ``logits = (q + r_w_bias) k^T + relative_shift((q + r_r_bias) r_k^T)``,
    softmax, attention dropout, ``@ v``, then ``Linear(C)`` with a bias,
    zero at the start."""

    def __init__(self, cfg: EnformerConfig, g: torch.Generator):
        super().__init__()
        C, H, K, V = cfg.channels, cfg.num_heads, cfg.key_size, cfg.value_size
        R = cfg.num_relative_position_features
        dt = cfg.compute_dtype
        self.cfg = cfg
        # VarianceScaling(2.0): twice lecun_normal's variance
        s2 = math.sqrt(2.0)
        self.query = Dense((C,), (H * K,), dt, g, use_bias=False, init_scale=s2)
        self.key = Dense((C,), (H * K,), dt, g, use_bias=False, init_scale=s2)
        self.value = Dense((C,), (H * V,), dt, g, use_bias=False, init_scale=s2)
        self.rel_key = Dense((R,), (H * K,), dt, g, use_bias=False, init_scale=s2)
        # the published (1, H, 1, K) biases; fan-in H under VarianceScaling(2.0)
        self.r_w_bias = nn.Parameter(_lecun_normal((H, K), H, g) * s2)
        self.r_r_bias = nn.Parameter(_lecun_normal((H, K), H, g) * s2)
        self.out = Dense((H * V,), (C,), dt, g)
        with torch.no_grad():
            self.out.kernel.zero_()
        self._features: tuple | None = None

    def features(self, T: int, device) -> torch.Tensor:
        """The relative-position features of ``T`` tokens, computed once."""
        if self._features is None or self._features[0] != (T, device):
            self._features = ((T, device), relative_position_features(
                T, self.cfg.num_relative_position_features, device))
        return self._features[1]

    def forward(self, x: torch.Tensor, g: torch.Generator | None) -> torch.Tensor:
        cfg = self.cfg
        N, T, _ = x.shape
        H, K = cfg.num_heads, cfg.key_size
        dt = cfg.compute_dtype

        def heads(t):  # (N, T, H * d) -> (N, H, T, d)
            return t.view(N, T, H, -1).transpose(1, 2)

        q = heads(self.query(x)) * K**-0.5
        k, v = heads(self.key(x)), heads(self.value(x))
        pos = dropout(self.features(T, x.device), cfg.positional_dropout_rate, g)
        r_k = self.rel_key(pos.to(dt)).view(2 * T - 1, H, K).transpose(0, 1)  # (H, 2T-1, K)
        content = (q + self.r_w_bias.to(dt)[:, None]) @ k.transpose(-1, -2)
        rel = relative_shift((q + self.r_r_bias.to(dt)[:, None]) @ r_k.transpose(-1, -2))
        w = dropout(torch.softmax(content + rel, dim=-1), cfg.attention_dropout_rate, g)
        return self.out((w @ v).transpose(1, 2).reshape(N, T, -1))


class TransformerBlock(nn.Module):
    """``x + Dropout(MHA(LN(x)))``, then ``x + Dropout(Linear(C)(ReLU(
    Dropout(Linear(2C)(LN(x))))))``, on ``(N, T, C)``."""

    def __init__(self, cfg: EnformerConfig, g: torch.Generator):
        super().__init__()
        C, dt = cfg.channels, cfg.compute_dtype
        self.rate = cfg.dropout_rate
        self.mha_norm = LayerNorm(C, dt, cfg.layer_norm_eps)
        self.attention = RelativeAttention(cfg, g)
        self.mlp_norm = LayerNorm(C, dt, cfg.layer_norm_eps)
        self.mlp_in = Dense((C,), (2 * C,), dt, g)
        self.mlp_out = Dense((2 * C,), (C,), dt, g)

    def forward(self, x: torch.Tensor, g: torch.Generator | None) -> torch.Tensor:
        x = x + dropout(self.attention(self.mha_norm(x), g), self.rate, g)
        h = torch.relu(dropout(self.mlp_in(self.mlp_norm(x)), self.rate, g))
        return x + dropout(self.mlp_out(h), self.rate, g)


class Enformer(nn.Module):
    """The model.  Parameters are drawn from ``seed`` (an int, or a CPU
    ``torch.Generator``) on the CPU, never from the global generator, then
    moved to ``device``: one seed gives the same model on every device."""

    def __init__(self, cfg: EnformerConfig = EnformerConfig(),
                 seed: int | torch.Generator = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        g = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
        self.cfg = cfg
        C, dt = cfg.channels, cfg.compute_dtype
        filters = cfg.filter_list
        self.stem = TowerStage(cfg.num_channels, C // 2, cfg, g, stem=True)
        self.tower = nn.ModuleList(TowerStage(c_in, f, cfg, g)
                                   for c_in, f in zip([C // 2] + filters[:-1], filters))
        self.transformer = nn.ModuleList(TransformerBlock(cfg, g)
                                         for _ in range(cfg.num_transformer_layers))
        self.final = ConvBlock(C, 2 * C, 1, cfg, g)
        self.head = Dense((2 * C,), (cfg.num_tracks,), dt, g)
        self.to(dev)

    def trunk(self, codes: torch.Tensor, g: torch.Generator | None) -> torch.Tensor:
        """``(N, L)`` codes to the transformer's ``(N, T, C)`` output."""
        cfg = self.cfg
        with annotate("hh.enformer.stem"):
            x = windows_to_onehot(codes, cfg.num_channels, cfg.compute_dtype).transpose(1, 2)
            x = self.stem(x)
        with annotate("hh.enformer.conv_tower"):
            for stage in self.tower:
                x = stage(x)
        with annotate("hh.enformer.transformer"):
            x = x.transpose(1, 2).contiguous()  # (N, T, C): token-major
            for block in self.transformer:
                x = block(x, g)
        return x

    def forward(self, hap1: torch.Tensor, hap2: torch.Tensor,
                generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """hap1/hap2: ``(B, L)`` int8 codes.  Returns ``rates`` ``(B,
        target_length, tracks)``, float32: the mean of the two haplotypes'
        softplus rates.  ``generator`` draws the dropout masks (none: no
        dropout)."""
        cfg = self.cfg
        B, L = hap1.shape
        if L != cfg.sequence_length:
            raise ValueError(f"windows of {L} bp; this model takes {cfg.sequence_length}")
        g = generator if self.training else None
        x = self.trunk(torch.cat([hap1, hap2]), g)
        with annotate("hh.enformer.head"):
            trim = (x.shape[1] - cfg.target_length) // 2
            x = x[:, trim: trim + cfg.target_length].transpose(1, 2)  # (N, C, target)
            x = gelu(dropout(self.final(x), cfg.final_dropout_rate, g))
            r = F.softplus(self.head(x.transpose(1, 2)).float())
            return {"rates": (r[:B] + r[B:]) / 2}


def poisson_loss(rates: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The published Poisson loss: ``mean(rates - targets log(rates + 1e-7))``."""
    return (rates - targets * torch.log(rates + POISSON_EPS)).mean()

