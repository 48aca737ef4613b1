"""A hybrid Mamba-2/attention nucleotide language model with the widths of
IBM's Granite 4.0-H Micro, trained on both haplotypes of the sampler's
windows.

The layer equations are those of the published ``config.json`` of
``ibm-granite/granite-4.0-h-micro`` (model type ``granitemoehybrid``, no
experts); :class:`GraniteHybridConfig` keeps its key names (the published
``mamba_conv_bias: true``, ``mamba_proj_bias`` and ``attention_bias: false``
are built in), and its defaults are the published model but for the depth
(``layer_types`` lists the layers held; the published model has 40,
attention at 5, 15, 25 and 35).

- Embedding: ``h = embed(tokens) * embedding_multiplier``; a window's int8
  base codes (A, C, G, T, N: 0-4) index ``token_ids``, the five token ids.
- Each layer: ``h = h + r * mixer(rmsnorm(h))``, then ``h = h + r *
  mlp(rmsnorm(h))``, ``r = residual_multiplier``.  The MLP is
  ``output_linear(silu(a) * b)``, ``[a, b] = input_linear(x)``.
- A ``mamba`` mixer (Mamba-2): ``in_proj`` to ``z`` (``mamba_expand *
  hidden_size``), ``xBC`` (that plus ``2 * mamba_n_groups *
  mamba_d_state``) and ``dt`` (``mamba_n_heads``); ``xBC`` through a causal
  depthwise conv1d of width ``mamba_d_conv`` with a bias, then SiLU, split
  into ``x``, ``B`` and ``C``; ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(A_log)``; the chunked scan (``ops/ssd_scan.py``, float32 state) in
  chunks of ``mamba_chunk_size``; then ``rmsnorm(y * silu(z)) * w`` (the gate
  before the norm, over the whole width: one group) and ``out_proj``.
- An ``attention`` mixer: grouped-query attention (``num_attention_heads``
  queries, ``num_key_value_heads`` keys and values, head size ``hidden_size
  / num_attention_heads``), causal, scaled by ``attention_multiplier``, no
  position encoding (``position_embedding_type: nope``), through
  ``F.scaled_dot_product_attention`` (on a card its flash path, which never
  holds the ``T x T`` scores).
- Head: a final RMSNorm, the tied embedding as the output matrix, the logits
  divided by ``logits_scaling``.  The loss is the mean next-token
  cross-entropy over both haplotypes' ``L - 1`` predicted positions, computed
  by :class:`ChunkedHeadLoss` over ``loss_chunk`` tokens at a time, so no
  tensor ever holds all the logits.

Cast rules (the port's, as HaploFormer's): float32 parameters; every matrix
product, the conv and the residual stream in ``compute_dtype``; the norms'
statistics and affine, and the mixer's gate before its norm, in float32,
rounded once (``ops/rms_norm.py``: on a card one kernel pass each way, which
keeps no float32 activation for the backward); ``A_log``, ``dt_bias``,
``D``, ``dt``, the scan's state and the loss's log-sum-exp in float32.

The model owns its training: :meth:`GraniteHybrid.loss`,
:meth:`GraniteHybrid.make_optimizer` (AdamW, weight decay on the matrices
only) and ``clip_global_norm``.  Spans (``core/profiling.py``):
``hh.granite.embed``, ``hh.granite.mamba`` (one a mixer),
``hh.granite.attention``, ``hh.granite.mlp`` (one a layer) and
``hh.granite.head_loss``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.core.profiling import annotate
from haplohyped_tpu_torch.models.hybrid_layers import (  # noqa: F401 (re-exported)
    Attention,
    ChunkedHeadLoss,
    Linear,
    Mamba2Mixer,
    MambaShape,
    RMSNorm,
    _normal,
)
from haplohyped_tpu_torch.ops.rms_norm import load as load_rms_norm
from haplohyped_tpu_torch.ops.ssd_scan import load as load_ssd_scan

#: the published 40 layers' first period: attention at index 5
PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4


@dataclass(frozen=True)
class GraniteHybridConfig:
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    mamba_n_heads: int = 64
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk_size: int = 256
    attention_multiplier: float = 0.015625
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 8.0
    rms_norm_eps: float = 1e-5
    vocab_size: int = 100352
    layer_types: tuple = PERIOD
    #: the token ids of the base codes 0-4 (A, C, G, T, N)
    token_ids: tuple = (32, 34, 38, 51, 45)
    #: tokens a chunk of the head and loss
    loss_chunk: int = 4096
    #: AdamW's (beta1, beta2), epsilon and weight decay (on the matrices)
    adam_betas: tuple = (0.9, 0.95)
    adam_eps: float = 1e-8
    weight_decay: float = 0.1
    clip_global_norm: float = 1.0
    dtype: str = "bfloat16"

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        object.__setattr__(self, "token_ids", tuple(self.token_ids))
        object.__setattr__(self, "adam_betas", tuple(self.adam_betas))
        if set(self.layer_types) - {"mamba", "attention"}:
            raise ValueError(f"unknown layer types in {self.layer_types}")
        if self.mamba_n_groups != 1:
            raise ValueError("the Granite hybrid takes its published one group of B and C "
                             "(mamba_n_groups=1)")
        if self.mamba_expand * self.hidden_size != self.mamba_n_heads * self.mamba_d_head:
            raise ValueError("mamba_expand * hidden_size must be mamba_n_heads * mamba_d_head")
        if self.hidden_size % self.num_attention_heads \
                or self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("the heads must divide hidden_size, the key heads the query heads")
        if len(self.token_ids) != 5 or max(self.token_ids) >= self.vocab_size:
            raise ValueError(f"token_ids {self.token_ids}: five ids below {self.vocab_size}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def mamba_width(self) -> int:
        return self.mamba_expand * self.hidden_size

    @property
    def conv_dim(self) -> int:
        return self.mamba_width + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def mamba(self) -> MambaShape:
        return MambaShape(self.hidden_size, self.mamba_n_heads, self.mamba_d_head,
                          self.mamba_d_state, self.mamba_n_groups, self.mamba_d_conv,
                          self.mamba_chunk_size, self.rms_norm_eps, self.compute_dtype)

    def create_model(self, sample_batch: tuple, seed, device, mesh=None) -> "GraniteHybrid":
        if mesh is not None:
            raise ValueError("the hybrid model trains on one device: no tensor-parallel rules "
                             "cut its layers")
        return GraniteHybrid(self, seed, device=device)


class SharedMLP(nn.Module):
    """``output_linear(silu(a) * b)``, ``[a, b] = input_linear(x)``."""

    def __init__(self, cfg: GraniteHybridConfig, g: torch.Generator):
        super().__init__()
        dt = cfg.compute_dtype
        self.input_linear = Linear(cfg.hidden_size, 2 * cfg.intermediate_size, dt, g)
        self.output_linear = Linear(cfg.intermediate_size, cfg.hidden_size, dt, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.input_linear(x).chunk(2, dim=-1)
        return self.output_linear(F.silu(a) * b)


class Layer(nn.Module):
    def __init__(self, kind: str, cfg: GraniteHybridConfig, g: torch.Generator):
        super().__init__()
        self.kind, self.r = kind, cfg.residual_multiplier
        eps = cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps)
        if kind == "mamba":
            self.mamba = Mamba2Mixer(cfg.mamba, g)
        else:
            d, heads = cfg.hidden_size, cfg.num_attention_heads
            self.self_attn = Attention(d, heads, cfg.num_key_value_heads, d // heads,
                                       cfg.attention_multiplier, cfg.compute_dtype, g)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.shared_mlp = SharedMLP(cfg, g)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = self.input_layernorm(h)
        if self.kind == "mamba":
            with annotate("hh.granite.mamba"):
                h = h + self.r * self.mamba(x)
        else:
            with annotate("hh.granite.attention"):
                h = h + self.r * self.self_attn(x)
        with annotate("hh.granite.mlp"):
            return h + self.r * self.shared_mlp(self.post_attention_layernorm(h))


class GraniteHybrid(nn.Module):
    """The model.  Parameters are drawn from ``seed`` (an int: on
    ``device``, from a generator of that device; or a ``torch.Generator``:
    on its device, then moved to ``device``), never from the global
    generator: kernels and the embedding ``N(0, 0.02^2)``, the conv ``N(0, 1
    / d_conv)``, Mamba-2's ``A``, ``dt`` and ``D`` as the paper's code sets
    them, norms 1, biases 0.  The same int seed draws other values on a card
    than on the CPU."""

    def __init__(self, cfg: GraniteHybridConfig = GraniteHybridConfig(),
                 seed: int | torch.Generator = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        g = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size,
            _weight=_normal((cfg.vocab_size, cfg.hidden_size), 0.02, g))
        self.layers = nn.ModuleList(Layer(kind, cfg, g) for kind in cfg.layer_types)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.register_buffer("token_table", torch.tensor(cfg.token_ids, dtype=torch.int64),
                             persistent=False)
        self.to(dev)
        if dev.type == "cuda":  # a first build falls in set-up
            load_rms_norm()
            if "mamba" in cfg.layer_types:
                load_ssd_scan()

    clip_global_norm = property(lambda self: self.cfg.clip_global_norm)

    def tokens(self, hap1: torch.Tensor, hap2: torch.Tensor) -> torch.Tensor:
        """``(2B, L)`` int64 token ids of both haplotypes' base codes."""
        return self.token_table[torch.cat([hap1, hap2]).long()]

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """The last layer's output ``(n, L, hidden)`` over ``tokens``."""
        cfg = self.cfg
        with annotate("hh.granite.embed"):
            h = self.embed_tokens(tokens).to(cfg.compute_dtype) * cfg.embedding_multiplier
        for layer in self.layers:
            h = layer(h)
        return h

    def forward(self, hap1: torch.Tensor, hap2: torch.Tensor) -> torch.Tensor:
        """The mean next-token cross-entropy over both haplotypes of the
        ``(B, L)`` windows, float32."""
        tokens = self.tokens(hap1, hap2)
        h = self.hidden(tokens)
        with annotate("hh.granite.head_loss"):
            h = self.norm(h)
            n, L, d = h.shape
            return ChunkedHeadLoss.apply(h[:, :-1].reshape(n * (L - 1), d),
                                         self.embed_tokens.weight,
                                         tokens[:, 1:].reshape(-1),
                                         self.cfg.logits_scaling, self.cfg.loss_chunk)

    def loss(self, hap1, hap2, n_variants=None, targets=None, generator=None):
        """``(loss, {})``: the windows are their own targets."""
        return self(hap1, hap2), {}

    def make_optimizer(self, learning_rate: float) -> torch.optim.Optimizer:
        """AdamW, the matrices and the embedding decayed, the vectors not."""
        cfg = self.cfg
        params = list(self.parameters())
        groups = [{"params": [p for p in params if p.dim() >= 2]},
                  {"params": [p for p in params if p.dim() < 2], "weight_decay": 0.0}]
        return torch.optim.AdamW(groups, lr=learning_rate, betas=cfg.adam_betas,
                                 eps=cfg.adam_eps, weight_decay=cfg.weight_decay)

    def dropout_generator(self, seed) -> None:
        return None

    def after_step(self) -> None:
        """Nothing besides the parameters moves after a step."""

