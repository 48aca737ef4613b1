"""A hybrid Mamba-2/MoE/attention nucleotide language model with the widths
of NVIDIA's Nemotron 3 Nano 30B-A3B, trained on both haplotypes of the
sampler's windows.

The layer equations are those of the published ``config.json`` of
``nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16`` (model type ``nemotron_h``);
:class:`NemotronHConfig` keeps its key names (the published
``use_conv_bias: true``, ``use_bias``, ``mamba_proj_bias``, ``mlp_bias`` and
``attention_bias: false`` are built in).  Its defaults are what one card of
the 32-card deployment holds: pipeline stage 1 of 4,
``hybrid_override_pattern[0:13]`` (``M`` Mamba-2, ``E`` MoE, ``*``
attention; the published model has 52 layers), experts
``experts_held`` of each MoE layer's ``n_routed_experts`` (the other 112
live on the node's other 7 cards), and rows 0-16,383 of the 131,072-row
embedding and head (``vocab_size`` is the rows held).

- Embedding: ``h = embed(tokens)``; a window's int8 base codes (A, C, G, T,
  N: 0-4) index ``token_ids``, five ids inside the held rows.
- Each layer: ``h = h + mixer(rmsnorm(h))``, one mixer a layer:
  - ``M``, Mamba-2 (``models/hybrid_layers.py::Mamba2Mixer``):
    ``mamba_num_heads`` heads of ``mamba_head_dim`` (the width, not
    ``expand``), a state of ``ssm_state_size`` in ``n_groups`` groups of
    ``B`` and ``C`` (head ``h`` reads group ``h // 8``), conv width
    ``conv_kernel`` with a bias, chunks of ``chunk_size``; the gated norm
    over each group's 512 columns.
  - ``E``, the MoE (``models/moe.py``): a sigmoid router over all
    ``n_routed_experts``, the top ``num_experts_per_tok`` of its scores plus
    ``e_score_correction_bias``, their unbiased scores renormalised and
    times ``routed_scaling_factor``; ReLU² experts of
    ``moe_intermediate_size``, this card's computed by grouped products; one
    shared ReLU² expert of ``moe_shared_expert_intermediate_size``.
  - ``*``, attention (``models/hybrid_layers.py::Attention``):
    ``num_attention_heads`` queries and ``num_key_value_heads`` keys and
    values of ``head_dim``, causal, scaled by ``1 / sqrt(head_dim)``, no
    position encoding (the ``nemotron_h`` modeling code applies no rotary;
    ``rope_theta`` is read by no layer).
- Head: the final RMSNorm and the untied ``lm_head``; the loss is the mean
  next-token cross-entropy over both haplotypes' ``L - 1`` predicted
  positions, through :class:`ChunkedHeadLoss` over ``loss_chunk`` tokens at
  a time.

Cast rules as the Granite hybrid's (``models/hybrid_layers.py``), with the
router's product, its scores, the selection and the slot weights in float32.

The model owns its training: :meth:`NemotronH.loss`,
:meth:`NemotronH.make_optimizer` (AdamW, weight decay on the matrices and
the embedding), ``clip_global_norm`` and :meth:`NemotronH.after_step`, which
moves each MoE layer's router bias by the step's loads.  Spans
(``core/profiling.py``): ``hh.nemotron.embed``, ``hh.nemotron.mamba``,
``hh.nemotron.moe`` and ``hh.nemotron.attention`` (one a layer) and
``hh.nemotron.head_loss``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.core.profiling import annotate
from haplohyped_tpu_torch.models.hybrid_layers import (
    Attention,
    ChunkedHeadLoss,
    Linear,
    Mamba2Mixer,
    MambaShape,
    RMSNorm,
    _normal,
)
from haplohyped_tpu_torch.models.moe import MoE
from haplohyped_tpu_torch.ops.rms_norm import load as load_rms_norm
from haplohyped_tpu_torch.ops.ssd_scan import load as load_ssd_scan

#: the published 52 layers' first 13: pipeline stage 1 of 4
STAGE_1 = "MEMEM*EMEMEM*"
#: the mixer each letter of ``hybrid_override_pattern`` names
KINDS = {"M": "mamba", "E": "moe", "*": "attention"}


@dataclass(frozen=True)
class NemotronHConfig:
    hidden_size: int = 2688
    moe_intermediate_size: int = 1856
    moe_shared_expert_intermediate_size: int = 3712
    mamba_num_heads: int = 64
    mamba_head_dim: int = 64
    ssm_state_size: int = 128
    n_groups: int = 8
    conv_kernel: int = 4
    chunk_size: int = 128
    num_attention_heads: int = 32
    num_key_value_heads: int = 2
    head_dim: int = 128
    n_routed_experts: int = 128
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.5
    layer_norm_epsilon: float = 1e-5
    #: the embedding's and head's rows held (published: 131,072)
    vocab_size: int = 16384
    hybrid_override_pattern: str = STAGE_1
    #: ``(first, count)``: the routed experts this card holds
    experts_held: tuple = (0, 16)
    #: the token ids of the base codes 0-4 (A, C, G, T, N)
    token_ids: tuple = (65, 67, 71, 84, 78)
    #: tokens a chunk of the head and loss
    loss_chunk: int = 4096
    #: the router bias's move a step (DeepSeek-V3's gamma, 1e-3 there; a
    #: card holding 16 of the 128 experts needs ten times it to keep its
    #: share of the load: the absent experts add nothing, so the router gains
    #: by sending slots away from the held ones)
    router_bias_update_rate: float = 1e-2
    #: AdamW's (beta1, beta2), epsilon and weight decay (on the matrices)
    adam_betas: tuple = (0.9, 0.95)
    adam_eps: float = 1e-8
    weight_decay: float = 0.1
    clip_global_norm: float = 1.0
    dtype: str = "bfloat16"

    def __post_init__(self):
        for k in ("experts_held", "token_ids", "adam_betas"):
            object.__setattr__(self, k, tuple(getattr(self, k)))
        if set(self.hybrid_override_pattern) - set(KINDS):
            raise ValueError(f"unknown layer letters in {self.hybrid_override_pattern!r}")
        if self.mamba_num_heads % self.n_groups:
            raise ValueError("the groups of B and C (n_groups) must divide the Mamba-2 heads")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("the key heads must divide the query heads")
        if len(self.token_ids) != 5 or max(self.token_ids) >= self.vocab_size:
            raise ValueError(f"token_ids {self.token_ids}: five ids below {self.vocab_size}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def layer_types(self) -> tuple:
        return tuple(KINDS[c] for c in self.hybrid_override_pattern)

    @property
    def mamba(self) -> MambaShape:
        return MambaShape(self.hidden_size, self.mamba_num_heads, self.mamba_head_dim,
                          self.ssm_state_size, self.n_groups, self.conv_kernel, self.chunk_size,
                          self.layer_norm_epsilon, self.compute_dtype)

    def create_model(self, sample_batch: tuple, seed, device, mesh=None) -> "NemotronH":
        if mesh is not None:
            raise ValueError("the Nemotron-H hybrid trains on one device: no tensor-parallel "
                             "rules cut its layers")
        return NemotronH(self, seed, device=device)


class Layer(nn.Module):
    def __init__(self, kind: str, cfg: NemotronHConfig, g: torch.Generator):
        super().__init__()
        self.kind = kind
        self.norm = RMSNorm(cfg.hidden_size, cfg.layer_norm_epsilon)
        dt = cfg.compute_dtype
        if kind == "mamba":
            self.mixer = Mamba2Mixer(cfg.mamba, g)
        elif kind == "moe":
            self.mixer = MoE(cfg.hidden_size, cfg.n_routed_experts, cfg.num_experts_per_tok,
                             cfg.moe_intermediate_size, cfg.moe_shared_expert_intermediate_size,
                             cfg.routed_scaling_factor, cfg.experts_held, dt, g,
                             cfg.router_bias_update_rate)
        else:
            self.mixer = Attention(cfg.hidden_size, cfg.num_attention_heads,
                                   cfg.num_key_value_heads, cfg.head_dim,
                                   1 / math.sqrt(cfg.head_dim), dt, g)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        with annotate(f"hh.nemotron.{self.kind}"):
            return h + self.mixer(self.norm(h))


class NemotronH(nn.Module):
    """The model.  Parameters are drawn from ``seed`` (an int: on
    ``device``, from a generator of that device; or a ``torch.Generator``:
    on its device, then moved to ``device``), never from the global
    generator: every matrix, the embedding and the head ``N(0, 0.02^2)``,
    the conv ``N(0, 1 / conv_kernel)``, Mamba-2's ``A``, ``dt`` and ``D`` as
    the paper's code sets them, norms 1, biases and router biases 0."""

    def __init__(self, cfg: NemotronHConfig = NemotronHConfig(),
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
        self.norm_f = RMSNorm(cfg.hidden_size, cfg.layer_norm_epsilon)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, cfg.compute_dtype, g)
        self.register_buffer("token_table", torch.tensor(cfg.token_ids, dtype=torch.int64),
                             persistent=False)
        self.to(dev)
        if dev.type == "cuda":  # a first build falls in set-up
            load_rms_norm()
            if "mamba" in cfg.layer_types:
                load_ssd_scan()

    clip_global_norm = property(lambda self: self.cfg.clip_global_norm)

    def moe_layers(self) -> list[MoE]:
        return [layer.mixer for layer in self.layers if layer.kind == "moe"]

    def tokens(self, hap1: torch.Tensor, hap2: torch.Tensor) -> torch.Tensor:
        """``(2B, L)`` int64 token ids of both haplotypes' base codes."""
        return self.token_table[torch.cat([hap1, hap2]).long()]

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """The last layer's output ``(n, L, hidden)`` over ``tokens``."""
        with annotate("hh.nemotron.embed"):
            h = self.embed_tokens(tokens).to(self.cfg.compute_dtype)
        for layer in self.layers:
            h = layer(h)
        return h

    def forward(self, hap1: torch.Tensor, hap2: torch.Tensor) -> torch.Tensor:
        """The mean next-token cross-entropy over both haplotypes of the
        ``(B, L)`` windows, float32."""
        tokens = self.tokens(hap1, hap2)
        h = self.hidden(tokens)
        with annotate("hh.nemotron.head_loss"):
            h = self.norm_f(h)
            n, L, d = h.shape
            return ChunkedHeadLoss.apply(h[:, :-1].reshape(n * (L - 1), d), self.lm_head.weight,
                                         tokens[:, 1:].reshape(-1), 1.0, self.cfg.loss_chunk)

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

    def after_step(self) -> None:
        """Move each MoE layer's router bias by the loads of the step."""
        for m in self.moe_layers():
            m.update_bias()

    def dropout_generator(self, seed) -> None:
        return None
