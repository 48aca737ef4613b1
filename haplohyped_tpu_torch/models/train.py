"""HaploFormer's loss, train step and fused sample-into-train step,
checkpoints, and the training loop over the sampler: the JAX package's
``models/train.py`` in PyTorch, on one card.

bf16 compute, float32 parameters and AdamW state.  A step updates the
module's parameters and the optimiser's state in place and returns its
metrics as device tensors: no host round-trip happens inside a step.  Only
``train_on_sampler`` reads a loss on the host, at its logging steps.
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from haplohyped_tpu_torch.models.haploformer import HaploFormer, HaploFormerConfig
from haplohyped_tpu_torch.ops.haplotype_window import windows_to_onehot

logger = logging.getLogger(__name__)

#: ``optax.adamw``'s defaults (torch's AdamW decays by 1e-2 by default)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
#: the file a checkpoint directory holds
CHECKPOINT_FILE = "train_state.pt"


class TrainState(NamedTuple):
    """The model, its optimiser and the number of steps taken.  A step
    returns a new tuple around the same (updated) module and optimiser."""

    model: HaploFormer
    optimizer: torch.optim.AdamW
    step: int


def token_targets(hap1: torch.Tensor, T: int, pool: int, num_channels: int) -> torch.Tensor:
    """``(B, T)`` int64: for each token, the channel most frequent over its
    ``pool`` positions of ``hap1[:, :T * pool]``; a tie goes to the lowest
    channel (both libraries' argmax takes the first maximum)."""
    oh = hap1 if hap1.ndim == 3 else windows_to_onehot(hap1, num_channels, torch.float32)
    B, _, C = oh.shape
    return oh[:, : T * pool].reshape(B, T, pool, C).sum(dim=2).argmax(dim=-1)


def loss_fn(model: HaploFormer, hap1, hap2, n_variants):
    """``(loss, {"reg", "ce"})``: ``0.01 * reg + ce``, with ``reg`` the MSE
    of the variant count against ``n_variants`` (free labels from the
    sampler) and ``ce`` the cross-entropy of the token head against
    :func:`token_targets` of hap1."""
    out = model(hap1, hap2)
    reg = ((out["variant_count"] - n_variants.float()) ** 2).mean()
    logits = out["base_logits"]
    cfg = model.cfg
    targets = token_targets(hap1, logits.shape[1], cfg.pool, cfg.num_channels)
    ce = F.cross_entropy(logits.flatten(0, 1), targets.flatten())
    return reg * 0.01 + ce, {"reg": reg, "ce": ce}


def create_train_state(
    cfg: HaploFormerConfig,
    sample_batch: tuple,
    learning_rate: float = 3e-4,
    seed: int | torch.Generator = 0,
    device: str | torch.device = "cuda",
) -> TrainState:
    """A model built for ``sample_batch``'s window length (``(hap1, hap2)``,
    as flax's ``init`` takes its shapes from it), initialised from ``seed``,
    with ``AdamW`` at optax's defaults over every parameter in one group
    (optax applies no mask: biases, norms and ``pos_embed`` decay too)."""
    model = HaploFormer(cfg, sample_batch[0].shape[1], seed, device=device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate, **ADAMW)
    return TrainState(model, optimizer, 0)


def _train_step(state: TrainState, hap1, hap2, n_variants):
    loss, aux = loss_fn(state.model, hap1, hap2, n_variants)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
    return TrainState(state.model, state.optimizer, state.step + 1), metrics


def make_train_step():
    """``step(state, hap1, hap2, n_variants) -> (state, metrics)``: one
    AdamW step on the batch; ``metrics`` holds ``loss``, ``reg`` and ``ce``
    as device tensors.  The module and optimiser travel in the state, so
    nothing is bound here (the JAX package binds them into its jitted step)."""
    return _train_step


def make_fused_train_step(sampler):
    """``fused(state, step_idx) -> (state, metrics)``: draw sampling step
    ``step_idx``'s batch on the device (the window kernel in codes mode on
    CUDA) and take one train step on it; equal to the batch
    ``sampler.sample()`` gives at that step followed by the train step."""

    def fused(state: TrainState, step_idx: int):
        b = sampler.windows_from_draws(*sampler.draw_indices(step_idx))
        return _train_step(state, b.hap1, b.hap2, b.n_variants)

    return fused


def save_checkpoint(state: TrainState, ckpt_dir: str, step: int | None = None) -> str:
    """Write the module's and the optimiser's ``state_dict`` and the step to
    ``ckpt_dir/step_{n}`` (``torch.save``); returns that directory."""
    step = state.step if step is None else step
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, os.path.join(path, CHECKPOINT_FILE))
    return path


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint of :func:`save_checkpoint` into ``template``'s
    module and optimiser (built for the same configuration) and return them
    with the saved step."""
    # onto the CPU first: load_state_dict moves each tensor to its parameter,
    # and leaves AdamW's step counters on the host, where they belong
    ckpt = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)
    template.model.load_state_dict(ckpt["model"])
    template.optimizer.load_state_dict(ckpt["optimizer"])
    return TrainState(template.model, template.optimizer, int(ckpt["step"]))


def train_on_sampler(
    sampler,
    cfg: HaploFormerConfig | None = None,
    steps: int = 100,
    learning_rate: float = 3e-4,
    log_every: int = 20,
    seed: int = 0,
):
    """Sampled batches feed train steps on the sampler's device, with no host
    data path after set-up.  The first ``sample()`` gives the model its
    window length; ``steps`` more batches are trained on.  Returns the final
    state and the loss at every ``log_every``-th step and the last."""
    first = sampler.sample()
    state = create_train_state(cfg or HaploFormerConfig(), (first.hap1, first.hap2),
                               learning_rate, seed, device=sampler.device)
    step_fn = make_train_step()
    losses = []
    for i in range(steps):
        batch = sampler.sample()
        state, metrics = step_fn(state, batch.hap1, batch.hap2, batch.n_variants)
        if (i + 1) % log_every == 0 or i == steps - 1:
            loss = metrics["loss"].item()
            losses.append(loss)
            logger.info("step %d loss %.4f", i + 1, loss)
    return state, losses
