"""HaploFormer's loss, train step and fused sample-into-train step,
checkpoints, and the training loop over the sampler: the JAX package's
``models/train.py`` in PyTorch.

bf16 compute, float32 parameters and AdamW state.  A step updates the
module's parameters and the optimiser's state in place and returns its
metrics as device tensors: no host round-trip happens inside a step.  Only
``train_on_sampler`` reads a loss on the host, at its logging steps.

With a ``mesh`` (``parallel.mesh.make_mesh``) a step is data parallel over
``data`` and tensor parallel over ``model``: every rank is given the same
global batch and trains on its ``data`` block of it; the model's attention
heads and MLP hidden dim are cut over ``model`` (``parallel.mesh.
shard_model``); after the backward one all-reduce over ``data`` averages
every gradient and the metrics in one flat buffer, so each rank reports the
global loss; AdamW then updates each rank's shards (elementwise, the same
update as on the whole tensors).  Checkpoints hold the global tensors.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.core.profiling import annotate
from haplohyped_tpu_torch.models.haploformer import HaploFormer, HaploFormerConfig
from haplohyped_tpu_torch.ops.haplotype_window import windows_to_onehot
from haplohyped_tpu_torch.parallel import distributed
from haplohyped_tpu_torch.parallel.mesh import (
    axis_group,
    axis_size,
    param_shardings,
    shard_batch_spec,
    shard_model,
)

logger = logging.getLogger(__name__)

#: ``optax.adamw``'s defaults (torch's AdamW decays by 1e-2 by default)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
#: the file a checkpoint directory holds
CHECKPOINT_FILE = "train_state.pt"


class TrainState(NamedTuple):
    """The model, its optimiser, the number of steps taken, and the mesh the
    model is sharded over (None: unsharded).  A step returns a new tuple
    around the same (updated) module and optimiser."""

    model: HaploFormer
    optimizer: torch.optim.AdamW
    step: int
    mesh: DeviceMesh | None = None


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
    mesh: DeviceMesh | None = None,
) -> TrainState:
    """A model built for ``sample_batch``'s window length (``(hap1, hap2)``,
    as flax's ``init`` takes its shapes from it), initialised from ``seed``,
    with ``AdamW`` at optax's defaults over every parameter in one group
    (optax applies no mask: biases, norms and ``pos_embed`` decay too).
    With ``mesh`` (on ``device``'s kind), every rank builds the same model
    and keeps its ``model`` shards of it."""
    with annotate("hh.train.create_state"):
        model = HaploFormer(cfg, sample_batch[0].shape[1], seed, device=device)
        if mesh is not None:
            if mesh.device_type != resolve_device(device).type:
                raise ValueError(f"a {mesh.device_type} mesh for a model on {device}")
            shard_model(model, mesh)
        optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate, **ADAMW)
    return TrainState(model, optimizer, 0, mesh)


def _average_over_data(params: list, metrics: dict, mesh: DeviceMesh) -> dict:
    """Average every gradient and the metrics over ``data`` in one flat
    all-reduce; returns the averaged metrics.  The span
    ``hh.parallel.allreduce`` (attribute ``bytes``: the flat buffer's size)
    covers the exchange and the copy back, not the concatenation."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([m.float() for m in metrics.values()])])
    with annotate("hh.parallel.allreduce", bytes=flat.numel() * flat.element_size()):
        dist.all_reduce(flat, group=axis_group(mesh, "data"))
        flat /= axis_size(mesh, "data")
        parts = flat.split([g.numel() for g in grads] + [len(metrics)])
        torch._foreach_copy_(grads, [part.view_as(g) for g, part in zip(grads, parts)])
    return dict(zip(metrics, parts[-1].unbind()))


def _train_step(state: TrainState, hap1, hap2, n_variants, mesh: DeviceMesh | None = None):
    if state.mesh is not mesh:
        raise ValueError("the train state was made for another mesh than the step's")
    with annotate("hh.train.step"):
        if mesh is not None:
            block = shard_batch_spec(mesh)
            hap1, hap2, n_variants = (block.local(t) for t in (hap1, hap2, n_variants))
        with annotate("hh.train.forward"):
            loss, aux = loss_fn(state.model, hap1, hap2, n_variants)
        with annotate("hh.train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
        if mesh is not None:
            metrics = _average_over_data(list(state.model.parameters()), metrics, mesh)
        with annotate("hh.train.optimizer"):
            state.optimizer.step()
    return TrainState(state.model, state.optimizer, state.step + 1, mesh), metrics


def make_train_step(mesh: DeviceMesh | None = None):
    """``step(state, hap1, hap2, n_variants) -> (state, metrics)``: one
    AdamW step on the batch; ``metrics`` holds ``loss``, ``reg`` and ``ce``
    as device tensors.  The module and optimiser travel in the state, so
    only the mesh is bound here (the JAX package binds the model and
    optimiser into its jitted step).  With ``mesh``, the batch is the global
    one and the state must be :func:`create_train_state`'s for that mesh."""
    if mesh is None:
        return _train_step
    return functools.partial(_train_step, mesh=mesh)


def make_fused_train_step(sampler, mesh: DeviceMesh | None = None):
    """``fused(state, step_idx) -> (state, metrics)``: build sampling step
    ``step_idx``'s batch on the device (``sampler.batch_at``: on CUDA one
    draw-kernel launch, which crops the windows too, and the window kernel in
    codes mode) and take one train step on it; equal to the batch
    ``sampler.sample()`` gives at that step followed by the train step.
    With ``mesh`` every rank draws the global batch and trains on its block."""

    def fused(state: TrainState, step_idx: int):
        with annotate("hh.train.fused_step"):
            b = sampler.batch_at(step_idx)
            return _train_step(state, b.hap1, b.hap2, b.n_variants, mesh)

    return fused


def _global_state(state: TrainState) -> tuple[dict, dict]:
    """The module's and the optimiser's ``state_dict`` with every sharded
    parameter and AdamW slot gathered over ``model`` (a collective)."""
    model_sd, opt_sd = state.model.state_dict(), state.optimizer.state_dict()
    if state.mesh is None:
        return model_sd, opt_sd
    placements = param_shardings(state.model, state.mesh)
    names = [n for n, _ in state.model.named_parameters()]
    model_sd = {k: placements[k].gather(v) for k, v in model_sd.items()}
    opt_sd["state"] = {i: {k: placements[names[i]].gather(v) if v.ndim else v
                           for k, v in slots.items()}
                       for i, slots in opt_sd["state"].items()}
    return model_sd, opt_sd


def _local_state(template: TrainState, model_sd: dict, opt_sd: dict) -> tuple[dict, dict]:
    """The global state dicts cut to ``template``'s shards."""
    if template.mesh is None:
        return model_sd, opt_sd
    placements = param_shardings(template.model, template.mesh)
    names = [n for n, _ in template.model.named_parameters()]
    model_sd = {k: placements[k].local(v) for k, v in model_sd.items()}
    opt_sd["state"] = {i: {k: placements[names[i]].local(v) if v.ndim else v
                           for k, v in slots.items()}
                       for i, slots in opt_sd["state"].items()}
    return model_sd, opt_sd


def save_checkpoint(state: TrainState, ckpt_dir: str, step: int | None = None) -> str:
    """Write the module's and the optimiser's ``state_dict`` and the step to
    ``ckpt_dir/step_{n}`` (``torch.save``); returns that directory.  A
    sharded state writes the global tensors, gathered over ``model``, from
    rank 0 (every rank must call it), so any mesh, or none, restores it."""
    step = state.step if step is None else step
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    model_sd, opt_sd = _global_state(state)
    if distributed.process_info()[0] == 0 or state.mesh is None:
        os.makedirs(path, exist_ok=True)
        torch.save({"model": model_sd, "optimizer": opt_sd, "step": state.step},
                   os.path.join(path, CHECKPOINT_FILE))
    if state.mesh is not None:
        distributed.barrier()  # the file is whole before any rank reads it
    return path


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint of :func:`save_checkpoint` into ``template``'s
    module and optimiser (built for the same configuration, and cut to its
    mesh's shards where it has one) and return them with the saved step."""
    # onto the CPU first: load_state_dict moves each tensor to its parameter,
    # and leaves AdamW's step counters on the host, where they belong
    ckpt = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)
    model_sd, opt_sd = _local_state(template, ckpt["model"], ckpt["optimizer"])
    template.model.load_state_dict(model_sd)
    template.optimizer.load_state_dict(opt_sd)
    return TrainState(template.model, template.optimizer, int(ckpt["step"]), template.mesh)


def train_on_sampler(
    sampler,
    cfg: HaploFormerConfig | None = None,
    steps: int = 100,
    learning_rate: float = 3e-4,
    log_every: int = 20,
    seed: int = 0,
    mesh: DeviceMesh | None = None,
):
    """Sampled batches feed train steps on the sampler's device, with no host
    data path after set-up.  The first ``sample()`` gives the model its
    window length; ``steps`` more batches are trained on.  Returns the final
    state and the loss at every ``log_every``-th step and the last.  With
    ``mesh`` every rank's sampler (the same seed) draws the same global
    batch, a function of (seed, step), and trains on its block of it."""
    first = sampler.sample()
    state = create_train_state(cfg or HaploFormerConfig(), (first.hap1, first.hap2),
                               learning_rate, seed, device=sampler.device, mesh=mesh)
    step_fn = make_train_step(mesh)
    losses = []
    for i in range(steps):
        batch = sampler.sample()
        state, metrics = step_fn(state, batch.hap1, batch.hap2, batch.n_variants)
        if (i + 1) % log_every == 0 or i == steps - 1:
            loss = metrics["loss"].item()
            losses.append(loss)
            logger.info("step %d loss %.4f", i + 1, loss)
    return state, losses
