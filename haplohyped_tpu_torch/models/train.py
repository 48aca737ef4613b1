"""The loss, train step and fused sample-into-train step, checkpoints, and
the training loop over the sampler: the JAX package's ``models/train.py`` in
PyTorch, for every model of the port.

A train state's model is the one its config names (``cfg.create_model``):
HaploFormer, Enformer, the Granite hybrid or the Nemotron-H hybrid.  Each model owns its training:
``model.loss(hap1, hap2, n_variants, targets, generator)``,
``model.make_optimizer(learning_rate)``, ``model.clip_global_norm`` (None:
no clip), ``model.dropout_generator(seed)`` (None: no dropout) and
``model.after_step()``, called after each optimiser step for what the model
keeps besides its parameters (the Nemotron-H hybrid's router biases; a no-op
for the others).
HaploFormer trains with AdamW at optax's defaults on the sampler's free
labels; Enformer with Adam, the global gradient norm clipped, on targets the
fused step's ``targets`` callback gives, its dropout drawn from a generator
the state holds; the Granite and Nemotron-H hybrids with AdamW and a clip,
on the windows' own next bases.

bf16 compute, float32 parameters and optimiser state.  A step updates the
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
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from haplohyped_tpu_torch.core.profiling import annotate
from haplohyped_tpu_torch.models.haploformer import (  # noqa: F401 (token_targets re-exported)
    HaploFormerConfig,
    token_targets,
)
from haplohyped_tpu_torch.parallel import distributed
from haplohyped_tpu_torch.parallel.mesh import (
    axis_group,
    axis_size,
    param_shardings,
    shard_batch_spec,
)

logger = logging.getLogger(__name__)

#: the file a checkpoint directory holds
CHECKPOINT_FILE = "train_state.pt"


class TrainState(NamedTuple):
    """The model, its optimiser, the number of steps taken, the mesh the
    model is sharded over (None: unsharded) and the generator its dropout
    draws from (None: no dropout).  A step returns a new tuple around the
    same (updated) module, optimiser and generator."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    mesh: DeviceMesh | None = None
    generator: torch.Generator | None = None


def loss_fn(model: nn.Module, hap1, hap2, n_variants, targets=None,
            generator: torch.Generator | None = None):
    """``(loss, aux)``: the model's own loss on the batch (``model.loss``).
    HaploFormer's aux holds ``reg`` and ``ce``; Enformer trains on
    ``targets`` ``(B, target_length, tracks)``, its dropout drawn from
    ``generator``; the Granite hybrid on the windows' next bases."""
    return model.loss(hap1, hap2, n_variants, targets, generator)


def create_train_state(
    cfg,
    sample_batch: tuple,
    learning_rate: float = 3e-4,
    seed: int | torch.Generator = 0,
    device: str | torch.device = "cuda",
    mesh: DeviceMesh | None = None,
) -> TrainState:
    """The model ``cfg`` names (``cfg.create_model``), initialised from
    ``seed`` on ``device``, with the optimiser it trains with and its dropout
    generator.  HaploFormer is built for ``sample_batch``'s window length and
    takes a ``mesh`` (on ``device``'s kind): every rank builds the same model
    and keeps its ``model`` shards of it.  Enformer takes windows of
    ``cfg.sequence_length``; neither it nor the Granite hybrid takes a mesh."""
    with annotate("hh.train.create_state"):
        model = cfg.create_model(sample_batch, seed, device, mesh)
        optimizer = model.make_optimizer(learning_rate)
        generator = model.dropout_generator(seed)
    return TrainState(model, optimizer, 0, mesh, generator)


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


def _train_step(state: TrainState, hap1, hap2, n_variants, mesh: DeviceMesh | None = None,
                targets=None):
    if state.mesh is not mesh:
        raise ValueError("the train state was made for another mesh than the step's")
    with annotate("hh.train.step"):
        if mesh is not None:
            block = shard_batch_spec(mesh)
            hap1, hap2, n_variants = (block.local(t) for t in (hap1, hap2, n_variants))
        with annotate("hh.train.forward"):
            loss, aux = loss_fn(state.model, hap1, hap2, n_variants, targets, state.generator)
        with annotate("hh.train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
        if mesh is not None:
            metrics = _average_over_data(list(state.model.parameters()), metrics, mesh)
        clip = state.model.clip_global_norm
        if clip is not None:
            with annotate("hh.train.clip"):
                torch.nn.utils.clip_grad_norm_(state.model.parameters(), clip, foreach=True)
        with annotate("hh.train.optimizer"):
            state.optimizer.step()
            state.model.after_step()
    return state._replace(step=state.step + 1), metrics


def make_train_step(mesh: DeviceMesh | None = None):
    """``step(state, hap1, hap2, n_variants, targets=None) -> (state,
    metrics)``: one optimiser step on the batch; ``metrics`` holds ``loss``
    (and HaploFormer's ``reg`` and ``ce``) as device tensors.  The module and optimiser travel in the state, so
    only the mesh is bound here (the JAX package binds the model and
    optimiser into its jitted step).  With ``mesh``, the batch is the global
    one and the state must be :func:`create_train_state`'s for that mesh."""
    if mesh is None:
        return _train_step
    return functools.partial(_train_step, mesh=mesh)


def make_fused_train_step(sampler, mesh: DeviceMesh | None = None, targets=None):
    """``fused(state, step_idx) -> (state, metrics)``: build sampling step
    ``step_idx``'s batch on the device (``sampler.batch_at``: on CUDA one
    draw-kernel launch, which crops the windows too, and the window kernel in
    codes mode) and take one train step on it; equal to the batch
    ``sampler.sample()`` gives at that step followed by the train step.
    With ``mesh`` every rank draws the global batch and trains on its block.
    ``targets(step_idx, batch) -> tensor``, called after sampling, gives the
    step's targets (Enformer's tracks, which a deployment reads per donor and
    region), under the span ``hh.train.targets``."""

    def fused(state: TrainState, step_idx: int):
        with annotate("hh.train.fused_step"):
            b = sampler.batch_at(step_idx)
            if targets is None:
                return _train_step(state, b.hap1, b.hap2, b.n_variants, mesh)
            with annotate("hh.train.targets"):
                y = targets(step_idx, b)
            return _train_step(state, b.hap1, b.hap2, b.n_variants, mesh, targets=y)

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
    return template._replace(step=int(ckpt["step"]))


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
