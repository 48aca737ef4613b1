"""Process mesh and sharding rules.

The JAX package's ``parallel/mesh.py`` on ``torch.distributed``: a
``('data', 'model')`` ``DeviceMesh`` of process groups, regex rules mapping
parameter names to partition specs (tensor parallelism of the attention
heads and the MLP hidden dimension on ``model``, the batch on ``data``), and
the helpers that training and the sharded converter share.  Where XLA
inserted collectives from shardings, here the code issues them itself: a
:class:`Placement` cuts a tensor to this rank's block and gathers the blocks
back, and :func:`shard_model` cuts a model's parameters and puts the
Megatron pair of collectives (``parallel/collectives.py``) into its blocks.
"""

from __future__ import annotations

import re
from typing import Mapping, NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from haplohyped_tpu_torch.core.config import MeshConfig, resolve_device
from haplohyped_tpu_torch.parallel import distributed

#: parameter-name regex -> partition spec (first match wins), over the
#: port's parameter names with ``.`` read as ``/`` (flax's paths).  A spec
#: names, for each leading dim of the tensor, the mesh axis it is cut over,
#: or None.  Attention projections and the MLP hidden dimension shard on
#: ``model``; their output projections shard the contracting dim; all else
#: is replicated.
PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    (r"attn/(query|key|value)/kernel$", (None, "model", None)),
    (r"attn/out/kernel$", ("model", None, None)),
    (r"mlp_in/kernel$", (None, "model")),
    (r"mlp_out/kernel$", ("model", None)),
    (r"mlp_in/bias$", ("model",)),
    (r".*", ()),
)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that share every coordinate but ``axis``."""
    return mesh.get_group(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: its card under NCCL (the
    current device), the CPU under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(config: MeshConfig | None = None, device: str | torch.device = "cuda") -> DeviceMesh:
    """A ``('data', 'model')`` mesh over the processes of the default group,
    rank ``d * model + m`` at coordinate ``(d, m)`` (row-major, as the JAX
    package reshapes its device list).

    With no process group, it starts one: from torchrun's variables where
    they are set (:func:`distributed.initialize`), else a group of world size
    1 over an in-process store, which is how one card runs it.  NCCL on
    ``device="cuda"``, gloo on ``device="cpu"``.  ``config`` defaults to
    ``MeshConfig(data=world_size)``; a mesh must hold every process (a rank
    outside a ``DeviceMesh`` has no coordinate), and one larger than the
    world raises ``ValueError``."""
    dev = resolve_device(device)
    backend = distributed.backend_for(dev)
    if not dist.is_initialized() and not distributed.initialize(device=dev):
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, a {dev.type} mesh "
                         f"needs {backend}")
    world = dist.get_world_size()
    if config is None:
        config = MeshConfig(data=world, model=1)
    n = config.num_devices
    if n > world:
        raise ValueError(f"mesh needs {n} processes, have {world}")
    if n < world:
        raise ValueError(f"a mesh of {n} processes leaves {world - n} of the {world} "
                         "without a coordinate; make the mesh cover the world")
    ranks = torch.arange(n).reshape(config.data, config.model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(config.axis_names))


class Placement(NamedTuple):
    """A partition spec on a mesh (``NamedSharding``'s counterpart): for each
    leading dim of a tensor, the mesh axis it is cut over, or None; ``()``
    is replicated.  Each rank holds the contiguous block of its coordinate."""

    spec: tuple
    mesh: DeviceMesh

    @property
    def is_replicated(self) -> bool:
        return all(a is None for a in self.spec)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``x`` (a new contiguous tensor)."""
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = axis_size(self.mesh, axis)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over "
                                 f"the {n} ranks of '{axis}'")
            c = x.shape[dim] // n
            x = x.narrow(dim, axis_rank(self.mesh, axis) * c, c)
        return x.clone(memory_format=torch.contiguous_format)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block ``x`` (an all-gather over
        each axis the spec names)."""
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(axis_size(self.mesh, axis))]
            dist.all_gather(parts, x, group=axis_group(self.mesh, axis))
            x = torch.cat(parts, dim=dim)
        return x


def _spec_for(name: str, ndim: int, rules) -> tuple:
    path = name.replace(".", "/")
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(spec[:ndim])  # drop axes past the tensor's rank
    return ()


def param_shardings(params: nn.Module | Mapping[str, torch.Tensor], mesh: DeviceMesh,
                    rules=PARAM_RULES) -> dict[str, Placement]:
    """Each parameter's :class:`Placement` by name rules: a module's
    ``named_parameters()`` or a ``{name: tensor}`` mapping (a ``state_dict``)."""
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {n: Placement(_spec_for(n, p.ndim, rules), mesh) for n, p in items}


def shard_batch_spec(mesh: DeviceMesh) -> Placement:
    """Batch tensors shard their leading dim over ``data``."""
    return Placement(("data",), mesh)


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement((), mesh)


def shard_model(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Cut ``model`` for tensor parallelism over ``model`` in place and return
    it.  Every parameter that :data:`PARAM_RULES` shards becomes this rank's
    slice (q/k/v kernels and ``attn.out.kernel`` on heads, ``mlp_in``'s kernel
    and bias on the hidden dim, ``mlp_out.kernel`` on its input dim); each
    module with a ``tensor_parallel`` method (HaploFormer's ``Attention``
    and ``Block``) then takes its local heads and its collectives.  Every rank
    must hold the same global parameters before.  With ``model`` of size 1
    nothing changes: the model computes exactly what it computed."""
    size = axis_size(mesh, "model")
    if size == 1:
        return model
    rank, group = axis_rank(mesh, "model"), axis_group(mesh, "model")
    placements = param_shardings(model, mesh)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            pl = placements[name]
            if not pl.is_replicated:
                owner, _, attr = name.rpartition(".")
                setattr(model.get_submodule(owner), attr, nn.Parameter(pl.local(p)))
    for m in model.modules():
        if hasattr(m, "tensor_parallel"):
            m.tensor_parallel(rank, size, group)
    return model
