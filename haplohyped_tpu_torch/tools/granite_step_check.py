"""One training step of the Granite hybrid on the card, with what it
dispatches and what its scan and norm kernels count.

``chip_smoke.py`` phases 21 and 22 and the ``cuda``-marked tests of the
scan and the norms run :func:`granite_step` on the main path,
``GraniteHybrid(GraniteHybridConfig())``, and hold it to
:func:`check_granite_step`.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from haplohyped_tpu_torch.models.granite_hybrid import GraniteHybrid, GraniteHybridConfig
from haplohyped_tpu_torch.ops.rms_norm import rms_norm
from haplohyped_tpu_torch.ops.ssd_scan import ssd_scan

#: bases a sequence in the Granite hybrid cell's step (one window pair)
GRANITE_L = 8192
#: the counters each kernel's wrapper keeps
SSD_COUNTERS = ("launches", "forward_calls", "backward_calls")
RMS_COUNTERS = ("launches", "forward_calls", "gated_calls", "backward_calls")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def granite_step(seed: int, length: int = GRANITE_L) -> dict:
    """One bf16 forward and backward of ``GraniteHybrid(GraniteHybridConfig())``
    on one window pair of ``length`` bases, the scan's and the norms'
    counters reset to 0 just before it.  Returns those counters, the loss,
    the largest op output's elements, each op's dispatch count and what the
    step should read."""
    cfg = GraniteHybridConfig()
    model = GraniteHybrid(cfg, seed, device="cuda").train()
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    h1, h2 = (torch.randint(0, 5, (1, length), generator=gen,
                            device="cuda").to(torch.int8) for _ in range(2))
    ops: dict = {}
    largest = [0]

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            ops[name] = ops.get(name, 0) + 1
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    largest[0] = max(largest[0], t.numel())
            return out

    for c in SSD_COUNTERS:
        setattr(ssd_scan, c, 0)
    for c in RMS_COUNTERS:
        setattr(rms_norm, c, 0)
    with Ops():
        loss = model.loss(h1, h2)[0]
        loss.backward()
    torch.cuda.synchronize()
    mixers = cfg.layer_types.count("mamba")
    out = {"length": length, "mixers": mixers,
           # each layer's two norms, the final norm and each mixer's gated norm
           "norms": 2 * len(cfg.layer_types) + 1 + mixers,
           "ssd_scan": {c: getattr(ssd_scan, c) for c in SSD_COUNTERS},
           "rms_norm": {c: getattr(rms_norm, c) for c in RMS_COUNTERS},
           "loss": loss.item(), "largest_numel": largest[0],
           "logits_numel": 2 * (length - 1) * cfg.vocab_size, "ops": ops}
    del model, loss
    torch.cuda.empty_cache()
    return out


def check_granite_step(step: dict) -> None:
    """Raise unless :func:`granite_step`'s reading is the main path's: each
    mixer calls the scan once forward and once backward (3 + 5 launches),
    each norm the norms' kernels once forward and once backward (1 + 2
    launches, the mixers' norms gated), no ``pow`` or ``rsqrt`` op is
    dispatched, and the loss is finite."""
    mixers, norms = step["mixers"], step["norms"]
    ssd, rms = step["ssd_scan"], step["rms_norm"]
    _check(ssd["forward_calls"] == ssd["backward_calls"] == mixers,
           f"{ssd['forward_calls']} forward and {ssd['backward_calls']} backward scan calls "
           f"for {mixers} Mamba-2 mixers")
    _check(ssd["launches"] == 8 * mixers, f"{ssd['launches']} scan launches for {mixers} mixers")
    _check(rms["forward_calls"] == rms["backward_calls"] == norms,
           f"{rms['forward_calls']} forward and {rms['backward_calls']} backward norm calls "
           f"for {norms} norms")
    _check(rms["gated_calls"] == mixers, f"{rms['gated_calls']} gated calls for {mixers} mixers")
    _check(rms["launches"] == 3 * norms, f"{rms['launches']} norm launches for {norms} norms")
    pows, rsqrts = step["ops"].get("pow", 0), step["ops"].get("rsqrt", 0)
    _check(pows == rsqrts == 0, f"{pows} pow and {rsqrts} rsqrt ops dispatched")
    _check(math.isfinite(step["loss"]), f"loss {step['loss']}")
