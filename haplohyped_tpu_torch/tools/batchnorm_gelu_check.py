"""The comparison that holds Enformer's conv-block kernels
(``ops/batchnorm_gelu.py``) to their plain version on the card.

``chip_smoke.py`` phase 20 runs :func:`bn_compare` at the published model's
block shapes, and the ``cuda``-marked tests at small ones; the CPU tests use
:func:`bn_run` and :func:`bf16_steps_apart` on the plain version.
"""

from __future__ import annotations

import torch

from haplohyped_tpu_torch.ops.batchnorm_gelu import batchnorm_gelu, batchnorm_gelu_plain

#: the moving averages' momentum and the variance's epsilon of the comparisons
BN_MOMENTUM, BN_EPS = 0.1, 1e-5


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bn_run(fn, inp: dict, training: bool, wide=None) -> dict:
    """``fn`` forward and backward on copies of ``inp`` (widened to ``wide``
    if given): the output, the three gradients and the moving statistics."""
    cast = (lambda t: t.to(wide)) if wide is not None else (lambda t: t)
    x = cast(inp["x"]).detach().requires_grad_()
    scale, bias = (cast(inp[k]).detach().requires_grad_() for k in ("scale", "bias"))
    mean, var = cast(inp["mean"]).clone(), cast(inp["var"]).clone()
    z = fn(x, scale, bias, mean, var, training, BN_MOMENTUM, BN_EPS)
    dx, dscale, dbias = torch.autograd.grad(z, (x, scale, bias), cast(inp["dz"]))
    return {"z": z.detach(), "dx": dx, "dscale": dscale, "dbias": dbias, "mean": mean,
            "var": var}


def u_terms(inp: dict, training: bool) -> torch.Tensor:
    """``|a x| + |b| + |scale|`` of every element of ``inp``, in float32: the
    two terms summed into the normalised value ``u = a x + b`` (``a = scale /
    sqrt(var + eps)``, ``b = bias - mean a``, from the batch's statistics in
    training and the moving ones in eval) and ``u``'s size at one standard
    deviation, which the statistics' own float32 round-off scales."""
    x = inp["x"].float()
    if training:
        mean, var = x.mean((0, 2)), x.var((0, 2), unbiased=False)
    else:
        mean, var = inp["mean"].float(), inp["var"].float()
    scale = inp["scale"].float()
    a = scale / torch.sqrt(var + BN_EPS)
    b = inp["bias"].float() - mean * a
    return (a[:, None] * x).abs() + (b.abs() + scale.abs())[:, None]


def bf16_steps_apart(a: torch.Tensor, b: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """Where ``a`` and ``b`` differ by more than one bf16 step (``2^(e - 7)``
    for a value in ``[2^e, 2^(e + 1))``) at the largest of ``|a|``, ``|b|``
    and ``2^-12 terms``.  The last is float32's floor near ``u = 0``: each
    side's ``u`` carries float32 round-off of a few ``2^-24`` of its terms
    and of its statistics, and the GELU's slope is at most 1.13, so there
    two correct float32 results may lie more than a step of the output
    itself apart."""
    a, b = a.float(), b.float()
    top = torch.maximum(torch.maximum(a.abs(), b.abs()), 2.0**-12 * terms)
    step = torch.exp2(torch.floor(torch.log2(top.clamp(min=2.0**-126))) - 7)
    return (a - b).abs() > step


def bn_compare(inp: dict, training: bool, what: str) -> dict:
    """:func:`batchnorm_gelu` on the card's tensors ``inp`` (the kernels)
    against the plain version: a bf16 output equal to the plain version's
    or one bf16 step apart, at most 1% of outputs apart; a float32 one
    within 1e-5 of the float64 plain version's norm; ``dx`` (against the
    float64 plain version's rounded to the input's dtype), the scale's and
    bias's gradients and both moving averages within 1e-3 of the float64
    plain version's norm; two runs bit-equal.  Raises on a failed check;
    returns the worst gaps."""
    _check(inp["x"].is_cuda, f"{what}: the kernels' comparison needs the card's tensors")
    got = bn_run(batchnorm_gelu, inp, training)
    again = bn_run(batchnorm_gelu, inp, training)
    torch.cuda.synchronize()  # a fault in a kernel surfaces here
    for k in got:
        _check(torch.equal(got[k], again[k]), f"{what}: two runs give different {k}")
    plain = bn_run(batchnorm_gelu_plain, inp, training)
    exact = bn_run(batchnorm_gelu_plain, inp, training, wide=torch.float64)
    if got["z"].dtype == torch.bfloat16:
        share = float((got["z"] != plain["z"]).float().mean())
        terms = u_terms(inp, training)
        far = bf16_steps_apart(got["z"], plain["z"], terms)
        _check(not bool(far.any()),
               f"{what}: {int(far.sum())} outputs more than one bf16 step from the plain "
               f"version's: kernel {got['z'][far][:4].tolist()}, plain "
               f"{plain['z'][far][:4].tolist()}, terms {terms[far][:4].tolist()}")
        _check(share <= 0.01, f"{what}: {share:.4%} of outputs differ from the plain version's")
        gaps = {"z_apart_share": share}
    else:  # float32: one rounding of float32 round-off
        gap = float((got["z"].double() - exact["z"]).norm() / exact["z"].norm())
        _check(gap <= 1e-5, f"{what}: z is {gap:.3g} of the float64 plain version's norm off")
        gaps = {"z_f32": gap}
    for k in ("dx", "dscale", "dbias", "mean", "var"):
        want = exact[k].to(got[k].dtype).double() if k == "dx" else exact[k]
        gap = float((got[k].double() - want).norm() / exact[k].norm())
        gaps[k] = gap
        _check(gap <= 1e-3, f"{what}: {k} is {gap:.3g} of the float64 plain version's norm off")
    return gaps
