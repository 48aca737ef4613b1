"""Enformer's conv-block batch norm and GELU (``ops/batchnorm_gelu.py``).

On the CPU: the plain version is the op sequence the conv blocks ran before
the kernels (``F.batch_norm`` then the GELU), bit for bit in float32, and
rounds once in bf16; a torch-op transcription of the kernels' algebra (the
forward's coefficients, the backward's recomputed GELU derivative and two
per-channel sums) agrees with the plain version and passes ``gradcheck`` in
float64.  The kernels themselves run only on the card (``cuda``-marked
cases here; ``chip_smoke.py`` phase 20 at the published model's shapes).
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from haplohyped_tpu_torch.models import enformer as E
from haplohyped_tpu_torch.ops import batchnorm_gelu as B
from haplohyped_tpu_torch.tools.batchnorm_gelu_check import (
    BN_EPS,
    BN_MOMENTUM,
    bf16_steps_apart,
    bn_compare,
    bn_run,
)

MODES = [pytest.param(True, id="train"), pytest.param(False, id="eval")]


def _inputs(shape, dtype=torch.float32, seed=0, wide=torch.float32):
    """x off zero mean and unit variance per channel, dz, and parameters
    and moving statistics (in ``wide``) off their initial values."""
    g = torch.Generator().manual_seed(seed)
    N, C, L = shape

    def rnd(*s):
        return torch.randn(s, generator=g, dtype=torch.float64)

    x = rnd(N, C, L) * (1 + rnd(C, 1).abs()) + rnd(C, 1)
    return {"x": x.to(dtype), "dz": rnd(N, C, L).to(dtype),
            "scale": (1 + 0.1 * rnd(C)).to(wide), "bias": (0.1 * rnd(C)).to(wide),
            "mean": (0.1 * rnd(C)).to(wide), "var": (1 + 0.1 * rnd(C).abs()).to(wide)}


def _op_sequence(x, scale, bias, mean, var, training, momentum, eps):
    """The conv block's batch norm and GELU as torch ops."""
    y = F.batch_norm(x, mean, var, scale, bias, training, momentum, eps)
    return torch.sigmoid(1.702 * y) * y


class KernelAlgebra(torch.autograd.Function):
    """The kernels' algebra in torch ops: the forward's per-channel
    coefficients ``(a, b, mean, invstd)``, ``u = a x + b`` and the GELU; the
    backward's ``u`` and GELU derivative recomputed from ``x``, the sums of
    ``dy`` and ``dy x̂`` a channel, then ``dx``."""

    @staticmethod
    def forward(ctx, x, scale, bias, moving_mean, moving_variance, training, momentum, eps):
        ct = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(ct)
        if training:
            m = xf.numel() // xf.shape[1]
            mean, var = xf.mean((0, 2)), xf.var((0, 2), unbiased=False)
            moving_mean.copy_(momentum * mean + (1 - momentum) * moving_mean)
            moving_variance.copy_(momentum * var * m / (m - 1)
                                  + (1 - momentum) * moving_variance)
        else:
            mean, var = moving_mean.to(ct), moving_variance.to(ct)
        invstd = 1 / torch.sqrt(var + eps)
        a = scale.to(ct) * invstd
        b = bias.to(ct) - mean * a
        ctx.save_for_backward(x, torch.stack([a, b, mean, invstd], 1))
        ctx.training = training
        return B.gelu(xf * a[:, None] + b[:, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dz):
        x, coef = ctx.saved_tensors
        xf, dzf = x.to(coef.dtype), dz.to(coef.dtype)
        a, b, mean, invstd = (coef[:, i, None] for i in range(4))
        u = xf * a + b
        s = torch.sigmoid(B.GELU_K * u)
        dy = dzf * (s + B.GELU_K * u * s * (1 - s))
        xh = (xf - mean) * invstd
        dbias, dscale = dy.sum((0, 2)), (dy * xh).sum((0, 2))
        if ctx.training:
            m = xf.numel() // xf.shape[1]
            dy = dy - dbias[:, None] / m - xh * dscale[:, None] / m
        return (a * dy).to(x.dtype), dscale, dbias, None, None, None, None, None


@pytest.mark.parametrize("training", MODES)
@pytest.mark.parametrize("fn", [B.batchnorm_gelu_plain, B.batchnorm_gelu],
                         ids=["plain", "wrapper"])
def test_plain_is_the_op_sequence_bit_for_bit_in_float32(fn, training):
    """The plain version, and the wrapper on a CPU tensor, give the output,
    the three gradients and both moving averages of ``F.batch_norm`` then
    the GELU, bit for bit."""
    inp = _inputs((3, 5, 40))
    got, want = bn_run(fn, inp, training), bn_run(_op_sequence, inp, training)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["mean"], inp["mean"]) != training  # updated in training only


@pytest.mark.parametrize("training", MODES)
def test_conv_block_on_the_cpu_is_the_op_sequence(training):
    """A ``ConvBlock`` on a CPU tensor: its output and every gradient equal
    the conv over ``F.batch_norm`` and the GELU, bit for bit in float32."""
    cfg = E.EnformerConfig(channels=64, divisible_by=16, sequence_length=8192,
                           target_length=32, dtype="float32")
    block = E.ConvBlock(6, 8, 5, cfg, torch.Generator().manual_seed(3))
    with torch.no_grad():
        block.norm.scale.add_(0.1)
        block.norm.bias.add_(0.2)
    block.train(training)
    twin = E.ConvBlock(6, 8, 5, cfg, torch.Generator().manual_seed(3))
    twin.load_state_dict(block.state_dict())
    twin.train(training)
    n = twin.norm
    x = _inputs((2, 6, 48))["x"]
    out = block(x)
    want = twin.conv(_op_sequence(x, n.scale, n.bias, n.moving_mean, n.moving_variance,
                            n.training, 1 - n.decay, n.eps))
    assert torch.equal(out, want)
    out.sum().backward()
    want.sum().backward()
    for (k, p), q in zip(block.named_parameters(), twin.parameters()):
        assert torch.equal(p.grad, q.grad), k
    for (k, b), c in zip(block.named_buffers(), twin.buffers()):
        assert torch.equal(b, c), k


@pytest.mark.parametrize("training", MODES)
@pytest.mark.parametrize("fn", [B.batchnorm_gelu_plain, KernelAlgebra.apply],
                         ids=["plain", "function"])
def test_gradcheck_in_float64(fn, training):
    """The plain version's autograd and the kernels' algebra's own backward
    against finite differences, in float64."""
    inp = _inputs((2, 3, 7), torch.float64, wide=torch.float64)
    mean, var = inp["mean"], inp["var"]

    def f(x, scale, bias):
        return fn(x, scale, bias, mean.clone(), var.clone(), training, BN_MOMENTUM, BN_EPS)

    args = tuple(inp[k].clone().requires_grad_() for k in ("x", "scale", "bias"))
    assert torch.autograd.gradcheck(f, args)


@pytest.mark.parametrize("training", MODES)
@pytest.mark.parametrize("shape", [(1, 4, 64), (3, 5, 40), (2, 16, 1000)])
def test_the_kernels_algebra_matches_the_plain_version_in_float32(shape, training):
    """The torch-op transcription of the kernels' algebra against the plain
    version in float32: output, gradients and moving averages within 1e-5 of
    the plain version's norm (only the order of sums differs)."""
    inp = _inputs(shape, seed=shape[2])
    got, want = bn_run(KernelAlgebra.apply, inp, training), bn_run(B.batchnorm_gelu_plain, inp,
                                                               training)
    for k in want:
        assert float((got[k] - want[k]).norm()) <= 1e-5 * float(want[k].norm()), k


@pytest.mark.parametrize("training", MODES)
@pytest.mark.parametrize("fn", [B.batchnorm_gelu_plain, B.batchnorm_gelu],
                         ids=["plain", "wrapper"])
def test_bf16_rounds_once(fn, training):
    """On bf16 CPU inputs each bf16 output (the result and ``dx``) lies
    within one bf16 step of the float32 result on the same values, and the
    float32 gradients and moving averages equal it."""
    inp = _inputs((2, 6, 256), torch.bfloat16, seed=5)
    got = bn_run(fn, inp, training)
    want = bn_run(B.batchnorm_gelu_plain, {**inp, "x": inp["x"].float(), "dz": inp["dz"].float()},
                training)
    for k in ("z", "dx"):
        assert got[k].dtype == torch.bfloat16
        assert not bool(bf16_steps_apart(got[k], want[k], torch.zeros_like(want[k])).any()), k
    for k in ("dscale", "dbias", "mean", "var"):
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


def test_a_cpu_call_runs_the_plain_version_and_builds_nothing(monkeypatch):
    """The module imports and runs without a card: a CPU tensor never
    reaches the autograd function or the kernels' library."""
    def refuse(*a, **k):
        raise AssertionError("the kernels' path on a CPU tensor")

    monkeypatch.setattr(B.BatchNormGelu, "apply", refuse)
    monkeypatch.setattr(B, "_library", refuse)
    before = (B.batchnorm_gelu.launches, B.batchnorm_gelu.forward_calls,
              B.batchnorm_gelu.backward_calls)
    got = bn_run(B.batchnorm_gelu, _inputs((2, 3, 16)), True)
    assert got["z"].shape == (2, 3, 16)
    assert (B.batchnorm_gelu.launches, B.batchnorm_gelu.forward_calls,
            B.batchnorm_gelu.backward_calls) == before


@pytest.mark.parametrize("case", ["cpu", "strided", "float16", "two_dims", "float64_params",
                                  "short_params"])
def test_the_kernels_path_refuses_what_it_does_not_take(case):
    """What the kernels do not take raises before any launch, each for its
    own reason (the device is checked last, so a CPU tensor reaches the
    checks a card's does)."""
    inp = _inputs((2, 4, 32))
    x, params = inp["x"], [inp[k] for k in ("scale", "bias", "mean", "var")]
    reason = {"cpu": "CUDA tensor", "strided": "contiguous x", "float16": "bf16 or float32",
              "two_dims": "bf16 or float32", "float64_params": "parameters",
              "short_params": "parameters"}[case]
    if case == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "float16":
        x = x.half()
    elif case == "two_dims":
        x = x[0]
    elif case == "float64_params":
        params[0] = params[0].double()
    elif case == "short_params":
        params[1] = params[1][:3]
    with pytest.raises(ValueError, match=reason):
        B._parts(x, params)


# -- on the card ---------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("training", MODES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1, 3, 8), (4, 5, 896), (2, 3, 8192 + 64), (3, 2, 40000)])
def test_kernels_match_the_plain_version_on_card(shape, dtype, training):
    """``chip_smoke.py`` phase 20's comparison at rows shorter than a
    block's chunk, at one chunk and a part, and at several chunks."""
    _need_card()
    inp = {k: v.cuda() for k, v in _inputs(shape, dtype, seed=sum(shape)).items()}
    bn_compare(inp, training, f"{shape} {dtype}")


@pytest.mark.cuda
def test_an_output_gradient_off_a_16_byte_boundary_is_copied_on_card():
    """A ``dz`` that is contiguous but starts 2 bytes past a 16-byte boundary
    gives the gradients of an aligned copy, bit for bit, where the kernels'
    16-byte loads of it would fault."""
    _need_card()
    inp = {k: v.cuda() for k, v in _inputs((2, 3, 64), torch.bfloat16, seed=9).items()}
    store = torch.empty(inp["dz"].numel() + 1, dtype=torch.bfloat16, device="cuda")
    offset = store[1:].view_as(inp["dz"])
    offset.copy_(inp["dz"])
    assert offset.is_contiguous() and offset.data_ptr() % 16
    got, want = bn_run(B.batchnorm_gelu, {**inp, "dz": offset}, True), bn_run(B.batchnorm_gelu,
                                                                              inp, True)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_a_double_backward_raises_on_card():
    """The kernels' gradients cannot be differentiated again: a second
    backward through them raises, where it would give zeros."""
    _need_card()
    inp = {k: v.cuda() for k, v in _inputs((2, 3, 64), torch.float32, seed=4).items()}
    x = inp["x"].requires_grad_()
    z = B.batchnorm_gelu(x, inp["scale"], inp["bias"], inp["mean"], inp["var"], True,
                         BN_MOMENTUM, BN_EPS)
    (dx,) = torch.autograd.grad(z, x, inp["dz"], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dx.sum(), x)


@pytest.mark.cuda
def test_conv_blocks_dispatch_no_batch_norm_or_sigmoid_on_card():
    """On the card a bf16 Enformer forward and backward reach the conv
    blocks' kernels once each a block and dispatch no ``batch_norm`` and
    only the head's one ``sigmoid``."""
    _need_card()
    cfg = E.EnformerConfig(channels=64, num_transformer_layers=1, num_heads=2, key_size=8,
                           value_size=32, num_relative_position_features=12, divisible_by=16,
                           sequence_length=8192, target_length=32, heads={"human": 7})
    model = E.Enformer(cfg, seed=1, device="cuda")
    h = torch.randint(0, 5, (2, 8192), dtype=torch.int8, device="cuda")
    seen = []

    class Names(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    calls = (B.batchnorm_gelu.forward_calls, B.batchnorm_gelu.backward_calls)
    with Names():
        model(h, h)["rates"].sum().backward()
    blocks = 2 + 2 * cfg.tower_stages
    assert (B.batchnorm_gelu.forward_calls - calls[0],
            B.batchnorm_gelu.backward_calls - calls[1]) == (blocks, blocks)
    assert not any("batch_norm" in n for n in seen)
    assert seen.count("sigmoid") == 1
