"""The Granite hybrid's norms, plain and gated (``ops/rms_norm.py``).

On the CPU: the plain version is the op sequence the model ran before the
kernels (the mixer's gate, then ``RMSNorm.forward``), bit for bit in
float32, and rounds once in bf16; a torch-op transcription of the kernels'
algebra (the forward's ``rstd`` a row, the backward's recomputed normalised
row, ``dx = rstd (w dy - x̂ mean(w dy x̂))`` and the gate's split through
``silu'``) agrees with autograd and passes ``gradcheck`` in float64; the
wrapper refuses what the kernels do not take.  The kernels themselves run
only on the card (``cuda``-marked cases here; ``chip_smoke.py`` phase 22).
"""

import pytest
import torch
import torch.nn.functional as F

from haplohyped_tpu_torch.models import granite_hybrid as G
from haplohyped_tpu_torch.models import hybrid_layers
from haplohyped_tpu_torch.ops import rms_norm as R
from haplohyped_tpu_torch.tools.granite_step_check import check_granite_step, granite_step
from haplohyped_tpu_torch.tools.rms_norm_check import (
    EPS,
    HIDDEN,
    IN_PROJ,
    MIXER,
    NEMOTRON_GROUP,
    NEMOTRON_HIDDEN,
    NEMOTRON_IN_PROJ,
    NEMOTRON_ROWS,
    ROWS,
    rms_compare,
    rms_inputs,
    rms_run,
)

GATED = [pytest.param(False, id="plain"), pytest.param(True, id="gated")]


def _inputs(shape, gated, dtype=torch.float32, seed=0, gate_from=None):
    return rms_inputs(*shape, gated, dtype, torch.Generator().manual_seed(seed), gate_from)


def _op_sequence(x, weight, eps, gate=None):
    """The Granite hybrid's norms as torch ops before the kernels: the
    mixer's ``y.float() * F.silu(z.float())``, then ``RMSNorm.forward``,
    cast to the compute dtype (``x``'s)."""
    dtype = x.dtype
    if gate is not None:
        x = x.float() * F.silu(gate.float())
    x = x.float()
    return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight).to(dtype)


class KernelAlgebra(torch.autograd.Function):
    """The kernels' algebra in torch ops: the forward keeps ``x``, the gate
    and ``rstd`` a row; the backward recomputes ``u = x silu(g)`` and ``x̂ =
    u rstd`` from them, then ``du = rstd (w dy - x̂ mean(w dy x̂))``, ``dw =
    sum dy x̂`` and, gated, ``dx = du silu(g)``, ``dg = du x sigmoid(g) (1 +
    g (1 - sigmoid(g)))``."""

    @staticmethod
    def forward(ctx, x, weight, gate, eps):
        u = x.to(torch.promote_types(x.dtype, torch.float32))
        if gate is not None:
            g = gate.to(u.dtype)
            u = u * (g * torch.sigmoid(g))
        rstd = torch.rsqrt(u.pow(2).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, weight, gate, rstd)
        return (u * rstd * weight).to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, weight, gate, rstd = ctx.saved_tensors
        xf, dy = x.to(rstd.dtype), dout.to(rstd.dtype)
        if gate is not None:
            g = gate.to(rstd.dtype)
            s = torch.sigmoid(g)
            xh = xf * g * s * rstd
        else:
            xh = xf * rstd
        gy = dy * weight
        du = rstd * (gy - xh * (gy * xh).mean(-1, keepdim=True))
        dw = (dy * xh).reshape(-1, x.shape[-1]).sum(0)
        if gate is None:
            return du.to(x.dtype), dw.to(weight.dtype), None, None
        dx, dg = du * g * s, du * xf * s * (1 + g * (1 - s))
        return dx.to(x.dtype), dw.to(weight.dtype), dg.to(gate.dtype), None


def _algebra(x, weight, eps, gate=None):
    return KernelAlgebra.apply(x, weight, gate, eps)


@pytest.mark.parametrize("gated", GATED)
@pytest.mark.parametrize("fn", [R.rms_norm_plain, R.rms_norm], ids=["plain", "wrapper"])
def test_plain_is_the_op_sequence_bit_for_bit_in_float32(fn, gated):
    """The plain version, and the wrapper on a CPU tensor, give the output
    and every gradient of the model's former op sequence, bit for bit, the
    gate read through a strided view as the mixer's ``z`` is."""
    inp = _inputs((6, 48), gated, seed=1, gate_from=104)
    got, want = rms_run(fn, inp), rms_run(_op_sequence, inp)
    assert set(got) == set(want) == ({"out", "dx", "dw", "dg"} if gated else {"out", "dx", "dw"})
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("gated", GATED)
def test_the_models_norms_on_the_cpu_are_the_op_sequence(gated):
    """``RMSNorm`` on a CPU tensor, plain and with the mixer's gate, in the
    bf16 compute dtype: output and every gradient equal the former ops'."""
    norm = G.RMSNorm(48, EPS)
    with torch.no_grad():
        norm.weight.add_(0.1 * torch.randn(48, generator=torch.Generator().manual_seed(2)))
    inp = _inputs((4, 48), gated, torch.bfloat16, seed=3)
    got = rms_run(lambda x, w, eps, gate: torch.func.functional_call(
        norm, {"weight": w}, (x,), {"gate": gate}), {**inp, "weight": norm.weight})
    want = rms_run(_op_sequence, {**inp, "weight": norm.weight})
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("gated", GATED)
@pytest.mark.parametrize("fn", [R.rms_norm_plain, _algebra], ids=["plain", "algebra"])
def test_gradcheck_in_float64(fn, gated):
    """The plain version's autograd and the kernels' algebra's own backward
    against finite differences, in float64."""
    inp = _inputs((3, 8), gated, torch.float64, seed=4)
    args = [inp["x"].clone().requires_grad_(), inp["weight"].double().requires_grad_()]
    if gated:
        args.append(inp["gate"].clone().requires_grad_())
    assert torch.autograd.gradcheck(lambda x, w, *g: fn(x, w, EPS, *g), tuple(args))


@pytest.mark.parametrize("gated", GATED)
@pytest.mark.parametrize("shape", [(1, 8), (5, 136), (33, 2048)])
def test_the_kernels_algebra_matches_autograd_in_float32(shape, gated):
    """The torch-op transcription of the kernels' algebra against the plain
    version's autograd in float32: output and every gradient within 1e-5 of
    the plain version's norm (only the order of sums differs)."""
    inp = _inputs(shape, gated, seed=shape[1])
    got, want = rms_run(_algebra, inp), rms_run(R.rms_norm_plain, inp)
    for k in want:
        assert float((got[k] - want[k]).norm()) <= 1e-5 * float(want[k].norm()), k


@pytest.mark.parametrize("gated", GATED)
@pytest.mark.parametrize("fn", [R.rms_norm_plain, R.rms_norm], ids=["plain", "wrapper"])
def test_bf16_rounds_once(fn, gated):
    """On bf16 CPU inputs the bf16 results (the output, ``dx`` and ``dg``)
    are the float32 results on the same values rounded once, and ``dw`` is
    the float32 one."""
    inp = _inputs((5, 64), gated, torch.bfloat16, seed=6)
    got = rms_run(fn, inp)
    want = rms_run(R.rms_norm_plain, {k: v.float() for k, v in inp.items()})
    for k in want:
        dtype = torch.float32 if k == "dw" else torch.bfloat16
        assert got[k].dtype == dtype, k
        assert torch.equal(got[k], want[k].to(dtype)), k


def test_a_cpu_call_runs_the_plain_version_and_builds_nothing(monkeypatch):
    """The module imports and runs without a card: a CPU tensor never
    reaches the autograd function or the kernels' library."""
    def refuse(*a, **k):
        raise AssertionError("the kernels' path on a CPU tensor")

    monkeypatch.setattr(R.RmsNorm, "apply", refuse)
    monkeypatch.setattr(R, "_library", refuse)
    counters = ("launches", "forward_calls", "gated_calls", "backward_calls")
    before = [getattr(R.rms_norm, c) for c in counters]
    for gated in (False, True):
        assert rms_run(R.rms_norm, _inputs((2, 16), gated))["out"].shape == (2, 16)
    assert [getattr(R.rms_norm, c) for c in counters] == before


def test_the_mixers_tensors_pass_as_rows():
    """The mixer's ``y`` reshaped from the scan's ``(n, T, H, P)`` and its
    gate ``z``, the first columns of ``in_proj``'s output, reach the kernels
    as rows one stride apart: ``z`` in place, at ``in_proj``'s row stride."""
    n, T = 2, 5
    proj = torch.zeros(n, T, IN_PROJ, dtype=torch.bfloat16)
    z = proj.split([MIXER, IN_PROJ - MIXER], dim=-1)[0]
    y = torch.zeros(n, T, 64, 64, dtype=torch.bfloat16).reshape(n, T, MIXER)
    assert R._rows(z, "z") == (n * T, IN_PROJ)
    assert R._rows(y, "y") == (n * T, MIXER)
    with pytest.raises(ValueError, match="CUDA tensor"):  # every check before the device's
        R._check_inputs(y, torch.ones(MIXER), z)


@pytest.mark.parametrize("length", [64, 50], ids=["whole_chunks", "padded"])
def test_the_models_norms_get_rows_the_kernels_take(monkeypatch, length):
    """Every norm of a bf16 model's step, at a length of whole scan chunks
    and at one the scan pads and cuts back, gets an ``x`` and a gate that
    pass every check of the kernels' path before the device's."""
    calls = []

    def record(x, weight, eps, gate=None, group=None):
        calls.append(gate is not None)
        with pytest.raises(ValueError, match="CUDA tensor"):
            R._check_inputs(x, weight, gate, group)
        return R.rms_norm(x, weight, eps, gate, group)

    monkeypatch.setattr(hybrid_layers, "rms_norm", record)
    cfg = G.GraniteHybridConfig(
        hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
        mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=32,
        vocab_size=512, loss_chunk=48)
    model = G.GraniteHybrid(cfg, 0, device="cpu")
    h1, h2 = (torch.randint(0, 5, (1, length), generator=torch.Generator().manual_seed(k),
                            dtype=torch.int8) for k in (1, 2))
    model.loss(h1, h2)[0].backward()
    mixers = cfg.layer_types.count("mamba")
    assert len(calls) == 2 * len(cfg.layer_types) + 1 + mixers and sum(calls) == mixers


@pytest.mark.parametrize("group", [16, 48], ids=["groups_of_16", "one_group"])
def test_the_grouped_norm_is_the_norm_of_each_group(group):
    """A gated norm over groups of ``group`` columns is, group by group,
    the plain gated norm of the group's columns with its part of the
    weight: output and every gradient in float64; a group as wide as the
    row is the ungrouped norm, bit for bit."""
    inp = _inputs((5, 48), True, torch.float64, seed=4, gate_from=80)
    got = rms_run(R.rms_norm, inp, group=group)
    parts = []
    for a in range(0, 48, group):
        cols = slice(a, a + group)
        parts.append(rms_run(R.rms_norm_plain, {k: (v[cols] if k == "weight" else v[:, cols])
                                                 for k, v in inp.items()}))
    want = {k: torch.cat([p[k] for p in parts], 0 if k == "dw" else 1) for k in parts[0]}
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-14)
    if group == 48:
        plain = rms_run(R.rms_norm, inp)
        for k in plain:
            assert torch.equal(got[k], plain[k]), k


def test_gradcheck_grouped_in_float64():
    inp = _inputs((3, 32), True, torch.float64, seed=6)
    args = [inp[k].detach().double().requires_grad_() for k in ("x", "weight", "gate")]
    assert torch.autograd.gradcheck(lambda x, w, g: R.rms_norm_plain(x, w, EPS, g, 8), args)


def test_the_nemotron_widths_pass_every_check_before_the_devices():
    """The Nemotron-H cell's plain rows of 2,688 and its mixer's gated rows
    of 4,096 in groups of 512, the gate a view of ``in_proj``'s output,
    reach the device check."""
    g = torch.Generator().manual_seed(0)
    plain = rms_inputs(4, NEMOTRON_HIDDEN, False, torch.bfloat16, g)
    gated = rms_inputs(4, MIXER, True, torch.bfloat16, g, NEMOTRON_IN_PROJ)
    with pytest.raises(ValueError, match="CUDA tensor"):
        R._check_inputs(plain["x"], plain["weight"], None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        R._check_inputs(gated["x"], gated["weight"], gated["gate"], NEMOTRON_GROUP)


@pytest.mark.parametrize("group, gated, match", [
    (500, True, "groups of a multiple of 256"), (768, True, "groups of a multiple of 256"),
    (512, False, "only with a gate")], ids=["not_whole_warps", "not_dividing", "no_gate"])
def test_the_kernels_path_refuses_a_group_it_does_not_take(group, gated, match):
    x = torch.zeros(4, MIXER, dtype=torch.bfloat16)
    gate = torch.zeros_like(x) if gated else None
    with pytest.raises(ValueError, match=match):
        R._check_inputs(x, torch.ones(MIXER), gate, group)


CASES = {
    "float16": "bf16 or float32",
    "scalar": "bf16 or float32",
    "width_not_a_multiple_of_8": "multiple of 8",
    "too_wide": "multiple of 8",
    "transposed": "contiguous rows",
    "rows_not_one_stride_apart": "one stride apart",
    "row_stride_off_16_bytes": "16-byte boundary",
    "start_off_16_bytes": "16-byte boundary",
    "gate_shape": "gate must match",
    "gate_dtype": "gate must match",
    "weight_float64": "contiguous float32",
    "weight_short": "contiguous float32",
    "cpu": "CUDA tensor",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_kernels_path_refuses_what_it_does_not_take(case):
    """What the kernels do not take raises before any launch, each for its
    own reason (the device is checked last, so a CPU tensor reaches the
    checks a card's does)."""
    x = torch.zeros(4, 16, dtype=torch.bfloat16)
    w, gate = torch.ones(16), None
    if case == "float16":
        x = x.half()
    elif case == "scalar":
        x = torch.zeros((), dtype=torch.bfloat16)
    elif case == "width_not_a_multiple_of_8":
        x, w = torch.zeros(4, 12, dtype=torch.bfloat16), torch.ones(12)
    elif case == "too_wide":
        x, w = torch.zeros(2, 4104, dtype=torch.float32), torch.ones(4104)
    elif case == "transposed":
        x = torch.zeros(16, 16, dtype=torch.bfloat16).t()
    elif case == "rows_not_one_stride_apart":
        x = torch.zeros(3, 4, 24, dtype=torch.bfloat16)[:, :2, :16]
    elif case == "row_stride_off_16_bytes":
        x = torch.zeros(4, 20, dtype=torch.bfloat16)[:, :16]
    elif case == "start_off_16_bytes":
        x = torch.zeros(4 * 16 + 1, dtype=torch.bfloat16)[1:].view(4, 16)
    elif case == "gate_shape":
        gate = torch.zeros(4, 8, dtype=torch.bfloat16)
    elif case == "gate_dtype":
        gate = torch.zeros(4, 16, dtype=torch.float32)
    elif case == "weight_float64":
        w = w.double()
    elif case == "weight_short":
        w = w[:8]
    with pytest.raises(ValueError, match=CASES[case]):
        R._check_inputs(x, w, gate)


# -- on the card ---------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape, gated, gate_from", [
    ((ROWS, HIDDEN), False, None), ((ROWS, MIXER), True, IN_PROJ),
    ((1, 8), False, None), ((3, 8), True, 24), ((7, 136), True, None), ((5, 1032), False, None),
    ((9, 4096), False, None)], ids=["cell_plain", "cell_gated", "1x8", "3x8_gated",
                                    "7x136_gated", "5x1032", "9x4096"])
def test_kernels_match_the_plain_version_on_card(shape, gated, gate_from, dtype):
    """``chip_smoke.py`` phase 22's comparison at the cell's two norms (the
    gate a strided view of an ``in_proj``-wide tensor) and at rows of one
    vector, of ragged vectors and of every vector count; one forward launch
    and two backward launches a call."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    inp = rms_inputs(*shape, gated, dtype, gen, gate_from)
    before = (R.rms_norm.launches, R.rms_norm.forward_calls, R.rms_norm.backward_calls)
    rms_compare(inp, f"{shape} gated={gated} {dtype}")
    assert (R.rms_norm.launches - before[0], R.rms_norm.forward_calls - before[1],
            R.rms_norm.backward_calls - before[2]) == (6, 2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape, gated, gate_from, group", [
    ((NEMOTRON_ROWS, NEMOTRON_HIDDEN), False, None, None),
    ((NEMOTRON_ROWS, MIXER), True, NEMOTRON_IN_PROJ, NEMOTRON_GROUP),
    ((3, 1024), True, None, 256), ((5, 4096), True, 4104, 2048), ((7, 2688), True, None, None)],
    ids=["nemotron_plain", "nemotron_grouped", "3x1024_by_256", "5x4096_by_2048", "7x2688_gated"])
def test_grouped_and_ragged_kernels_match_the_plain_version_on_card(shape, gated, gate_from,
                                                                     group, dtype):
    """``chip_smoke.py`` phase 23's comparison at the Nemotron-H cell's
    norms: its hidden rows of 2,688 (21 vectors of 128 threads' 8 and a
    ragged last) and its mixer's gated rows of 4,096 in 8 groups of 512;
    and groups at other widths."""
    _need_card()
    if group is not None and dtype == torch.float32 and group % 128:
        pytest.skip("float32 groups are whole warps at 128 columns")
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    inp = rms_inputs(*shape, gated, dtype, gen, gate_from)
    rms_compare(inp, f"{shape} gated={gated} group={group} {dtype}", group)


@pytest.mark.cuda
def test_an_output_gradient_off_a_16_byte_boundary_is_copied_on_card():
    """A ``dout`` that starts 2 bytes past a 16-byte boundary gives the
    gradients of an aligned copy, bit for bit, where the kernels' 16-byte
    loads of it would fault."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    inp = rms_inputs(6, 64, True, torch.bfloat16, gen)
    store = torch.empty(inp["dout"].numel() + 1, dtype=torch.bfloat16, device="cuda")
    offset = store[1:].view_as(inp["dout"])
    offset.copy_(inp["dout"])
    assert offset.data_ptr() % 16
    got, want = rms_run(R.rms_norm, {**inp, "dout": offset}), rms_run(R.rms_norm, inp)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_a_double_backward_raises_on_card():
    """The kernels' gradients cannot be differentiated again: a second
    backward through them raises, where it would give zeros."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    inp = rms_inputs(4, 64, True, torch.float32, gen)
    x = inp["x"].requires_grad_()
    out = R.rms_norm(x, inp["weight"], EPS, inp["gate"])
    (dx,) = torch.autograd.grad(out, x, inp["dout"], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dx.sum(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [8192, 1000], ids=["cell", "padded"])
def test_a_granite_step_reaches_the_kernels_and_no_norm_ops_on_card(length):
    """One bf16 forward and backward of ``GraniteHybrid(GraniteHybridConfig())``
    on one window pair, the counters reset just before it
    (``chip_smoke.py`` phases 21 and 22's step): 30 forward norm calls (the
    9 mixers' gated), 30 backward calls and 90 launches, 9 and 9 scan calls
    and 72 launches, and no ``pow`` or ``rsqrt`` op dispatched; at the
    cell's 8,192 bp and at 1,000, which the scan pads to its chunk and cuts
    back, so the mixer's ``y`` reaches the norm from a cut tensor."""
    _need_card()
    step = granite_step(1, length)
    check_granite_step(step)
    assert (step["rms_norm"]["forward_calls"], step["rms_norm"]["gated_calls"],
            step["rms_norm"]["backward_calls"], step["rms_norm"]["launches"]) == (30, 9, 30, 90)
    assert step["ssd_scan"]["launches"] == 72
