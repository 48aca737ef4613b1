"""The window-kernel lab of the PyTorch port against the JAX package's lab.

The JAX lab (``tools/window_kernel_lab.py``) is loaded from its file, and its
Pallas kernel runs in interpret mode (``pallas_call`` wrapped with
``interpret=True``).  Integer outputs, so every tolerance is 0:

- ``full`` and ``dma_only`` (plain versions, ``dma_only`` at the JAX lab's
  grid stride 1024) are bit-equal to the JAX lab's ``(True, True)`` and
  ``(True, False)`` variants;
- ``compute_only`` equals both packages' baseline encode on the
  materialised synthetic state (the JAX variant's output is undefined);
- ``dma_only``'s sink, the port's own output, equals a loop over numpy;
- the fixture and the chained starts equal the JAX lab's;
- pure-torch twins of the kernel's own arithmetic (the synthetic bucket
  table of ``compute_only``, ``dma_only``'s ``lo0`` from the count below the
  start) equal what the plain versions compute another way.

The Hopper kernel is held against the plain versions on the card only
(``cuda``-marked tests; ``chip_smoke.py`` phase 11 at full size).
"""

import functools
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas

from haplohyped_tpu.ops.haplotype_window import encode_haplotype_windows as jax_encode
from haplohyped_tpu.ops.pallas_window import build_pallas_window_index
from haplohyped_tpu_torch.core.constants import INT32_MAX
from haplohyped_tpu_torch.ops import _build
from haplohyped_tpu_torch.ops.haplotype_window import encode_haplotype_windows
from haplohyped_tpu_torch.ops.window_kernel import (
    BK,
    bucket_table,
    build_window_index,
    window_bounds,
)
from haplohyped_tpu_torch.ops.window_lab import (
    SP,
    SYNTH_STRIDE,
    VARIANTS,
    WINDOWS_PER_BLOCK,
    encode_windows_lab,
    grid_lo0,
    lab_plain,
    synthetic_state,
)
from haplohyped_tpu_torch.tools import window_kernel_lab as lab

from chip_smoke import edge_fixtures

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_SP = 1024  # the JAX lab's coarse-grid stride, dma_only's sp
L, K = 1000, 64
FIELDS = ("hap1", "hap2", "n_variants", "overflow")


@pytest.fixture(scope="module")
def jax_lab():
    """The JAX lab module, loaded from its file; the environment and
    ``sys.path`` it touches on import are restored."""
    saved_path = list(sys.path)
    saved_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(
        "jax_window_kernel_lab", ROOT / "tools" / "window_kernel_lab.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved_path
        if saved_env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = saved_env
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pallas_call`` runs in interpret mode."""
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))


def small_state(seed=0, G=400_000, D=2, V=3000):
    """A ~400 kb genome and D donors x V SNVs on one chromosome; donor 1
    stops 700 short of V (INT32_MAX padding, zero codes past its count)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=G).astype(np.int8)
    pos = np.sort(rng.choice(G - 2000, size=(D, 1, V), replace=False), axis=-1).astype(np.int32)
    ref, alt = (rng.integers(0, 4, size=(D, 1, V)).astype(np.int8) for _ in range(2))
    p1, p2 = (rng.integers(0, 2, size=(D, 1, V)).astype(np.int8) for _ in range(2))
    counts = np.full((D, 1), V, np.int32)
    counts[1:] = V - 700
    for d in range(1, D):
        pos[d, 0, counts[d, 0]:] = INT32_MAX
        for a in (ref, alt, p1, p2):
            a[d, 0, counts[d, 0]:] = 0
    return genome, np.zeros(1, np.int32), pos, ref, alt, p1, p2, counts


def small_draws(seed, G, D, B):
    rng = np.random.default_rng(seed + 100)
    return (rng.integers(0, D, size=B).astype(np.int32), np.zeros(B, np.int32),
            rng.integers(0, G - L - 8, size=B).astype(np.int32))


def jax_legacy(state):
    """The JAX lab's separate padded ``vp_pad``/``sub_pad`` arrays, built as
    its ``build_fixture`` builds them."""
    _, _, pos, ref, alt, p1, p2, _ = state
    D, C, V = pos.shape
    Vp = -(-V // JAX_SP) * JAX_SP + 2 * JAX_SP
    vp = np.full((D * C, Vp), INT32_MAX, np.int32)
    vp[:, :V] = pos.reshape(D * C, V)
    sub1 = np.where(p1 == 1, alt, ref).astype(np.int32)
    sub2 = np.where(p2 == 1, alt, ref).astype(np.int32)
    sub = np.zeros((D * C, Vp), np.int32)
    sub[:, :V] = ((sub1 & 0xFF) | (sub2 << 8)).reshape(D * C, V)
    return {"vp_pad": jnp.asarray(vp.reshape(D * C, Vp // 128, 128)),
            "sub_pad": jnp.asarray(sub.reshape(D * C, Vp // 128, 128))}


def port_index(state):
    return build_window_index(*map(torch.from_numpy, state))


def assert_fields_equal(got, want, fields=FIELDS):
    for name in fields:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


# ---------------------------------------------------------------------------
# (a) full and dma_only against the JAX lab in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,w", [(16, 8), (13, 1)])
@pytest.mark.parametrize("variant", ["full", "dma_only"])
def test_plain_matches_jax_lab_interpret(variant, B, w, jax_lab, interpret):
    state = small_state()
    draws = small_draws(0, state[0].size, state[2].shape[0], B)
    jidx = build_pallas_window_index(*state[:1], *state[2:])
    call = jax_lab.make_variant_call(True, variant == "full", w, L, K, legacy=jax_legacy(state))
    want = call(jidx, jnp.asarray(state[1]), *map(jnp.asarray, draws))
    got = encode_windows_lab(port_index(state), *map(torch.from_numpy, draws),
                             L=L, K=K, variant=variant, sp=JAX_SP)
    assert_fields_equal(got, want)
    if variant == "full":
        assert int(got.n_variants.sum()) > 0
        assert not got.sink.any()


# ---------------------------------------------------------------------------
# (b) compute_only against both baselines on the synthetic state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_compute_only_matches_baselines_on_synthetic_state(seed):
    state = small_state(seed)
    index = port_index(state)
    draws = small_draws(seed, state[0].size, state[2].shape[0], 24)
    tdraws = list(map(torch.from_numpy, draws))
    got = encode_windows_lab(index, *tdraws, L=L, K=K, variant="compute_only")
    synth = synthetic_state(index)
    want_port = encode_haplotype_windows(*synth, *tdraws, L=L, K=K)
    want_jax = jax_encode(*(jnp.asarray(np.ascontiguousarray(t.numpy())) for t in synth),
                          *map(jnp.asarray, draws), L=L, K=K)
    assert_fields_equal(got, want_port)
    assert_fields_equal(got, want_jax)
    assert not got.sink.any()
    # the synthetic state keeps ~1.2 variants a 1,000 bp window
    assert 0.8 < float(got.n_variants.float().mean()) < 1.6


def test_synthetic_state_closed_form():
    index = port_index(small_state())
    genome, offsets, pos, ref, alt, p1, p2, counts = synthetic_state(index)
    G = index.genome.shape[0]
    assert genome.shape == (G,) and torch.equal(genome.long(), torch.arange(G) & 3)
    i = torch.arange(pos.shape[2])
    for d in range(pos.shape[0]):
        n = int(counts[d, 0])
        assert torch.equal(pos[d, 0, :n].long(), i[:n] * SYNTH_STRIDE)
        assert bool((pos[d, 0, n:] == INT32_MAX).all())
    sub1 = torch.where(p1 == 1, alt, ref)
    sub2 = torch.where(p2 == 1, alt, ref)
    assert torch.equal(sub1[1, 0].long(), i & 3) and torch.equal(sub2[0, 0].long(), (i >> 2) & 3)
    assert offsets is index.offsets and counts is index.counts


def test_compute_only_refuses_positions_past_int32():
    state = small_state(V=3000)
    index = port_index(state)
    big = index._replace(pos=torch.zeros((1, 1, 2**31 // SYNTH_STRIDE + 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="too large"):
        synthetic_state(big)


# ---------------------------------------------------------------------------
# dma_only against a numpy loop (the sink is the port's own output)
# ---------------------------------------------------------------------------

def numpy_dma_only(state, draws, L, K, sp):
    genome, offsets, pos, ref, alt, p1, p2, counts = state
    D, C, V = pos.shape
    sub12 = (np.where(p1 == 1, alt, ref).astype(np.int32)
             | (np.where(p2 == 1, alt, ref).astype(np.int32) << 8))
    rows = []
    for d, c, s in zip(*draws):
        d, c = min(max(int(d), 0), D - 1), min(max(int(c), 0), C - 1)
        s = int(s)
        p, sb, n = pos[d, c].astype(np.int64), sub12[d, c], int(counts[d, c])
        flat = min(max(int(offsets[c]) + s, 0), genome.size - L)
        a = 4 * ((flat >> 2) // sp) * sp + (flat & 3)
        lo0 = max(int((p[::sp] < s).sum()) - 1, 0) * sp
        lo, hi = int((p < s).sum()), int((p < s + L).sum())
        n_apply = min(max(min(hi, n) - min(lo, n), 0), K)
        sink = 0
        for k in range(n_apply):
            sink ^= int(p[lo + k]) ^ int(sb[lo + k])
        rows.append((genome[a:a + L], int(p[lo0]), int(sb[lo0]), sink))
    return rows


@pytest.mark.parametrize("sp", [SP, JAX_SP])
@pytest.mark.parametrize("name", sorted(edge_fixtures()) + ["small_state"])
def test_dma_only_matches_numpy_loop(name, sp):
    if name == "small_state":
        state = small_state(3)
        fx = (state, small_draws(3, state[0].size, 2, 9), L, K)
    else:
        fx = edge_fixtures()[name]
    state, draws, L_, K_ = fx
    got = encode_windows_lab(port_index(state), *map(torch.from_numpy, draws),
                             L=L_, K=K_, variant="dma_only", sp=sp)
    for b, (win, nv, ovf, sink) in enumerate(numpy_dma_only(state, draws, L_, K_, sp)):
        assert np.array_equal(got.hap1[b].numpy(), win) and np.array_equal(got.hap2[b].numpy(), win)
        assert (int(got.n_variants[b]), int(got.overflow[b]), int(got.sink[b])) == (nv, ovf, sink)


@pytest.mark.parametrize("name", sorted(edge_fixtures()))
def test_full_and_compute_only_match_the_encode_on_edges(name):
    """Edge fixtures of the window kernel: empty rows and overflow,
    duplicate positions, bucket crossings, the clamp at the genome's end."""
    state, draws, L_, K_ = edge_fixtures()[name]
    index = port_index(state)
    td = list(map(torch.from_numpy, draws))
    for variant, st in (("full", index.plain_args), ("compute_only", synthetic_state(index))):
        got = encode_windows_lab(index, *td, L=L_, K=K_, variant=variant)
        assert_fields_equal(got, encode_haplotype_windows(*st, *td, L=L_, K=K_))


# ---------------------------------------------------------------------------
# the kernel's arithmetic: pure-torch twins of csrc/window_kernel_lab.cu
# ---------------------------------------------------------------------------

def synthetic_first(j, count):
    """compute_only's trip 2: ``first[row, j] = min(ceil((j << BK) / 833),
    count)``, the bucket table of the synthetic positions ``i * 833``."""
    return torch.minimum(((j.long() << BK) + SYNTH_STRIDE - 1) // SYNTH_STRIDE, count.long())


def lo0_from_count(lo, sp):
    """dma_only's ``lo0`` from ``lo``, the count below the start that the
    table and the slice give: ``max(ceil(lo / sp) - 1, 0) * sp``, a mask
    for ``sp`` a power of two."""
    return torch.where(lo == 0, 0, (lo - 1) & -sp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_table_closed_form(seed):
    """The closed form equals ``bucket_table`` on ``synthetic_state``'s
    positions, for random counts, 0 and V among them."""
    rng = np.random.default_rng(seed)
    index = port_index(small_state(seed, D=3, V=3000))
    D, C, V = index.pos.shape
    counts = rng.integers(0, V + 1, size=(D, C)).astype(np.int32)
    counts[0, 0], counts[1, 0] = 0, V
    index = index._replace(counts=torch.from_numpy(counts))
    pos = synthetic_state(index)[2]
    first = bucket_table(pos, index.counts)
    j = torch.arange(first.shape[2])
    assert first.shape[2] == ((V - 1) * SYNTH_STRIDE >> BK) + 2
    # the kernel reads every bucket, past the table's last as well (up to
    # 2^19, bp 2^31): there the closed form holds the whole count
    past = torch.tensor([first.shape[2], first.shape[2] + 1000, 2**19])
    for d in range(D):
        for c in range(C):
            n = index.counts[d, c]
            assert torch.equal(synthetic_first(j, n), first[d, c].long())
            assert torch.equal(synthetic_first(past, n), n.long().expand(3))


def lo0_cases():
    """(name, state, draws, L): every edge fixture's state and random rows of
    small_state with negative starts and starts past the last position."""
    cases = [(name, st, dr, L_) for name, (st, dr, L_, _) in sorted(edge_fixtures().items())]
    for seed in (0, 1):
        state = small_state(seed)
        rng = np.random.default_rng(seed + 7)
        G = state[0].size
        s = np.concatenate([rng.integers(-5000, G + 5000, 40), [-2**31, -1, 0, G, 2**31 - 1]])
        d = rng.integers(0, 2, s.size)
        cases.append((f"random_{seed}", state,
                      (d.astype(np.int32), np.zeros(s.size, np.int32), s.astype(np.int32)), L))
    return cases


@pytest.mark.parametrize("sp", [SP, JAX_SP])
@pytest.mark.parametrize("case", range(len(lo0_cases())), ids=[c[0] for c in lo0_cases()])
def test_lo0_from_count_matches_grid_count(case, sp):
    """dma_only's ``lo0`` from the count below the start (the kernel's
    search, :func:`window_bounds`) equals the grid count of the plain
    version, which counts ``pos[row, ::sp]`` over the whole row."""
    _, state, draws, L_ = lo0_cases()[case]
    index = port_index(state)
    td = list(map(torch.from_numpy, draws))
    lo, _ = window_bounds(index, *td, L_)
    D, C, V = index.pos.shape
    row = td[0].long().clamp(0, D - 1) * C + td[1].long().clamp(0, C - 1)
    want = grid_lo0(index.pos.reshape(D * C, V)[row], td[2], sp)
    assert torch.equal(lo0_from_count(lo, sp), want)


def test_kernels_share_the_header_and_hash_it(tmp_path):
    """Both window kernels include ``window_common.cuh``, and the header
    enters every kernel's build hash: an edited header rebuilds them."""
    hdr = _build.CSRC_DIR / "window_common.cuh"
    assert hdr in _build._kernel_deps()
    for name in ("window_kernel", "window_kernel_lab"):
        assert '#include "window_common.cuh"' in (_build.CSRC_DIR / f"{name}.cu").read_text()
    edited = tmp_path / hdr.name
    edited.write_bytes(hdr.read_bytes() + b"\n")
    src = _build._kernel_sources("window_kernel_lab")
    argv = ["nvcc", *_build.NVCC_FLAGS]
    assert (_build._target("window_kernel_lab", [*src, hdr], argv)
            != _build._target("window_kernel_lab", [*src, edited], argv))


# ---------------------------------------------------------------------------
# (c) the fixture, (d) the chained starts
# ---------------------------------------------------------------------------

def test_build_fixture_matches_jax_lab(jax_lab):
    jidx, legacy, jLc, jD = jax_lab.build_fixture()
    index, Lc, D = lab.build_fixture(device="cpu")
    assert (Lc, D) == (jLc, jD) == (10_000_000, 8)
    V = index.pos.shape[2]
    np.testing.assert_array_equal(
        index.pos[..., ::JAX_SP].reshape(D, -1).numpy(), np.asarray(jidx.grid))
    np.testing.assert_array_equal(index.counts.reshape(-1).numpy(), np.asarray(jidx.counts))
    words = np.asarray(jidx.genome_words).view(np.int8).reshape(-1)
    np.testing.assert_array_equal(words[:Lc], index.genome.numpy())
    vp = np.asarray(legacy["vp_pad"]).reshape(D, -1)
    sub = np.asarray(legacy["sub_pad"]).reshape(D, -1)
    np.testing.assert_array_equal(vp[:, :V], index.pos.reshape(D, V).numpy())
    np.testing.assert_array_equal(sub[:, :V], index.sub12.reshape(D, V).numpy())


def _jax_baseline_call(state):
    genome, _, pos, ref, alt, p1, p2, counts = map(jnp.asarray, state)

    def call(idx, offs, di, ci, st):
        return jax_encode(genome, offs, pos, ref, alt, p1, p2, counts, di, ci, st, L=L, K=K)

    return call


@pytest.mark.parametrize("port_call", ["baseline", "prod", "full_w1", "dma_only_w8"])
def test_make_chained_matches_jax_lab(port_call, jax_lab, interpret):
    state = small_state(5)
    G, D, B, n_chain = state[0].size, state[2].shape[0], 16, 3
    di, _, starts = small_draws(5, G, D, B)
    offs = jnp.asarray(state[1])
    if port_call == "dma_only_w8":
        jcall = jax_lab.make_variant_call(True, False, 8, L, K, legacy=jax_legacy(state))
        jidx = build_pallas_window_index(*state[:1], *state[2:])
        index = port_index(state)
        call = functools.partial(encode_windows_lab, L=L, K=K, variant="dma_only", w=8,
                                 sp=JAX_SP)
    else:
        jcall, jidx = _jax_baseline_call(state), None
        index = port_index(state)
        call = {"baseline": lambda i, d, c, s: encode_haplotype_windows(
                    *i.plain_args, d, c, s, L=L, K=K)} | lab.lab_calls(L, K)
        call = call[port_call]
    want = jax_lab.make_chained(jcall, jidx, offs, G, D, B, L, n_chain)(starts, di)
    run = lab.make_chained(call, index, G, D, B, L, n_chain)
    got = run(torch.from_numpy(starts), torch.from_numpy(di))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), starts)


# ---------------------------------------------------------------------------
# the wrapper and the tool on the CPU
# ---------------------------------------------------------------------------

def test_lab_index_strides_the_grid():
    """dma_only reads the row at ``lo0`` of the grid ``pos[..., ::sp]`` it
    slices itself: the index holds no grid."""
    state = small_state()
    index = port_index(state)
    assert "grid" not in index._fields
    draws = small_draws(0, state[0].size, 2, 12)
    td = list(map(torch.from_numpy, draws))
    for sp in (SP, JAX_SP, 100):
        got = lab_plain(index, *td, L=L, K=K, variant="dma_only", sp=sp)
        for b, (d, _, s) in enumerate(zip(*draws)):
            grid = index.pos[d, 0, ::sp]
            lo0 = max(int((grid < int(s)).sum()) - 1, 0) * sp
            assert int(got.n_variants[b]) == int(index.pos[d, 0, lo0])
            assert int(got.overflow[b]) == int(index.sub12[d, 0, lo0])


def test_wrapper_runs_plain_versions_on_cpu_tensors():
    state = small_state(2)
    index = port_index(state)
    draws = list(map(torch.from_numpy, small_draws(2, state[0].size, 2, 8)))
    before = encode_windows_lab.launches
    for variant in VARIANTS:
        got = encode_windows_lab(index, *draws, L=L, K=K, variant=variant, w=32)
        assert_fields_equal(got, lab_plain(index, *draws, L=L, K=K, variant=variant),
                            FIELDS + ("sink",))
        assert got.hap1.shape == (8, L) and got.sink.dtype == torch.int32
    assert encode_windows_lab.launches == before  # no kernel launched


def test_wrapper_refuses_what_the_kernel_does_not_take():
    state = small_state(2)
    index = port_index(state)
    draws = list(map(torch.from_numpy, small_draws(2, state[0].size, 2, 4)))
    kw = dict(L=L, K=K)
    with pytest.raises(ValueError, match="unknown lab variant"):
        encode_windows_lab(index, *draws, variant="dma", **kw)
    with pytest.raises(ValueError, match="windows per block"):
        encode_windows_lab(index, *draws, variant="full", w=3, **kw)
    for sp in (0, 100):  # no grid stride; a stride the kernel cannot mask
        with pytest.raises(ValueError, match="sp="):
            encode_windows_lab(index, *draws, variant="dma_only", sp=sp, **kw)
    with pytest.raises(ValueError, match="K="):
        encode_windows_lab(index, *draws, variant="full", L=L, K=129)
    meta = [torch.empty(d.shape, dtype=torch.int32, device="meta") for d in draws]
    with pytest.raises(ValueError, match="no lab kernel"):
        encode_windows_lab(index, *meta, variant="full", **kw)


def test_bound_model():
    """The bucket-table model: per window 12 + 8 + L + 2L + 8 B, the two
    table entries (8 B), 6 B per applied variant, 4 B per other position of
    the slice capped at two binary searches of it; the lab's rows 4 B more
    (sink), dma_only 6 B more (lo0); compute_only its stores alone.  The
    smoke's row-1 bound is the same function."""
    hbm = 3.35e12
    # window 0: a slice of 5, 2 applied, 3 others; window 1: an empty slice;
    # window 2: a slice of 100, none applied, others capped at 2 * 7
    slices = [(torch.tensor([0, 10, 40]), torch.tensor([5, 10, 140]))]
    n_apply = [torch.tensor([2, 0, 0])]
    prod = lab.bound_bytes("prod", slices, n_apply, 1000)
    assert prod["search"] == 3 * 8 + 4 * (3 + 0 + 14)
    assert prod["applied"] == 2
    assert prod["bytes"] == 3 * (20 + 1000 + 2008) + prod["search"] + 6 * 2
    assert lab.bound_bytes("full", slices, n_apply, 1000)["bytes"] == prod["bytes"] + 3 * 4
    assert lab.bound_bytes("dma_only", slices, n_apply, 1000)["bytes"] == prod["bytes"] + 3 * 10
    assert lab.bound_bytes("compute_only", slices, n_apply, 1000)["bytes"] == 3 * 2012
    # two batches: the bound is the mean a batch
    assert lab.bound_ms("prod", slices * 2, n_apply * 2, 1000) == pytest.approx(
        prod["bytes"] / hbm * 1e3)
    import chip_smoke
    assert not hasattr(chip_smoke, "bound_bytes")  # one model


def test_lab_main_on_cpu(tmp_path, capsys):
    out = tmp_path / "lab.json"
    res = lab.main(["--device", "cpu", "--batch", "4", "--n-chain", "2", "--iters", "1",
                    "--seed", "7", "--out", str(out)])
    names = ["prod"] + [f"{v}_w{w}" for v in VARIANTS for w in (1, 8, 32)]
    assert [r["name"] for r in res["results"]] == names
    assert (res["platform"], res["B"], res["L"], res["K"], res["n_chain"]) == ("cpu", 4, 1000, 64, 2)
    for r in res["results"]:
        assert r["median_s"] > 0 and r["windows_per_sec"] > 0 and r["us_per_window"] > 0
        assert r["device_ms_per_launch"] is None and r["bound_ms"] is None
    assert json.loads(out.read_text()) == res
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res


def test_lab_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        lab.main(["--batch", "4"])


# ---------------------------------------------------------------------------
# (e) on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w,L_", [(w, L) for w in WINDOWS_PER_BLOCK] + [(32, 4080)])
@pytest.mark.parametrize("variant,sp", [("full", SP), ("dma_only", SP), ("dma_only", JAX_SP),
                                        ("compute_only", SP)])
def test_kernel_matches_plain_on_card(variant, sp, w, L_, card):
    """Every variant at every w; at w=32 also L=4080, whose 32 windows a
    block take 133,120 B of dynamic shared memory."""
    state = small_state(4)
    index = build_window_index(*(torch.from_numpy(a).to(card) for a in state))
    draws = [torch.from_numpy(d).to(card) for d in small_draws(4, state[0].size, 2, 61)]
    got = encode_windows_lab(index, *draws, L=L_, K=K, variant=variant, w=w, sp=sp)
    want = lab_plain(index, *draws, L=L_, K=K, variant=variant, sp=sp)
    torch.cuda.synchronize()
    assert_fields_equal(type(got)(*(t.cpu() for t in got)), type(want)(*(t.cpu() for t in want)),
                        FIELDS + ("sink",))


@pytest.mark.cuda
def test_make_chained_counts_replays_on_card(card):
    state = small_state(4)
    index = build_window_index(*(torch.from_numpy(a).to(card) for a in state))
    di, _, st = (torch.from_numpy(a).to(card) for a in small_draws(4, state[0].size, 2, 16))
    call = lab.lab_calls(L, K)["full_w8"]
    run = lab.make_chained(call, index, state[0].size, 2, 16, L, 3)
    base = encode_windows_lab.launches  # after the warm-up and the capture
    for _ in range(2):
        st = run(st, di)
    torch.cuda.synchronize()
    assert encode_windows_lab.launches == base + 2 * 3
    cpu = lab.make_chained(call, port_index(state), state[0].size, 2, 16, L, 3)
    want = torch.from_numpy(small_draws(4, state[0].size, 2, 16)[2])
    for _ in range(2):
        want = cpu(want, di.cpu())
    assert torch.equal(st.cpu(), want)
