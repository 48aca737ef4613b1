"""Window encode of the PyTorch port against the JAX package.

The port's plain ``encode_haplotype_windows`` must be bit-equal (integer
outputs, tolerance 0) to the JAX baseline ``encode_haplotype_windows`` and to
the Pallas kernel in interpret mode, on the same numpy inputs.  The Hopper
kernel is held against the plain version on the card only
(``test_kernel_matches_plain_on_card``, marked ``cuda``; it skips without a
card, and ``chip_smoke.py`` makes the same checks at full size there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haplohyped_tpu.ops.haplotype_window import build_window_index as jax_build_window_index
from haplohyped_tpu.ops.haplotype_window import encode_haplotype_windows as jax_encode
from haplohyped_tpu.ops.haplotype_window import windows_to_onehot as jax_onehot
from haplohyped_tpu.ops.pallas_window import (
    build_pallas_window_index,
    encode_windows_pallas,
)
from haplohyped_tpu_torch.ops import window_lab
from haplohyped_tpu_torch.ops.haplotype_window import (
    encode_haplotype_windows,
    windows_to_onehot,
)
from haplohyped_tpu_torch.ops.window_kernel import (
    build_window_index,
    encode_windows_kernel,
)

from chip_smoke import edge_fixtures
from tests.test_window_kernels import make_batch, make_fixture

EDGE_FIXTURES = edge_fixtures()


def random_fixture(seed, L, K, B=32):
    genome, offsets, pos, ref, alt, p1, p2, counts, lens = make_fixture(seed)
    D, C, _ = pos.shape
    return (genome, offsets, pos, ref, alt, p1, p2, counts), make_batch(seed, lens, D, C, B=B, L=L), L, K


def port(state, draws, L, K):
    return encode_haplotype_windows(
        *map(torch.from_numpy, state), *map(torch.from_numpy, draws), L=L, K=K
    )


def reference(state, draws, L, K):
    return jax_encode(*map(jnp.asarray, state), *map(jnp.asarray, draws), L=L, K=K)


def assert_windows_equal(got, want):
    for name in ("hap1", "hap2", "n_variants", "overflow"):
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("L,K", [(256, 32), (1000, 64)])
def test_plain_matches_jax_random(seed, L, K):
    fx = random_fixture(seed, L, K)
    assert_windows_equal(port(*fx), reference(*fx))


@pytest.mark.parametrize("name", sorted(EDGE_FIXTURES))
def test_plain_matches_jax_edges(name):
    """chip_smoke.py's edge fixtures: empty rows and overflow, duplicate
    positions, coarse-bucket crossings, the slice clamp at the genome's end."""
    fx = EDGE_FIXTURES[name]
    got = port(*fx)
    assert_windows_equal(got, reference(*fx))
    if name == "duplicate_positions":  # the last duplicate wins
        assert int(got.hap1[0, 10]) == 3 and int(got.hap2[0, 10]) == 0
    if name == "empty_rows_and_overflow":
        genome = fx[0][0]
        assert np.array_equal(got.hap1[0].numpy(), genome[:128])
        assert int(got.overflow[1]) == 128 - 8


def test_plain_matches_jax_prime_batch():
    fx = random_fixture(4, 300, 16, B=61)
    assert_windows_equal(port(*fx), reference(*fx))


def test_plain_matches_pallas_interpret():
    state, draws, L, K = random_fixture(3, 256, 64, B=16)
    pidx = build_pallas_window_index(*state[:1], *state[2:])
    pal = encode_windows_pallas(
        pidx, jnp.asarray(state[1]), *map(jnp.asarray, draws), L=L, K=K, interpret=True
    )
    assert_windows_equal(port(state, draws, L, K), pal)


def test_windows_to_onehot_matches_jax():
    codes = np.random.default_rng(0).integers(0, 5, size=(3, 7, 50)).astype(np.int8)
    got = windows_to_onehot(torch.from_numpy(codes), 5, torch.float32)
    want = jax_onehot(jnp.asarray(codes), 5, jnp.float32)
    assert got.shape == (3, 7, 50, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_index_matches_jax_fast_index():
    """The kernel's packed sub12 equals the JAX fast path's (same packing),
    and so does the grid the lab's dma_only slices, ``pos[..., ::SP]`` (the
    strides agree at 512)."""
    state, _, _, _ = random_fixture(1, 256, 32)
    genome, offsets, pos, ref, alt, p1, p2, counts = state
    idx = build_window_index(*map(torch.from_numpy, state))
    jidx = jax_build_window_index(genome, pos, ref, alt, p1, p2)
    assert window_lab.SP == 512
    np.testing.assert_array_equal(idx.sub12.numpy(), np.asarray(jidx.sub12))
    np.testing.assert_array_equal(idx.pos[..., ::window_lab.SP].numpy(), np.asarray(jidx.grid))


def test_index_rejects_codes_outside_7_bits():
    state, _, _, _ = EDGE_FIXTURES["duplicate_positions"]
    state = list(map(torch.from_numpy, state))
    state[4] = state[4].clone()
    state[4][0, 0, 0] = -1  # alt
    with pytest.raises(ValueError, match=r"\[0, 128\)"):
        build_window_index(*state)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    state, draws, L, K = random_fixture(2, 256, 32)
    idx = build_window_index(*map(torch.from_numpy, state))
    before = encode_windows_kernel.launches
    got = encode_windows_kernel(idx, *map(torch.from_numpy, draws), L=L, K=K)
    assert encode_windows_kernel.launches == before  # no kernel launched
    assert_windows_equal(got, reference(state, draws, L, K))


def test_wrapper_refuses_other_devices():
    state, draws, L, K = EDGE_FIXTURES["duplicate_positions"]
    idx = build_window_index(*map(torch.from_numpy, state))
    meta = [torch.empty(d.shape, dtype=torch.int32, device="meta") for d in draws]
    with pytest.raises(ValueError, match="no window kernel"):
        encode_windows_kernel(idx, *meta, L=L, K=K)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_FIXTURES) + ["random_prime_batch"])
def test_kernel_matches_plain_on_card(name, card):
    fx = EDGE_FIXTURES.get(name) or random_fixture(0, 1000, 128, B=61)
    state, draws, L, K = fx
    idx = build_window_index(*(torch.from_numpy(a).to(card) for a in state))
    dev_draws = [torch.from_numpy(d).to(card) for d in draws]
    got = encode_windows_kernel(idx, *dev_draws, L=L, K=K)
    want = encode_haplotype_windows(*idx.plain_args, *dev_draws, L=L, K=K)
    torch.cuda.synchronize()
    assert_windows_equal(
        type(got)(*(t.cpu() for t in got)), type(want)(*(t.cpu() for t in want))
    )
