"""The window kernel's bucket table and search, against numpy and the JAX package.

The Hopper window kernel finds each window's variants through the bucket
table ``first[d, c, j] = #{pos[d, c] < j << BK}`` and a slice of the row
between two of its entries.  On the CPU:

- ``bucket_table`` equals ``np.searchsorted`` over each row's counted
  positions, at the default ``BK``, at ``bk=0`` (1-bp buckets, most empty)
  and at ``bk=20`` (every row in one or two buckets, dense);
- ``window_bounds``, the kernel's search as plain torch ops, gives ``n_in``
  equal to the JAX package's ``n_variants`` (tolerance 0), and its slice
  holds ``[lo, hi)``;
- a numpy model of the kernel's substitution (a scatter in which only the
  last applied variant at a position writes) equals the JAX package's
  windows;
- ``_check`` refuses a ``first`` of the wrong type or shape.

The kernel itself runs only on a card (``tests/test_torch_window.py::
test_kernel_matches_plain_on_card``, marked ``cuda``, over the same edge
fixtures; ``chip_smoke.py`` holds it against the plain version there).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haplohyped_tpu.ops.haplotype_window import encode_haplotype_windows as jax_encode
from haplohyped_tpu_torch.core.constants import INT32_MAX
from haplohyped_tpu_torch.ops import window_kernel
from haplohyped_tpu_torch.ops.haplotype_window import encode_haplotype_windows
from haplohyped_tpu_torch.ops.window_kernel import (
    BK,
    bucket_table,
    build_window_index,
    window_bounds,
    window_slice,
)

from chip_smoke import edge_fixtures
from tests.test_torch_window import random_fixture

EDGE_FIXTURES = edge_fixtures()
FIXTURES = sorted(EDGE_FIXTURES) + ["random_0", "random_1", "random_2"]
#: 1-bp buckets (most empty), the kernel's, and buckets wider than any row
BKS = (0, BK, 20)


def fixture(name):
    if name.startswith("random_"):
        return random_fixture(int(name[-1]), 1000, 64, B=48)
    return EDGE_FIXTURES[name]


@functools.cache
def jax_windows(name):
    state, draws, L, K = fixture(name)
    return jax_encode(*map(jnp.asarray, state), *map(jnp.asarray, draws), L=L, K=K)


def index_of(state):
    return build_window_index(*map(torch.from_numpy, state))


@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("name", FIXTURES)
def test_first_matches_searchsorted(name, bk):
    pos, counts = fixture(name)[0][2], fixture(name)[0][7]
    first = bucket_table(torch.from_numpy(pos), torch.from_numpy(counts), bk)
    assert first.dtype == torch.int32
    D, C, nb1 = first.shape
    top = max((int(pos[d, c, counts[d, c] - 1]) for d in range(D) for c in range(C)
               if counts[d, c] > 0), default=-1)
    assert nb1 == ((top >> bk) + 2 if top >= 0 else 1)
    bounds = np.arange(nb1, dtype=np.int64) << bk
    for d in range(D):
        for c in range(C):
            want = np.searchsorted(pos[d, c, :counts[d, c]], bounds, side="left")
            np.testing.assert_array_equal(first[d, c].numpy(), want)


@pytest.mark.parametrize("name", FIXTURES)
def test_window_bounds_match_jax_n_variants(name):
    state, draws, L, K = fixture(name)
    index = index_of(state)
    td = list(map(torch.from_numpy, draws))
    lo, hi = window_bounds(index, *td, L)
    a, e = window_slice(index, *td, L)
    np.testing.assert_array_equal((hi - lo).int().numpy(), np.asarray(jax_windows(name).n_variants))
    assert bool(((a <= lo) & (lo <= hi) & (hi <= e)).all())
    # lo and hi are the searchsorted counts clamped to the row's count
    D, C, V = state[2].shape
    for b, (d, c, s) in enumerate(zip(*draws)):
        row = state[2][min(max(d, 0), D - 1), min(max(c, 0), C - 1)]
        n = state[7][min(max(d, 0), D - 1), min(max(c, 0), C - 1)]
        want = [min(int(np.searchsorted(row, x, side="left")), n) for x in (s, int(s) + L)]
        assert [int(lo[b]), int(hi[b])] == want


def kernel_model(state, draws, L, K, first_wins=False):
    """The kernel's substitution in numpy: the genome window, then a scatter
    of the applied variants in which only the last at its position writes
    (the first, with ``first_wins``)."""
    genome, offsets = state[0], state[1]
    index = index_of(state)
    td = list(map(torch.from_numpy, draws))
    lo, hi = (t.numpy() for t in window_bounds(index, *td, L))
    D, C, V = state[2].shape
    sub12 = index.sub12.reshape(D * C, V).numpy()
    pos = state[2].reshape(D * C, V)
    hap1, hap2 = [], []
    for b, (d, c, s) in enumerate(zip(*draws)):
        d, c, s = min(max(int(d), 0), D - 1), min(max(int(c), 0), C - 1), int(s)
        flat = min(max(int(offsets[c]) + s, 0), genome.size - L)
        h1, h2 = genome[flat:flat + L].copy(), genome[flat:flat + L].copy()
        row = d * C + c
        n_apply = min(int(hi[b] - lo[b]), K)
        for i in range(n_apply):
            k = int(lo[b]) + i
            if first_wins:
                writes = i == 0 or pos[row, k - 1] != pos[row, k]
            else:
                writes = i + 1 == n_apply or pos[row, k + 1] != pos[row, k]
            if writes:
                h1[pos[row, k] - s] = sub12[row, k] & 0xFF
                h2[pos[row, k] - s] = sub12[row, k] >> 8
        hap1.append(h1)
        hap2.append(h2)
    return np.stack(hap1), np.stack(hap2), (hi - lo).astype(np.int32)


@pytest.mark.parametrize("name", FIXTURES)
def test_scatter_model_matches_jax(name):
    state, draws, L, K = fixture(name)
    hap1, hap2, n_in = kernel_model(state, draws, L, K)
    want = jax_windows(name)
    np.testing.assert_array_equal(hap1, np.asarray(want.hap1))
    np.testing.assert_array_equal(hap2, np.asarray(want.hap2))
    np.testing.assert_array_equal(n_in, np.asarray(want.n_variants))


@pytest.mark.parametrize("name", ["duplicate_positions", "dense_slice"])
def test_scatter_model_first_match_wins_fails(name):
    """The mutation the scatter's rule guards against: with the first
    applied variant at a position writing instead of the last, the model
    differs from the JAX package on duplicate positions."""
    state, draws, L, K = fixture(name)
    hap1, _, _ = kernel_model(state, draws, L, K, first_wins=True)
    assert not np.array_equal(hap1, np.asarray(jax_windows(name).hap1))


@pytest.mark.parametrize("name", ["far_starts", "bucket_edges"])
def test_window_bounds_at_the_int32_edge(name):
    """A position just below INT32_MAX: the table is capped so its last
    bucket start fits in int32, and starts past it search to the count."""
    state, _, _, _ = fixture(name)
    state = [a.copy() for a in state]
    pos, counts = state[2], state[7]
    pos[0, 0, counts[0, 0] - 1] = INT32_MAX - 1
    index = index_of(state)
    assert index.first.shape[2] == (INT32_MAX >> BK) + 1
    starts = np.array([INT32_MAX - 60, INT32_MAX - 5000, 0, 2**31 - 4096], np.int32)
    z = np.zeros(starts.size, np.int32)
    draws = (z, z, starts)
    lo, hi = window_bounds(index, *map(torch.from_numpy, draws), 60)
    want = encode_haplotype_windows(*map(torch.from_numpy, state), *map(torch.from_numpy, draws),
                                    L=60, K=8)
    np.testing.assert_array_equal((hi - lo).int().numpy(), want.n_variants.numpy())
    assert int(hi[0] - lo[0]) == 1


def test_index_carries_the_table():
    state, _, _, _ = fixture("random_1")
    index = index_of(state)
    assert index.first.is_contiguous()
    assert torch.equal(index.first, bucket_table(index.pos, index.counts, BK))
    # no coarse grid: the lab's dma_only slices pos[..., ::sp] from the index
    assert "grid" not in index._fields
    assert index.pos[..., ::1024].shape == (*index.pos.shape[:2], -(-index.pos.shape[2] // 1024))
    # a state with no variants has one bucket start, at 0
    empty = EDGE_FIXTURES["empty_rows_and_overflow"][0]
    first = bucket_table(torch.from_numpy(empty[2]), torch.from_numpy(empty[7]), 5)
    assert first.shape[2] == (1023 >> 5) + 2
    none = [a.copy() for a in EDGE_FIXTURES["duplicate_positions"][0]]
    none[7][:] = 0
    assert index_of(none).first.shape == (1, 1, 1)


@pytest.mark.parametrize("bk", [-1, 31])
def test_bucket_table_refuses_bk(bk):
    state = fixture("duplicate_positions")[0]
    with pytest.raises(ValueError, match="bk="):
        bucket_table(torch.from_numpy(state[2]), torch.from_numpy(state[7]), bk)


def _bad_tables(first):
    D, C, nb1 = first.shape
    return {
        "int64": (first.long(), TypeError),
        "chromosomes": (torch.zeros((D, C + 1, nb1), dtype=torch.int32), ValueError),
        "no buckets": (torch.zeros((D, C, 0), dtype=torch.int32), ValueError),
        "two dims": (first.reshape(D * C, nb1), ValueError),
        "not contiguous": (torch.zeros((D, C, 2 * nb1), dtype=torch.int32)[..., ::2], ValueError),
        "past int32": (torch.zeros((D, C, (INT32_MAX >> BK) + 2), dtype=torch.int32), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_tables(torch.zeros((2, 1, 3), dtype=torch.int32))))
def test_check_refuses_bad_first(case):
    state, draws, L, K = fixture("bucket_edges")
    index = index_of(state)
    td = list(map(torch.from_numpy, draws))
    window_kernel._check(index, *td, L, K)  # the index as built passes
    bad, err = _bad_tables(index.first)[case]
    with pytest.raises(err):
        window_kernel._check(index._replace(first=bad), *td, L, K)
