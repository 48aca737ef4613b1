"""The window kernel on long windows and past 128 variants, against the
plain version: at Enformer's L=196,608 and K=512 (a thread then holds up to
four applied variants, and a window is cut into parts of 8,192 bytes, one
block each), and at K <= 128, where a window of one part keeps the kernel's
one-variant-a-thread code and a longer one runs the four-a-thread build over
parts.  Every comparison is bit for bit.

The comparisons need a card (``cuda``-marked; they skip without one).  On
the card's machine, which has no JAX, run them without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_window_card.py

This file imports no JAX; ``tests/test_torch_window_long.py`` holds the
plain version against the JAX package on the CPU, on the same fixture.
"""

import numpy as np
import pytest
import torch

from haplohyped_tpu_torch.core.constants import INT32_MAX
from haplohyped_tpu_torch.ops.haplotype_window import encode_haplotype_windows
from haplohyped_tpu_torch.ops.window_kernel import build_window_index, encode_windows_kernel

L_LONG, K_LONG = 196_608, 512


def long_fixture(seed: int, B: int = 4, L: int = L_LONG):
    """``(state, draws)`` numpy, for windows of ``L`` bp: 3 donors x 2
    chromosomes of 600 and 450 kb; donor 0 at 1.2 SNVs a kb (about 236 a
    window), donor 1 at 3 a kb (about 590: past K=512, so windows
    overflow), donor 2 at 0.5 a kb with runs of repeated positions (the last
    one wins).  Draws cover every donor, both chromosomes, a start of 0, the
    clamp at the chromosome's end and a start before it."""
    rng = np.random.default_rng(seed)
    lens = np.array([600_000, 450_000])
    offsets = np.array([0, lens[0]], np.int32)
    genome = rng.integers(0, 5, size=int(lens.sum()), dtype=np.int8)
    rates = (1.2e-3, 3e-3, 0.5e-3)
    V = int(lens.max() * max(rates) * 1.2)
    D, C = len(rates), len(lens)
    pos = np.full((D, C, V), INT32_MAX, np.int32)
    ref, alt, p1, p2 = (np.zeros((D, C, V), np.int8) for _ in range(4))
    counts = np.zeros((D, C), np.int32)
    for d, rate in enumerate(rates):
        for c, n_bp in enumerate(lens):
            n = min(int(rng.poisson(n_bp * rate)), V)
            p = np.sort(rng.integers(0, n_bp, size=n)).astype(np.int32)
            if d == 2:
                p[1::7] = p[0::7][: len(p[1::7])]  # repeated positions
                p = np.sort(p)
            pos[d, c, :n] = p
            ref[d, c, :n] = genome[offsets[c] + p]
            alt[d, c, :n] = (ref[d, c, :n] + rng.integers(1, 4, n)) % 4
            p1[d, c, :n] = rng.integers(0, 2, n)
            p2[d, c, :n] = rng.integers(0, 2, n)
            counts[d, c] = n
    donor = (np.arange(B) % D).astype(np.int32)
    chrom = ((np.arange(B) // D) % C).astype(np.int32)
    lim = lens[chrom] - L
    start = rng.integers(0, lim + 1).astype(np.int32)
    start[0] = 0
    if B > 1:
        start[1] = lim[1] + 5_000  # past the end: the genome slice clamps
    if B > 2:
        start[2] = -3  # before the start
    return (genome, offsets, pos, ref, alt, p1, p2, counts), (donor, chrom, start)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_and_plain(state, draws, L, K, dev):
    idx = build_window_index(*(torch.from_numpy(a).to(dev) for a in state))
    dr = [torch.from_numpy(d).to(dev) for d in draws]
    got = encode_windows_kernel(idx, *dr, L=L, K=K)
    want = encode_haplotype_windows(*idx.plain_args, *dr, L=L, K=K)
    torch.cuda.synchronize()
    return [t.cpu() for t in got], [t.cpu() for t in want]


@pytest.mark.cuda
@pytest.mark.parametrize("seed, B", [(0, 4), (1, 7), (2, 1)])
@pytest.mark.parametrize("K", [K_LONG, 300, 129])
def test_long_windows_past_128_variants_match_plain(card, seed, B, K):
    got, want = _kernel_and_plain(*long_fixture(seed, B), L_LONG, K, card)
    for g, w, name in zip(got, want, ("hap1", "hap2", "n_variants", "overflow")):
        assert torch.equal(g, w), name
    if K == K_LONG and B >= 2:
        assert int(want[3].max()) > 0  # donor 1's windows overflow K


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1000, 8192, 8193, 40_000])
@pytest.mark.parametrize("K", [128, 64, 1])
def test_k_up_to_128_matches_plain(card, L, K):
    got, want = _kernel_and_plain(*long_fixture(3, 9, L), L, K, card)
    for g, w, name in zip(got, want, ("hap1", "hap2", "n_variants", "overflow")):
        assert torch.equal(g, w), name


def test_fixture_windows_hold_past_k_and_repeats():
    """The plain version on the fixture (CPU): donor 0's windows hold about
    236 variants, donor 1's overflow K=512, and its windows are L long."""
    state, draws = long_fixture(0, 4)
    t = [torch.from_numpy(a) for a in state]
    w = encode_haplotype_windows(*t, *map(torch.from_numpy, draws), L=L_LONG, K=K_LONG)
    assert w.hap1.shape == (4, L_LONG)
    assert 150 < int(w.n_variants[0]) < 350
    assert int(w.overflow[1]) > 0 and int(w.overflow[0]) == 0
    assert not torch.equal(w.hap1, w.hap2)
