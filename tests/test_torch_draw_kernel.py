"""The sampler's draws (``ops/draw_kernel.py``) against the JAX package.

On the CPU ``draw_windows`` runs its plain version, which must give the JAX
sampler's draws of every step (``fold_in(key, step)``, ``split(., 3)``, one
``randint`` a field, as ``haplohyped_tpu/data/sampler.py::_sample_batch``
makes them) and its window starts, bit for bit (tolerance 0).  The draws
that ``chip_smoke.py`` holds the card's kernel to are checked against JAX
here, and so are the kernel's divisor constants, against ``//`` and ``%``.
The kernel itself runs only on a card: the ``cuda``-marked test holds it
bit-equal to the plain version at the sampler's lane counts and at odd batch
sizes, and ``chip_smoke.py`` phase 3 does the same at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import JAX_DRAWS
from haplohyped_tpu_torch.ops import threefry as tf
from haplohyped_tpu_torch.ops.draw_kernel import (
    Draws,
    divisor,
    draw_windows,
    draws_plain,
    window_starts,
)

#: divisor sizes: the smallest, small odd and even spans, the state's C and
#: D, both sides of 2^16 (where randint's multiplier wraps to 0), the state's
#: R and the largest int32 size
DIVISORS = (1, 2, 3, 7, 12, 128, 65_535, 65_536, 65_537, 100_000, 2**31 - 1)
#: batch sizes that neither fill nor divide the kernel's 64-lane blocks
ODD_BATCHES = (1, 3, 65, 257)


def jax_step_draws(key, step, sizes, B):
    kr, kd, kc = jax.random.split(jax.random.fold_in(key, step), 3)
    return [np.asarray(jax.random.randint(k, (B,), 0, n)).astype(np.int32)
            for k, n in zip((kr, kd, kc), sizes)]


def jax_starts(regions, lengths, r, c, L):
    """The JAX sampler's crop (``_sample_batch``), in jnp int32."""
    span = jnp.asarray(regions)[r]
    mid = (span[:, 0] + span[:, 1]) // 2
    new_start = jnp.maximum(0, mid - L // 2)
    limit = jnp.maximum(jnp.asarray(lengths)[c] - L, 0)
    return np.asarray(jnp.minimum(new_start, limit).astype(jnp.int32))


def state(R=50, C=3, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(100, 5000, C).astype(np.int32)
    s = rng.integers(0, 6000, R)
    regions = np.stack([s, s + rng.integers(0, 900, R)], axis=1).astype(np.int32)
    return regions, lengths


def assert_draws_equal_jax(key, step0, n, B, regions, lengths, D, L):
    """``draw_windows`` on the CPU against the JAX sampler's draws and crop
    of steps ``step0 .. step0 + n - 1``, bit for bit."""
    got = draw_windows(key, step0, n, B, torch.from_numpy(regions), torch.from_numpy(lengths),
                       D, L)
    assert isinstance(got, Draws) and got.key.tolist() == list(key)
    sizes = (regions.shape[0], D, lengths.shape[0])
    jkey = jnp.asarray(np.array(key, np.uint32))
    for i in range(n):
        r, d, c = jax_step_draws(jkey, step0 + i, sizes, B)
        lanes = slice(i * B, (i + 1) * B)
        for g, w in zip((got.region_idx, got.donor_idx, got.chrom_idx), (r, d, c)):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g[lanes].numpy(), w)
        np.testing.assert_array_equal(got.start[lanes].numpy(),
                                      jax_starts(regions, lengths, r, c, L))


@pytest.mark.parametrize("key", [(0, 7), (123, 2**32 - 1)])
@pytest.mark.parametrize("step0", [0, 41, 2**31 - 3])
def test_draws_equal_jax_on_cpu(key, step0):
    assert_draws_equal_jax(key, step0, 3, 5, *state(), D=9, L=300)


@pytest.mark.parametrize("B", ODD_BATCHES)
def test_draws_equal_jax_at_odd_batch_sizes(B):
    """The shapes the card's kernel is held to ``draws_plain`` at: a block
    of the kernel covers part of a batch, or many."""
    assert_draws_equal_jax((0xC0FFEE, 2**32 - 7), 2**31 - 2, 3, B, *state(R=70, C=5, seed=B),
                           D=11, L=257)


@pytest.mark.parametrize("d", DIVISORS)
def test_divisor_constants_divide_every_uint32(d):
    """The kernel's ``/`` and ``%`` by a size fixed for the launch, mirrored
    in numpy uint64, against ``//`` and ``%`` at the edges (0, d - 1, d,
    2^31, 2^32 - 1) and on a seeded sample; and its randint reduction, which
    skips ``h`` where the multiplier is 0, against ``ops/threefry.py``'s."""
    d_, magic, shift, mult = divisor(d)
    assert d_ == d and 0 < magic < 2**32 and 0 <= shift <= 31
    assert mult == tf.randint_multiplier(d)
    rng = np.random.default_rng(d)
    n = np.concatenate([np.array([0, d - 1, d, 2**31, 2**32 - 1], np.uint64),
                        rng.integers(0, 2**32, 100_000, dtype=np.uint64)])
    u32 = np.uint64(tf.MASK32)

    def quotient(x):
        return (((x * np.uint64(magic)) >> np.uint64(32)) + x) >> np.uint64(shift)

    def remainder(x):
        return x - quotient(x) * np.uint64(d)

    np.testing.assert_array_equal(quotient(n), n // np.uint64(d))
    np.testing.assert_array_equal(remainder(n), n % np.uint64(d))
    h, low = n, rng.permutation(n)
    v = remainder(low)
    if mult:
        v = remainder((remainder(h) * np.uint64(mult) + v) & u32)
    want = (((((h % np.uint64(d)) * np.uint64(mult)) & u32) + low % np.uint64(d)) & u32
            ) % np.uint64(d)
    np.testing.assert_array_equal(v, want)


def test_digest_folds_the_key_in_first():
    """A chain link: the draws of ``fold_in(key, digest)``, which they return."""
    regions, lengths = state(seed=1)
    args = (2, 4, torch.from_numpy(regions), torch.from_numpy(lengths), 6, 64)
    key = jax.random.PRNGKey(5)
    digest = torch.tensor(0xDEADBEEF)
    got = draw_windows(tf.prng_key(5), 0, *args, digest=digest)
    folded = jax.random.fold_in(key, np.uint32(0xDEADBEEF))
    assert got.key.tolist() == np.asarray(folded).astype(np.int64).tolist()
    want = draw_windows(tuple(got.key.tolist()), 0, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_key_tensor_and_its_words_draw_alike():
    regions, lengths = state(seed=2)
    args = (7, 2, 4, torch.from_numpy(regions), torch.from_numpy(lengths), 6, 64)
    a = draw_windows((17, 99), *args)
    b = draw_windows(torch.tensor([17, 99]), *args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_window_starts_wrap_as_jax_int32():
    """Spans near int32's ends and windows longer than a chromosome."""
    regions = np.array([[2**31 - 10, 2**31 - 2], [-(2**31), -(2**31) + 5], [0, 1], [50, 51],
                        [2**30, 2**30 + 7]], np.int32)
    lengths = np.array([10, 2**31 - 1, 400], np.int32)
    r = np.array([0, 1, 2, 3, 4, 0, 1], np.int32)
    c = np.array([0, 1, 2, 1, 1, 2, 0], np.int32)
    for L in (1, 300, 2**31 - 1):
        got = window_starts(torch.from_numpy(regions), torch.from_numpy(lengths),
                            torch.from_numpy(r), torch.from_numpy(c), L)
        np.testing.assert_array_equal(got.numpy(), jax_starts(regions, lengths, r, c, L))


def test_chip_smoke_constants_equal_jax():
    """The draws ``chip_smoke.py`` holds the card to, made here by JAX."""
    c = JAX_DRAWS
    key = jax.random.PRNGKey(c["seed"])
    want = jax_step_draws(key, c["step"], c["sizes"], c["B"])
    assert [c["region"], c["donor"], c["chrom"]] == [w.tolist() for w in want]
    # a lane's draw does not depend on B, so phase 3 reads them off B=64's
    wide = jax_step_draws(key, c["step"], c["sizes"], 64)
    assert [w[:c["B"]].tolist() for w in wide] == [w.tolist() for w in want]
    link = jax.random.fold_in(key, np.uint32(c["digest"]))
    assert c["link_key"] == np.asarray(link).astype(np.int64).tolist()
    # and the port's plain version gives them too
    R, D, C = c["sizes"]
    regions = torch.zeros((R, 2), dtype=torch.int32)
    lengths = torch.full((C,), 10**6, dtype=torch.int32)
    got = draw_windows(tf.prng_key(c["seed"]), c["step"], 1, c["B"], regions, lengths, D,
                       100)
    assert [got.region_idx.tolist(), got.donor_idx.tolist(), got.chrom_idx.tolist()] == [
        c["region"], c["donor"], c["chrom"]]


def test_bad_arguments_raise():
    regions, lengths = (torch.from_numpy(a) for a in state())
    with pytest.raises(OverflowError, match="int32"):
        draw_windows((0, 0), 2**31, 1, 4, regions, lengths, 3, 10)
    with pytest.raises(ValueError, match="sizes"):
        draw_windows((0, 0), 0, 1, 4, regions, lengths, 0, 10)
    with pytest.raises(ValueError, match="n_batches"):
        draw_windows((0, 0), 0, 0, 4, regions, lengths, 3, 10)
    with pytest.raises(ValueError, match="key tensor"):
        draw_windows(torch.tensor([1, 2, 3]), 0, 1, 4, regions, lengths, 3, 10)
    with pytest.raises(ValueError, match="two words"):
        draw_windows((1, 2, 3), 0, 1, 4, regions, lengths, 3, 10)
    with pytest.raises(TypeError, match="int32"):
        draw_windows((1, 2), 0, 1, 4, regions.long(), lengths, 3, 10)
    with pytest.raises(ValueError, match="digest"):
        draw_windows((1, 2), 0, 1, 4, regions, lengths, 3, 10, digest=torch.tensor([1]))


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(card):
    regions, lengths = (torch.from_numpy(a).to(card) for a in state(R=1000, C=12, seed=3))
    shapes = [(n_batches, 64) for n_batches in (1, 16, 256)]
    shapes += [(n_batches, B) for B in ODD_BATCHES for n_batches in (1, 3)]
    for n_batches, B in shapes:
        for key, step0 in (((0, 1), 0), ((2**32 - 1, 5), 2**31 - 300)):
            for digest in (None, torch.tensor(0xABCDEF12, device=card)):
                args = (step0, n_batches, B, regions, lengths, 128, 1000)
                before = draw_windows.launches
                got = draw_windows(key, *args, digest=digest)
                assert draw_windows.launches == before + 1
                want = draws_plain(key, *args, digest=digest)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
                on_card = draw_windows(got.key, *args)  # a key the card holds
                assert all(torch.equal(g, w) for g, w in zip(on_card[1:], want[1:]))
