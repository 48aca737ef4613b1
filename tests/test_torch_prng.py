"""The port's threefry stream (``ops/threefry.py``) against ``jax.random``.

Keys, ``fold_in``, ``split``, random bits and ``randint`` of the port must
equal JAX's bit for bit (tolerance 0), on fixed cases and on hypothesis'
keys, steps and spans.  The port reproduces the mode JAX runs by default
(threefry2x32, partitionable, 64-bit types off); the first test pins that
mode, so a change of JAX's default fails here and not as a silent mismatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from haplohyped_tpu_torch.ops import threefry as tf

SEEDS = (0, 1, 42, 2**31 - 1, 2**31, 2**32 + 5, 2**63 - 1, -1, -(2**31), -(2**63))
SPANS = (1, 2, 12, 37, 128, 2**16, 2**16 + 1, 100_000, 2**31 - 1)
words = st.integers(0, 2**32 - 1)
settings.register_profile("threefry", max_examples=40, deadline=None)


def jkey(k0: int, k1: int):
    return jnp.asarray(np.array([k0, k1], np.uint32))


def as_list(a) -> list:
    return np.asarray(a).astype(np.int64).tolist()


def key_tensor(seed: int) -> torch.Tensor:
    """``PRNGKey(seed)`` as the port's functions take it."""
    return torch.tensor(tf.prng_key(seed))


def test_jax_runs_the_mode_the_port_reproduces():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_enable_x64 is False
    assert jax.random.PRNGKey(0).dtype == jnp.uint32


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equals_jax(seed):
    assert tf.prng_key(seed) == tuple(as_list(jax.random.PRNGKey(seed)))


def test_prng_key_outside_int64_raises_as_jax_does():
    for seed in (2**63, -(2**63) - 1):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError, match="int64"):
            tf.prng_key(seed)


def test_threefry_known_answer():
    """Random123's known-answer vectors for threefry2x32 (20 rounds), as
    JAX's own tests check them."""
    cases = [
        ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
    ]
    for key, (x0, x1), want in cases:
        y = tf.threefry2x32(torch.tensor(key), torch.tensor(x0), torch.tensor(x1))
        assert (int(y[0]), int(y[1])) == want


@pytest.mark.parametrize("seed", (0, 7, 2**31 - 1, -5))
@pytest.mark.parametrize("data", (0, 1, 5, 2**31 - 1, 2**31, 2**32 - 1))
def test_fold_in_equals_jax(seed, data):
    want = as_list(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    key = key_tensor(seed)
    assert tf.fold_in(key, data).tolist() == want
    assert tf.fold_in(key, torch.tensor(data)).tolist() == want
    assert tf.fold_in_words(tf.prng_key(seed), data) == tuple(want)


def test_fold_in_of_int32_steps_wraps_as_jax_does():
    """The JAX sampler folds in an int32 step, taken as uint32."""
    key = jax.random.PRNGKey(3)
    for step in (-1, -(2**31)):
        want = as_list(jax.random.fold_in(key, jnp.int32(step)))
        assert tf.fold_in(key_tensor(3), step).tolist() == want
        assert tf.fold_in(key_tensor(3), torch.tensor(step)).tolist() == want


@pytest.mark.parametrize("n", (1, 3, 64, 1000))
def test_split_and_bits_equal_jax(n):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    tkey = torch.tensor(as_list(key))
    assert tf.split(tkey, n).tolist() == as_list(jax.random.split(key, n))
    assert tf.random_bits32(tkey, n).tolist() == as_list(jax.random.bits(key, (n,)))


def test_batched_keys_broadcast():
    """Keys of shape (..., 2): each row as on its own."""
    base = jax.random.PRNGKey(9)
    steps = torch.arange(5)
    keys = tf.fold_in(key_tensor(9), steps)
    assert keys.shape == (5, 2)
    split3 = tf.split(keys, 3)
    assert split3.shape == (5, 3, 2)
    draws = tf.randint(split3[:, 1], 7, 0, 37)
    assert draws.shape == (5, 7)
    for s in range(5):
        k = jax.random.fold_in(base, s)
        assert keys[s].tolist() == as_list(k)
        kd = jax.random.split(k, 3)[1]
        assert draws[s].tolist() == as_list(jax.random.randint(kd, (7,), 0, 37))


@pytest.mark.parametrize("n", (1, 3, 64, 1000))
@pytest.mark.parametrize("span", SPANS)
def test_randint_equals_jax(n, span):
    key = jax.random.fold_in(jax.random.PRNGKey(7), 5)
    tkey = torch.tensor(as_list(key))
    got = tf.randint(tkey, n, 0, span)
    assert got.tolist() == as_list(jax.random.randint(key, (n,), 0, span))
    assert int(got.min()) >= 0 and int(got.max()) < span


@pytest.mark.parametrize("lo,hi", [(-5, 3), (10, 10), (10, 4), (-(2**31), 2**31 - 1)])
def test_randint_bounds_equal_jax(lo, hi):
    key = jax.random.PRNGKey(21)
    got = tf.randint(torch.tensor(as_list(key)), 64, lo, hi)
    assert got.tolist() == as_list(jax.random.randint(key, (64,), lo, hi))


def test_randint_bound_outside_int32_raises():
    with pytest.raises(OverflowError, match="int32"):
        tf.randint(key_tensor(0), 4, 0, 2**31)


def test_randint_multiplier_wraps_in_uint32():
    assert tf.randint_multiplier(37) == ((2**16 % 37) ** 2) % 37
    assert tf.randint_multiplier(2**16) == 0
    assert tf.randint_multiplier(2**16 + 1) == 0  # (2^16)^2 wraps to 0
    assert tf.randint_span(5, 5) == tf.randint_span(5, 1) == 1


@settings(settings.get_profile("threefry"))
@given(k0=words, k1=words, step=st.integers(0, 2**31 - 1), span=st.integers(1, 2**31 - 1))
def test_sampler_draw_equals_jax_on_any_key_step_and_span(k0, k1, step, span):
    """The sampler's chain of calls: fold_in of the step, split in three,
    one randint a field."""
    key = jax.random.fold_in(jkey(k0, k1), step)
    fields = jax.random.split(key, 3)
    tfields = tf.split(tf.fold_in(torch.tensor([k0, k1]), step), 3)
    assert tfields.tolist() == as_list(fields)
    for f in range(3):
        want = as_list(jax.random.randint(fields[f], (9,), 0, span))
        assert tf.randint(tfields[f], 9, 0, span).tolist() == want


@settings(settings.get_profile("threefry"))
@given(k0=words, k1=words, data=words)
def test_fold_in_of_host_words_equals_jax_on_any_key(k0, k1, data):
    """The key-less chain's first key, hashed in Python ints on the host."""
    want = as_list(jax.random.fold_in(jkey(k0, k1), np.uint32(data)))
    assert tf.fold_in_words((k0, k1), data) == tuple(want)
    assert tf.fold_in(torch.tensor([k0, k1]), data).tolist() == want


@settings(settings.get_profile("threefry"))
@given(k0=words, k1=words, x0=words, x1=words)
def test_threefry_hash_equals_jax_on_any_words(k0, k1, x0, x1):
    from jax._src import prng as jax_prng

    want = as_list(jax_prng.threefry_2x32(jkey(k0, k1), jnp.asarray(np.array([x0, x1], np.uint32))))
    y = tf.threefry2x32(torch.tensor([k0, k1]), torch.tensor(x0), torch.tensor(x1))
    assert [int(y[0]), int(y[1])] == want
