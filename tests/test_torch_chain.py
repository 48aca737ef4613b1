"""``DeviceHaplotypeSampler.sample_chain`` and the sampler's ``key=`` in the
PyTorch port, against the JAX package and against a loop written here.

The chain draws the JAX package's stream: link 0 is ``sample_many(n,
key=k)`` and link ``k + 1`` draws under ``fold_in(key_k, digest_k)``.  So
its digest must equal the JAX package's ``sample_chain`` for the same key
(or seed and step), and its links' keys the ones ``jax.random`` makes in a
loop written here (tolerance 0).  Every other check is exact too.
"""

import jax
import numpy as np
import pytest
import torch

from haplohyped_tpu_torch.data.sampler import HaplotypeBatch, chain_digest
from haplohyped_tpu_torch.ops.draw_kernel import draw_windows
from haplohyped_tpu_torch.ops.window_kernel import encode_windows_kernel

from tests.test_torch_sampler import BATCH_FIELDS, both_samplers

M32 = (1 << 32) - 1
CFG = dict(seq_length=128, batch_size=6, seed=4, max_variants_per_window=16)


def key_words(key) -> list[int]:
    return np.asarray(key).astype(np.int64).tolist()


def host_digest(b) -> int:
    """The JAX chain digest of a batch, in numpy."""
    codes1, codes2 = (np.asarray(getattr(b, n)).astype(np.int64) for n in ("hap1_codes", "hap2_codes"))
    d = int((codes1 & 1).sum() & 1) ^ (int((codes2 & 1).sum() & 1) << 1)
    d ^= int(np.asarray(b.n_variants).astype(np.uint64).sum()) & M32
    if np.asarray(b.hap1).ndim > codes1.ndim:
        o1, o2 = ((np.asarray(getattr(b, n)).astype(np.int64) & 1).sum() & 1 for n in ("hap1", "hap2"))
        d ^= (int(o1) << 2) ^ (int(o2) << 3)
    return d


def torch_batch(b) -> HaplotypeBatch:
    leaves = {n: torch.from_numpy(np.array(getattr(b, n))) for n in BATCH_FIELDS}
    return HaplotypeBatch(**leaves)


@pytest.mark.parametrize("emit_onehot", [False, True])
def test_digest_equals_jax_chain_on_jax_windows(emit_onehot):
    """Link 0 of the JAX chain is ``sample_many(n, key=k)``; link 1 is the
    same call on ``fold_in(k, digest 0)``; the chain returns their sum."""
    js, _ = both_samplers(CFG, emit_onehot=emit_onehot)
    key = jax.random.PRNGKey(17)
    d0 = int(chain_digest(torch_batch(js.sample_many(3, key=key))))
    assert d0 == int(np.asarray(js.sample_chain(1, 3, key=key)))
    assert d0 == host_digest(js.sample_many(3, key=key))
    key1 = jax.random.fold_in(key, np.uint32(d0))
    d1 = int(chain_digest(torch_batch(js.sample_many(3, key=key1))))
    assert (d0 + d1) & M32 == int(np.asarray(js.sample_chain(2, 3, key=key)))
    assert js._step == 0


def test_digest_reads_every_leaf():
    _, ps = both_samplers(CFG, emit_onehot=True)
    b = ps.sample_many(2)
    d = int(chain_digest(b))
    assert 0 <= d <= M32 and d == host_digest(b)
    for name, bit in (("hap1_codes", 1), ("hap2_codes", 2), ("hap1", 4), ("hap2", 8)):
        t = getattr(b, name).clone()
        t.view(-1)[7] += 1  # one more odd byte flips that leaf's parity
        assert int(chain_digest(b._replace(**{name: t}))) == d ^ bit, name
    nv = b.n_variants.clone()
    nv.view(-1)[0] += 5
    old = int(b.n_variants.sum())
    assert int(chain_digest(b._replace(n_variants=nv))) == d ^ old ^ (old + 5)


@pytest.mark.parametrize("emit_onehot", [False, True])
def test_chain_equals_a_loop_written_here(emit_onehot):
    """The chain against ``windows_from_draws`` of each link's JAX draws
    (steps ``0 .. n - 1`` of the link's key), the digests taken in numpy and
    the next key made by ``jax.random.fold_in``."""
    js, ps = both_samplers(CFG, emit_onehot=emit_onehot)
    n_chain, n_batches = 4, 3
    sizes = (ps._regions.shape[0], ps.cohort.num_donors, len(ps.genome.chrom_names))
    key, total, keys = jax.random.PRNGKey(99), 0, []
    for _ in range(n_chain):
        keys.append(key_words(key))
        draws = [jax_draws_of_key(key, s, *sizes, CFG["batch_size"]) for s in range(n_batches)]
        b = ps.windows_from_draws(*(torch.cat(t) for t in zip(*draws)))
        d = host_digest(b)
        total = (total + d) & M32
        key = jax.random.fold_in(key, np.uint32(d))
    run = ps.chain_run(n_chain, n_batches, key=99)
    assert run.digest.dtype == torch.int64 and run.digest.shape == ()
    assert int(run.digest) == total == int(np.asarray(js.sample_chain(n_chain, n_batches,
                                                                      key=jax.random.PRNGKey(99))))
    assert run.keys.dtype == torch.int64 and run.keys.tolist() == keys
    for name in BATCH_FIELDS:
        want = getattr(b, name)
        assert torch.equal(getattr(run.last, name), want.view(n_batches, -1, *want.shape[1:])), name
    assert (run.last.hap1 is run.last.hap1_codes) == (not emit_onehot)
    assert int(ps.sample_chain(n_chain, n_batches, key=99)) == total
    assert ps._step == 0


def jax_draws_of_key(key, step, R, D, C, B):
    """The JAX sampler's draws of step ``step`` of ``key``."""
    kr, kd, kc = jax.random.split(jax.random.fold_in(key, step), 3)
    return tuple(
        torch.from_numpy(np.array(jax.random.randint(k, (B,), 0, n), dtype=np.int32))
        for k, n in ((kr, R), (kd, D), (kc, C))
    )


@pytest.mark.parametrize("emit_onehot", [False, True])
@pytest.mark.parametrize("keyed", [True, False])
def test_chain_digest_equals_jax_sample_chain(emit_onehot, keyed):
    """Keyed: the same key on both sides.  Key-less: both start from
    ``fold_in(PRNGKey(seed), step counter)`` after a ``sample()``, and both
    counters advance alike."""
    js, ps = both_samplers(CFG, emit_onehot=emit_onehot)
    if keyed:
        jkey = jax.random.fold_in(jax.random.PRNGKey(31), 2)
        got = ps.sample_chain(3, 2, key=np.asarray(jkey))
        want = js.sample_chain(3, 2, key=jkey)
    else:
        ps.sample(), js.sample()
        got, want = ps.sample_chain(3, 2), js.sample_chain(3, 2)
        assert ps._step == js._step == 7
        assert int(ps.sample_chain(2, 2)) == int(np.asarray(js.sample_chain(2, 2)))
    assert int(got) == int(np.asarray(want))


@pytest.mark.parametrize("emit_onehot", [False, True])
def test_chain_link_zero_is_sample_many_of_the_key(emit_onehot):
    _, ps = both_samplers(CFG, emit_onehot=emit_onehot)
    run = ps.chain_run(3, 4, key=13)
    first = ps.chain_run(1, 4, key=13)
    many = ps.sample_many(4, key=13)
    assert run.keys[0].tolist() == key_words(jax.random.PRNGKey(13))
    for name in BATCH_FIELDS:
        assert torch.equal(getattr(first.last, name), getattr(many, name)), name
    assert int(first.digest) == int(chain_digest(many))


def test_chain_is_deterministic_for_a_key_and_changes_with_it():
    _, a = both_samplers(CFG)
    _, b = both_samplers(CFG)
    digests = {k: int(a.sample_chain(3, 2, key=k)) for k in (1, 2, 3)}
    assert digests[1] == int(b.sample_chain(3, 2, key=1)) == int(a.sample_chain(3, 2, key=1))
    assert len(set(digests.values())) == 3
    # a link's key depends on every link before it
    k1, k2 = a.chain_run(3, 2, key=1).keys, a.chain_run(3, 2, key=2).keys
    assert not torch.equal(k1, k2) and len(set(map(tuple, k1.tolist()))) == 3


def test_keyless_chain_advances_the_step():
    _, a = both_samplers(CFG)
    _, b = both_samplers(CFG)
    first = int(a.sample_chain(2, 3))
    assert a._step == 6
    start = jax.random.fold_in(jax.random.PRNGKey(CFG["seed"]), 0)
    assert first == int(b.sample_chain(2, 3, key=key_words(start))) and b._step == 0
    second = int(a.sample_chain(2, 3))
    assert a._step == 12 and second != first
    # the counter it advances is the one sample() reads
    assert torch.equal(a.sample().hap1_codes, b.sample_many(13).hap1_codes[12])
    with pytest.raises(ValueError, match=">= 1"):
        a.sample_chain(0, 3)


def test_sample_with_a_key_leaves_the_step_alone():
    _, ps = both_samplers(CFG)
    _, fresh = both_samplers(CFG)
    ps.sample()
    assert ps._step == 1
    keyed = ps.sample(key=CFG["seed"])
    assert ps._step == 1
    first = fresh.sample()
    for name in BATCH_FIELDS:
        assert torch.equal(getattr(keyed, name), getattr(first, name)), name
    many = ps.sample_many(3, key=8)
    assert ps._step == 1
    assert torch.equal(many.hap1_codes[0], ps.sample(key=8).hap1_codes)
    _, other = both_samplers(CFG | dict(seed=8))
    assert torch.equal(many.hap2_codes, other.sample_many(3).hap2_codes)
    assert not torch.equal(many.hap1_codes, ps.sample_many(3, key=9).hap1_codes)
    assert ps._step == 1


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("emit_onehot", [False, True])
def test_graph_chain_equals_the_eager_plain_chain_on_card(card, emit_onehot):
    _, cpu = both_samplers(CFG, emit_onehot=emit_onehot)
    gpu = type(cpu)(cpu.genome, cpu.cohort, cpu._regions.numpy(), cpu.config,
                    emit_onehot=emit_onehot, device=card)
    want = gpu.chain_run(3, 4, key=5, kernel="baseline")
    gpu.chain_run(3, 4, key=5)  # warms up and captures the graph
    before = encode_windows_kernel.launches, draw_windows.launches
    got = gpu.chain_run(3, 4, key=5)
    assert (encode_windows_kernel.launches - before[0], draw_windows.launches - before[1]) == (3, 3)
    assert int(got.digest) == int(want.digest) == int(cpu.sample_chain(3, 4, key=5))
    assert torch.equal(got.keys.cpu(), want.keys.cpu())
    assert torch.equal(got.keys.cpu(), cpu.chain_run(3, 4, key=5).keys)
    for name in BATCH_FIELDS:
        assert torch.equal(getattr(got.last, name).cpu(), getattr(want.last, name).cpu()), name
    gpu.chain_run(2, 4, key=5)  # another shape: only its graph is kept
    assert gpu._chain_graph_cache[0] == (2, 4, emit_onehot)
    assert int(gpu.chain_run(3, 4, key=5).digest) == int(want.digest)
