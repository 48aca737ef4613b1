"""``DeviceHaplotypeSampler.sample_chain`` and the sampler's ``key=`` in the
PyTorch port, against the JAX package and against a loop written here.

The chain's draws are the port's own (counter-based, so the card can replay
them in a CUDA graph), so only the digest is held against the JAX package:
``chain_digest`` of the JAX sampler's own windows must equal the JAX chain's
result (tolerance 0).  Every other check is exact too.
"""

import jax
import numpy as np
import pytest
import torch

from haplohyped_tpu_torch.data.sampler import (
    HaplotypeBatch,
    _step_seed,
    chain_digest,
    counter_draws,
)
from haplohyped_tpu_torch.ops.window_kernel import encode_windows_kernel

from tests.test_torch_sampler import BATCH_FIELDS, both_samplers

M64, M32 = (1 << 64) - 1, (1 << 32) - 1
GOLDEN, DIGEST_MUL = 0x9E3779B97F4A7C15, 0xD1B54A32D192ED03
CFG = dict(seq_length=128, batch_size=6, seed=4, max_variants_per_window=16)


def mix64(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def signed(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def host_draws(seed: int, n: int, sizes) -> list[list[int]]:
    """The counter draws as Python ints: output ``i * F + f`` of splitmix64
    from ``seed``, reduced from its high 32 bits."""
    F = len(sizes)
    return [
        [((mix64((seed + (i * F + f + 1) * GOLDEN) & M64) >> 32) * size) >> 32 for i in range(n)]
        for f, size in enumerate(sizes)
    ]


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


def test_counter_draws_match_splitmix64_on_the_host():
    sizes = (100_000, 128, 12)
    for seed in (0, 1, 0xDEADBEEFCAFEBABE, M64):
        got = counter_draws(torch.tensor([signed(seed)]), 257, sizes)
        assert all(g.dtype == torch.int32 and g.is_contiguous() for g in got)
        assert [g.tolist() for g in got] == host_draws(seed, 257, sizes)
    # the draws spread over every value of a small range
    few = counter_draws(torch.tensor([5]), 4000, (12,))[0]
    assert sorted(set(few.tolist())) == list(range(12))


@pytest.mark.parametrize("emit_onehot", [False, True])
def test_chain_equals_a_loop_written_here(emit_onehot):
    """The chain against ``windows_from_draws`` of each link's draws, the
    digests taken in numpy and the seeds mixed in Python ints."""
    _, ps = both_samplers(CFG, emit_onehot=emit_onehot)
    n_chain, n_batches, key = 4, 3, 99
    sizes = (ps._regions.shape[0], ps.cohort.num_donors, len(ps.genome.chrom_names))
    seed, total, seeds = _step_seed(key, 0), 0, []
    for _ in range(n_chain):
        seeds.append(signed(seed))
        draws = host_draws(seed, n_batches * CFG["batch_size"], sizes)
        b = ps.windows_from_draws(*(torch.tensor(d, dtype=torch.int32) for d in draws))
        d = host_digest(b)
        total = (total + d) & M32
        seed = mix64(seed ^ ((d * DIGEST_MUL) & M64))
    run = ps.chain_run(n_chain, n_batches, key=key)
    assert run.digest.dtype == torch.int64 and run.digest.shape == ()
    assert int(run.digest) == total
    assert run.seeds.tolist() == seeds
    for name in BATCH_FIELDS:
        want = getattr(b, name)
        assert torch.equal(getattr(run.last, name), want.view(n_batches, -1, *want.shape[1:])), name
    assert (run.last.hap1 is run.last.hap1_codes) == (not emit_onehot)
    assert int(ps.sample_chain(n_chain, n_batches, key=key)) == total
    assert ps._step == 0


def test_chain_is_deterministic_for_a_key_and_changes_with_it():
    _, a = both_samplers(CFG)
    _, b = both_samplers(CFG)
    digests = {k: int(a.sample_chain(3, 2, key=k)) for k in (1, 2, 3)}
    assert digests[1] == int(b.sample_chain(3, 2, key=1)) == int(a.sample_chain(3, 2, key=1))
    assert len(set(digests.values())) == 3
    # a link's seed depends on every link before it
    s1, s2 = a.chain_run(3, 2, key=1).seeds, a.chain_run(3, 2, key=2).seeds
    assert not torch.equal(s1, s2) and len(set(s1.tolist())) == 3


def test_keyless_chain_advances_the_step():
    _, a = both_samplers(CFG)
    _, b = both_samplers(CFG)
    first = int(a.sample_chain(2, 3))
    assert a._step == 6
    assert first == int(b.sample_chain(2, 3, key=CFG["seed"])) and b._step == 0
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
    before = encode_windows_kernel.launches
    got = gpu.chain_run(3, 4, key=5)
    assert encode_windows_kernel.launches - before == 3
    assert int(got.digest) == int(want.digest) == int(cpu.sample_chain(3, 4, key=5))
    assert torch.equal(got.seeds.cpu(), want.seeds.cpu())
    for name in BATCH_FIELDS:
        assert torch.equal(getattr(got.last, name).cpu(), getattr(want.last, name).cpu()), name
    seed = torch.tensor([123456789])
    assert all(torch.equal(g.cpu(), c) for g, c in zip(
        gpu.chain_draws(seed.to(card), 4), cpu.chain_draws(seed, 4)))
    gpu.chain_run(2, 4, key=5)  # another shape: only its graph is kept
    assert gpu._chain_graph_cache[0] == (2, 4, emit_onehot)
    assert int(gpu.chain_run(3, 4, key=5).digest) == int(want.digest)
