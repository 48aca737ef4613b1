"""The plain reference against the program on the CPU at small sizes: the
draws, the encode (with variants past K), the digest and the chain bit for
bit; the model's loss, gradients and AdamW steps in float32."""

import numpy as np
import pytest
import torch

from portbench import state as state_mod
from portbench import weights
from portbench.reference import haploformer as rh
from portbench.reference import sampler as rs
from portbench.tests.conftest import TINY_DEPLOYMENT

DEV = torch.device("cpu")
SEED = 4_000_000_017


@pytest.fixture(scope="module")
def state():
    return state_mod.make_state(TINY_DEPLOYMENT, SEED, DEV)


def _sampler(state, L, B, K, seed=SEED):
    from portbench import common

    cfg = {"sampler": {"seq_length": L, "batch_size": B, "max_variants_per_window": K}}
    return common.sampler(state, cfg, seed, DEV)


@pytest.mark.parametrize("L, B, K", [(64, 8, 128), (500, 5, 3), (1000, 3, 1)])
@pytest.mark.parametrize("step", [0, 7, 2**31 - 1])
def test_batches_equal_the_program(state, L, B, K, step):
    b = _sampler(state, L, B, K).batch_at(step)
    w = rs.batch(state, SEED, step, B, L, K, DEV)
    assert torch.equal(b.hap1_codes, w.hap1) and torch.equal(b.hap2_codes, w.hap2)
    assert torch.equal(b.n_variants.long(), w.n_variants)
    assert torch.equal(b.overflow.long(), w.overflow)


def test_some_windows_overflow_k(state):
    w = rs.batch(state, SEED, 3, 16, 1000, 1, DEV)
    assert int(w.overflow.max()) > 0


@pytest.mark.parametrize("key", [(0, 5), (2**32 - 1, 123456789)])
def test_chain_equals_the_program(state, key):
    run = _sampler(state, 64, 4, 8).chain_run(3, 2, key=np.array(key, np.uint32))
    ref = rs.chain(state, key, 3, 2, 4, 64, 8, DEV)
    assert int(run.digest) == ref.digest
    assert torch.equal(run.keys, ref.keys)
    assert torch.equal(run.last.hap1_codes.reshape(-1, 64), ref.last.hap1)
    assert torch.equal(run.last.n_variants.reshape(-1).long(), ref.last.n_variants)


def test_digest_equals_the_program(state):
    from haplohyped_tpu_torch.data.sampler import chain_digest

    b = _sampler(state, 64, 8, 4).batch_at(1)
    w = rs.batch(state, SEED, 1, 8, 64, 4, DEV)
    assert int(chain_digest(b)) == int(rs.digest(w))


def test_fewer_threefry_rounds_change_the_chain(state):
    full = rs.chain(state, (1, 2), 2, 2, 4, 64, 8, DEV)
    cut = rs.chain(state, (1, 2), 2, 2, 4, 64, 8, DEV, rounds=12)
    assert full.digest != cut.digest


CFG = {"num_channels": 5, "d_model": 32, "num_heads": 2, "num_layers": 2, "mlp_ratio": 4,
       "conv_width": 9, "pool": 8}
OPT = {"learning_rate": 3e-4, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 1e-4}


def _program(L, init):
    from haplohyped_tpu_torch.models.haploformer import HaploFormerConfig
    from haplohyped_tpu_torch.models.train import create_train_state

    shape = torch.zeros((2, L), dtype=torch.int8)
    ts = create_train_state(HaploFormerConfig(**CFG, dtype="float32"), (shape, shape),
                            learning_rate=OPT["learning_rate"], device="cpu")
    ts.model.load_state_dict(init)
    return ts


def test_model_leaves_are_the_programs():
    from haplohyped_tpu_torch.models.haploformer import HaploFormer, HaploFormerConfig

    specs = rh.param_specs(CFG, 64)
    model = HaploFormer(HaploFormerConfig(**CFG), 64, 0, "cpu")
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == \
        [(n, s) for n, s, _, _ in specs]


def test_three_float32_steps_equal_the_program(state):
    from haplohyped_tpu_torch.models.train import make_train_step

    L = 64
    init = weights.make(rh.param_specs(CFG, L), SEED, DEV)
    batches = [rs.batch(state, SEED, i, 8, L, 4, DEV) for i in range(3)]
    ts, step, losses = _program(L, init), make_train_step(), []
    for w in batches:
        ts, m = step(ts, w.hap1, w.hap2, w.n_variants)
        losses.append(float(m["loss"]))
    ref = rh.train(CFG, OPT, init, [(w.hap1, w.hap2, w.n_variants) for w in batches])
    assert ref["losses"] == pytest.approx(losses, rel=1e-5)
    median = float(np.median(list(ref["grad"].values())))
    for name, p in ts.model.named_parameters():
        if ref["grad"][name] < 1e-3 * median:  # a key's bias: moved by round-off alone
            continue
        change = float((p.detach() - init[name]).norm())
        assert ref["change"][name] == pytest.approx(change, rel=1e-3, abs=1e-9), name


def test_output_grads_are_the_programs_row_by_row(state):
    """The reference's gradient of the loss with respect to the model's two
    outputs equals the program's backward row by row (float32), and a step
    on the first half of the batch reads ``row_grad_gap`` 1."""
    from haplohyped_tpu_torch.models.train import make_train_step
    from portbench.checks import row_grad_gap
    from portbench.loops.fused_train import OUTPUTS

    L, B = 64, 8
    init = weights.make(rh.param_specs(CFG, L), SEED, DEV)
    w = rs.batch(state, SEED, 0, B, L, 4, DEV)
    ref = rh.train(CFG, OPT, init, [(w.hap1, w.hap2, w.n_variants)])["output_grads"]
    step = make_train_step()
    for rows, want in ((B, 0.0), (B // 2, 1.0)):
        ts, got = _program(L, init), {}

        def on_forward(module, args, out, got=got):
            for k in OUTPUTS:
                out[k].register_hook(lambda g, k=k: got.__setitem__(k, g.detach()))

        hook = ts.model.register_forward_hook(on_forward)
        step(ts, w.hap1[:rows], w.hap2[:rows], w.n_variants[:rows])
        hook.remove()
        assert row_grad_gap(got, ref)[0] == pytest.approx(want, abs=1e-5), rows
    assert row_grad_gap({}, ref)[0] == pytest.approx(1.0)


def test_weights_are_a_function_of_the_seed():
    specs = rh.param_specs(CFG, 64)
    a, b = weights.make(specs, 5, DEV), weights.make(specs, 5, DEV)
    c = weights.make(specs, 6, DEV)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem.conv1.kernel"], c["stem.conv1.kernel"])
    assert torch.allclose(a["block0.ln1.scale"], torch.ones(32), atol=0.1)


def test_sign_share_counts_the_elements_whose_sign_differs():
    from portbench.checks import sign_share

    want = {"a": torch.tensor([1.0, -2.0, 3.0, -4.0]), "b": torch.tensor([0.5, 0.5])}
    got = {"a": torch.tensor([1.0, 2.0, 3.0, -4.0]), "b": torch.tensor([0.5, 0.5])}
    assert sign_share(got, want, ["a", "b"]) == pytest.approx(1 / 6)
    assert sign_share(got, want, ["b"]) == 0.0
    assert sign_share({}, want, ["a", "b"]) == pytest.approx(4 / 6)
