"""Enformer (``models/enformer.py``) and its train path on the CPU, at a
small size (64 channels, 2 blocks of 2 heads, 8,192-bp windows, 32 target
bins, 7 tracks), against the benchmark's plain reference
(``portbench/reference/enformer.py``, float32 plain PyTorch written from
the published equations) on seeded weights whose biases and norm scales are
off zero and one.

Tolerances, float32 on both sides, where only the order of sums differs:

- rates and loss: ``1e-5`` relative;
- gradients: ``1e-4`` of the median leaf's norm for every element, and
  ``1e-3`` relative to its own norm for each leaf the gradient moves (at
  least ``TINY_GRAD`` of the median leaf's).  The conv biases that feed a
  batch norm have a gradient of round-off alone (a millionth of the
  median), so only the absolute floor holds for them;
- after three fused steps with dropout on and the clip acting: the losses
  ``1e-5`` relative, and each moved leaf's change ``1e-3`` relative (Adam's
  step is a ratio of gradient moments, which the round-off above enters).

The positional bases, in float64, are held to their closed forms (the
gamma density from ``scipy.stats``) at ``1e-6`` relative, and the float32
features to the reference's at ``1e-5``; ``relative_shift`` to an index
gather exactly.
"""

import math
import statistics

import numpy as np
import pytest
import scipy.stats
import torch

from haplohyped_tpu_torch.models import enformer as E
from haplohyped_tpu_torch.models import train
from portbench import weights
from portbench.checks import TINY_GRAD
from portbench.reference import enformer as ref
from tests.test_torch_train import cpu_sampler

SMALL = dict(channels=64, num_transformer_layers=2, num_heads=2, key_size=8, value_size=32,
             num_relative_position_features=12, divisible_by=16, sequence_length=8192,
             target_length=32, dtype="float32")
HEADS = {"human": 7}
CFG = E.EnformerConfig(**SMALL, heads=HEADS)
#: the reference's view of the same model
M = {k: getattr(CFG, k) for k in CFG.__dataclass_fields__ if k != "heads"}
OPT = {"learning_rate": 5e-4, "betas": [0.9, 0.999], "eps": 1e-8, "clip_global_norm": 0.2}
B, L = 2, 8192
SEED = 2**31 + 77


def _model(seed=SEED):
    init = weights.make(ref.param_specs(M, HEADS), seed, torch.device("cpu"))
    x = torch.zeros((B, L), dtype=torch.int8)
    state = train.create_train_state(CFG, (x, x), OPT["learning_rate"], seed=seed, device="cpu")
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            p.copy_(init[k])
    return state, init


def _windows(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 5, (B, L), generator=g, dtype=torch.int8),
            torch.randint(0, 5, (B, L), generator=g, dtype=torch.int8),
            torch.randn((B, 32, 7), generator=g).exp())


def test_published_sizes():
    full = E.EnformerConfig()
    assert full.filter_list == [768, 896, 1024, 1152, 1280, 1536]
    assert full.bin_size == 128 and full.sequence_length // full.bin_size == 1536
    assert (full.channels, full.num_transformer_layers, full.num_heads, full.key_size,
            full.value_size, full.num_relative_position_features) == (1536, 11, 8, 64, 192, 192)
    assert full.num_tracks == 5313 and full.clip_global_norm == 0.2
    spec = ref.param_specs({k: getattr(full, k) for k in full.__dataclass_fields__}, full.heads)
    n = sum(math.prod(shape) for _, shape, _, _ in spec)
    assert 240e6 < n < 260e6  # about 250 M parameters
    with pytest.raises(ValueError, match="one head"):
        E.EnformerConfig(heads={"human": 5313, "mouse": 1643})
    with pytest.raises(ValueError, match="multiple"):
        E.EnformerConfig(sequence_length=1000)


def test_leaves_are_the_references():
    state, _ = _model()
    names = [n for n, _ in state.model.named_parameters()]
    spec = ref.param_specs(M, HEADS)
    assert names == [n for n, _, _, _ in spec]
    assert [tuple(p.shape) for p in state.model.parameters()] == [s for _, s, _, _ in spec]


def test_rates_loss_and_every_gradient_match_the_reference():
    state, init = _model()
    h1, h2, y = _windows(1)
    model = state.model
    out = model(h1, h2)["rates"]  # no generator: no dropout
    loss = E.poisson_loss(out, y)
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    want = ref.Model(M).rates(p, h1, h2, None)
    want_loss = ref.poisson(want, y)
    grads = dict(zip(p, torch.autograd.grad(want_loss, list(p.values()))))
    assert out.shape == (B, 32, 7)
    torch.testing.assert_close(out, want.detach(), rtol=1e-5, atol=0)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    norms = {k: float(g.norm()) for k, g in grads.items()}
    med = statistics.median(norms.values())
    for k, prm in model.named_parameters():
        torch.testing.assert_close(prm.grad, grads[k], rtol=0, atol=1e-4 * med, msg=k)
        if norms[k] >= TINY_GRAD * med:
            assert float((prm.grad - grads[k]).norm()) <= 1e-3 * norms[k], k


def test_three_fused_steps_with_dropout_and_the_clip_match_the_reference():
    sampler = cpu_sampler(L=L, batch_size=B, seed=4)
    state, init = _model()
    ys = {i: _windows(10 + i)[2] for i in range(3)}
    seen = []

    def targets(step, batch):
        seen.append((batch.hap1, batch.hap2))
        return ys[step]

    fused = train.make_fused_train_step(sampler, targets=targets)
    losses = []
    for i in range(3):
        state, m = fused(state, i)
        losses.append(float(m["loss"]))
    assert state.step == 3 and state.generator is not None
    batches = [(h1, h2, ys[i]) for i, (h1, h2) in enumerate(seen)]
    want = ref.train(M, HEADS, OPT, init, batches, SEED, torch.device("cpu"))
    assert want["grad_norm_before_clip"] > 2 * OPT["clip_global_norm"]  # the clip acts
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    med = statistics.median(want["grad"].values())
    moved = [k for k, g in want["grad"].items() if g >= TINY_GRAD * med]
    assert len(moved) >= 85
    for k, prm in state.model.named_parameters():
        if k in moved:
            assert float((prm.detach() - init[k]).norm()) == pytest.approx(
                want["change"][k], rel=1e-3), k
    # without the generator the same steps draw no masks: the losses move
    state2, _ = _model()
    h1, h2, y = batches[0]
    _, m2 = train._train_step(state2._replace(generator=None), h1, h2, None, targets=y)
    assert float(m2["loss"]) != pytest.approx(losses[0], rel=1e-4)


def test_dropout_masks_follow_the_documented_order(monkeypatch):
    """The masks the program draws, in order, are the reference's."""
    state, _ = _model()
    h1, h2, _ = _windows(2)
    g = torch.Generator().manual_seed(9)
    drawn = []
    real = torch.rand

    def spy(*a, **k):
        out = real(*a, **k)
        drawn.append(out)
        return out

    monkeypatch.setattr(torch, "rand", spy)
    state.model(h1, h2, g)
    monkeypatch.undo()
    want = ref.draw_masks(M, torch.Generator().manual_seed(9), 2 * B, torch.device("cpu"))
    block = [CFG.positional_dropout_rate, CFG.attention_dropout_rate] + [CFG.dropout_rate] * 3
    rates = block * CFG.num_transformer_layers + [CFG.final_dropout_rate]
    assert len(drawn) == len(want) == 11
    for u, w, r in zip(drawn, want, rates):
        assert torch.equal(u >= r, w)


def test_swapping_the_haplotypes_leaves_the_rates():
    state, _ = _model()
    h1, h2, _ = _windows(3)
    a = state.model(h1, h2)["rates"]
    b = state.model(h2, h1)["rates"]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("T", [64, 1536])
def test_positional_bases_are_their_closed_forms(T):
    n = 32
    d = torch.arange(-T + 1, T, dtype=torch.float64)
    a = d.abs().double().numpy()[:, None]
    half = 2.0 ** np.linspace(3.0, math.log2(T), n)
    np.testing.assert_allclose(E.positional_features_exponential(d, n, T).numpy(),
                               np.exp(-math.log(2) * a / half), rtol=1e-6, atol=0)
    widths = 2.0 ** np.arange(1, n + 1) - 1
    np.testing.assert_array_equal(E.positional_features_central_mask(d, n).numpy(),
                                  (widths > a).astype(np.float64))
    mean = np.linspace(T / n, T, n)
    sd = T / (2 * n)
    pdf = scipy.stats.gamma.pdf(a, (mean / sd) ** 2, scale=sd**2 / mean) + 1e-8
    np.testing.assert_allclose(E.positional_features_gamma(d, n, T).numpy(),
                               pdf / pdf.max(axis=0, keepdims=True), rtol=1e-6, atol=0)
    feats = E.relative_position_features(T, 6 * n)
    assert feats.shape == (2 * T - 1, 6 * n)
    assert feats.dtype == torch.float32
    np.testing.assert_array_equal(feats[:, 3 * n:].numpy(),
                                  (torch.sign(d)[:, None] * feats[:, : 3 * n]).numpy())
    np.testing.assert_allclose(feats.numpy(), ref.position_features(T, 6 * n, "cpu").numpy(),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_relative_shift_is_an_index_gather(T):
    x = torch.randn(3, 2, T, 2 * T - 1)
    i = torch.arange(T)
    idx = (i[None, :] - i[:, None] + T - 1).expand(3, 2, T, T)
    assert torch.equal(E.relative_shift(x), torch.gather(x, -1, idx))


def test_the_train_path_refuses_what_it_does_not_take():
    x = torch.zeros((B, L), dtype=torch.int8)
    short = torch.zeros((B, 4096), dtype=torch.int8)
    with pytest.raises(ValueError, match="sequence_length"):
        train.create_train_state(CFG, (short, short), device="cpu")
    with pytest.raises(ValueError, match="one device"):
        train.create_train_state(CFG, (x, x), device="cpu", mesh=object())
    state, _ = _model()
    with pytest.raises(ValueError, match="targets"):
        train._train_step(state, x, x, None)
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert state.optimizer.param_groups[0]["weight_decay"] == 0.0


def test_eval_mode_takes_the_moving_statistics_and_no_dropout():
    """Training updates each batch norm's moving averages (decay 0.9); in
    eval mode the model reads them, draws no masks and gives one answer."""
    state, _ = _model()
    h1, h2, _ = _windows(4)
    bn = state.model.stem.pointwise.norm
    state.model(h1, h2, torch.Generator().manual_seed(1))
    assert not torch.equal(bn.moving_mean, torch.zeros_like(bn.moving_mean))
    state.model.eval()
    a = state.model(h1, h2, torch.Generator().manual_seed(1))["rates"]
    b = state.model(h1, h2, torch.Generator().manual_seed(2))["rates"]
    assert torch.equal(a, b)
    state.model.train()
    c = state.model(h1, h2)["rates"]
    assert not torch.allclose(a, c)
