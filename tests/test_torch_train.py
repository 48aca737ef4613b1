"""Loss, gradients, AdamW and the train step of the PyTorch port against the
JAX package's ``models/train.py``; the fused step, checkpoints and
``train_on_sampler`` of the port on a CPU sampler.

The JAX side runs jitted, with flax's params carried across by
``convert.params_from_flax``.  Tolerances (float32 on the CPU; only the
order of sums differs):

- loss, ``reg`` and ``ce``: ``1e-5`` relative;
- gradients: ``1e-4`` relative to each tensor's largest value, floored at
  ``1e-3`` of the largest gradient (the attention key biases' gradient is
  zero up to round-off: softmax ignores a shift shared by every key);
- AdamW fed the same gradients: ``1e-6`` absolute and relative;
- parameters after two train steps: ``1e-5`` relative and ``0.05 * lr``
  absolute.  Adam's step is ``lr`` times a ratio of gradient moments, which
  amplifies the gradients' ``1e-5`` where two steps' gradients nearly
  cancel; the key biases, whose gradient is round-off, may move by up to
  ``lr`` a step either way.

The fused step, checkpoint resume and the carry-across are bit-equal.  The
port's sampler draws the JAX package's stream, so the fused step's batch at
step ``s`` is bit-equal to the JAX package's ``_sample_batch(base_key, s)``,
and the fused step and ``train_on_sampler`` from flax's params carried over
by ``convert`` report metrics within the loss's ``1e-5`` of JAX's.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from haplohyped_tpu.data.sampler import _sample_batch
from haplohyped_tpu.models import train as jax_train
from haplohyped_tpu.models.haploformer import HaploFormer as JaxHaploFormer
from haplohyped_tpu.models.haploformer import HaploFormerConfig as JaxConfig
from haplohyped_tpu_torch import convert, train_on_sampler
from haplohyped_tpu_torch.models import train
from haplohyped_tpu_torch.models.haploformer import HaploFormerConfig
from tests.torch_cpu_sampler import SMALL, cpu_sampler

WIDTHS = dict(d_model=32, num_heads=2, num_layers=2, dtype="float32")
B = 4
LR = 3e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[128, 333], ids=lambda L: f"L{L}")
def case(request):
    """Inputs of window length L, flax's params, and the JAX loss and
    gradients there."""
    L = request.param
    rng = np.random.default_rng(L + 1)
    h1, h2 = (rng.integers(0, 5, (B, L)).astype(np.int8) for _ in range(2))
    nv = rng.integers(0, 12, B).astype(np.int32)
    jm = JaxHaploFormer(JaxConfig(**WIDTHS))
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), h1, h2)["params"]
    vg = jax.jit(lambda p: jax.value_and_grad(jax_train.loss_fn, has_aux=True)(p, jm, h1, h2, nv))
    (loss, aux), grads = vg(params)
    return SimpleNamespace(L=L, h1=h1, h2=h2, nv=nv, jm=jm, params=params, vg=vg,
                           loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                           grads=convert._flatten(jax.device_get(grads)))


def port_state(case, seed=1) -> train.TrainState:
    state = train.create_train_state(HaploFormerConfig(**WIDTHS), (case.h1, case.h2),
                                     learning_rate=LR, seed=seed, device="cpu")
    state.model.load_state_dict(convert.params_from_flax(jax.device_get(case.params)))
    return state


def test_loss_matches_jax(case):
    state = port_state(case)
    with torch.no_grad():
        loss, aux = train.loss_fn(state.model, _t(case.h1), _t(case.h2), _t(case.nv))
    np.testing.assert_allclose(float(loss), case.loss, rtol=1e-5)
    for k in ("reg", "ce"):
        np.testing.assert_allclose(float(aux[k]), case.aux[k], rtol=1e-5, err_msg=k)


def test_gradients_match_jax(case):
    state = port_state(case)
    loss, _ = train.loss_fn(state.model, _t(case.h1), _t(case.h2), _t(case.nv))
    loss.backward()
    floor = 1e-3 * max(np.abs(g).max() for g in case.grads.values())
    names = [n for n, _ in state.model.named_parameters()]
    assert sorted(names) == sorted(case.grads)
    for n, p in state.model.named_parameters():
        want = case.grads[n]
        err = np.abs(p.grad.numpy() - want).max() / max(np.abs(want).max(), floor)
        assert err <= 1e-4, (n, err)


def test_token_targets_break_a_tie_to_the_first_channel():
    """A pool of 8 ties 4/4 often; both libraries take the first maximum."""
    rng = np.random.default_rng(4)
    h = rng.integers(0, 5, (3, 64)).astype(np.int8)
    h[0, :8] = [3, 1, 3, 1, 1, 3, 3, 1]  # 4/4 between channels 1 and 3
    h[0, 8:16] = [4, 2, 4, 2, 2, 4, 2, 4]  # 4/4 between channels 2 and 4
    h[1, :8] = [0, 1, 2, 3, 0, 1, 2, 3]  # 2/2/2/2
    h[2, :8] = 7  # codes outside the channels: a zero row, argmax 0
    got = train.token_targets(_t(h), 8, 8, 5)
    oh = jax.nn.one_hot(h, 5, dtype=jnp.float32)
    want = np.asarray(jnp.argmax(oh[:, :64].reshape(3, 8, 8, 5).sum(axis=2), axis=-1))
    assert np.array_equal(got.numpy(), want)
    assert got[0, 0] == 1 and got[0, 1] == 2 and got[1, 0] == 0 and got[2, 0] == 0


def test_adamw_matches_optax_on_jax_gradients(case):
    """Three steps, each fed the JAX gradients at JAX's current params."""
    state = port_state(case)
    tx = optax.adamw(LR)
    params, opt_state = case.params, tx.init(case.params)
    for _ in range(3):
        (_, _), grads = case.vg(params)
        for n, p in state.model.named_parameters():
            p.grad = _t(convert._flatten(jax.device_get(grads))[n])
        state.optimizer.step()
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    want = convert._flatten(jax.device_get(params))
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6, atol=1e-6, err_msg=n)


def test_two_train_steps_match_jax(case):
    tx = optax.adamw(LR)
    jstate = jax_train.TrainState(case.params, tx.init(case.params), jnp.zeros((), jnp.int32))
    jstep = jax_train.make_train_step(case.jm, tx)
    state, step = port_state(case), train.make_train_step()
    for _ in range(2):
        jstate, jm = jstep(jstate, case.h1, case.h2, case.nv)
        state, m = step(state, _t(case.h1), _t(case.h2), _t(case.nv))
        assert set(m) == {"loss", "reg", "ce"} and not m["loss"].requires_grad
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == 2
    want = convert._flatten(jax.device_get(jstate.params))
    for n, p in state.model.named_parameters():
        got = p.detach().numpy()
        if n.endswith("attn.key.bias"):
            assert np.abs(got - want[n]).max() <= 2 * LR * 2, n
        else:
            np.testing.assert_allclose(got, want[n], rtol=1e-5, atol=0.05 * LR, err_msg=n)


# ---------------------------------------------------------------------------
# the port's own: fused step, checkpoints, train_on_sampler
# ---------------------------------------------------------------------------



def _params(state):
    return [p.detach().clone() for p in state.model.parameters()]


def test_fused_step_equals_sample_then_step():
    sampler = cpu_sampler()
    first = sampler.sample()
    a = train.create_train_state(SMALL, (first.hap1, first.hap2), seed=5, device="cpu")
    b = train.create_train_state(SMALL, (first.hap1, first.hap2), seed=5, device="cpu")
    fused, step = train.make_fused_train_step(sampler), train.make_train_step()
    for i in (1, 2):
        batch = sampler.sample()  # step i
        a, ma = step(a, batch.hap1, batch.hap2, batch.n_variants)
        b, mb = fused(b, i)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(_params(a), _params(b)))
    assert a.step == b.step == 2


def test_checkpoint_resume_is_bit_equal(tmp_path):
    sampler = cpu_sampler(seed=1)
    batches = [sampler.sample() for _ in range(3)]
    args = [(x.hap1, x.hap2, x.n_variants) for x in batches]
    step = train.make_train_step()
    run = train.create_train_state(SMALL, args[0][:2], seed=2, device="cpu")
    run, _ = step(run, *args[0])
    run, _ = step(run, *args[1])
    path = train.save_checkpoint(run, str(tmp_path))
    assert path.endswith("step_2")
    run, m_run = step(run, *args[2])

    other = train.create_train_state(SMALL, args[0][:2], seed=9, device="cpu")
    resumed = train.restore_checkpoint(path, other)
    assert resumed.step == 2
    resumed, m_res = step(resumed, *args[2])
    assert all(torch.equal(m_run[k], m_res[k]) for k in m_run)
    assert all(torch.equal(x, y) for x, y in zip(_params(run), _params(resumed)))
    sa, sb = run.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])


def test_train_on_sampler_on_the_cpu():
    sampler = cpu_sampler(seed=2)
    state, losses = train_on_sampler(sampler, SMALL, steps=5, log_every=2)
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert state.step == 5 and sampler._step == 6  # the first batch only sizes the model
    assert state.model.pos_embed.shape == (1, 16, 16)


def test_create_train_state_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    x = torch.zeros((2, 128), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.create_train_state(SMALL, (x, x))


# ---------------------------------------------------------------------------
# the fused step and train_on_sampler against the JAX package's
# ---------------------------------------------------------------------------

SAMPLED = dict(seq_length=128, batch_size=B, seed=3, max_variants_per_window=16)


def flax_params(L: int):
    """flax's params of the ``WIDTHS`` model for windows of length L, from
    ``PRNGKey(0)`` as the JAX package's ``train_on_sampler`` makes them (init
    reads the inputs' shapes only)."""
    x = np.zeros((B, L), np.int8)
    return JaxHaploFormer(JaxConfig(**WIDTHS)).init(jax.random.PRNGKey(0), x, x)["params"]


def jax_batch(js, step: int):
    """The JAX package's fused-step batch at ``step``."""
    _, _, lengths = js._genome_dev
    cfg = js.config
    return _sample_batch(
        js._base_key, step, lengths, js._regions_dev, js._enc, L=cfg.seq_length,
        K=cfg.max_variants_per_window, B=cfg.batch_size, D=js.cohort.num_donors,
        num_channels=js.num_channels, onehot_dtype=js.onehot_dtype, emit_onehot=js.emit_onehot,
        kernel=js.kernel, interpret=js._interpret)


def test_fused_step_trains_on_jax_sample_batch(monkeypatch):
    from tests.test_torch_sampler import both_samplers

    js, ps = both_samplers(SAMPLED)
    params = flax_params(SAMPLED["seq_length"])
    jm, tx = JaxHaploFormer(JaxConfig(**WIDTHS)), optax.adamw(LR)
    jstate = jax_train.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    jfused = jax_train.make_fused_train_step(jm, tx, js)
    x = torch.zeros((B, SAMPLED["seq_length"]), dtype=torch.int8)
    state = train.create_train_state(HaploFormerConfig(**WIDTHS), (x, x), learning_rate=LR,
                                     device="cpu")
    state.model.load_state_dict(convert.params_from_flax(jax.device_get(params)))
    seen = []
    inner = train._train_step

    def spy(state, hap1, hap2, n_variants, mesh=None):
        seen.append((hap1, hap2, n_variants))
        return inner(state, hap1, hap2, n_variants, mesh)

    monkeypatch.setattr(train, "_train_step", spy)
    fused = train.make_fused_train_step(ps)
    for s in (0, 5, 6):
        jstate, jm_ = jfused(jstate, jnp.int32(s))
        state, m = fused(state, s)
        want = jax_batch(js, jnp.int32(s))
        for got, name in zip(seen[-1], ("hap1", "hap2", "n_variants")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(want, name)),
                                          err_msg=f"step {s} {name}")
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-5, err_msg=k)
    assert js._step == ps._step == 0  # the fused step reads no counter


def test_train_on_sampler_matches_jax(monkeypatch):
    """Three steps from flax's params (carried over by ``convert``): every
    step's loss within ``1e-5``, and the sampler's counter where JAX's is."""
    from tests.test_torch_sampler import both_samplers

    js, ps = both_samplers(SAMPLED)
    params = flax_params(SAMPLED["seq_length"])
    make = train.create_train_state

    def from_flax(*args, **kwargs):
        state = make(*args, **kwargs)
        state.model.load_state_dict(convert.params_from_flax(jax.device_get(params)))
        return state

    monkeypatch.setattr(train, "create_train_state", from_flax)
    jstate, jlosses = jax_train.train_on_sampler(js, JaxHaploFormer(JaxConfig(**WIDTHS)), steps=3,
                                                 learning_rate=LR, log_every=1)
    state, losses = train_on_sampler(ps, HaploFormerConfig(**WIDTHS), steps=3, learning_rate=LR,
                                     log_every=1)
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert state.step == int(jstate.step) == 3 and ps._step == js._step == 4
