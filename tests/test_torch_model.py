"""HaploFormer of the PyTorch port against the JAX package's flax model.

The same numpy inputs go through both, with flax's params carried across
by ``convert.params_from_flax`` (the JAX side jitted, ``init`` included).
Tolerances, from the dtype:

- float32 (``dtype="float32"``): every output within ``1e-5`` absolute and
  ``1e-5`` relative.  Both run in float32 on the CPU; only the order of
  sums differs.
- bfloat16: every output within ``2**-5`` of the output's largest
  magnitude (4 bf16 ulps there).  The two libraries round to bf16 at other
  places: XLA fuses elementwise chains and rounds once at their end, torch
  rounds after every op.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax

from haplohyped_tpu.models.haploformer import HaploFormer as JaxHaploFormer
from haplohyped_tpu.models.haploformer import HaploFormerConfig as JaxConfig
from haplohyped_tpu_torch import convert
from haplohyped_tpu_torch.models.haploformer import (
    ConvStem,
    HaploFormer,
    HaploFormerConfig,
    train_flops_per_step,
)
from haplohyped_tpu_torch.models.train import loss_fn
from haplohyped_tpu_torch.ops.haplotype_window import windows_to_onehot

#: the small widths the tests run at
WIDTHS = dict(d_model=32, num_heads=2, num_layers=2)
B = 4
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 2.0**-5


def _codes(rng, L):
    return rng.integers(0, 5, (B, L)).astype(np.int8)


@pytest.fixture(scope="module", params=[128, 333], ids=lambda L: f"L{L}")
def case(request):
    """Inputs of window length L and flax's params for them."""
    L = request.param
    rng = np.random.default_rng(L)
    h1, h2 = _codes(rng, L), _codes(rng, L)
    jm = JaxHaploFormer(JaxConfig(dtype="float32", **WIDTHS))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), h1, h2)["params"]
    return SimpleNamespace(L=L, h1=h1, h2=h2, params=params, tree=jax.device_get(params))


def port_model(case, dtype="float32") -> HaploFormer:
    m = HaploFormer(HaploFormerConfig(dtype=dtype, **WIDTHS), case.L, seed=1, device="cpu")
    m.load_state_dict(convert.params_from_flax(case.tree), strict=True)
    return m


def jax_forward(case, dtype, h1, h2):
    jm = JaxHaploFormer(JaxConfig(dtype=dtype, **WIDTHS))
    return {k: np.asarray(v) for k, v in jax.jit(jm.apply)({"params": case.params}, h1, h2).items()}


def port_forward(model, h1, h2):
    with torch.no_grad():
        out = model(torch.from_numpy(h1), torch.from_numpy(h2))
    return {k: v.numpy() for k, v in out.items()}


def test_param_names_and_shapes_match_flax(case):
    flat = convert._flatten(case.tree)
    got = {k: tuple(v.shape) for k, v in port_model(case).state_dict().items()}
    assert got == {k: v.shape for k, v in flat.items()}
    assert all(v.dtype == np.float32 for v in flat.values())


def test_params_round_trip_bit_equal(case):
    back = convert.params_to_flax(port_model(case))
    a, b = convert._flatten(case.tree), convert._flatten(back)
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == np.float32 and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_params_from_flax_rejects_a_bad_tree(case, fault):
    tree = jax.tree_util.tree_map(np.array, case.tree)
    if fault == "missing":
        del tree["block1"]["ln2"]["bias"]
    elif fault == "extra":
        tree["block0"]["attn"]["rope"] = np.zeros(3, np.float32)
    elif fault == "shape":
        tree["base_head"]["kernel"] = np.zeros((32, 4), np.float32)
    else:
        tree["pair_ln"]["scale"] = tree["pair_ln"]["scale"].astype(np.float64)
    error = TypeError if fault == "dtype" else ValueError
    with pytest.raises(error, match={"missing": "missing leaves", "extra": "extra leaves",
                                     "shape": "base_head.kernel", "dtype": "float32"}[fault]):
        convert.params_from_flax(tree)


def test_forward_matches_flax_in_float32(case):
    want = jax_forward(case, "float32", case.h1, case.h2)
    got = port_forward(port_model(case), case.h1, case.h2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32_TOL)


def test_forward_matches_flax_in_bfloat16(case):
    want = jax_forward(case, "bfloat16", case.h1, case.h2)
    got = port_forward(port_model(case, "bfloat16"), case.h1, case.h2)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max()
        assert err <= BF16_TOL * np.abs(want[k]).max(), (k, err)


def test_stem_tokens_floor(case):
    T = case.L // 8  # 128 -> 16; 333 -> 83 -> 41 tokens
    out = port_forward(port_model(case), case.h1, case.h2)
    assert out["base_logits"].shape == (B, T, 5)
    assert out["pair_embedding"].shape == (B, 64) and out["variant_count"].shape == (B,)


def test_codes_and_their_one_hot_give_identical_outputs(case):
    m = port_model(case)
    oh1, oh2 = (windows_to_onehot(torch.from_numpy(h), 5) for h in (case.h1, case.h2))
    with torch.no_grad():
        a = m(oh1, oh2)
    b = port_forward(m, case.h1, case.h2)
    for k in b:
        assert np.array_equal(a[k].numpy(), b[k]), k


def test_codes_outside_the_channels_give_zero_rows(case):
    """The window kernel allows codes up to 127: they one-hot to zero rows
    in both packages (``F.one_hot`` would raise)."""
    h1 = case.h1.copy()
    h1[0, :40] = [5, 6, 7, 127] * 10
    h1[1, 3] = -1
    want = jax_forward(case, "float32", h1, case.h2)
    m = port_model(case)
    got = port_forward(m, h1, case.h2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32_TOL)
    oh = windows_to_onehot(torch.from_numpy(h1), 5)
    assert float(oh[0, :40].abs().sum()) == 0 and float(oh[1, 3].abs().sum()) == 0


def test_longer_window_than_built_for_raises(case):
    m = port_model(case)
    x = torch.zeros((1, case.L + 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="tokens exceed"):
        m(x, x)


def test_train_flops_per_step_counted_by_hand():
    """The default configuration at the JAX bench's B=64, L=1000, and its
    scaled point (d_model 512, 8 layers, B=256)."""
    d, T = 256, 125
    stem = 2 * 9 * (5 * 128 * 1000 + 128 * 256 * 250)
    block = T * (24 * d * d + 4 * T * d)
    heads = 2 * T * d * 5 + 4 * d
    want = 3 * 64 * (2 * (stem + 4 * block) + heads)
    assert train_flops_per_step(HaploFormerConfig(), 64, 1000) == want
    assert 3.8e11 < want < 3.95e11
    scaled = train_flops_per_step(HaploFormerConfig(d_model=512, num_layers=8), 256, 1000)
    assert 1.05e13 < scaled < 1.15e13


def test_init_follows_flax_in_distribution():
    m = HaploFormer(HaploFormerConfig(), 1000, seed=3, device="cpu")
    sd = m.state_dict()
    for name, fan_in in (("stem.conv1.kernel", 9 * 5), ("stem.conv2.kernel", 9 * 128),
                         ("block0.attn.query.kernel", 256), ("block0.attn.out.kernel", 256),
                         ("block0.mlp_in.kernel", 256), ("block3.mlp_out.kernel", 1024),
                         ("count_head.kernel", 512)):
        w = sd[name].double()
        std = 1 / math.sqrt(fan_in)  # lecun_normal: variance 1 / fan_in
        assert abs(float(w.std()) / std - 1) < (0.2 if w.numel() < 1000 else 0.03), name
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6, name
    for name, t in sd.items():
        if name.endswith(".bias"):
            assert not t.any(), name
        elif name.endswith(".scale"):
            assert bool((t == 1).all()), name
    assert sd["pos_embed"].shape == (1, 125, 256)
    assert abs(float(sd["pos_embed"].std()) / 0.02 - 1) < 0.03


def test_init_takes_its_own_generator():
    rng_state = torch.get_rng_state()
    cfg = HaploFormerConfig(**WIDTHS)
    a = HaploFormer(cfg, 128, seed=7, device="cpu").state_dict()
    b = HaploFormer(cfg, 128, seed=torch.Generator().manual_seed(7), device="cpu").state_dict()
    c = HaploFormer(cfg, 128, seed=8, device="cpu").state_dict()
    assert torch.equal(torch.get_rng_state(), rng_state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem.conv1.kernel"], c["stem.conv1.kernel"])


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HaploFormer(HaploFormerConfig(**WIDTHS), 128)


@pytest.mark.cuda
def test_card_matches_cpu_in_float32():
    """Forward and every gradient on the card against the CPU, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    h1, h2 = (torch.from_numpy(_codes(rng, 1000)) for _ in range(2))
    nv = torch.from_numpy(rng.integers(0, 10, B).astype(np.int32))
    cfg = HaploFormerConfig(d_model=64, num_heads=2, num_layers=2, dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        models = [HaploFormer(cfg, 1000, seed=0, device=d) for d in ("cpu", "cuda")]
        outs = []
        for m in models:
            dev = m.pos_embed.device
            loss, _ = loss_fn(m, h1.to(dev), h2.to(dev), nv.to(dev))
            loss.backward()
            outs.append({n: p.grad.cpu() for n, p in m.named_parameters()} | {"loss": loss.cpu()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    # relative to each tensor's largest value, floored at 1e-3 of the largest
    # gradient (the attention key biases' gradient is zero up to round-off)
    floor = 1e-3 * max(float(g.abs().max()) for g in outs[0].values())
    for k, want in outs[0].items():
        err = float((outs[1][k] - want).abs().max()) / max(float(want.abs().max()), floor)
        assert err <= 1e-4, (k, err)


def _pair(cfg, n, L, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    h1, h2 = (torch.randint(0, cfg.num_channels, (n, L), generator=g, dtype=torch.int8)
              for _ in range(2))
    nv = torch.randint(0, 10, (n,), generator=g, dtype=torch.int32)
    return h1.to(device), h2.to(device), nv.to(device)


def _channels_first_stem(monkeypatch):
    """Make the stem hand over its tokens as the channels-first view
    ``(2B, T, d)`` with strides ``(T d, 1, T)`` that conv1d's output gives
    when only transposed: the same values in the layout the blocks must
    not carry."""
    shipped = ConvStem.forward

    def forward(self, x):
        return shipped(self, x).transpose(1, 2).contiguous().transpose(1, 2)

    monkeypatch.setattr(ConvStem, "forward", forward)


@pytest.mark.parametrize("widths", [WIDTHS, dict(d_model=512, num_layers=2)],
                         ids=["d32", "d512"])
def test_stream_layout_changes_no_bit(widths, monkeypatch):
    """The loss, the three outputs and every gradient are bit-equal whether
    the blocks carry the contiguous token-major stream or the stem's
    channels-first view of the same values.  Biases and norm scales are
    moved off their initial zeros and ones, as training moves them: a zero
    bias would hide where it is added (the base head adds its own after the
    product on either layout).  In the compute dtype, bf16: a float32 model
    sums the token mean in another order on the other layout."""
    cfg = HaploFormerConfig(**widths)
    h1, h2, nv = _pair(cfg, 2, 1000, seed=widths["d_model"])

    def run():
        m = HaploFormer(cfg, 1000, seed=0, device="cpu")
        g = torch.Generator().manual_seed(11)
        with torch.no_grad():
            for n, p in m.named_parameters():
                if n.endswith((".bias", ".scale")):
                    p.add_(torch.randn(p.shape, generator=g) * 0.01)
        outs = []
        m.register_forward_hook(lambda mod, args, out: outs.append(out))
        stem_contiguous = []
        m.stem.register_forward_hook(lambda mod, args, out: stem_contiguous.append(out.is_contiguous()))
        loss, _ = loss_fn(m, h1, h2, nv)
        loss.backward()
        return stem_contiguous[0], loss, outs[0], {n: p.grad for n, p in m.named_parameters()}

    contiguous, loss, out, grads = run()
    with monkeypatch.context() as mp:
        _channels_first_stem(mp)
        view_contiguous, view_loss, view_out, view_grads = run()
    assert contiguous and not view_contiguous
    assert torch.equal(loss, view_loss)
    assert out.keys() == view_out.keys() == {"pair_embedding", "variant_count", "base_logits"}
    for k in out:
        assert torch.equal(out[k], view_out[k]), k
    assert grads.keys() == view_grads.keys()
    for n in grads:
        assert grads[n] is not None and torch.equal(grads[n], view_grads[n]), n


class _StreamAudit(TorchDispatchMode):
    """Below autograd, the ops that read a non-contiguous tensor of the
    residual stream's shape: the norms and adds that receive one
    (``misses``), and the copies made from one (``copies``)."""

    CHECKED = {"native_layer_norm", "native_layer_norm_backward", "add", "add_"}
    COPIES = {"clone", "copy_", "_to_copy"}

    def __init__(self, shape):
        super().__init__()
        self.shape, self.misses, self.copies = tuple(shape), [], 0

    def _strided(self, t):
        return isinstance(t, torch.Tensor) and tuple(t.shape) == self.shape and not t.is_contiguous()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in self.CHECKED:
            self.misses += [(name, t.dtype, t.stride()) for t in tree_leaves((args, kwargs))
                            if self._strided(t)]
        if name in self.COPIES:
            source = args[1] if name == "copy_" else args[0]
            self.copies += self._strided(source)
        return func(*args, **kwargs)


def _audit_step(model, h1, h2, nv):
    n, T, d = 2 * h1.shape[0], h1.shape[1] // model.cfg.pool, model.cfg.d_model
    with _StreamAudit((n, T, d)) as audit:
        loss, _ = loss_fn(model, h1, h2, nv)
        loss.backward()
    return audit


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_residual_stream_is_never_read_strided(device, monkeypatch):
    """The mechanism's counter: in a forward and backward of ``loss_fn`` no
    LayerNorm (forward or backward) and no add receives a non-contiguous
    tensor of the stream's ``(2B, T, d)`` shape, and the copies from such a
    tensor are the stem's own hand-over, one forward and one backward at
    most, beside the attention's own (its key gradient, which the head
    transposes leave T-major: counted on one ``Attention`` given a
    contiguous stream-shaped input)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = HaploFormerConfig(**WIDTHS)
    model = HaploFormer(cfg, 1000, seed=0, device=device)
    h1, h2, nv = _pair(cfg, B, 1000, seed=5, device=device)
    audit = _audit_step(model, h1, h2, nv)
    assert audit.misses == []

    x = torch.randn(2 * B, 1000 // cfg.pool, cfg.d_model, device=device,
                    dtype=cfg.compute_dtype, requires_grad=True)
    with _StreamAudit(x.shape) as attention:
        y = model.block0.attn(x)
        y.backward(torch.ones_like(y))
    assert attention.misses == []
    assert audit.copies - cfg.num_layers * attention.copies <= 2

    # the audit sees the layout it guards against
    model.zero_grad(set_to_none=True)
    _channels_first_stem(monkeypatch)
    strided = _audit_step(model, h1, h2, nv)
    assert {name for name, *_ in strided.misses} >= {"native_layer_norm",
                                                     "native_layer_norm_backward", "add"}
