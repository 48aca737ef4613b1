"""The port's parallel layer in one process, against the JAX package on the
8-device CPU mesh of ``tests/conftest.py``: ``MeshConfig``, ``make_mesh``
(a gloo group of world size 1), the parameter rules for every parameter of
a small and of the flagship configuration, ``shard_model``'s slices, the
shard plan, ``FRAME_COUNTS``, the multi-process helpers without a group,
and the layer at world size 1 (the step bit-equal to the unsharded step).
``tests/test_torch_parallel_mp.py`` runs it across processes."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from haplohyped_tpu.core.config import MeshConfig as JaxMeshConfig
from haplohyped_tpu.hostio import vcf as jax_vcf
from haplohyped_tpu.models.haploformer import HaploFormer as JaxHaploFormer
from haplohyped_tpu.models.haploformer import HaploFormerConfig as JaxConfig
from haplohyped_tpu.parallel import make_mesh as jax_make_mesh
from haplohyped_tpu.parallel import param_shardings as jax_param_shardings
from haplohyped_tpu.parallel import sharded_decode_frames as jax_sharded_decode
from haplohyped_tpu.parallel.sharded_convert import convert_sharded as jax_convert
from haplohyped_tpu.parallel.sharded_convert import plan_shards as jax_plan_shards
from haplohyped_tpu_torch import MeshConfig, convert
from haplohyped_tpu_torch.core import MeshConfig as CoreMeshConfig
from haplohyped_tpu_torch.hostio import vcf as port_vcf
from haplohyped_tpu_torch.models import train
from haplohyped_tpu_torch.models.haploformer import Attention, HaploFormer, HaploFormerConfig
from haplohyped_tpu_torch.parallel import distributed, make_mesh, param_shardings
from haplohyped_tpu_torch.parallel.collectives import sharded_decode_frames
from haplohyped_tpu_torch.parallel.mesh import PARAM_RULES, Placement, shard_model
from haplohyped_tpu_torch.parallel.sharded_convert import ShardPlan, convert_sharded, plan_shards
from tests.synth import make_corpus

SMALL = dict(d_model=64, num_heads=4, num_layers=2)
COHORT_FIELDS = ("pos", "ref_code", "alt_code", "phase1", "phase2", "counts")


@pytest.fixture
def world1():
    """A gloo group of world size 1 (an in-process store), torn down after."""
    assert not dist.is_initialized()
    mesh = make_mesh(MeshConfig(1, 1), device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=["small", "flagship"])
def flax_params(request):
    """flax's params of a small and of the flagship configuration (L=128)."""
    widths = SMALL if request.param == "small" else {}
    h = np.zeros((2, 128), np.int8)
    params = jax.jit(JaxHaploFormer(JaxConfig(**widths)).init)(jax.random.PRNGKey(1), h, h)
    return SimpleNamespace(name=request.param, widths=widths,
                           tree=jax.device_get(params["params"]))


@pytest.mark.parametrize("data,model", [(1, 1), (4, 2), (2, 1), (1, 8)])
def test_mesh_config_matches_jax(data, model):
    port, ref = MeshConfig(data, model), JaxMeshConfig(data, model)
    assert CoreMeshConfig is MeshConfig
    assert (port.data, port.model, port.axis_names, port.num_devices) == (
        ref.data, ref.model, ref.axis_names, ref.num_devices)
    assert MeshConfig() == MeshConfig(1, 1) and MeshConfig().axis_names == ("data", "model")


def test_make_mesh_at_world_size_1(world1):
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert world1.mesh_dim_names == ("data", "model")
    assert tuple(world1.mesh.shape) == (1, 1) and world1.device_type == "cpu"
    assert make_mesh(device="cpu").mesh.shape == (1, 1)  # MeshConfig(data=world) by default


def test_too_many_devices_raises(world1):
    with pytest.raises(ValueError):
        jax_make_mesh(JaxMeshConfig(data=16, model=2))
    with pytest.raises(ValueError, match="needs 32 processes"):
        make_mesh(MeshConfig(data=16, model=2), device="cpu")


def test_make_mesh_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(MeshConfig(1, 1))
    assert not dist.is_initialized()  # no gloo group in its place


def test_param_shardings_match_jax_for_every_parameter(flax_params, world1):
    jax_sh = convert._flatten(jax_param_shardings(flax_params.tree, jax_make_mesh(
        JaxMeshConfig(4, 2))))
    sd = convert.params_from_flax(flax_params.tree)
    got = param_shardings(sd, world1)
    assert len(got) == len(jax_sh) == (43 if flax_params.name == "small" else 75)
    assert sorted(got) == sorted(jax_sh)
    for name, pl in got.items():
        assert pl.spec == tuple(jax_sh[name].spec), name
        assert pl.mesh is world1
    # a module gives the same placements as its state_dict
    model = HaploFormer(HaploFormerConfig(**flax_params.widths), 128, device="cpu")
    assert {n: p.spec for n, p in param_shardings(model, world1).items()} == {
        n: p.spec for n, p in got.items()}
    assert PARAM_RULES[-1] == (r".*", ())


class FakeMesh:
    """The corner of a ``DeviceMesh`` that ``shard_model`` reads, at one
    coordinate of a larger mesh than this process's world (it issues no
    collective: the groups are only stored)."""

    def __init__(self, data: int, model: int, coord: tuple[int, int]):
        self.shape = (data, model)
        self.mesh_dim_names = ("data", "model")
        self.coord = dict(zip(self.mesh_dim_names, coord))

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, axis):
        return self.coord[axis]

    def get_group(self, axis):
        return f"group:{axis}"


@pytest.mark.parametrize("m", [0, 1])
def test_shard_model_slices_match_the_cut_of_the_flax_params(flax_params, m):
    cfg = HaploFormerConfig(**flax_params.widths)
    sd = convert.params_from_flax(flax_params.tree)
    model = HaploFormer(cfg, 128, device="cpu")
    model.load_state_dict(sd)
    shard_model(model, FakeMesh(4, 2, (3, m)))
    h, hd, hid = cfg.num_heads // 2, cfg.d_model // cfg.num_heads, cfg.d_model * cfg.mlp_ratio // 2
    cuts = {"attn.query.kernel": np.s_[:, m * h:(m + 1) * h], "attn.key.kernel":
            np.s_[:, m * h:(m + 1) * h], "attn.value.kernel": np.s_[:, m * h:(m + 1) * h],
            "attn.out.kernel": np.s_[m * h:(m + 1) * h], "mlp_in.kernel":
            np.s_[:, m * hid:(m + 1) * hid], "mlp_in.bias": np.s_[m * hid:(m + 1) * hid],
            "mlp_out.kernel": np.s_[m * hid:(m + 1) * hid]}
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(sd)
    for name, want in sd.items():
        cut = next((c for k, c in cuts.items() if name.endswith(k)), np.s_[:])
        assert torch.equal(got[name].detach(), want[cut]), name
        assert got[name].is_contiguous(), name
    for mod in model.modules():
        if isinstance(mod, Attention):
            assert mod.heads == h and mod.tp_group == "group:model"
            assert mod.query.bias_rows == slice(m * h, (m + 1) * h)  # a full, replicated bias
            assert mod.out.row_parallel and mod.query.bias.shape == (cfg.num_heads, hd)


def test_shard_model_at_model_size_1_changes_nothing(world1):
    cfg = HaploFormerConfig(**SMALL, dtype="float32")
    a, b = (HaploFormer(cfg, 128, seed=2, device="cpu") for _ in range(2))
    assert shard_model(b, world1) is b
    assert all(getattr(m, "tp_group", None) is None for m in b.modules())
    h = torch.from_numpy(np.random.default_rng(0).integers(0, 5, (2, 128)).astype(np.int8))
    with torch.no_grad():
        assert all(torch.equal(x, y) for x, y in zip(a(h, h).values(), b(h, h).values()))


def test_placement_cuts_and_gathers_at_world_size_1(world1):
    x = torch.arange(24).reshape(4, 6)
    for spec in ((), ("data",), (None, "model"), ("data", "model")):
        pl = Placement(spec, world1)
        assert torch.equal(pl.local(x), x) and torch.equal(pl.gather(pl.local(x)), x)
    assert Placement((None, "model"), world1).is_replicated is False
    assert Placement((None, None), world1).is_replicated


@pytest.mark.parametrize("donors,chroms,n", [
    (["a", "b", "c"], ["chr1", "chr2"], 2),
    ([f"d{i}" for i in range(5)], ["chr21", "chr22"], 4),
    ([f"d{i}" for i in range(100)], ["chr22"], 8),
    (["a"], ["chr1", "chr2", "chr3"], 8),
])
def test_plan_shards_matches_jax(donors, chroms, n):
    port, ref = plan_shards(donors, chroms, n), jax_plan_shards(donors, chroms, n)
    assert isinstance(port, ShardPlan)
    assert port.tasks == ref.tasks and port.n_shards == ref.n_shards
    assert (port.t_pad, port.rows_per_shard) == (ref.t_pad, ref.rows_per_shard)
    for s in range(n):
        assert port.shard_rows(s) == ref.shard_rows(s)
        assert port.shard_tasks(s) == ref.shard_tasks(s)
    assert port.tasks[: len(donors)] == [(d, chroms[0]) for d in donors]  # chromosome-major


def test_frame_counts_match_jax(test_data_dir):
    """Every frame, frame12 and frame_v2 call counts one pass of its file."""
    from haplohyped_tpu.hostio.vcf import VCFSource as JaxSource
    from haplohyped_tpu_torch.hostio.vcf import VCFSource

    path = str(test_data_dir / "chr22.filtered.vcf.gz")
    with open(test_data_dir / "ipscs_samples_test.txt") as f:
        donor = f.readline().strip()
    for counts, src in ((port_vcf.FRAME_COUNTS, VCFSource(path)),
                        (jax_vcf.FRAME_COUNTS, JaxSource(path))):
        counts.clear()
        src.frame(donor, "chr22")
        src.frame12(donor, "chr22")
        src.frame_v2([donor], "chr22")
        src.frame_v2("*")
    assert port_vcf.FRAME_COUNTS == jax_vcf.FRAME_COUNTS == {path: 4}


def test_helpers_without_a_process_group(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not dist.is_initialized()  # nothing was set up
    assert distributed.process_info() == (0, 1)
    assert distributed.host_local_tasks(list(range(5))) == list(range(5))
    distributed.barrier()
    tree = {"a": np.arange(3), "b": [torch.ones(2)]}
    assert distributed.broadcast_from_host0(tree) is tree


def test_train_step_at_world_size_1_is_the_unsharded_step(world1):
    """One rank: the flat all-reduce sums one term and divides by 1, so the
    losses, parameters and AdamW slots stay bit-equal to the unsharded
    step; a checkpoint of the sharded state restores into an unsharded one."""
    cfg = HaploFormerConfig(d_model=32, num_heads=2, num_layers=1, dtype="float32")
    rng = np.random.default_rng(5)
    batches = [tuple(torch.from_numpy(a) for a in (
        rng.integers(0, 5, (4, 128)).astype(np.int8), rng.integers(0, 5, (4, 128)).astype(np.int8),
        rng.integers(0, 9, 4).astype(np.int32))) for _ in range(3)]
    a = train.create_train_state(cfg, batches[0][:2], seed=3, device="cpu")
    b = train.create_train_state(cfg, batches[0][:2], seed=3, device="cpu", mesh=world1)
    step_a, step_b = train.make_train_step(), train.make_train_step(world1)
    for batch in batches:
        a, ma = step_a(a, *batch)
        b, mb = step_b(b, *batch)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert b.step == 3 and b.mesh is world1
    assert all(torch.equal(x, y) for x, y in zip(a.model.parameters(), b.model.parameters()))
    with pytest.raises(ValueError, match="another mesh"):
        step_a(b, *batches[0])


def test_sharded_decode_and_convert_at_world_size_1(world1, tmp_path):
    from haplohyped_tpu.hostio.frame_format import pack_frame
    from haplohyped_tpu.ops.vcf_decode import decode_frames_numpy

    frames = np.stack([pack_frame(b"chr1", str(10 + i).encode(), b"A", b"C", b"0|1")
                       for i in range(7)])
    dec = sharded_decode_frames(frames, world1)
    ref = jax_sharded_decode(frames, jax_make_mesh(JaxMeshConfig(1, 1)))
    want = decode_frames_numpy(frames)
    for f in ref._fields:
        j = np.asarray(getattr(ref, f))
        assert np.array_equal(getattr(dec, f).numpy().astype(j.dtype), j), f
        if f in want:
            assert np.array_equal(getattr(dec, f).numpy().astype(want[f].dtype), want[f]), f

    c = make_corpus(str(tmp_path / "c"), n_samples=4, seed=2)
    args = ({c["chrom"]: c["vcf"]}, c["samples"], [c["chrom"]])
    jax_vcf.FRAME_COUNTS.clear()
    port_vcf.FRAME_COUNTS.clear()
    want = jax_convert(*args, jax_make_mesh(JaxMeshConfig(1, 1)), threads=1, host_workers=1)
    for device_decode in (False, True):
        got = convert_sharded(*args, world1, threads=1, host_workers=1,
                              device_decode=device_decode)
        for k in COHORT_FIELDS:
            assert getattr(got, k).tobytes() == np.asarray(getattr(want, k)).tobytes(), k
    assert dict(port_vcf.FRAME_COUNTS) == {c["vcf"]: 2}  # one pass a call
    assert dict(jax_vcf.FRAME_COUNTS) == {c["vcf"]: 1}


def test_fused_step_and_train_on_sampler_at_world_size_1(world1):
    """The fused step and ``train_on_sampler`` with a mesh of one rank give
    the unsharded ones' metrics, losses and parameters exactly."""
    from tests.torch_cpu_sampler import SMALL as TRAIN_SMALL, cpu_sampler

    sampler = cpu_sampler(seed=3)
    first = sampler.sample()
    a = train.create_train_state(TRAIN_SMALL, (first.hap1, first.hap2), seed=1, device="cpu")
    b = train.create_train_state(TRAIN_SMALL, (first.hap1, first.hap2), seed=1, device="cpu",
                                 mesh=world1)
    fa, fb = train.make_fused_train_step(sampler), train.make_fused_train_step(sampler, world1)
    for i in (1, 2):
        a, ma = fa(a, i)
        b, mb = fb(b, i)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(a.model.parameters(), b.model.parameters()))

    sa, la = train.train_on_sampler(cpu_sampler(seed=4), TRAIN_SMALL, steps=3, log_every=1)
    sb, lb = train.train_on_sampler(cpu_sampler(seed=4), TRAIN_SMALL, steps=3, log_every=1,
                                    mesh=world1)
    assert la == lb and len(lb) == 3 and sb.mesh is world1
    assert all(torch.equal(x, y) for x, y in zip(sa.model.parameters(), sb.model.parameters()))
