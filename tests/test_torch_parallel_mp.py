"""The port's parallel layer across processes, over gloo on the CPU, against
the JAX package on the 8-device CPU mesh of ``tests/conftest.py``.

Two clusters, each started once per module (``tests/test_torch_parallel_worker.py``
is the rank's code; a ``file://`` store under ``tmp_path``, no TCP port, so
xdist workers cannot collide; every join waits at most ``TIMEOUT`` seconds,
then the ranks are killed and the test fails):

- 4 ranks: one train step at ``data=2 x model=2`` against JAX's
  ``make_train_step(mesh=MeshConfig(4, 2))`` on the same params and batch,
  in float32 and bf16, read from the sharded ``save_checkpoint``; the
  sharded decode of 13 frames, ``all_gather_cohort``, ``psum_counts``, the
  position-sharded window gather and ``convert_sharded`` over ``data=4``.
- 2 ranks: ``convert_sharded`` (the decode as torch ops), and the
  multi-process helpers.

Tolerances.  float32: the loss within 1e-5 relative; each parameter after
the step within 1e-5 relative and ``0.05 * lr`` absolute, as
``tests/test_torch_train.py`` holds the unsharded step (Adam's first step
is ``lr`` times ``g / (|g| + eps)``, so a gradient within round-off of zero
moves its parameter by up to ``lr`` either way; the attention key biases,
whose gradient is round-off, within ``2 lr``).  bf16: the JAX test's own
bounds (``tests/test_parallel.py``: loss rtol 2e-2, parameters atol 5e-3).
Every integer output is bit-equal.
"""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from haplohyped_tpu.core.config import MeshConfig as JaxMeshConfig
from haplohyped_tpu.hostio.frame_format import pack_frame
from haplohyped_tpu.models import train as jax_train
from haplohyped_tpu.models.haploformer import HaploFormer as JaxHaploFormer
from haplohyped_tpu.models.haploformer import HaploFormerConfig as JaxConfig
from haplohyped_tpu.ops.vcf_decode import decode_frames_numpy
from haplohyped_tpu.parallel import all_gather_cohort as jax_all_gather
from haplohyped_tpu.parallel import make_mesh as jax_make_mesh
from haplohyped_tpu.parallel import param_shardings as jax_param_shardings
from haplohyped_tpu.parallel import sharded_decode_frames as jax_sharded_decode
from haplohyped_tpu.parallel.collectives import psum_counts as jax_psum
from haplohyped_tpu.parallel.genome_shard import ShardedGenome as JaxShardedGenome
from haplohyped_tpu.parallel.genome_shard import sharded_window_gather as jax_window_gather
from haplohyped_tpu.parallel.sharded_convert import convert_sharded as jax_convert
from haplohyped_tpu.parallel.sharded_convert import plan_shards as jax_plan_shards
from haplohyped_tpu_torch import convert
from haplohyped_tpu_torch.models import train
from haplohyped_tpu_torch.models.haploformer import HaploFormerConfig
from tests.synth import make_corpus

WORKER = os.path.join(os.path.dirname(__file__), "test_torch_parallel_worker.py")
TIMEOUT = 120.0
#: tests/test_torch_parallel_worker.py's TRAIN_WIDTHS
WIDTHS = dict(d_model=32, num_heads=4, num_layers=2)
B, L, LR = 8, 128, 3e-4
COHORT_FIELDS = ("pos", "ref_code", "alt_code", "phase1", "phase2", "counts")
DTYPES = ("float32", "bfloat16")


def start_cluster(case: str, world: int, inputs: dict, out_dir) -> list:
    """Start ``world`` ranks of ``case`` on ``inputs``; :func:`join_cluster`
    waits for them."""
    os.makedirs(out_dir, exist_ok=True)
    inp = os.path.join(out_dir, "inputs.npz")
    np.savez(inp, **inputs)
    store = os.path.join(out_dir, "store")
    return [subprocess.Popen([sys.executable, WORKER, case, str(r), str(world), store, inp,
                              str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def join_cluster(procs: list, case: str, out_dir, t_start: float) -> list[dict]:
    """Wait for every rank, at most ``TIMEOUT`` seconds from ``t_start`` in
    all (then kill them and fail), and return each rank's outputs."""
    deadline = t_start + TIMEOUT
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}: the ranks did not finish within {TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{case} rank {r} exited {p.returncode}:\n{log[-4000:]}"
    outs = []
    for r in range(len(procs)):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def corpus(tmp) -> dict:
    """Two chromosomes of the synthetic corpus over the same 5 donors."""
    parts = [make_corpus(str(tmp / c), chrom=c, chrom_num=int(c[3:]), n_samples=5, seed=s)
             for c, s in (("chr21", 3), ("chr22", 4))]
    return {"vcf_for": {p["chrom"]: p["vcf"] for p in parts}, "donors": parts[0]["samples"],
            "chroms": [p["chrom"] for p in parts]}


def cohort_inputs(cor: dict) -> dict:
    return {"vcf_for": np.array(json.dumps(cor["vcf_for"])), "donors": np.array(cor["donors"]),
            "chroms": np.array(cor["chroms"])}


def jax_cohort(cor: dict, n_shards: int):
    """JAX's ``convert_sharded`` on a ``data=n_shards`` mesh, and the framing
    passes by file that JAX's plan gives a deployment of one process a shard:
    one a (chromosome, shard) the shard's tasks touch.  (In one process every
    shard is local, and JAX frames each chromosome once for all of them.)"""
    ct = jax_convert(cor["vcf_for"], cor["donors"], cor["chroms"],
                     jax_make_mesh(JaxMeshConfig(n_shards, 1)), threads=1, host_workers=1)
    plan = jax_plan_shards(cor["donors"], cor["chroms"], n_shards)
    passes = {}
    for s in range(n_shards):
        for c in {c for _, c in plan.shard_tasks(s)}:
            passes[cor["vcf_for"][c]] = passes.get(cor["vcf_for"][c], 0) + 1
    return ct, passes


@pytest.fixture(scope="module")
def cluster4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cluster4")
    rng = np.random.default_rng(10)
    h1, h2 = (rng.integers(0, 5, (B, L)).astype(np.int8) for _ in range(2))
    nv = rng.integers(0, 12, B).astype(np.int32)
    frames = np.stack([pack_frame(b"chr22", str(100 + 7 * i).encode(), b"ACGT"[i % 4:i % 4 + 1],
                                  b"G" if i % 3 else b"AT", (b"1|0", b"0/1", b"./.")[i % 3])
                       for i in range(13)])
    codes = rng.integers(0, 5, 100_000).astype(np.int8)
    cor = corpus(tmp / "corpus")

    # the params both sides start from (one jitted init; the compute dtype
    # does not enter it); JAX's genome chunks give the starts: chunk
    # boundaries, a start on one, windows across them, past the end
    jm = {dt: JaxHaploFormer(JaxConfig(**WIDTHS, dtype=dt)) for dt in DTYPES}
    params = jax.device_get(jax.jit(jm["float32"].init)(jax.random.PRNGKey(3), h1, h2)["params"])
    flat = convert._flatten(params)
    sg = JaxShardedGenome.from_codes(codes, jax_make_mesh(JaxMeshConfig(4, 1)), halo=1000)
    bounds = [sg.chunk * k for k in range(1, 4)]
    starts = np.array([0, 17, 100_000 - 1000] + bounds + [b - 500 for b in bounds]
                      + [4 * sg.chunk, 4 * sg.chunk + 3] + list(rng.integers(0, 99_000, 16)),
                      np.int32)
    inputs = {"h1": h1, "h2": h2, "nv": nv, "frames": frames,
              "cohort_x": np.arange(32, dtype=np.int32).reshape(32, 1),
              "ones": np.ones(16, np.int32), "codes": codes, "halo": np.int64(1000),
              "L": np.int64(1000), "starts": starts, **cohort_inputs(cor)}
    inputs |= {f"param/{k}": v for k, v in flat.items()}
    t0 = time.monotonic()
    procs = start_cluster("mesh4", 4, inputs, tmp / "out")

    # meanwhile JAX's mesh steps (data=4 x model=2) from the same params, on
    # the state create_train_state(mesh=) makes (its init is eager and slow)
    jax_mesh = jax_make_mesh(JaxMeshConfig(4, 2))
    jax_out = {}
    try:
        p_sh = jax_param_shardings(params, jax_mesh)
        tx = optax.adamw(LR)
        with jax_mesh:
            p_dev = jax.device_put(params, p_sh)
            opt = jax.jit(tx.init)(p_dev)
            opt = jax.device_put(opt, jax_train._opt_shardings(opt, p_sh, jax_mesh))
            for dt in DTYPES:
                state = jax_train.TrainState(p_dev, opt, jnp.zeros((), jnp.int32))
                step = jax_train.make_train_step(jm[dt], tx, mesh=jax_mesh)
                state, m = step(state, h1, h2, nv)
                jax_out[dt] = (convert._flatten(jax.device_get(state.params)),
                               {k: float(v) for k, v in m.items()})
    finally:
        outs = join_cluster(procs, "mesh4", tmp / "out", t0)
    return SimpleNamespace(outs=outs, out_dir=tmp / "out", inputs=inputs, jax=jax_out,
                           params=flat, frames=frames, jax_genome=sg, cor=cor)


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cluster2")
    cor = corpus(tmp / "corpus")
    procs = start_cluster("mesh2", 2, cohort_inputs(cor), tmp / "out")
    return SimpleNamespace(outs=join_cluster(procs, "mesh2", tmp / "out", time.monotonic()),
                           cor=cor)


def _checkpoint(cluster, dt: str) -> dict:
    path = os.path.join(cluster.out_dir, dt, "step_1", train.CHECKPOINT_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("dt", DTYPES)
def test_train_step_matches_jax_mesh_step(cluster4, dt):
    want_params, want_m = cluster4.jax[dt]
    for r, out in enumerate(cluster4.outs):  # every rank reports the global metrics
        for k, v in want_m.items():
            rtol = 1e-5 if dt == "float32" else 2e-2
            np.testing.assert_allclose(float(out[f"{dt}/{k}"]), v, rtol=rtol, err_msg=f"{k} r{r}")
    got = _checkpoint(cluster4, dt)["model"]
    assert sorted(got) == sorted(want_params)
    for n, t in got.items():
        g, w = t.numpy(), want_params[n]
        assert g.shape == w.shape, n
        if dt == "bfloat16":
            np.testing.assert_allclose(g, w, atol=5e-3, err_msg=n)
        elif n.endswith("attn.key.bias"):
            assert np.abs(g - w).max() <= 2 * LR, n
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0.05 * LR, err_msg=n)


def test_sharded_checkpoint_restores_into_an_unsharded_state(cluster4):
    """The sharded checkpoint holds the global tensors: restored into an
    unsharded state it equals the unsharded port's step on the same params
    and batch (float32, within the step's tolerance), AdamW slots too."""
    inp = cluster4.inputs
    batch = tuple(torch.from_numpy(inp[k]) for k in ("h1", "h2", "nv"))
    cfg = HaploFormerConfig(**WIDTHS, dtype="float32")
    ref = train.create_train_state(cfg, batch[:2], device="cpu")
    ref.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in cluster4.params.items()})
    ref, _ = train.make_train_step()(ref, *batch)
    path = os.path.join(cluster4.out_dir, "float32", "step_1")
    back = train.restore_checkpoint(path, train.create_train_state(cfg, batch[:2], seed=4,
                                                                   device="cpu"))
    assert back.step == 1 and back.mesh is None
    sa, sb = ref.optimizer.state_dict()["state"], back.optimizer.state_dict()["state"]
    # the first moment is 0.1 g: held as tests/test_torch_train.py holds
    # gradients, 1e-4 of each tensor's largest value floored at 1e-3 of the
    # largest (the key biases' gradient is round-off)
    floor = 1e-3 * max(float(slots["exp_avg"].abs().max()) for slots in sa.values())
    for (n, p), q, i in zip(ref.model.named_parameters(), back.model.parameters(), sa):
        tol = dict(rtol=1e-5, atol=2 * LR if n.endswith("attn.key.bias") else 0.05 * LR)
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), **tol, err_msg=n)
        for k in ("exp_avg", "exp_avg_sq"):
            assert sb[i][k].shape == sa[i][k].shape, (n, k)
        want = sa[i]["exp_avg"]
        err = float((sb[i]["exp_avg"] - want).abs().max())
        assert err <= 1e-4 * max(float(want.abs().max()), floor), (n, err)
    # and it trains on from there
    back, m = train.make_train_step()(back, *batch)
    assert back.step == 2 and np.isfinite(float(m["loss"]))


def test_sharded_decode_over_4_ranks_matches_jax(cluster4):
    frames = cluster4.frames
    jax_dec = jax_sharded_decode(frames, jax_make_mesh(JaxMeshConfig(4, 1)))
    want = decode_frames_numpy(frames)
    sizes = [out["decode/start"].shape[0] for out in cluster4.outs]
    assert sizes == [4, 4, 4, 1]  # 13 records padded to 16 over 4 ranks
    for f in jax_dec._fields:
        got = np.concatenate([out[f"decode/{f}"] for out in cluster4.outs])
        j = np.asarray(getattr(jax_dec, f))
        assert np.array_equal(got.astype(j.dtype), j) and got.shape == j.shape, f
        if f in want:
            assert np.array_equal(got.astype(want[f].dtype), want[f]), f


def test_all_gather_and_psum_match_jax(cluster4):
    mesh = jax_make_mesh(JaxMeshConfig(4, 1))
    x = cluster4.inputs["cohort_x"]
    want = np.asarray(jax_all_gather(x, mesh))
    total = np.asarray(jax_psum(cluster4.inputs["ones"], mesh)).ravel()
    for out in cluster4.outs:
        assert np.array_equal(out["gather"], want) and out["gather"].dtype == want.dtype
        assert np.array_equal(out["psum"], total) and out["psum"].dtype == total.dtype
    # over the model axis of the data=2 x model=2 mesh: ranks (d, 0), (d, 1)
    for r, out in enumerate(cluster4.outs):
        d = r // 2
        assert np.array_equal(out["gather_model"].ravel(), [2 * d] * 2 + [2 * d + 1] * 2)


def test_window_gather_over_4_ranks_matches_jax(cluster4):
    sg = cluster4.jax_genome
    inp = cluster4.inputs
    want = np.asarray(jax_window_gather(sg, inp["starts"], 1000))
    codes = inp["codes"]
    for out in cluster4.outs:
        assert int(out["genome_chunk"]) == sg.chunk
        assert np.array_equal(out["windows"], want)
        assert "exceeds halo" in str(out["halo_refused"])
    for s, w in zip(inp["starts"], cluster4.outs[0]["windows"]):
        if s >= 4 * sg.chunk:
            assert not w.any()  # a start no shard owns gives zeros
        elif s + 1000 <= codes.shape[0]:
            assert np.array_equal(w, codes[s:s + 1000])


@pytest.mark.parametrize("world", [2, 4])
def test_convert_sharded_matches_jax(cluster2, cluster4, world):
    cluster = cluster2 if world == 2 else cluster4
    want, passes = jax_cohort(cluster.cor, world)
    for out in cluster.outs:
        for k in COHORT_FIELDS:
            w = np.asarray(getattr(want, k))
            g = out[f"cohort/{k}"]
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k
    got = {}
    for out in cluster.outs:  # each rank counts its own passes
        for path, n in json.loads(str(out["frame_counts"])).items():
            got[path] = got.get(path, 0) + n
    assert got == passes  # one pass a (chromosome, shard), never one a donor
    assert all(0 < n <= world for n in got.values())


def test_multiprocess_helpers_over_2_ranks(cluster2):
    a, b = cluster2.outs
    assert a["tasks"].tolist() == [0, 2, 4, 6] and b["tasks"].tolist() == [1, 3, 5]
    for out in cluster2.outs:  # rank 0's values everywhere
        assert out["bcast_a"].tolist() == [0, 0, 0] and out["bcast_a"].dtype == np.int32
        assert not out["bcast_b"].any()
