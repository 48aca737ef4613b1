"""Multi-process sharded cohort conversion on the PyTorch port — the
operator path.

The counterpart of ``examples/04_multihost_conversion.py``, with torchrun's
contract in place of ``JAX_COORDINATOR_ADDRESS``.  One invocation runs in
EVERY process of the job (one process a card), joined through the variables
``torchrun`` sets, or that an operator sets by hand:

    MASTER_ADDR=host0  MASTER_PORT=29500   # the same on every process
    WORLD_SIZE=8                           # processes in the job
    RANK=0                                 # unique, 0..WORLD_SIZE-1
    LOCAL_RANK=0                           # the card of this process on its host

Each process parses only the (donor, chromosome) rows of its ``data``
coordinate (one single-pass framing a chromosome group), the columns merge
with an all-gather (NCCL between cards, gloo with ``--device cpu``), and
rank 0 writes the merged cohort.  Runbook: ``docs/MULTIHOST_TORCH.md``.

Smoke mode (no ``--vcf-dir`` and no ``MASTER_ADDR``): spawns ITSELF as a
2-process localhost job on the bundled test corpus.

Usage (torchrun starts the processes of one host):
    torchrun --nnodes=2 --nproc_per_node=4 --rdzv_backend=c10d \\
        --rdzv_endpoint=host0:29500 examples/torch/04_multihost_conversion.py \\
        --vcf-dir /data/cohort_vcfs --samples /data/samples.txt --out /shared/cohort.npz
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def run_conversion(vcf_dir: str, samples_path: str, out_path: str, device: str) -> None:
    """The conversion in one process (every process runs it identically)."""
    import numpy as np
    import torch.distributed as dist

    from haplohyped_tpu_torch import MeshConfig
    from haplohyped_tpu_torch.parallel import distributed, make_mesh
    from haplohyped_tpu_torch.parallel.sharded_convert import convert_sharded

    # 1. join the job (torchrun's variables; alone, a mesh of one process)
    joined = distributed.initialize(device=device)
    rank, world = distributed.process_info()
    mesh = make_mesh(MeshConfig(data=world, model=1), device=device)
    print(f"[rank {rank}/{world}] {dist.get_backend()} (joined={joined})", flush=True)

    # 2. every process computes the SAME plan from the same inputs
    with open(samples_path) as f:
        donors = [line.strip() for line in f if line.strip()]
    vcf_for = {
        os.path.basename(p).split(".")[0]: p
        for p in sorted(glob.glob(os.path.join(vcf_dir, "chr*.filtered.vcf.gz")))
    }
    if not vcf_for:
        raise SystemExit(f"no chr*.filtered.vcf.gz under {vcf_dir}")
    chroms = sorted(vcf_for)

    # 3. each process parses its rows; the all-gather merges them
    t0 = time.time()
    cohort = convert_sharded(
        vcf_for, donors, chroms, mesh,
        threads=int(os.environ.get("HH_CXX_THREADS", "2")),
        host_workers=int(os.environ.get("HH_HOST_WORKERS", "2")),
    )
    print(f"[rank {rank}] converted {len(donors)} donors x {len(chroms)} "
          f"chroms in {time.time() - t0:.2f}s", flush=True)

    # 4. every process holds the merged tensors; rank 0 writes them
    distributed.barrier()
    if rank == 0:
        np.savez(out_path, pos=cohort.pos, ref_code=cohort.ref_code, alt_code=cohort.alt_code,
                 phase1=cohort.phase1, phase2=cohort.phase2, counts=cohort.counts)
        print(f"[rank 0] wrote merged cohort -> {out_path} "
              f"({int(cohort.counts.sum())} SNP records)", flush=True)
    distributed.barrier()
    dist.destroy_process_group()


def smoke(device: str) -> None:
    """A 2-process localhost job on the bundled corpus, under torchrun's
    variables."""
    import socket
    import subprocess
    import tempfile

    import numpy as np

    data = os.path.join(REPO, "tests", "data")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(prefix="hh_torch_mh_"), "cohort.npz")
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--vcf-dir", data,
             "--samples", os.path.join(data, "ipscs_samples_test.txt"),
             "--out", out, "--device", device],
            env=env,
        ))
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if rcs != [0, 0]:
        raise SystemExit(f"smoke job failed: exit codes {rcs}")
    m = np.load(out)
    print(f"smoke OK: merged counts {m['counts'].ravel().tolist()}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vcf-dir", help="directory of chr*.filtered.vcf.gz")
    ap.add_argument("--samples", help="donor list, one per line")
    ap.add_argument("--out", default="cohort.npz")
    ap.add_argument("--device", default="cuda", help="cuda (default; NCCL) or cpu (gloo)")
    args = ap.parse_args()

    if not args.vcf_dir and not os.environ.get("MASTER_ADDR"):
        print("no --vcf-dir and no MASTER_ADDR: running the 2-process localhost smoke")
        smoke(args.device)
        return
    run_conversion(args.vcf_dir, args.samples, args.out, args.device)


if __name__ == "__main__":
    main()
