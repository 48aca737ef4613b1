"""Mesh-sharded conversion on the PyTorch port's ``parallel`` layer.

The counterpart of ``examples/03_sharded_conversion.py``: (donor x
chromosome) tasks are assigned over the ``data`` axis of a ``('data',
'model')`` process mesh, each process parses its rows (one single-pass
framing a chromosome), and the columns merge with one all-gather over
``data``.  Alone it runs a mesh of one process (NCCL on a card, gloo with
``--device cpu``); under ``torchrun --nproc_per_node=N`` every process takes
its share.

Run from the repo root:
    python examples/torch/03_sharded_conversion.py [--device cuda|cpu]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
DATA = os.path.join(REPO, "tests", "data")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch.distributed as dist

    from haplohyped_tpu_torch import MeshConfig
    from haplohyped_tpu_torch.parallel import distributed, make_mesh
    from haplohyped_tpu_torch.parallel.sharded_convert import convert_sharded

    distributed.initialize(device=args.device)  # torchrun's variables, where set
    _, world = distributed.process_info()
    mesh = make_mesh(MeshConfig(data=world, model=1), device=args.device)
    print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over {dist.get_backend()}")

    with open(os.path.join(DATA, "ipscs_samples_test.txt")) as f:
        donors = [line.strip() for line in f if line.strip()]

    cohort = convert_sharded(
        {"chr22": os.path.join(DATA, "chr22.filtered.vcf.gz")},
        donors,
        ["chr22"],
        mesh,
        device_decode=True,
    )
    print(f"cohort tensor: donors={cohort.num_donors} "
          f"chroms={cohort.chrom_names} vmax={cohort.max_variants}")
    print(f"variant counts: {cohort.counts.ravel().tolist()}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
