"""Row-sharded SpMV over torch.distributed: halo against all-gather.

    python examples/distributed_spmv_torch.py [m] [devices] [--device cuda|cpu]

The PyTorch counterpart of ``distributed_spmv.py``. A banded matrix
(bandwidth 11, m rows, default 65536) is split into row blocks, one per
rank, and y = A @ x runs twice: with x all-gathered, and with the
neighbour halos ``halo="auto"`` picks for a band. On the card (the
default) the one H100 is a mesh of D = 1 on NCCL in this process; with
``--device cpu`` D gloo ranks (default 8) are spawned on this host, the
counterpart of the JAX example's virtual CPU mesh. Prints the x bytes
each rank receives per SpMV in either form and each form's max relative
error against scipy.
"""

import argparse
import os
import sys

import numpy as np
import scipy.sparse as sp
import torch

# the spawned ranks import this file by name: keep its directory on the path
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed as pd  # noqa: E402
from benchmark_spmv_using_csr5_tpu_torch.parallel import launch  # noqa: E402
from benchmark_spmv_using_csr5_tpu_torch.utils import synth  # noqa: E402


def compare_exchanges(rank: int, world_size: int, m: int, device: str) -> dict:
    """One rank's part: both distributions, both products, the counters."""
    mesh = pd.make_mesh(world_size, device)
    a = sp.csr_matrix(synth.banded(m, 11, dtype=np.float32))
    x = np.random.default_rng(0).integers(1, 10, m).astype(np.float32)
    xd = torch.from_numpy(x).to(mesh.device)
    y_ref = a @ x
    out = {"backend": mesh.backend, "devices": world_size}
    for tag, halo in (("all_gather", "none"), ("halo", "auto")):
        da = pd.distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh, halo=halo)
        y = pd.distributed_spmv(da, xd, mesh).cpu().numpy()
        out[f"{tag}_bytes"] = da.x_bytes_exchanged()
        out[f"{tag}_widths"] = da.halo
        out[f"{tag}_rel_err"] = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", nargs="?", type=int, default=65536)
    ap.add_argument("devices", nargs="?", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        d = args.devices or 8
        out = launch.run_ranks(compare_exchanges, d, args.m, "cpu")[0]
    else:
        if (args.devices or 1) != 1:
            raise SystemExit("on the card this example runs D = 1; --device cpu spawns D ranks")
        with launch.single_rank_group(args.device):
            out = compare_exchanges(0, 1, args.m, args.device)
    print(f"mesh: {out['devices']} rank(s) on {out['backend']}, banded m={args.m}")
    print(f"all-gather exchange: {out['all_gather_bytes']:,} B/device, "
          f"max rel err {out['all_gather_rel_err']:.2e}")
    print(f"halo exchange {out['halo_widths']}: {out['halo_bytes']:,} B/device, "
          f"max rel err {out['halo_rel_err']:.2e}")
    return out


if __name__ == "__main__":
    main()
