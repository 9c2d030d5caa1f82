"""HPCG's matrix over a 1 x 1 x P process grid: P local nx x ny x nz grids
stacked along z into one global nx x ny x (P * nz) grid.

Rank r's local grid is the global grid's planes ``[r * nz, (r + 1) * nz)``,
so its rows are one contiguous block of the global 27-point stencil
(``stencil27``), and its halo is one nx x ny plane of each neighbour, as
in HPCG's exchange of faces. The matrix is ``stencil27``'s on the global
grid, the same function of the seed on every rank as in one process. The
distributed layer plans every shard on every rank, so each rank is given
the whole matrix.

Only the multi-rank harness calls it, with the rank it runs; called
without one it raises, so a one-process run of a multi-rank cell stops
here instead of putting P local grids on one card.
"""

from __future__ import annotations

from csr5_bench.generators import stencil27


def generate(cfg: dict, seed: int, device, rank=None) -> dict:
    """The global CSR of ``cfg``'s stacked grids on ``device``, for rank
    ``rank`` of ``cfg["process_grid"]`` (as ``stencil27.generate``)."""
    px, py, pz = (int(p) for p in cfg["process_grid"])
    if rank is None:
        raise RuntimeError(
            f"{cfg.get('name', 'this configuration')} runs as {px * py * pz} ranks, one per "
            "chip: run it through the multi-rank harness (csr5_bench/ranks.py)")
    if (px, py) != (1, 1):
        raise ValueError(f"process grid {cfg['process_grid']}: only grids stacked along z "
                         "(1 x 1 x P) keep each rank's rows one contiguous block")
    if not 0 <= rank < pz:
        raise ValueError(f"rank {rank} outside a process grid of {pz}")
    return stencil27.generate({**cfg, "nz": int(cfg["nz"]) * pz}, seed, device)
