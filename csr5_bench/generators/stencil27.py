"""HPCG's matrix: the 27-point stencil on an nx x ny x nz grid.

Row ``r = iz*nx*ny + iy*nx + ix`` holds a nonzero for each of its 27
neighbours inside the grid, columns ascending (HPCG 3.1,
``GenerateProblem_ref.cpp``). HPCG fixes the values at 26 and -1; here
each off-diagonal is ``-u`` with u uniform in [0.5, 1.5), drawn once per
unordered pair so that the matrix stays symmetric, and the diagonal is
the sum of u over all 26 neighbour slots, stored or outside the grid, as
HPCG's 26 counts them: interior rows sum to 0 and boundary rows are
strictly dominant, as in HPCG, so the matrix is SPD.
"""

from __future__ import annotations

import torch

#: the 27 offsets (dz, dy, dx) in lexicographic order: for one row their
#: columns ascend; index 13 is the diagonal
OFFSETS = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
#: the 13 offsets after (0, 0, 0): the pair (r, r + o) draws its value at
#: row r, the smaller index of the two
POSITIVE = [o for o in OFFSETS if o > (0, 0, 0)]


def generate(cfg: dict, seed: int, device) -> dict:
    """The CSR of the configuration's grid on ``device``: ``row_ptr``
    int64 (m + 1), ``col`` int32, ``val`` float64, ``shape`` (m, m)."""
    nx, ny, nz = (int(cfg[k]) for k in ("nx", "ny", "nz"))
    m = nx * ny * nz
    gen = torch.Generator(device=device).manual_seed(seed)
    u = 0.5 + torch.rand((len(POSITIVE), m), generator=gen, dtype=torch.float64, device=device)

    r = torch.arange(m, dtype=torch.int64, device=device)
    ix, iy, iz = r % nx, (r // nx) % ny, r // (nx * ny)
    cols = torch.empty((m, 27), dtype=torch.int64, device=device)
    valid = torch.empty((m, 27), dtype=torch.bool, device=device)
    vals = torch.zeros((m, 27), dtype=torch.float64, device=device)
    diag = torch.zeros(m, dtype=torch.float64, device=device)
    for k, (dz, dy, dx) in enumerate(OFFSETS):
        cols[:, k] = r + dz * nx * ny + dy * nx + dx
        valid[:, k] = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0) & (iy + dy < ny)
                       & (iz + dz >= 0) & (iz + dz < nz))
        if (dz, dy, dx) == (0, 0, 0):
            continue
        if (dz, dy, dx) > (0, 0, 0):
            draw = u[POSITIVE.index((dz, dy, dx))]
        else:  # the pair's smaller index is the neighbour's
            draw = u[POSITIVE.index((-dz, -dy, -dx))][cols[:, k].clamp(0, m - 1)]
        vals[:, k] = torch.where(valid[:, k], -draw, 0.0)
        diag += draw
    del u, ix, iy, iz
    vals[:, 13] = diag

    row_ptr = torch.zeros(m + 1, dtype=torch.int64, device=device)
    torch.cumsum(valid.sum(dim=1), 0, out=row_ptr[1:])
    mask = valid.reshape(-1)
    col = cols.reshape(-1)[mask].to(torch.int32)
    del cols
    val = vals.reshape(-1)[mask]
    return {"row_ptr": row_ptr, "col": col, "val": val, "shape": (m, m)}
