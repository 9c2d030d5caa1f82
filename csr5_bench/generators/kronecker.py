"""The Graph500 Kronecker graph as the GAP Benchmark Suite builds it, and
its column-stochastic transition matrix P^T = A D^-1.

Each of ``edge_factor * 2**scale`` edges picks, at each of ``scale``
levels, one quadrant of the adjacency matrix with probabilities A, B, C
and 1 - A - B - C (GAP ``generator.h::MakeKronEdgeList``); vertex labels
are then permuted at random. The graph is made undirected, and
self-loops and duplicate edges are removed, as GAP does
(``SquishGraph``). Row i of P^T holds 1 / deg(j) at each
neighbour j, so PageRank's ``r <- d P^T r + (1 - d) / n`` moves rank
along edges.
"""

from __future__ import annotations

import torch


def generate(cfg: dict, seed: int, device) -> dict:
    """The CSR of P^T on ``device``: ``row_ptr`` int64 (n + 1), ``col``
    int32 (ascending in each row), ``val`` float32, ``shape`` (n, n)."""
    scale, ef = int(cfg["scale"]), int(cfg["edge_factor"])
    a, b, c = float(cfg["A"]), float(cfg["B"]), float(cfg["C"])
    n = 1 << scale
    edges = ef * n
    gen = torch.Generator(device=device).manual_seed(seed)
    src = torch.zeros(edges, dtype=torch.int64, device=device)
    dst = torch.zeros(edges, dtype=torch.int64, device=device)
    for level in range(scale):
        p = torch.rand(edges, generator=gen, device=device)
        src |= (p >= a + b).to(torch.int64) << level
        dst |= (((p >= a) & (p < a + b)) | (p >= a + b + c)).to(torch.int64) << level
    del p
    perm = torch.randperm(n, generator=gen, device=device)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = torch.unique(torch.cat([src * n + dst, dst * n + src]))
    del src, dst, keep
    row, col = key // n, key % n
    del key
    deg = torch.bincount(row, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=row_ptr[1:])
    val = (1.0 / deg[col].to(torch.float64)).to(torch.float32)
    return {"row_ptr": row_ptr, "col": col.to(torch.int32), "val": val, "shape": (n, n)}
