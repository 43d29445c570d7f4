"""Oracles for the iCh-scheduled BFS kernels, independent of the tile fold:
a pull-direction step and a full traversal straight from the CSR."""
from __future__ import annotations

import torch


def bfs_step_ref(indptr, indices, frontier, visited) -> torch.Tensor:
    """Pull-direction expansion: u joins iff some in-neighbor (row u of the
    CSR) is on the frontier and u is unvisited. Tensors on any one device;
    float32 indicators in and out."""
    indptr = torch.as_tensor(indptr)
    n = indptr.numel() - 1
    seg = torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                  torch.diff(indptr))
    hit = torch.zeros(n, dtype=torch.float32, device=indptr.device)
    hit.scatter_reduce_(0, seg, frontier[torch.as_tensor(indices).long()],
                        reduce="amax")
    return hit * (1.0 - visited)


def bfs_levels_ref(indptr, indices, source: int = 0) -> torch.Tensor:
    """Level per vertex (int32, -1 = unreached) under pull-direction BFS."""
    indptr = torch.as_tensor(indptr)
    n = indptr.numel() - 1
    level = torch.full((n,), -1, dtype=torch.int32, device=indptr.device)
    level[source] = 0
    frontier = torch.zeros(n, dtype=torch.float32, device=indptr.device)
    frontier[source] = 1.0
    visited = frontier.clone()
    depth = 0
    while bool(frontier.any()):
        nxt = bfs_step_ref(indptr, indices, frontier, visited)
        depth += 1
        level[nxt > 0] = depth
        visited = torch.maximum(visited, nxt)
        frontier = nxt
    return level
