"""Workload generators — the port's copy of `repro.core.workloads`: the
paper's synthetic loops (`synth_linear`, `synth_exp`), the BFS graph
generator and its per-level loop costs (`bfs_graph`, `bfs_levels`), the
K-Means per-round costs (`kmeans_rounds`), LavaMD's box costs
(`lavamd_costs`), the Table 1 matrix specs and row-nnz synthesizer
(`MatrixSpec`, `TABLE1`, `HUB_*`, `matrix_row_nnz`, `spmv_costs`,
`achieved_stats`) and the MoE router of the reference's dispatch benchmark
(`moe_router`, `benchmarks/bench_schedule_build.py:bench_moe_dispatch`).
Every synthesis must stay draw-for-draw identical to the reference: the
parity tests and the chip smoke run build the same inputs through both
packages' schedules."""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np


def synth_linear(n: int = 100_000, seed: int = 0) -> np.ndarray:
    """Linearly increasing workload (BinLPT's 'linear')."""
    return np.linspace(1.0, 1000.0, n)


def synth_exp(n: int = 100_000, increasing: bool = True, beta: float = None, seed: int = 0) -> np.ndarray:
    """1e6 samples from Exp(beta=1e6), sorted (paper uses n=beta=1e6).

    We keep beta = n so the workload *range* (max/min ~ 1e6 -> 1) matches the
    paper at any simulation scale.
    """
    rng = np.random.default_rng(seed)
    beta = float(n) if beta is None else beta
    w = rng.exponential(scale=beta, size=n)
    w = np.maximum(np.sort(w), 1.0)
    return w if increasing else w[::-1].copy()


def bfs_graph(kind: str = "uniform", n: int = 100_000,
              seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The Rodinia-BFS graph of the paper's BF workload, as the reference's
    `bfs_levels` builds it: uniform degrees in [1, 20] or scale-free
    degrees P(k) ~ k^-2.3 clipped at n // 10, then uniformly random
    targets from `seed + 1`. Returns (indptr, indices), both int64."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        degrees = rng.integers(1, 21, size=n)
    elif kind == "scale_free":
        degrees = np.minimum(rng.zipf(2.3, size=n), n // 10)
    else:
        raise ValueError(kind)
    degrees = degrees.astype(np.int64)
    rng = np.random.default_rng(seed + 1)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    indices = rng.integers(0, n, size=int(indptr[-1]), dtype=np.int64)
    return indptr, indices


def bfs_levels(kind: str = "uniform", n: int = 100_000, seed: int = 0,
               mask_cost: float = 0.5) -> tuple[list[np.ndarray], np.ndarray]:
    """Rodinia-BFS loops over `bfs_graph(kind, n, seed)`: each level is a
    parallel-for over ALL n vertices; cost = mask check (~mask_cost)
    everywhere + edge scans for vertices on the current frontier. Returns
    the per-level costs and the static, frontier-oblivious degree-based
    estimate (mask_cost + 1 + degree)."""
    indptr, indices = bfs_graph(kind, n, seed)
    visited = np.zeros(n, dtype=bool)
    frontier = np.array([0], dtype=np.int64)
    visited[0] = True
    levels: list[np.ndarray] = []
    deg = (indptr[1:] - indptr[:-1]).astype(np.float64)
    while len(frontier) > 0:
        costs = np.full(n, mask_cost)
        costs[frontier] += 1.0 + deg[frontier]
        levels.append(costs)
        nbr = np.concatenate([indices[indptr[v]:indptr[v + 1]] for v in frontier]) \
            if len(frontier) < 4096 else indices[_ranges_mask(indptr, frontier)]
        nbr = np.unique(nbr)
        nbr = nbr[~visited[nbr]]
        visited[nbr] = True
        frontier = nbr
    return levels, mask_cost + 1.0 + deg


def _ranges_mask(indptr: np.ndarray, frontier: np.ndarray) -> np.ndarray:
    """Gather concatenated index ranges for a large frontier, vectorized."""
    starts = indptr[frontier]
    lens = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
    total = int(lens.sum())
    # standard trick: offsets within each concatenated range
    rep = np.repeat(np.arange(len(frontier)), lens)
    within = np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return (starts[rep] + within).astype(np.int64)


def kmeans_rounds(n: int = 100_000, rounds: int = 10,
                  seed: int = 0) -> tuple[list[np.ndarray], np.ndarray]:
    """Per-round per-point costs of the paper's K-Means loop, and the
    round-0 estimate: a near-uniform base in [6, 10) with a reshuffled 2%
    heavy tail (Exp(120) added) every round."""
    rng = np.random.default_rng(seed)
    out: list[np.ndarray] = []
    for _ in range(rounds):
        base = rng.uniform(6.0, 10.0, size=n)
        tail_idx = rng.choice(n, size=n // 50, replace=False)
        base[tail_idx] += rng.exponential(120.0, size=len(tail_idx))
        out.append(base)
    return out, out[0].copy()


def lavamd_costs(nx: int = 8, particles_mean: float = 100.0, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (nx, nx, nx)
    particles = rng.poisson(particles_mean, size=shape).astype(np.float64)
    cost = np.zeros(shape)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                shifted = np.zeros(shape)
                xs = slice(max(0, dx), nx + min(0, dx))
                xd = slice(max(0, -dx), nx + min(0, -dx))
                ys = slice(max(0, dy), nx + min(0, dy))
                yd = slice(max(0, -dy), nx + min(0, -dy))
                zs = slice(max(0, dz), nx + min(0, dz))
                zd = slice(max(0, -dz), nx + min(0, -dz))
                shifted[xd, yd, zd] = particles[xs, ys, zs]
                cost += particles * shifted  # pairwise interactions
    return cost.reshape(-1) / 10.0  # heavy iterations (~1e3 units each)


def moe_router(n_tokens: int, n_experts: int, k: int, seed: int = 0,
               skew: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """A zipf-skewed MoE router, drawn as the reference's dispatch
    benchmark draws it: gumbel noise plus log zipf(`skew`) popularity per
    expert, the top-k experts of each token, then combine weights
    `rng.random + 0.1` renormalised per token. Every expert sees traffic
    at skew 1.0, the hot ones several times the mean. Returns (e_topk
    (n_tokens, k) int32, weights (n_tokens, k) float32)."""
    rng = np.random.default_rng(seed)
    pop = np.arange(1, n_experts + 1, dtype=np.float64) ** -float(skew)
    logits = rng.gumbel(size=(n_tokens, n_experts)) + np.log(pop)[None]
    e_topk = np.argsort(-logits, axis=1)[:, :k].astype(np.int32)
    w = (rng.random((n_tokens, k)) + 0.1).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    return e_topk, w


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    area: str
    mean: float     # x-bar: avg nnz/row
    ratio: float    # max/min nnz per row
    sigma2: float   # variance of nnz/row


# Paper Table 1: distributional stats of the evaluation matrices
# (SuiteSparse collection names).
TABLE1: list[MatrixSpec] = [
    MatrixSpec("FullChip", "Freescale", 8.9, 1.1e6, 3.2e6),
    MatrixSpec("circuit5M_dc", "Freescale", 4.2, 12, 1.0),
    MatrixSpec("wikipedia", "Gleich", 12.6, 1.8e5, 6.2e4),
    MatrixSpec("patents", "Pajek", 3.9, 762, 31.5),
    MatrixSpec("AS365", "DIMACS", 5.9, 4.6, 0.7),
    MatrixSpec("delaunay_n23", "DIMACS", 5.9, 7, 1.7),
    MatrixSpec("wb-edu", "Gleich", 5.8, 2.5e4, 2.0e3),
    MatrixSpec("hugebubbles-10", "DIMACS", 2.9, 1, 0.0),
    MatrixSpec("arabic-2005", "LAW", 28.1, 5.7e5, 3.0e5),
    MatrixSpec("road_usa", "DIMACS", 2.4, 4.5, 0.8),
    MatrixSpec("nlpkkt240", "Schenk", 27.1, 4.6, 4.8),
    MatrixSpec("uk-2005", "LAW", 23.7, 1.7e6, 2.7e6),
    MatrixSpec("kmer_P1a", "GenBank", 2.1, 20, 0.4),
    MatrixSpec("kmer_A2a", "GenBank", 2.1, 20, 0.3),
    MatrixSpec("kmer_V1r", "GenBank", 2.1, 4, 0.3),
]

# Per-item share cap for synthesized hub rows, as a multiple of the mean
# row: over-cap hubs are split k ways (k rows of degree/k), preserving the
# total hub mass and hence the nnz distribution's mean and skew.
HUB_DEG_CAP = 8.0

# Per-RUN share cap for hub placement: heavy rows stay clustered in
# contiguous runs (natural host/domain orderings, paper Fig. 1a/1b), but a
# single run holds at most this fraction of one thread's fair share at the
# paper's machine width.
HUB_RUN_SHARE = 0.25
_P_REF = 28  # the paper's thread count (Table 2 evaluation width)


def matrix_row_nnz(spec: MatrixSpec, n: int = 150_000,
                   seed: int = 0) -> np.ndarray:
    """Sample a row-nnz sequence approximately matching (mean, ratio,
    sigma2): a low-variance lognormal body plus a small set of hub rows
    placed in contiguous runs, with hub degrees and per-run masses capped
    (HUB_DEG_CAP / HUB_RUN_SHARE)."""
    # crc32, not hash(): str hashing is randomized per process
    rng = np.random.default_rng(seed + zlib.crc32(spec.name.encode()))
    mean, sigma2, ratio = spec.mean, spec.sigma2, max(spec.ratio, 1.0)
    hub_deg = max(1.0, min(ratio, n / 10.0))  # at simulation scale
    # hubs explain the variance beyond what a tame body can carry, but may
    # consume at most half the mean mass
    body_var = min(sigma2, max(1.0, mean) ** 2)
    hub_var = max(0.0, sigma2 - body_var)
    n_hubs = 0
    if hub_var > 0 and hub_deg > mean:
        by_var = math.ceil(hub_var * n / (hub_deg**2))
        by_mass = math.floor(0.5 * mean * n / hub_deg)
        n_hubs = int(max(1, min(by_var, by_mass, n // 50)))
        max_deg = max(mean + 1.0, HUB_DEG_CAP * mean)
        if hub_deg > max_deg:
            k = math.ceil(hub_deg / max_deg)
            n_hubs = min(n_hubs * k, n // 2)
            hub_deg = max(1.0, round(hub_deg / k))
    hub_mass = n_hubs * hub_deg / n
    body_mean = max(1.0, mean - hub_mass)
    if body_var > 0.05 * body_mean**2:
        s2 = math.log(1.0 + body_var / body_mean**2)
        mu = math.log(body_mean) - s2 / 2.0
        body = rng.lognormal(mu, math.sqrt(s2), size=n)
    else:
        body = rng.normal(body_mean, math.sqrt(max(body_var, 1e-12)), size=n)
    nnz = np.maximum(np.round(body), 1.0)
    if n_hubs > 0:
        # contiguous heavy runs, one per segment of the index space
        run_mass = HUB_RUN_SHARE * mean * n / _P_REF
        per_run = max(1, int(run_mass / hub_deg))
        m = math.ceil(n_hubs / per_run)
        seg = np.linspace(0, n, m + 1).astype(np.int64)
        left = n_hubs
        for i in range(m):
            take = min(per_run, left)
            start = int(rng.integers(seg[i],
                                     max(seg[i + 1] - take, seg[i] + 1)))
            nnz[start:start + take] = hub_deg
            left -= take
    return nnz


def spmv_costs(spec: MatrixSpec, n: int = 150_000,
               seed: int = 0) -> np.ndarray:
    """Row cost = row overhead (1) + 1 per nonzero (multiply-add +
    gather)."""
    return 1.0 + matrix_row_nnz(spec, n, seed)


def achieved_stats(nnz: np.ndarray) -> tuple[float, float, float]:
    return float(nnz.mean()), float(nnz.max() / max(nnz.min(), 1.0)), float(nnz.var())
