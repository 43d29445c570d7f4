"""Host-side scheduler core of the port: tile construction (numpy), the
policy descriptors and chunk laws, Welford statistics, the discrete-event
simulator, the threaded executor, the paper's workload generators
(Table-1 matrices, BFS graphs, K-Means costs). Two core modules need
torch and are imported on their own: the plain PyTorch segmented epilogue
of the kernels (`core.segmented`) and the schedule pipeline on the card
(`core.tiling_torch`)."""
from .policies import (
    Policy,
    assigned,
    binlpt,
    dynamic,
    guided,
    ich,
    ich_chunk,
    ich_initial_d,
    paper_policy_grid,
    pretiled,
    static,
    stealing,
    taskloop,
)
from .tiling import (
    TileSchedule,
    WorkerShards,
    build_schedule,
    coverage_counts,
    ich_tile_width,
    make_shards,
    pack_csr,
    partition_tiles,
    shard_schedule,
    shards_from_block_perm,
    split_items,
)
from .simulator import (
    SimParams,
    SimResult,
    best_time_over_grid,
    eps_sensitivity,
    replay_refined,
    simulate,
    speedup,
    worst_stealing,
)
from .welford import (WelfordVec, adapt_d, classify, ich_band, steal_merge,
                      LOW, NORMAL, HIGH)
from .executor import parallel_for, ExecStats

__all__ = [
    "Policy", "assigned", "binlpt", "dynamic", "guided", "ich", "ich_chunk",
    "ich_initial_d", "paper_policy_grid", "pretiled", "static", "stealing",
    "taskloop",
    "TileSchedule", "WorkerShards", "build_schedule", "coverage_counts",
    "ich_tile_width", "make_shards", "pack_csr", "partition_tiles",
    "shard_schedule", "shards_from_block_perm", "split_items",
    "SimParams", "SimResult", "best_time_over_grid", "eps_sensitivity",
    "replay_refined", "simulate", "speedup", "worst_stealing",
    "WelfordVec", "adapt_d", "classify", "ich_band", "steal_merge",
    "LOW", "NORMAL", "HIGH", "parallel_for", "ExecStats",
]
