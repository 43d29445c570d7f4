"""Carry state across from the reference package.

The system has no weights: its state is the lowered schedule and the
packed payload. `spmv_op_from_reference` takes them as numpy arrays — the
reference's `TileSchedule` (`item_id`, `width`, `rows_per_tile`), its
`WorkerShards` (`worker`, `block_perm`, `superstep`), the packed
`vals`/`cols` and the (T_pad, R) slot-cost stream — and builds the port's
`SpmvOp` over exactly that lowering, so both packages' kernels can be fed
the same bytes. Nothing here imports the reference: the caller hands the
arrays over.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.tiling import WorkerShards
from repro_torch.sched.kernels import SpmvOp


def spmv_op_from_reference(*, item_id, width: int, rows_per_tile: int,
                           worker, block_perm, superstep: int, vals, cols,
                           slot_cost, n_rows: int, device=None) -> SpmvOp:
    """The port's `SpmvOp` over a lowering given as numpy arrays (see the
    module docstring). Raises when the arrays disagree on shape."""
    item_id = np.asarray(item_id, np.int32)
    vals = np.asarray(vals, np.float32)
    cols = np.asarray(cols, np.int32)
    slot_cost = np.asarray(slot_cost, np.float32)
    R, W, B = int(rows_per_tile), int(width), int(superstep)
    T = item_id.shape[0]
    T_pad = -(-T // B) * B
    if item_id.shape != (T, R) or vals.shape != (T_pad, R, W) \
            or cols.shape != vals.shape or slot_cost.shape != (T_pad, R):
        raise ValueError(
            f"lowering shapes disagree: item_id {item_id.shape}, vals "
            f"{vals.shape}, cols {cols.shape}, slot_cost {slot_cost.shape} "
            f"for R={R}, W={W}, B={B}")
    shards = WorkerShards(worker=np.asarray(worker, np.int32),
                          block_perm=np.asarray(block_perm, np.int32),
                          superstep=B)
    return SpmvOp.from_lowering(item_id, shards, vals, cols, slot_cost,
                                n_rows, device=device)
