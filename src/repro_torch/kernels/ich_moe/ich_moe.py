"""iCh-scheduled MoE expert dispatch: the CUDA kernel's wrapper and its
plain PyTorch version.

* `ich_moe_sharded` — the main path: the gated expert FFN over every slot
  row that the (p, S_B) shard layout of `core.tiling.WorkerShards` names,
  read straight out of the flat (T_pad, R, W) pack of a dispatch plan's
  expert-major CSR (token ids in `cols`, combine weights in `vals`), the
  weighted outputs folded per token, and with `slot_cost` the (p, S_B)
  step costs and (p, E) per-expert costs;
* `MoeSlots` / `moe_slots` — the slot index the kernel reads beside the
  pack, built once per lowering: each slot row's first CSR index and token
  count (so padding lanes are skipped by position, not by value) and the
  token -> slots index of the combine.

For every live slot, in the plan's CSR order,
`ybuf[slot] = (silu(x[tok] . wg[e]) * (x[tok] . wi[e])) . wo[e] * weight`,
and `y[t]` is the left fold of ybuf over token t's slots in ascending slot
order. The plain version (`ich_moe_sharded_plain`) computes each expert's
slots in products of exactly PLAIN_ROWS rows a call (its slots in CSR
order, the last block padded with zeros) and the same fold and cost
folds, so the cost streams agree with the kernel exactly and y to the
rounding of the products' sums: the kernel runs both products on the
tensor cores as three TF32 products each (the 3xTF32 split, float32-level
accuracy; `csrc/ich_moe.cu`). Neither's y row of a token depends on the
other tokens of the plan or on the lowering: the kernel computes each
slot row on its own, and a float32 product's row can change bits with
the call's row count (on the CPU at one row, and at 2,048 wide at some
tens of rows) but not with the row's place in a call of a fixed count. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
`csrc/ich_moe.cu` or raises: there is no fallback. One call of the
wrapper launches five CUDA kernels and counts one launch in `LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.segmented import emit_step_cost
from repro_torch.kernels import _build
from repro_torch.kernels._common import (check, check_shard_layout, on_cpu,
                                         raise_on, shard_tiles)

__all__ = ["LAUNCHES", "MoeSlots", "PLAIN_ROWS", "expert_rows",
           "ich_moe_sharded", "ich_moe_sharded_plain", "moe_slots",
           "reset_launches", "slot_layout", "token_combine", "token_slots"]

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"ich_moe_sharded": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ slot index
class MoeSlots(NamedTuple):
    """What the kernel reads beside the pack, on the pack's device."""

    base: torch.Tensor      # (T_pad, R) int32 CSR index of the row's 1st token
    length: torch.Tensor    # (T_pad, R) int32 tokens in the row (0 = none)
    tok_ptr: torch.Tensor   # (n_tokens + 1,) int32 offsets into tok_slot
    tok_slot: torch.Tensor  # (n_slots,) int32 each token's slots, ascending


def slot_layout(item_id: np.ndarray, sizes: np.ndarray, width: int,
                n_tiles_padded: int) -> tuple[np.ndarray, np.ndarray]:
    """(base, length), each (n_tiles_padded, R) int32, of a schedule's slot
    rows: an item's segments are consecutive in flat tile order, its k-th
    covers units [k*W, k*W + length) of the item, and `base` is the CSR
    index of that first unit (`indptr[item] + k*W`). Padding rows and pad
    tiles have length 0."""
    item_id = np.asarray(item_id)
    sizes = np.asarray(sizes, np.int64)
    T, R = item_id.shape
    flat = item_id.reshape(-1)
    pos = np.flatnonzero(flat >= 0)
    items = flat[pos].astype(np.int64)
    if items.size and (np.any(np.diff(items) < 0) or items[-1] >= sizes.size):
        raise ValueError("slot rows must name items in ascending order, "
                         f"each below {sizes.size}")
    rank = np.arange(items.size) - np.searchsorted(items, items)
    start = rank * int(width)
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    base = np.zeros((n_tiles_padded * R,), np.int64)
    length = np.zeros((n_tiles_padded * R,), np.int64)
    base[pos] = indptr[items] + start
    length[pos] = np.clip(sizes[items] - start, 0, int(width))
    if int(length.sum()) != int(indptr[-1]):
        raise ValueError(f"slot rows cover {int(length.sum())} of "
                         f"{int(indptr[-1])} units: the sizes do not match "
                         "the schedule")
    return (base.reshape(-1, R).astype(np.int32),
            length.reshape(-1, R).astype(np.int32))


def token_slots(tokens: np.ndarray,
                n_tokens: int) -> tuple[np.ndarray, np.ndarray]:
    """(tok_ptr (n_tokens+1,), tok_slot (n_slots,)), int32: the slots of
    token t are tok_slot[tok_ptr[t]:tok_ptr[t+1]], ascending, for the
    (n_slots,) token id of every slot."""
    tokens = np.asarray(tokens, np.int64)
    if tokens.size and (int(tokens.min()) < 0
                        or int(tokens.max()) >= n_tokens):
        raise ValueError(f"token ids must lie in [0, {n_tokens})")
    tok_ptr = np.zeros(n_tokens + 1, np.int64)
    np.cumsum(np.bincount(tokens, minlength=n_tokens), out=tok_ptr[1:])
    tok_slot = np.argsort(tokens, kind="stable")
    return tok_ptr.astype(np.int32), tok_slot.astype(np.int32)


def moe_slots(item_id: np.ndarray, sizes: np.ndarray, cols: np.ndarray,
              n_tokens: int, device) -> MoeSlots:
    """The `MoeSlots` of a lowering: its (T, R) tile item ids, the per-item
    token counts the plan's CSR was laid out with, and the packed
    (T_pad, R, W) token ids."""
    cols = np.asarray(cols)
    T_pad, R, W = cols.shape
    base, length = slot_layout(item_id, sizes, W, T_pad)
    # token id of every slot, in CSR order: slot base + m holds lane m
    flat_len = length.reshape(-1).astype(np.int64)
    row = np.repeat(np.arange(flat_len.size), flat_len)
    lane = np.arange(row.size) - np.repeat(np.cumsum(flat_len) - flat_len,
                                           flat_len)
    tokens = np.empty(row.size, np.int64)
    tokens[base.reshape(-1)[row].astype(np.int64) + lane] = \
        cols.reshape(-1, W)[row, lane]
    tok_ptr, tok_slot = token_slots(tokens, n_tokens)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return MoeSlots(put(base), put(length), put(tok_ptr), put(tok_slot))


# --------------------------------------------------------- plain versions
PLAIN_ROWS = 128   # rows of every product call of the plain version


def expert_rows(xs, wi, wg, wo) -> torch.Tensor:
    """(silu(xs . wg) * (xs . wi)) . wo of the rows xs (n, D) of one
    expert, in calls of exactly PLAIN_ROWS rows, the last padded with
    zeros: a row's bits depend on that row alone."""
    n = xs.shape[0]
    blocks = torch.nn.functional.pad(xs, (0, 0, 0, -n % PLAIN_ROWS))
    out = []
    for xb in blocks.split(PLAIN_ROWS):
        g = xb @ wg
        out.append((g / (1.0 + torch.exp(-g)) * (xb @ wi)) @ wo)
    return torch.cat(out)[:n]


def token_combine(ybuf: torch.Tensor, tok_ptr: torch.Tensor,
                  tok_slot: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """(n_tokens, D): the left fold from +0.0, ascending slot order, of
    ybuf's rows over each token's slots — the kernel's combine."""
    y = torch.zeros((n_tokens, ybuf.shape[1]), dtype=torch.float32,
                    device=ybuf.device)
    ptr = tok_ptr.long()
    count = ptr[1:] - ptr[:-1]
    most = int(count.max()) if n_tokens else 0
    slot = tok_slot.long()
    for k in range(most):
        has = count > k
        idx = slot[torch.where(has, ptr[:-1] + k, 0)]
        y = torch.where(has[:, None], y + ybuf[idx], y)
    return y


def ich_moe_sharded_plain(vals, cols, rowid, blkid, x, wi, wg, wo, p: int,
                          superstep: int, slots: MoeSlots, *,
                          slot_cost=None):
    """Plain version of `ich_moe_sharded`: the same slots, the gated FFN of
    each expert over its slots in CSR order (`expert_rows`), the same
    token fold and cost folds."""
    T_pad, R, W = vals.shape
    n_tokens, D = x.shape
    E = wi.shape[0]
    B = int(superstep)
    S_B = blkid.numel() // p
    tiles = shard_tiles(blkid, B)                          # (p*S,)
    experts = rowid.long().reshape(-1)                     # (p*S*R,)
    flat = (tiles[:, None] * R + torch.arange(R, device=x.device)).reshape(-1)
    named = experts >= 0
    flat, experts = flat[named], experts[named]
    lens = slots.length.reshape(-1)[flat].long()
    row = torch.repeat_interleave(torch.arange(flat.numel(), device=x.device),
                                  lens)
    lane = torch.arange(row.numel(), device=x.device) \
        - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    fr = flat[row]
    slot = slots.base.reshape(-1)[fr].long() + lane
    order = torch.argsort(slot)          # CSR order: expert-major, as planned
    slot, fr, lane, ex = slot[order], fr[order], lane[order], \
        experts[row][order]
    tok = cols.reshape(-1, W)[fr, lane].long()
    wt = vals.reshape(-1, W)[fr, lane]
    ybuf = torch.zeros((slots.tok_slot.numel(), D), dtype=torch.float32,
                       device=x.device)
    start = 0
    for e, c in enumerate(torch.bincount(ex, minlength=E).tolist()):
        if c == 0:
            continue
        sl = slice(start, start + c)
        ybuf[slot[sl]] = expert_rows(x[tok[sl]], wi[e], wg[e], wo[e]) \
            * wt[sl, None]
        start += c
    y = token_combine(ybuf, slots.tok_ptr, slots.tok_slot, n_tokens)
    if slot_cost is None:
        return y
    S = S_B * B
    sc = slot_cost[tiles]                                  # (p*S, R)
    costs = emit_step_cost(rowid.reshape(p * S_B, B * R),
                           sc.reshape(p * S_B, B * R)).view(p, S_B)
    # expert costs: each worker's slots folded in shard order
    ecosts = torch.zeros((p, E), dtype=torch.float32, device=x.device)
    ew, cw = rowid.long().view(p, S * R), sc.view(p, S * R)
    workers = torch.arange(p, device=x.device)
    for k in range(S * R):
        ok = ew[:, k] >= 0
        e = ew[:, k].clamp(min=0)
        cur = ecosts[workers, e]
        ecosts[workers, e] = torch.where(ok, cur + cw[:, k], cur)
    return y, costs, ecosts


# --------------------------------------------------------------- wrapper
def _lib() -> ctypes.CDLL:
    lib = _build.load("ich_moe")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ich_moe_sharded_launch.argtypes = [ptr] * 19 + [i32] * 9 + [
            ctypes.c_int64, ptr]
        lib.ich_moe_sharded_launch.restype = i32
        lib._typed = True
    return lib


def ich_moe_sharded(vals, cols, rowid, blkid, x, wi, wg, wo, p: int,
                    superstep: int, slots: MoeSlots, *, slot_cost=None):
    """Worker-sharded MoE expert application over a packed dispatch plan.

    vals/cols (T_pad, R, W): the flat pack of the plan's expert-major CSR
    (combine weights, token ids), T padded to whole supersteps; rowid
    (p*S, R) per-slot expert ids and blkid (p*S_B,) from `WorkerShards`;
    `slots` from `moe_slots`; x (n_tokens, D); wi/wg (E, D, F), wo (E, F,
    D), all float32. Returns y (n_tokens, D), or (y, step_costs (p, S_B),
    expert_costs (p, E)) when `slot_cost`, the (T_pad, R) per-slot cost
    stream, is given."""
    T_pad, R, W = vals.shape
    n_tokens, D = x.shape
    E = wi.shape[0]
    p, B = int(p), int(superstep)
    S_B = check_shard_layout(T_pad, rowid, blkid, p, B)
    if on_cpu(vals, cols, rowid, blkid, x, wi, wg, wo, slot_cost, *slots):
        return ich_moe_sharded_plain(vals, cols, rowid, blkid, x, wi, wg, wo,
                                     p, B, slots, slot_cost=slot_cost)
    if D < 1 or wi.ndim != 3 or wi.shape[1] != D or wi.shape[2] < 1:
        raise ValueError(f"x (n_tokens, D) and wi (E, D, F >= 1) disagree: "
                         f"{tuple(x.shape)}, {tuple(wi.shape)}")
    F = wi.shape[2]
    check("vals", vals, torch.float32)
    check("cols", cols, torch.int32, (T_pad, R, W))
    check("rowid", rowid, torch.int32, (p * S_B * B, R))
    check("blkid", blkid, torch.int32, (p * S_B,))
    check("x", x, torch.float32)
    check("wi", wi, torch.float32)
    check("wg", wg, torch.float32, (E, D, F))
    check("wo", wo, torch.float32, (E, F, D))
    check("slots.base", slots.base, torch.int32, (T_pad, R))
    check("slots.length", slots.length, torch.int32, (T_pad, R))
    check("slots.tok_ptr", slots.tok_ptr, torch.int32, (n_tokens + 1,))
    check("slots.tok_slot", slots.tok_slot, torch.int32)
    if slot_cost is not None:
        check("slot_cost", slot_cost, torch.float32, (T_pad, R))
    dev = x.device
    n_slots = slots.tok_slot.numel()
    # the expert each flat slot row runs, -1 where the shard layout names
    # none (written by the launch's first kernel)
    named = torch.full((T_pad * R,), -1, dtype=torch.int32, device=dev)
    abuf = torch.empty((n_slots, F), dtype=torch.float32, device=dev)
    # zeroed: the combine reads every slot, named by the lowering or not
    ybuf = torch.zeros((n_slots, D), dtype=torch.float32, device=dev)
    y = torch.empty((n_tokens, D), dtype=torch.float32, device=dev)
    costs = ecosts = None
    if slot_cost is not None:
        costs = torch.empty((p, S_B), dtype=torch.float32, device=dev)
        ecosts = torch.empty((p, E), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _lib().ich_moe_sharded_launch(
        vals.data_ptr(), cols.data_ptr(), rowid.data_ptr(), blkid.data_ptr(),
        slots.base.data_ptr(), slots.length.data_ptr(),
        slots.tok_ptr.data_ptr(), slots.tok_slot.data_ptr(),
        None if slot_cost is None else slot_cost.data_ptr(), x.data_ptr(),
        wi.data_ptr(), wg.data_ptr(), wo.data_ptr(), named.data_ptr(),
        abuf.data_ptr(), ybuf.data_ptr(), y.data_ptr(),
        None if costs is None else costs.data_ptr(),
        None if ecosts is None else ecosts.data_ptr(),
        p, S_B, B, R, W, n_tokens, D, F, E, T_pad * R, stream)
    raise_on(code, "ich_moe_sharded")
    LAUNCHES["ich_moe_sharded"] += 1
    return y if costs is None else (y, costs, ecosts)
