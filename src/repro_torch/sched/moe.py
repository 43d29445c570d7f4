"""MoE expert dispatch as a scheduling problem — the port's copy of
`repro.sched.moe` (the arrays it returns must stay element-identical to
the original's: the parity tests plan through both packages).

The paper's loop-scheduling problem reappears in MoE routing: tokens are
loop iterations, experts are the irregular items, per-expert *capacity* is
the chunk size, and overflow rerouting is the steal — done at SCHEDULE
time, on the host, not at run time:

* `plan_dispatch` resolves the router's top-K choices into a
  `DispatchPlan`: stable-argsort positions inside each expert segment, a
  `pos < cap` capacity cut, and one steal round that reroutes each
  overflowing entry to its token's max-slack alternative;
* `DispatchPlan.csr()` lays the kept entries out as an expert-major CSR
  (indptr over experts, token ids + combine weights as payload), the shape
  `LoopScheduler.schedule` consumes through `ExpertLoadCosts` and the
  sharded MoE kernel executes (`sched/kernels.py:MoeDispatchOp`);
* `cap_scale_from_costs` / `refine_cap_scale` close the adaptive loop:
  measured per-expert load folds into the schedule's `CostRefiner`
  (`Schedule.observe` / `refine`) and the refined estimates become the
  next step's `cap_scale`.

Everything here is numpy: planning runs on the host between steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .defaults import (MOE_CAP_SCALE_MAX, MOE_CAP_SCALE_MIN,
                       MOE_CAPACITY_FACTOR, MOE_CMAX_FACTOR, MOE_MIN_CAPACITY)

__all__ = ["DispatchPlan", "expert_capacity", "plan_dispatch",
           "cap_scale_from_costs", "refine_cap_scale"]


def expert_capacity(n_tokens: int, n_experts: int, experts_per_token: int,
                    factor: float = MOE_CAPACITY_FACTOR) -> int:
    """Base per-expert capacity for a token pool: ceil(K*T*factor/E),
    floored at MOE_MIN_CAPACITY. The chunk-size analogue."""
    return max(MOE_MIN_CAPACITY,
               int(-(-experts_per_token * n_tokens * factor // n_experts)))


def _dispatch_positions(experts_flat: np.ndarray, n_experts: int):
    """Position of each (token, choice) entry within its expert segment:
    stable argsort, searchsorted segment starts, positions scattered
    back."""
    order = np.argsort(experts_flat, kind="stable")
    es = experts_flat[order]
    seg_start = np.searchsorted(es, np.arange(n_experts))
    pos_sorted = np.arange(es.shape[0], dtype=np.int64) - seg_start[es]
    pos = np.zeros_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """A resolved token->expert dispatch: which (token, choice) entries run
    where after the capacity cut and the schedule-time steal round.

    Entry arrays are flat over the (T, K) router choices in token-major
    order (entry t*K + k is token t's k-th choice). `expert`/`pos` are the
    FINAL assignment — a stolen entry points at its steal target, not its
    router choice."""

    n_tokens: int
    n_experts: int
    experts_per_token: int
    expert: np.ndarray      # (T*K,) int32 final expert per entry
    token: np.ndarray       # (T*K,) int32 token id per entry
    weight: np.ndarray      # (T*K,) float32 combine weight per entry
    pos: np.ndarray         # (T*K,) int64 slot within the expert segment
    keep: np.ndarray        # (T*K,) bool — entry survives dispatch
    cap: np.ndarray         # (E,) int32 per-expert capacity used
    counts: np.ndarray      # (E,) int64 kept token load per expert
    router_counts: np.ndarray  # (E,) int64 pre-cut router demand
    stolen: int             # entries rerouted by the steal round
    dropped: int            # entries dropped after the steal round

    def csr(self):
        """Kept entries as an expert-major CSR: (indptr (E+1,), token ids,
        combine weights), tokens of one expert ordered by dispatch slot.

        Kept slots per expert are contiguous [0, counts[e]) — first-round
        keeps occupy [0, used_e) and stolen entries are ranked from
        used_e up — so scattering by `indptr[expert] + pos` is a
        permutation of the kept entries, no gaps."""
        indptr, entry = self.csr_entries()
        return indptr, self.token[entry], self.weight[entry]

    def csr_entries(self):
        """(indptr (E+1,), entry (n_slots,) int64): the flat (token,
        choice) entry t*K + k that each slot of `csr()` holds, at
        `indptr[expert] + pos` — the map by which a gradient of the CSR's
        combine weights goes back to the router's (T, K) weights."""
        indptr = np.zeros(self.n_experts + 1, np.int64)
        np.cumsum(self.counts, out=indptr[1:])
        kept = np.flatnonzero(self.keep)
        entry = np.zeros(int(indptr[-1]), np.int64)
        entry[indptr[self.expert[kept]] + self.pos[kept]] = kept
        return indptr, entry


def plan_dispatch(e_topk: np.ndarray, weights: np.ndarray = None, *,
                  cap=None, cap_scale=None,
                  capacity_factor: float = MOE_CAPACITY_FACTOR,
                  cmax_factor: float = MOE_CMAX_FACTOR,
                  steal: bool = True) -> DispatchPlan:
    """Resolve a dispatch plan from router choices.

    e_topk (T, K): the router's top-K expert ids per token, with implied
    expert count E = max id + 1 unless `cap` fixes it. weights (T, K):
    combine weights (defaults to 1/K). Capacity comes either from `cap`
    ((E,) int, used verbatim) or from `cap_scale` ((E,) float, the d_i
    array) through the clip-to-[MOE_MIN_CAPACITY, C_max] rule;
    `cap_scale=None` means scale 1 everywhere.

    Decisions: entries take stable-sort positions inside their expert
    segment and survive while `pos < cap[expert]`; with `steal`, each
    overflowing entry is rerouted to its token's max-slack alternative
    (first max on ties) and ranked after the expert's first-round keeps,
    surviving under the same capacity rule.
    """
    e_topk = np.asarray(e_topk)
    if e_topk.ndim != 2:
        raise ValueError(f"e_topk must be (T, K), got {e_topk.shape}")
    T, K = e_topk.shape
    if weights is None:
        weights = np.full((T, K), 1.0 / K, np.float32)
    weights = np.asarray(weights, np.float32)
    if weights.shape != (T, K):
        raise ValueError(f"weights {weights.shape} != e_topk {(T, K)}")

    if cap is not None:
        cap_e = np.asarray(cap, np.int32)
        E = cap_e.shape[0]
    else:
        E = int(e_topk.max()) + 1 if e_topk.size else 1
        if cap_scale is None:
            cap_scale = np.ones(E, np.float64)
        cap_scale = np.asarray(cap_scale, np.float64)
        E = cap_scale.shape[0]
        c_base = expert_capacity(T, E, K, capacity_factor)
        c_max = max(c_base, int(round(cmax_factor * c_base)))
        cap_e = np.clip(np.round(c_base * cap_scale),
                        MOE_MIN_CAPACITY, c_max).astype(np.int32)
    if (e_topk < 0).any() or (e_topk >= E).any():
        raise ValueError(f"expert ids out of range [0, {E})")

    ef = e_topk.reshape(-1).astype(np.int64)
    tf = np.repeat(np.arange(T, dtype=np.int32), K)
    wf = weights.reshape(-1)
    router_counts = np.bincount(ef, minlength=E).astype(np.int64)

    pos = _dispatch_positions(ef, E)
    keep = pos < cap_e[ef]

    if steal:
        # float32 slack, as the in-graph argmax computes it (counts and
        # capacities are exact integers well under 2^24 in float32)
        slack = np.maximum(cap_e.astype(np.float32)
                           - router_counts.astype(np.float32), 0.0)
        alt_slack = slack[e_topk]                                    # (T,K)
        fallback = e_topk[np.arange(T), np.argmax(alt_slack, axis=-1)]
        ef2 = np.where(keep, ef, fallback[tf])
        used = np.bincount(ef[keep], minlength=E).astype(np.int64)
        # rank stolen entries only: kept entries park on sentinel E+1
        pos2 = _dispatch_positions(np.where(keep, E + 1, ef2), E + 2)
        pos2 = pos2 + used[ef2]
        keep2 = (~keep) & (pos2 < cap_e[ef2])
        ef = np.where(keep2, ef2, ef)
        pos = np.where(keep2, pos2, pos)
        stolen = int(keep2.sum())
        keep = keep | keep2
    else:
        stolen = 0

    counts = np.bincount(ef[keep], minlength=E).astype(np.int64)
    return DispatchPlan(
        n_tokens=T, n_experts=E, experts_per_token=K,
        expert=ef.astype(np.int32), token=tf, weight=wf, pos=pos,
        keep=keep, cap=cap_e, counts=counts, router_counts=router_counts,
        stolen=stolen, dropped=int((~keep).sum()))


# ---------------------------------------------------------------------------
# Closing the loop: measured expert load -> next step's cap_scale
# ---------------------------------------------------------------------------

def cap_scale_from_costs(costs: np.ndarray, *,
                         lo: float = MOE_CAP_SCALE_MIN,
                         hi: float = MOE_CAP_SCALE_MAX) -> np.ndarray:
    """Per-expert capacity scale from (refined) per-expert costs: the
    cost-to-mean ratio clipped to the materializable range, renormalized
    only when the total EXCEEDS the budget (sum == E)."""
    costs = np.asarray(costs, np.float64)
    mu = costs.mean() if costs.size else 0.0
    if mu <= 0:
        return np.ones_like(costs)
    scale = np.clip(costs / mu, lo, hi)
    over = scale.sum() / scale.size
    return scale / over if over > 1.0 else scale


def refine_cap_scale(schedule, measured: np.ndarray, *,
                     blend: float = None,
                     lo: float = MOE_CAP_SCALE_MIN,
                     hi: float = MOE_CAP_SCALE_MAX):
    """One closed-loop round: fold measured per-expert load (what the
    sharded MoE kernel's per-expert cost output sums to,
    `MoeDispatchOp.expert_load()`) into the schedule's `CostRefiner`,
    re-lower, and derive the next step's cap_scale from the refined
    estimates.

    Returns `(refined_schedule, cap_scale)`. On a structural
    (integer-count) workload repeated rounds reach a fixed point: once the
    Welford means equal the true loads, the schedule and the scale stop
    moving."""
    refined = schedule.observe(np.asarray(measured, np.float64),
                               level="item").refine(blend=blend)
    return refined, cap_scale_from_costs(refined.costs, lo=lo, hi=hi)
