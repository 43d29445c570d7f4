"""Differentiable collectives of the mesh layouts — what the reference's
`shard_map` transposes for the expert-parallel MoE block
(`repro/models/moe.py:287-328`) and what GSPMD inserts for its
tensor-parallel dense layers (`models/layers.py`, `models/attention.py`).

Each is a `torch.autograd.Function` over a `ProcessGroup`. Their
backwards are chosen by which side is replicated, so that the gradient
each rank holds is its share of the global loss's gradient:

* `to_model`: forward identity, backward all-reduce (sum). For a tensor
  replicated over the group (x and the router weights entering the
  experts: every "model" rank holds them, each adds only its own
  experts' part of their gradient).
* `from_model`: forward all-reduce (sum), backward identity. For the
  partial outputs of the ranks' experts.
* `gather_data(t, dim)`: forward all-gather along `dim`, backward
  reduce-scatter (sum). For expert weights stored in shards over
  "data" (FSDP) and gathered whole inside the block.
* `mean_over`: forward all-reduce divided by the group's size, backward
  the gradient divided by it: a scalar averaged over the batch ranks
  (the aux loss), each rank's gradient then summed over them by the
  train step.
* `gather_whole(t, dim)`: forward all-gather, backward this rank's slice
  of the gradient. For a weight split over "model" that a serving layout
  uses whole on every rank.
* `psum(x)`: forward all-reduce (sum), backward all-reduce (sum). For a
  statistic each rank adds its part to and then uses whole (the sum of
  squares of Mamba2's gated RMSNorm over its d_in split across "model"):
  every rank's use of the sum sends back a gradient, and each part needs
  them all.
* `scatter_sum(t, dim)`: forward reduce-scatter (sum) along `dim`,
  backward all-gather. For partial sums of every output column that each
  rank then keeps only its slice of (mLSTM's q, k, v and gates from
  row-split weights, scattered onto the rank's heads).

On a one-rank group each returns its input: the same bits as no
collective, and no copy.

Under the dry run (`launch/dryrun.py`) every call is also recorded
(`recording`): its kind, result bytes, group size and mesh axis, which
`launch/collective_stats.py` totals. Nothing is recorded otherwise.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# all_gather_single / reduce_scatter_single replace the *_tensor names in
# newer PyTorch; both take (output, input, group=)
_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# the dry run's record of the calls issued (None: not recording), and
# the mesh axes each process group spans (`name_group`)
_RECORD = None
_AXES = {}


def name_group(group, axes: tuple) -> None:
    """Remember that `group` spans the mesh axes `axes` (for the record)."""
    _AXES[id(group)] = "+".join(axes)


class recording:
    """Context: every collective issued inside is appended to `calls` as
    {"kind", "result_bytes", "group_size", "axis"} (the dry run)."""

    def __enter__(self):
        global _RECORD
        self._prev = _RECORD
        self.calls = _RECORD = []
        return self

    def __exit__(self, *exc):
        global _RECORD
        _RECORD = self._prev


def _record(kind: str, result: torch.Tensor, group) -> None:
    if _RECORD is not None:
        _RECORD.append({"kind": kind, "group_size": dist.get_world_size(group),
                        "result_bytes": result.numel() * result.element_size(),
                        "axis": _AXES.get(id(group), "?")})


def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """The sum (or `op`, a `dist.ReduceOp`) of t over the group's ranks (a
    new tensor)."""
    if dist.get_world_size(group) > 1:
        t = t.contiguous().clone()
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)
    _record("all-reduce", t, group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of t concatenated along `dim`, in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        _record("all-gather", t, group)
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _gather(out, src, group=group)
    _record("all-gather", out, group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along `dim` of the sum of t over the group."""
    n = dist.get_world_size(group)
    if n == 1:
        _record("reduce-scatter", t, group)
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _reduce_scatter(out, src, op=dist.ReduceOp.SUM, group=group)
    _record("reduce-scatter", out, group)
    return out.movedim(0, dim).contiguous()


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.n = t.shape[dim]
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ToModel.apply(x, group)


def from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _FromModel.apply(x, group)


def gather_data(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherData.apply(t, dim, group)


def gather_whole(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherWhole.apply(t, dim, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _Psum.apply(x, group)


def scatter_sum(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _ScatterSum.apply(t, dim, group)


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    return _MeanOver.apply(x, group)
