"""Collective traffic of one rank's step — the port's counterpart of
`repro.launch.hlo_stats`.

There is no HLO to parse: under the dry run the port's own collectives
(`launch/collectives.py`) record each call they issue, with its kind,
result bytes, group size and mesh axis. `summarize` turns those records
into operand bytes and ring-algorithm wire bytes per participating rank
(the number that divides by link bandwidth), with `hlo_stats`' formulas
(`repro/launch/hlo_stats.py:79-93`) kept as the same expressions, and
totals them by kind and by axis.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict


def ring_bytes(kind: str, rb: float, g: int) -> tuple:
    """(operand bytes, wire bytes a rank) of one collective with result
    bytes rb over a group of g ranks (`hlo_stats.parse_collectives`)."""
    if kind == "all-gather":
        ob = rb / max(g, 1)
        wire = rb * (g - 1) / max(g, 1)
    elif kind == "reduce-scatter":
        ob = rb * g
        wire = rb * (g - 1)
    elif kind == "all-reduce":
        ob = rb
        wire = 2.0 * rb * (g - 1) / max(g, 1)
    elif kind == "all-to-all":
        ob = rb
        wire = rb * (g - 1) / max(g, 1)
    else:  # collective-permute
        ob = rb
        wire = rb
    return ob, wire


@dataclasses.dataclass
class CollectiveStats:
    # per kind and per axis: [count, result_bytes, operand_bytes,
    # wire_bytes_per_device]
    by_kind: dict
    by_axis: dict
    total_operand_bytes: float
    total_wire_bytes: float

    def summary(self) -> str:
        lines = []
        for k, (c, rb, ob, wb) in sorted(self.by_kind.items()):
            lines.append(f"{k:20s} n={c:4d} result={rb/1e6:10.1f}MB "
                         f"operand={ob/1e6:10.1f}MB wire/dev={wb/1e6:10.1f}MB")
        return "\n".join(lines)


def summarize(calls) -> CollectiveStats:
    """Totals of recorded calls ({"kind", "result_bytes", "group_size",
    "axis"}, `collectives.recording`)."""
    by_kind = defaultdict(lambda: [0, 0.0, 0.0, 0.0])
    by_axis = defaultdict(lambda: [0, 0.0, 0.0, 0.0])
    for call in calls:
        rb, g = call["result_bytes"], call["group_size"]
        ob, wire = ring_bytes(call["kind"], rb, g)
        for ent in (by_kind[call["kind"]], by_axis[call["axis"]]):
            ent[0] += 1
            ent[1] += rb
            ent[2] += ob
            ent[3] += wire
    total_ob = sum(v[2] for v in by_kind.values())
    total_wb = sum(v[3] for v in by_kind.values())
    return CollectiveStats(dict(by_kind), dict(by_axis), total_ob, total_wb)
