"""Shared scheduler defaults — the port's copy of `repro.sched.defaults`
(the values must stay equal: the parity tests build schedules through
both packages and require identical tiles).

Dependency-free: no numpy, no torch, no intra-package imports, so
`core/` can import it without a cycle through the `sched` package init.
"""

# The paper evaluates iCh at eps in {25%, 33%, 50%} (Table 2) and finds the
# method insensitive within the band (eq. 10, Fig. 7); 33% is the midpoint
# schedule construction uses: the band edge mu*(1+eps) picks the tile width.
ICH_EPS = 0.33

# Segment slots per tile (R) for constructed schedules.
ROWS_PER_TILE = 8

# Tile-width clamp for `ich_tile_width` (work units per segment slot).
MIN_WIDTH = 8
MAX_WIDTH = 512

# Tiles per kernel superstep (B): each step of a worker of the sharded
# kernel processes one block of B consecutive tiles of the flat payload.
SUPERSTEP = 8

# Measured-cost feedback: weight of the observed running mean against the
# a-priori estimate once an item has been observed (1.0 trusts
# measurements fully, the paper's posture). Unobserved items keep their
# prior.
REFINE_BLEND = 1.0

# MoE expert dispatch (`sched/moe.py`): per-expert capacity is the chunk-
# size analogue. C_base = ceil(K * T * factor / E), floored at
# MOE_MIN_CAPACITY; the compiled expert buffer is MOE_CMAX_FACTOR * C_base,
# and cap_scale (the d_i array) is clipped to [MOE_CAP_SCALE_MIN,
# MOE_CAP_SCALE_MAX] so it never asks for more than that buffer.
MOE_CAPACITY_FACTOR = 1.25
MOE_CMAX_FACTOR = 2.0
MOE_MIN_CAPACITY = 4
MOE_CAP_SCALE_MIN = 0.25
MOE_CAP_SCALE_MAX = 2.0
