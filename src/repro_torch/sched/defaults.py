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
