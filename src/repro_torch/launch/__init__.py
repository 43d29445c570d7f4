"""Launchers and the device mesh of the port — the counterpart of
`repro.launch` for what the reference executes: `mesh` (process groups
and the ("data", "model") `DeviceMesh`), `collectives` (the
differentiable collectives of the expert-parallel MoE block), and the
command lines `train` and `serve`. The reference's compile-only dry run
(`dryrun`, `specs`, `costmodel`, `roofline`, `hlo_stats`) is not ported
yet (ROADMAP.md queue 1 item 6b)."""
