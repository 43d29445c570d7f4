"""Launchers and the device mesh of the port — the counterpart of
`repro.launch`: `mesh` (process groups, the ("data", "model") `DeviceMesh`,
the 256- and 512-rank production meshes over a fake process group, and
the H100's constants), `collectives` (the differentiable collectives of
the tensor- and expert-parallel layers), the command lines `train` and
`serve`, and the compile-only half: `specs` (each rank's inputs on the
meta device), `dryrun` (one rank's step traced under fake tensors:
memory, operations, collectives), `collective_stats` (the counterpart of
`hlo_stats`), `costmodel` and `roofline` (the analytic terms under the
H100's constants)."""
