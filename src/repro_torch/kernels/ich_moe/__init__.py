"""iCh-scheduled MoE expert dispatch: the CUDA kernels (`csrc/ich_moe.cu`),
their wrapper and plain version (`ich_moe.py`), the backward's
(`csrc/ich_moe_bwd.cu`, `ich_moe_bwd.py`), and oracles (`ref.py`)."""
