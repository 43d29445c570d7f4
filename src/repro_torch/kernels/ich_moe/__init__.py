"""iCh-scheduled MoE expert dispatch: the CUDA kernels (`csrc/ich_moe.cu`),
their wrapper and plain version (`ich_moe.py`), and oracles (`ref.py`)."""
