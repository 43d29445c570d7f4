"""The port's hand-written CUDA kernels for Hopper, one package per kernel
family; `_build.py` compiles `repro_torch/csrc/*.cu` on first use."""
