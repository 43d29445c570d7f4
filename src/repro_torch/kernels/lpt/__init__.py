"""The two CUDA kernels of the device schedule pipeline
(`csrc/lpt.cu`): the exact float64 segment fold and the LPT worker
assignment, with their wrappers and plain versions (`lpt.py`)."""
