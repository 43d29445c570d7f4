"""iCh-scheduled segmented CSR SpMV: CUDA kernels (`csrc/ich_spmv.cu`),
their wrappers and plain versions (`ich_spmv.py`), and oracles (`ref.py`)."""
