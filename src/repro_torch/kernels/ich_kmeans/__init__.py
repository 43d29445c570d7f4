"""iCh-scheduled K-Means assignment: CUDA kernels (`csrc/ich_kmeans.cu`),
their wrappers and plain versions (`ich_kmeans.py`), and oracles
(`ref.py`)."""
