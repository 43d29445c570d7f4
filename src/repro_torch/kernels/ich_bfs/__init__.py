"""iCh-scheduled pull-direction BFS: CUDA kernels (`csrc/ich_bfs.cu`), their
wrappers and plain versions (`ich_bfs.py`), and oracles (`ref.py`)."""
