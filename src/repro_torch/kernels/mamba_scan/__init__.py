"""Chunked SSD scan (Mamba2): the CUDA kernel (`csrc/mamba_scan.cu`), its
wrapper and plain version (`mamba_scan.py`), and the sequential-recurrence
oracle (`ref.py`)."""
