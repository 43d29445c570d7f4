"""Causal GQA flash attention: the CUDA kernel (`csrc/flash_attention.cu`),
its wrapper and plain version (`flash_attention.py`), and the oracle
(`ref.py`)."""
