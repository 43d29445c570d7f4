"""Host-side scheduler core of the port: tile construction (numpy), the
policy descriptors, Welford statistics, Table-1 workloads, and the plain
PyTorch segmented epilogue of the kernels."""
