"""Host-side scheduler core of the port: tile construction (numpy), the
policy descriptors, Welford statistics, the paper's workload generators
(Table-1 matrices, BFS graphs, K-Means costs), and the plain PyTorch
segmented epilogue of the kernels."""
