"""Oracle for the iCh-scheduled K-Means kernels, independent of the
schedule: the nearest centroid of every point."""
from __future__ import annotations

import torch


def kmeans_assign_ref(points, centroids) -> torch.Tensor:
    """argmin_k ||x_i - c_k||^2 over the whole (n, D) table, as int32 (a
    summed reduction over D, not the kernels' left fold: points within an
    ulp of two centroids may differ)."""
    d2 = ((points[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    return d2.argmin(dim=1).to(torch.int32)
