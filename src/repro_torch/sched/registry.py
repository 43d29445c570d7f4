"""Workload/kernel registry — the port's own, separate from `repro`'s.

A workload is two functions:

* ``costs(*inputs) -> CostProvider`` — derive the per-item cost description
  from the workload's raw inputs;
* ``build(schedule, *inputs, device=...) -> op`` — given the constructed
  `Schedule`, the same raw inputs and the device the op runs on, return
  the callable kernel op.

The built-ins (``spmv``, ``bfs``, ``kmeans``, ``moe-dispatch``,
``serve-prefill``) are registered by `sched/kernels.py`, which is imported
on the first lookup; `unregister` refuses them.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

from .costs import CostProvider


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A registered workload: name + cost derivation + kernel-op builder."""

    name: str
    costs: Callable[..., CostProvider]
    build: Callable[..., Any]
    doc: str = ""


_REGISTRY: dict[str, WorkloadSpec] = {}
_LOCK = threading.Lock()


def _load_builtins() -> None:
    # the kernels module registers its entries when it is first imported;
    # the import system's module lock makes that happen exactly once
    from . import kernels  # noqa: F401


def register(name: str, *, costs: Callable[..., CostProvider],
             build: Callable[..., Any], doc: str = "",
             overwrite: bool = False) -> WorkloadSpec:
    """Register a workload under `name`; returns the spec. Re-registering
    an existing name raises unless `overwrite=True`."""
    if not name or not isinstance(name, str):
        raise ValueError(f"workload name must be a non-empty string: {name!r}")
    spec = WorkloadSpec(name=name, costs=costs, build=build, doc=doc)
    with _LOCK:
        if name in _REGISTRY and not overwrite:
            raise ValueError(
                f"workload {name!r} is already registered; pass "
                "overwrite=True to replace it")
        _REGISTRY[name] = spec
    return spec


def get(name: str) -> WorkloadSpec:
    """Look up a registered workload (loads the built-ins on first use)."""
    _load_builtins()
    with _LOCK:
        spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(
            f"unknown workload {name!r}; registered: {registered()}")
    return spec


def registered() -> tuple[str, ...]:
    """Names of all registered workloads, sorted."""
    _load_builtins()
    with _LOCK:
        return tuple(sorted(_REGISTRY))


# what sched/kernels.py registers on its first import; the reference
# refuses its first three (its `_BUILTIN_NAMES`) and the port all five,
# which it registers the same way
_BUILTIN_NAMES = frozenset({"spmv", "bfs", "kmeans", "moe-dispatch",
                            "serve-prefill"})


def unregister(name: str) -> None:
    """Remove a workload (for tests tearing down custom entries); an
    unknown name is a no-op.

    Built-in names are refused: the kernels module registers them only on
    its first import, so removing one would be irreversible for the
    process. Replace a built-in with ``register(..., overwrite=True)``
    instead."""
    if name in _BUILTIN_NAMES:
        raise ValueError(f"cannot unregister built-in workload {name!r}; "
                         "use register(..., overwrite=True) to replace it")
    with _LOCK:
        _REGISTRY.pop(name, None)
