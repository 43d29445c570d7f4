"""`repro_torch.serve` — continuous-batching serving on the iCh scheduler
(the port's counterpart of `repro.serve`).

An admission-controlled request queue, an open-loop Poisson load
generator, pluggable dispatch policies (FCFS-static / round-robin /
ich-adaptive), and the continuous batcher that interleaves one
chunked-prefill slice with every running decode stream per engine step,
with per-request iCh chunk state and log-bucketed tail-latency metrics;
the `Engine` runs the port's models.

Exports are lazy (PEP 562): the queue/loadgen/metrics/policies/batcher
surface is numpy-only and must stay importable without paying for torch;
only `Engine`/`EngineConfig` pull in the model stack.
"""

_LAZY = {
    # real model engine (torch)
    "Engine": "engine",
    "EngineConfig": "engine",
    # open-loop load generation
    "Arrival": "loadgen",
    "LengthDist": "loadgen",
    "OpenPoissonLoadGen": "loadgen",
    # admission queue + per-request state
    "AdmissionQueue": "queue",
    "Request": "queue",
    "RequestState": "queue",
    # latency accounting
    "LatencyHistogram": "metrics",
    "ServeMetrics": "metrics",
    # dispatch policies
    "DispatchPolicy": "policies",
    "FCFSStatic": "policies",
    "IChAdaptive": "policies",
    "RoundRobin": "policies",
    "StepPlan": "policies",
    "default_policies": "policies",
    # the batcher + its backends/clocks + the hardened boundary
    "CircuitBreaker": "batcher",
    "ContinuousBatcher": "batcher",
    "EngineBackend": "batcher",
    "SimBackend": "batcher",
    "SimClock": "batcher",
    "StepCostModel": "batcher",
    "WallClock": "batcher",
    "make_request_factory": "batcher",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(__all__)
