"""`repro_torch.robust` — deterministic fault injection (the port's copy of
`repro.robust.faults`).

One seeded `FaultPlan` spans the host execution layers: the discrete-event
simulator replays it as fault events (`core/simulator.py`, `faults=`), the
threaded executor survives it with supervised workers (`core/executor.py`:
retry budgets, watchdog, dead-deque reclaim), and `Schedule.replay_faulty`
reports the makespan inflation a chaos scenario costs a constructed
schedule. Everything derived from a plan is a pure function of its seed, so
chaos runs replay bit-identically. Recovery of a sharded kernel run
(`repro.robust.recovery`) is not ported yet.
"""
from .faults import (ChaosBody, Death, FaultClock, FaultError, FaultPlan,
                     FaultReport, InjectedFault, Stall, simulate_faulty)

__all__ = ["ChaosBody", "Death", "FaultClock", "FaultError", "FaultPlan",
           "FaultReport", "InjectedFault", "Stall", "simulate_faulty"]
