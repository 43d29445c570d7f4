"""`repro_torch.robust` — deterministic fault injection and the recovery of
sharded kernel runs (the port's copies of `repro.robust.faults` and
`repro.robust.recovery`).

One seeded `FaultPlan` spans the host execution layers: the discrete-event
simulator replays it as fault events (`core/simulator.py`, `faults=`), the
threaded executor survives it with supervised workers (`core/executor.py`:
retry budgets, watchdog, dead-deque reclaim), and `Schedule.replay_faulty`
reports the makespan inflation a chaos scenario costs a constructed
schedule. Everything derived from a plan is a pure function of its seed, so
chaos runs replay bit-identically. A sharded kernel run interrupted by
worker deaths finishes from a `CheckpointLog` through `plan_recovery`
(`Schedule.reshard_survivors`), bit-identical to the fault-free run.
"""
from .faults import (ChaosBody, Death, FaultClock, FaultError, FaultPlan,
                     FaultReport, InjectedFault, Stall, simulate_faulty)
from .recovery import CheckpointLog, RecoveryPlan, plan_recovery

__all__ = ["ChaosBody", "CheckpointLog", "Death", "FaultClock",
           "FaultError", "FaultPlan", "FaultReport", "InjectedFault",
           "RecoveryPlan", "Stall", "plan_recovery", "simulate_faulty"]
