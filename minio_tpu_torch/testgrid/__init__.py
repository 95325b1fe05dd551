"""Declarative chaos-scenario grid over the multi-process cluster
harness (minio_tpu_torch/cluster/harness.py).

A Scenario names a cluster shape, a seeded workload, a fault schedule
(delivered to REMOTE nodes over the admin fault endpoint), and the
invariants that must hold afterwards: objects bit-identical at quorum
or cleanly absent, no torn xl.meta on any drive, breakers tripping on
the faulted node and recovering half-open.  The grid itself lives in
scenarios.py; the interpreter in engine.py.  The nodes run their codec
on the device ``MINIO_ERASURE_BACKEND`` names (the card by default).
"""

from .engine import Fault, Scenario, run_scenario
from .scenarios import GRID, scenario_by_name

__all__ = [
    "Fault",
    "Scenario",
    "run_scenario",
    "GRID",
    "scenario_by_name",
]
