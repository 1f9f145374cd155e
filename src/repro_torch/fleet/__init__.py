"""Multi-tenant fleet scheduler: training + serving on one simulated
cluster, every decision priced by a Hemingway model.  See DESIGN.md §9.

The port's copy of ``repro/fleet``: pure Python and numpy, no tensor;
only a training job's executor (``repro_torch.fleet_day --real-convex``)
runs on a device.
"""

from repro_torch.fleet.cluster import AllocationError, FleetCluster
from repro_torch.fleet.scheduler import FleetConfig, FleetScheduler
from repro_torch.fleet.simulate import (
    FleetRunLog,
    FleetSimulator,
    build_day_scenario,
    build_drift_scenario,
    build_migration_scenario,
    replay,
    run_fleet_sim,
)
from repro_torch.fleet.workloads import (
    AnalyticConvergence,
    RequestTrace,
    ServeDeployment,
    TrainingJob,
    serve_capacity_planner,
    training_model,
)

__all__ = [
    "AllocationError",
    "AnalyticConvergence",
    "FleetCluster",
    "FleetConfig",
    "FleetRunLog",
    "FleetScheduler",
    "FleetSimulator",
    "RequestTrace",
    "ServeDeployment",
    "TrainingJob",
    "build_day_scenario",
    "build_drift_scenario",
    "build_migration_scenario",
    "replay",
    "run_fleet_sim",
    "serve_capacity_planner",
    "training_model",
]
