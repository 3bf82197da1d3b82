"""Fault tolerance: heartbeats, straggler mitigation, elastic rescale
arithmetic, the chaos injector and the multi-process chaos cluster.
Importing it imports neither torch nor CUDA: the cluster's standby workers
run on these modules alone."""
from .chaos import (ChaosEvent, ChaosSchedule, ChaosStatus, FaultInjector,
                    VirtualClock)
from .cluster import ClusterSupervisor, WorkerSpec, drill
from .resilience import (ElasticPlan, HeartbeatMonitor, RescaleError,
                         RestartPolicy, StragglerMitigator, plan_rescale,
                         rescale_rules, survivor_devices)

__all__ = ["ChaosEvent", "ChaosSchedule", "ChaosStatus", "ClusterSupervisor",
           "ElasticPlan", "FaultInjector", "HeartbeatMonitor",
           "RescaleError", "RestartPolicy", "StragglerMitigator",
           "VirtualClock", "WorkerSpec", "drill", "plan_rescale",
           "rescale_rules", "survivor_devices"]
