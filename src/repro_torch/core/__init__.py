"""QEIL core planning layer, copied from ``repro.core`` (pure numpy/python).

devices       — capability vectors (paper's edge platform + targets)
decomposition — energy-aware task decomposition (stage FLOPs/bytes)
formalisms    — the five inference-time scaling formalisms (closed forms)
energy        — roofline-derived energy model ("v1"; "v2" arrives with the
                qeil2 slice of the port)
orchestrator  — greedy layer assignment (Eq. 12) + exhaustive oracle + Pareto
pareto        — non-dominated set utilities
safety        — thermal / fault-tolerance / adversarial robustness

fitting, metrics, roofline and sampling (the `VerifierCascade`) arrive with
the scheduler slice of the port.
"""
from repro_torch.core.devices import (DeviceProfile, EDGE_CPU, EDGE_GPU_INTEL,
                                      EDGE_GPU_NVIDIA, EDGE_NPU, EDGE_PLATFORM,
                                      CLOUD_GPU, TPU_V5E, get_device)
from repro_torch.core.decomposition import (Stage, Workload, decompose,
                                            phase_totals)
from repro_torch.core.formalisms import (CoverageParams, coverage, cost_total,
                                         device_task_match, energy_total,
                                         latency, quant_factor,
                                         samples_for_coverage)
from repro_torch.core.energy import (PlanCosts, StageExecution, execute_stage,
                                     homogeneous_assignment, plan_costs)
from repro_torch.core.orchestrator import (Assignment, Constraints,
                                           GreedyOrchestrator,
                                           ParetoOrchestrator,
                                           exhaustive_oracle)
from repro_torch.core.pareto import dominates, hypervolume_2d, pareto_front
from repro_torch.core.safety import (DriftEvent, FaultEvent, Health,
                                     HealthMonitor, InputValidator,
                                     OutputSanitizer, SafetyMonitor,
                                     ThermalModel, THETA_THROTTLE)
