"""QEIL core planning layer, copied from ``repro.core`` (pure numpy/python).

formalisms  — the five inference-time scaling formalisms (closed forms)
fitting     — scaling-exponent estimation with bootstrap CIs (Tables 1-2)
metrics     — IPW / ECE / PPP composite efficiency metrics
devices     — capability vectors (paper's edge platform + targets)
decomposition — energy-aware task decomposition (stage FLOPs/bytes)
roofline    — Formalism 5 + the dry-run three-term roofline analysis
energy      — roofline-derived energy model ("v1"; ``model="v2"`` dispatches
              to `repro_torch.qeil2.energy_v2`)
orchestrator — greedy layer assignment (Eq. 12) + exhaustive oracle + Pareto
pareto      — non-dominated set utilities
safety      — thermal / fault-tolerance / adversarial robustness
sampling    — repeated sampling + quality-verification cascade
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
from repro_torch.core.fitting import (JointFit, PowerLawFit,
                                      empirical_coverage, fit_coverage_joint,
                                      fit_power_law)
from repro_torch.core.metrics import RunMetrics, improvement
from repro_torch.core.roofline import (RooflineTerms, arithmetic_intensity,
                                       collective_bytes_from_hlo,
                                       is_memory_bound, stage_time,
                                       terms_from_counts)
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
from repro_torch.core.sampling import (CascadeStats, PassAtKResult,
                                       VerifierCascade,
                                       adaptive_sample_budget, run_pass_at_k,
                                       simulate_outcomes)
