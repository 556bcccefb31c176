"""QEIL v2 physics-grounded orchestration subsystem.

signals   — DASI / CPQ / Phi runtime device-workload signals
energy_v2 — unified energy equation modulated by the signal triple
pgsam     — Pareto-Guided Simulated Annealing with Momentum + orchestrator
runtime   — Pareto-routed serving runtime (SLA router, control loop,
            incremental delta-cost evaluation)
telemetry — trace collection + coefficient fitting + calibrated signal
            provider (measured traces close the loop back into the model)
"""
from repro_torch.qeil2.signals import (SignalSet, cpq, cpq_power_factor, dasi,
                                       memory_saturation, phi, signals_for)
from repro_torch.qeil2.energy_v2 import (StageExecutionV2, execute_stage_v2,
                                         plan_costs_v2, W_COMPUTE, W_MEMORY)
from repro_torch.qeil2.pgsam import (ArchiveEntry, PGSAM, PGSAMConfig,
                                     PGSAMOrchestrator, PGSAMResult)
from repro_torch.qeil2.runtime import (BatchRoutingDecision, ControlLoop,
                                       DeltaEvaluator, LoopConfig,
                                       ParetoRouter, RoutedServingEngine,
                                       RoutingDecision, SLATier, default_tiers,
                                       merge_tiers)
from repro_torch.qeil2.telemetry import (CalibratedSignalProvider,
                                         CalibrationFitter, CalibrationProfile,
                                         ResidualReport, TraceStore,
                                         synthetic_trace_store)
