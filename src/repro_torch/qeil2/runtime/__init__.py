"""Pareto-routed serving runtime: the online side of QEIL v2.

incremental  — DeltaEvaluator, O(1)-per-move plan costing for PGSAM anneals
router       — SLATier / ParetoRouter / RoutedServingEngine: the archive as
               a live routing surface for request classes
control_loop — ControlLoop: orchestrate -> execute -> heat -> re-orchestrate
               with drift-triggered, archive-warm-started re-anneals
"""
from repro_torch.qeil2.runtime.incremental import DeltaEvaluator, UndoToken
from repro_torch.qeil2.runtime.router import (BatchRoutingDecision,
                                              ParetoRouter,
                                              RoutedServingEngine,
                                              RoutingDecision, SLATier,
                                              default_tiers, merge_tiers)
from repro_torch.qeil2.runtime.control_loop import (ControlLoop, LoopConfig,
                                                    StepReport)
