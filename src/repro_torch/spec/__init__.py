"""Speculative multi-token decode: draft policies, distribution-preserving
verify, and roofline-priced routing of draft depth. Ported from
``repro.spec``.

Flow per decode step of a speculating batch:

  policy.propose(histories, n)          host-side drafts        (B, n)
    -> one verify forward over the batch's cache scores 1 + n query tokens
    -> verify_tokens accepts the longest draft prefix + 1 correction/bonus
    -> commit: rejected tail KV entries stay in place, masked by position
       and overwritten by the next step (rollback costs zero block traffic)

`SpecPlanner` picks n per routed batch by re-pricing the batch workload
through `spec_workload` at the fitted accept rate; `CalibrationFitter`
learns those rates from "spec" trace records the scheduler emits.
"""
from repro_torch.spec.policy import (DraftModelPolicy, DraftPolicy,
                                     NGramDraftPolicy, make_draft_policy,
                                     spec_supported)
from repro_torch.spec.routing import (DEFAULT_ACCEPT_RATE, DEFAULT_DEPTHS,
                                      SpecPlan, SpecPlanner,
                                      expected_tokens_per_step, spec_workload)
from repro_torch.spec.verify import emission_distribution, verify_tokens

__all__ = [
    "DraftModelPolicy", "DraftPolicy", "NGramDraftPolicy",
    "make_draft_policy", "spec_supported",
    "DEFAULT_ACCEPT_RATE", "DEFAULT_DEPTHS", "SpecPlan", "SpecPlanner",
    "expected_tokens_per_step", "spec_workload",
    "emission_distribution", "verify_tokens",
]
