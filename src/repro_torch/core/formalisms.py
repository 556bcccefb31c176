"""The paper's five inference-time scaling formalisms (Section 3.3), as code.

All functions are closed-form and pure; the *fitted* variants (exponents estimated
from observed coverage curves) live in ``repro_torch.core.fitting``. Default constants are
the paper's reported values: beta_N = beta_S = 0.7, delta = 0.2, alpha ~= 1e-4,
gamma_E = 0.9, f(FP16)=1.0, f(FP8)=0.65.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.devices import DeviceProfile


# =========================================================================== F1
@dataclass(frozen=True)
class CoverageParams:
    alpha: float = 1.67e-3
    beta_N: float = 0.7
    beta_S: float = 0.7
    delta: float = 0.2

    @classmethod
    def calibrated(cls, N_millions: float, target_cov: float = 0.70,
                   S: float = 20.0, T: float = 256.0,
                   beta_N: float = 0.7, beta_S: float = 0.7,
                   delta: float = 0.2) -> "CoverageParams":
        """alpha(N) such that C(S, N, T) == target_cov.

        The paper calls alpha "model-dependent" (Formalism 1.1) and its quoted
        alpha ~ 1e-4 is not consistent with its own coverage tables under any
        unit for N; we therefore treat alpha as the per-model calibration knob
        (exactly its declared role) and fix it from the Table 16 pass@k.
        """
        rate = -math.log(1.0 - target_cov)
        alpha = rate / ((N_millions ** beta_N) * (S ** beta_S) * (T ** delta))
        return cls(alpha=alpha, beta_N=beta_N, beta_S=beta_S, delta=delta)


def coverage(S: float, N: float, T: float,
             p: CoverageParams = CoverageParams()) -> float:
    """Formalism 1.1: C(S,N,T) = 1 - exp(-alpha * N^bN * S^bS * T^delta).

    N in parameters, S samples, T tokens/sample. N is fed in units of millions
    of parameters (the paper's alpha ~ 1e-4 calibration regime: GPT-2 at N=125,
    S=20, T=256 gives C ~ 0.70, matching Table 16).
    """
    rate = p.alpha * (N ** p.beta_N) * (S ** p.beta_S) * (T ** p.delta)
    return 1.0 - math.exp(-rate)


def samples_for_coverage(C_target: float, N: float, T: float,
                         p: CoverageParams = CoverageParams()) -> float:
    """Invert F1 for S — 'how many samples to hit the coverage SLA'."""
    if not 0 < C_target < 1:
        raise ValueError("target coverage must be in (0,1)")
    rate = -math.log(1.0 - C_target)
    denom = p.alpha * (N ** p.beta_N) * (T ** p.delta)
    return (rate / denom) ** (1.0 / p.beta_S)


# =========================================================================== F2
GAMMA_E = 0.9


QUANT_FACTORS = {"fp32": 1.35, "fp16": 1.0, "bf16": 1.0, "fp8": 0.65,
                 "int8": 0.65, "int4": 0.45}


def quant_factor(q: str) -> float:
    try:
        return QUANT_FACTORS[q.lower()]
    except KeyError:
        raise ValueError(
            f"unknown quantization format {q!r} "
            f"(supported: {', '.join(sorted(QUANT_FACTORS))})") from None


def energy_total(S: float, N: float, T: float, q: str,
                 device: DeviceProfile, e0_coeff: float = 2.8e-10) -> float:
    """Formalism 2.1: E = E0(N) * f(Q) * P_i * gamma_util * lambda_i * T * S.

    E0(N) = c1 * N^gamma_E with N in millions of parameters; e0_coeff is
    calibrated so GPT-2 (N=125) standard execution at S=20, T=256 on the edge
    GPU profile lands at the paper's 43.1 kJ (Table 16).
    """
    e0 = e0_coeff * (N ** GAMMA_E)
    return (e0 * quant_factor(q) * device.power_peak * device.util *
            device.lambda_eff * T * S)


# =========================================================================== F3
@dataclass(frozen=True)
class LatencyBreakdown:
    prefill_s: float
    decode_s: float
    io_s: float
    overhead_s: float

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s + self.io_s + self.overhead_s

    def as_dict(self) -> Dict[str, float]:
        return {"prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "io_s": self.io_s, "overhead_s": self.overhead_s,
                "total_s": self.total_s}


B0_REFERENCE_BW = 30e9  # paper's CPU-class reference bandwidth (30 GB/s)


def latency(S: float, T: float, N: float, device: DeviceProfile,
            io_bytes: float = 0.0, io_bw: Optional[float] = None,
            heterogeneous: bool = False,
            overhead_const_s: float = 2e-4,
            overhead_log_coeff: float = 5e-5) -> LatencyBreakdown:
    """Formalism 3.1. N in parameters (not millions) here: FLOPs/token ~ 2N.

    prefill: compute-bound at device frequency-scaled peak;
    decode: memory-bound, scaled by bandwidth advantage B_i/B_0;
    io: explicit transfer bytes / interconnect bandwidth;
    overhead: const + a*log(S), heterogeneous orchestration only.
    """
    flops_per_token = 2.0 * N
    t_prefill = T * flops_per_token / (device.peak_flops * device.util)
    bw_ratio = device.mem_bw / B0_REFERENCE_BW
    t_decode = ((S - 1) * T * flops_per_token /
                (device.peak_flops * device.util * bw_ratio)) if S > 1 else 0.0
    t_io = io_bytes / (io_bw or device.link_bw) if io_bytes else 0.0
    t_over = overhead_const_s + (overhead_log_coeff * math.log(max(S, 1))
                                 if heterogeneous else 0.0)
    return LatencyBreakdown(t_prefill, t_decode, t_io, t_over)


# =========================================================================== F4
def cost_total(S: float, energy_joules: float, device: DeviceProfile,
               price_kwh: float = 0.15) -> Dict[str, float]:
    """Formalism 4.1: amortization + energy + maintenance (per-workload USD)."""
    amort = device.hw_cost_usd / device.lifetime_ops * S
    energy_cost = energy_joules / 3.6e6 * price_kwh
    maint = device.maint_per_op * S
    return {"amortization": amort, "energy": energy_cost,
            "maintenance": maint,
            "total": amort + energy_cost + maint}


# =========================================================================== F5
def device_task_match(intensity: float, device: DeviceProfile) -> str:
    """Formalism 5.1: memory-bound iff I < C/B (Eq. 7)."""
    return "memory-bound" if intensity < device.ridge_point else "compute-bound"


def best_device_for_intensity(intensity: float, devices) -> DeviceProfile:
    """Pick the device whose ridge point best matches the task intensity:
    memory-bound tasks -> highest bandwidth-per-watt; compute-bound ->
    highest FLOPs-per-watt. This is F5 turned into a routing rule."""
    mem_bound = [d for d in devices if intensity < d.ridge_point]
    if mem_bound:
        return max(mem_bound, key=lambda d: d.mem_bw / d.power_peak)
    return max(devices, key=lambda d: d.peak_flops / d.power_peak)
