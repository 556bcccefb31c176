"""Device capability model (paper Eq. 10) and registry.

Two families of profiles:

* **Edge profiles** — the paper's experimental platform (Section 3.7 / Eq. 12):
  Intel Core Ultra 9 285HX CPU, Intel AI Boost NPU, NVIDIA RTX PRO 5000 GPU,
  Intel Graphics GPU. Used by the paper-reproduction benchmarks.
* **TPU profile** — v5e, the real deployment target of this framework; its
  constants also feed the roofline analysis of the dry-run artifacts
  (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).

The capability vector follows Eq. 10:
    d_i = (M_max, B, f, P, n_cores, lambda, type, T_max, priority)
extended with idle power, thermal RC constants, and economics (Eq. 5-6 inputs).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    kind: str                    # cpu | gpu | npu | tpu
    vendor: str
    peak_flops: float            # FLOP/s (fp16/bf16 unless noted)
    mem_bw: float                # bytes/s
    mem_cap: float               # bytes
    link_bw: float               # bytes/s per interconnect link
    power_peak: float            # W
    power_idle: float            # W
    lambda_eff: float            # paper's device efficiency multiplier
    util: float                  # gamma_util in (0, 1]
    freq_ghz: float
    n_cores: int
    t_max: float                 # max junction temperature, degC
    t_ambient: float = 25.0
    thermal_r: float = 0.25      # degC per W (RC model)
    thermal_tau: float = 30.0    # seconds
    priority: int = 0
    hw_cost_usd: float = 1000.0
    lifetime_ops: float = 1e8    # queries over device lifetime (Eq. 6)
    maint_per_op: float = 1e-6

    @property
    def ridge_point(self) -> float:
        """FLOP/byte where the device transitions memory- to compute-bound."""
        return self.peak_flops / self.mem_bw

    def energy_efficiency(self) -> float:
        """Paper Eq. 11: FLOPs per joule."""
        return self.peak_flops / self.power_peak

    def with_overrides(self, **kw) -> "DeviceProfile":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------- edge (paper)
# Constants from the paper: Eq. 12 memory/bandwidth/power caps, Section 3.3.2
# lambda multipliers (CPU 1.0, GPU 0.3-0.5, NPU 0.1-0.2), gamma_util 0.6-0.9.

EDGE_CPU = DeviceProfile(
    name="intel-core-ultra9-285hx", kind="cpu", vendor="intel",
    peak_flops=1.4e12, mem_bw=100e9, mem_cap=127e9, link_bw=32e9,
    power_peak=45.0, power_idle=8.0, lambda_eff=1.0, util=0.8,
    freq_ghz=2.8, n_cores=8, t_max=105.0, thermal_r=1.2, thermal_tau=25.0,
    priority=2, hw_cost_usd=600.0)

EDGE_NPU = DeviceProfile(
    name="intel-ai-boost-npu", kind="npu", vendor="intel",
    peak_flops=13e12, mem_bw=50e9, mem_cap=20e9, link_bw=32e9,
    power_peak=25.0, power_idle=2.0, lambda_eff=0.15, util=0.85,
    freq_ghz=1.4, n_cores=2, t_max=100.0, thermal_r=1.5, thermal_tau=20.0,
    priority=1, hw_cost_usd=250.0)

EDGE_GPU_NVIDIA = DeviceProfile(
    name="nvidia-rtx-pro-5000", kind="gpu", vendor="nvidia",
    peak_flops=120e12, mem_bw=900e9, mem_cap=96.2e9, link_bw=32e9,
    power_peak=300.0, power_idle=25.0, lambda_eff=0.4, util=0.75,
    freq_ghz=2.2, n_cores=12800, t_max=90.0, thermal_r=0.21, thermal_tau=45.0,
    priority=0, hw_cost_usd=4500.0)

EDGE_GPU_INTEL = DeviceProfile(
    name="intel-graphics-gpu", kind="gpu", vendor="intel",
    peak_flops=18e12, mem_bw=90e9, mem_cap=72.7e9, link_bw=32e9,
    power_peak=120.0, power_idle=12.0, lambda_eff=0.45, util=0.7,
    freq_ghz=1.8, n_cores=1024, t_max=95.0, thermal_r=0.5, thermal_tau=35.0,
    priority=3, hw_cost_usd=0.0)   # integrated: amortized with CPU

EDGE_PLATFORM: List[DeviceProfile] = [
    EDGE_CPU, EDGE_NPU, EDGE_GPU_NVIDIA, EDGE_GPU_INTEL]

# --------------------------------------------------------------------- cloud ref
CLOUD_GPU = DeviceProfile(
    name="datacenter-h100-like", kind="gpu", vendor="nvidia",
    peak_flops=900e12, mem_bw=3.0e12, mem_cap=80e9, link_bw=450e9,
    power_peak=700.0, power_idle=80.0, lambda_eff=0.35, util=0.8,
    freq_ghz=1.8, n_cores=16896, t_max=90.0, thermal_r=0.05, thermal_tau=60.0,
    priority=0, hw_cost_usd=30000.0)

# --------------------------------------------------------------------- TPU target
TPU_V5E = DeviceProfile(
    name="tpu-v5e", kind="tpu", vendor="google",
    peak_flops=197e12, mem_bw=819e9, mem_cap=16e9, link_bw=50e9,
    power_peak=170.0, power_idle=35.0, lambda_eff=0.25, util=0.8,
    freq_ghz=1.7, n_cores=1, t_max=95.0, thermal_r=0.1, thermal_tau=50.0,
    priority=0, hw_cost_usd=5000.0)

REGISTRY: Dict[str, DeviceProfile] = {
    d.name: d for d in EDGE_PLATFORM + [CLOUD_GPU, TPU_V5E]}


def get_device(name: str) -> DeviceProfile:
    return REGISTRY[name]
