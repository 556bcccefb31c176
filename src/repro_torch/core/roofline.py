"""Roofline machinery (paper Formalism 5 + deliverable (g)).

Two consumers:
  1. The orchestrator: per-stage device-task matching via arithmetic intensity
     ``I`` vs. ridge point ``C/B`` (Eq. 7).
  2. The dry-run analysis: the three roofline terms per (arch x mesh) derived
     from compiled HLO (FLOPs / bytes from ``cost_analysis()``, collective bytes
     from the HLO text), against TPU v5e constants.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.devices import DeviceProfile, TPU_V5E


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float        # HLO_FLOPs / (chips * peak)
    memory_s: float         # HLO_bytes / (chips * HBM bw)
    collective_s: float     # collective_bytes / (chips * link bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def overlap_time_s(self) -> float:
        """Lower bound assuming perfect compute/memory/collective overlap."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_time_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    def as_dict(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant}


def arithmetic_intensity(flops: float, bytes_moved: float) -> float:
    return flops / max(bytes_moved, 1.0)


def is_memory_bound(flops: float, bytes_moved: float,
                    device: DeviceProfile) -> bool:
    """Eq. 7: task memory-bound iff I < C/B."""
    return arithmetic_intensity(flops, bytes_moved) < device.ridge_point


def stage_time(flops: float, bytes_moved: float,
               device: DeviceProfile) -> float:
    """Roofline execution time on one device: max of compute & memory terms."""
    return max(flops / (device.peak_flops * device.util),
               bytes_moved / (device.mem_bw * device.util))


def terms_from_counts(flops: float, bytes_moved: float,
                      collective_bytes: float, n_chips: int,
                      device: DeviceProfile = TPU_V5E) -> RooflineTerms:
    """The deliverable-(g) three-term roofline.

    ``flops``/``bytes_moved`` are whole-program HLO totals (all chips), so each
    is divided by aggregate fleet capability; ``collective_bytes`` is the total
    over all collective ops, moved at per-chip link bandwidth.
    """
    return RooflineTerms(
        compute_s=flops / (n_chips * device.peak_flops),
        memory_s=bytes_moved / (n_chips * device.mem_bw),
        collective_s=collective_bytes / (n_chips * device.link_bw),
    )


# --------------------------------------------------------------------------- HLO
_COLL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)",
    re.MULTILINE)

_SHAPE_RE = re.compile(r"(bf16|f16|f32|f64|f8e4m3fn|f8e5m2|s32|u32|s64|u64|"
                       r"s16|u16|s8|u8|pred)\[([\d,]*)\]")

_DTYPE_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "f64": 8, "f8e4m3fn": 1,
                "f8e5m2": 1, "s32": 4, "u32": 4, "s64": 8, "u64": 8,
                "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1}


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, float]:
    """Sum result-shape bytes of every collective op in an HLO dump.

    Returns per-kind byte totals plus "total". Shapes are the *op result*
    shapes — the data each collective materializes, the standard proxy for
    wire bytes (exact wire traffic additionally depends on the algorithm, e.g.
    ring all-reduce moves 2(n-1)/n of the payload; we report payload bytes and
    keep the convention fixed across experiments so ratios are meaningful).
    """
    out: Dict[str, float] = {"all-gather": 0.0, "all-reduce": 0.0,
                             "reduce-scatter": 0.0, "all-to-all": 0.0,
                             "collective-permute": 0.0}
    count = 0
    for m in _COLL_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        out[kind] += _shape_bytes(shape_str)
        count += 1
    out["total"] = sum(v for k, v in out.items() if k != "total")
    out["n_ops"] = count
    return out
