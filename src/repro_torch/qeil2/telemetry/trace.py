"""Trace collection: the measurement side of the calibration loop.

`TraceStore` is an append-only store of telemetry records with optional JSONL
persistence. Three record kinds close the measurement loop the ROADMAP's two
open calibration items describe:

* ``kernel`` — measured Pallas kernel timings from `benchmarks/kernel_bench.py`
  (per-rep: flops, bytes, measured µs, roofline µs). The fitter turns these
  into per-kernel duty factors ``eta = t_roofline / t_measured`` that the
  `CalibratedSignalProvider` substitutes for analytic FLOP/byte duty cycles.
* ``energy`` — per-(stage, device) energy observations carrying the minimal
  sufficient statistics of the v2 energy equation (roofline time, base power,
  arithmetic intensity, ridge point, CPQ input, junction temperature, quant
  factor, measured joules). These drive the DASI-knee / CPQ-curve / Phi-leakage
  coefficient fit.
* ``step`` — per-step execution records emitted by
  `repro_torch.qeil2.runtime.control_loop.ControlLoop` (temps, powers, energy,
  per-stage `SignalSet.as_dict()` snapshots): runtime provenance for the
  residual report and replayable input for offline refits.
* ``dryrun`` — compiled-HLO FLOP/byte counts from `repro_torch.launch.dryrun`'s
  ``compiled.cost_analysis()``, cross-checking the analytic decomposition
  counts the energy records are built from.
* ``serve`` — per-batch step records from the continuous-batching scheduler
  (`repro_torch.serving.scheduler`): tier mix, queue delay, the routed operating
  point, batch energy/makespan, and per-stage `SignalSet.as_dict()`
  snapshots of the batch-workload costing — serving traces feed the same
  `CalibrationFitter` as control-loop step records.
* ``span`` — request-lifecycle spans from `repro_torch.obs.Tracer` (admit ->
  queue -> schedule -> prefill -> decode -> release, explicit sim/wall
  clock): per-request latency attribution riding the same JSONL files.
* ``clock`` — the header `repro_torch.obs.Tracer.save` writes first: its
  ``clock_offset_ns`` puts the wall spans on a profiler trace's clock.
* ``spec`` — per-batch speculative-decode outcomes from the scheduler
  (draft policy, depth, proposed/accepted draft token counts, optionally
  the serving model and merged tier): the `CalibrationFitter` aggregates
  these into per-(model, tier, policy) accept rates that
  `repro_torch.spec.SpecPlanner` prices draft depths with.

Records are plain dicts (JSON-serializable); `ingest` validates the minimal
per-kind schema — and rejects NaN/inf anywhere in a record's numeric fields
— so a malformed producer fails at the boundary, not inside the fitter (a
NaN that reaches JSONL round-trips as invalid JSON for strict parsers and
poisons every fit it touches).
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterable, List, Optional

# minimal required keys per record kind (ingest-time schema check)
_SCHEMAS: Dict[str, tuple] = {
    "kernel": ("kernel", "flops", "bytes", "measured_us", "roofline_us"),
    "energy": ("device", "intensity", "ridge", "cpq", "temp_c",
               "t_s", "p0_w", "quant_f", "energy_j"),
    "step": ("t_s", "temps", "powers", "energy_j"),
    "dryrun": ("arch", "shape", "flops"),
    "serve": ("t_s", "bucket", "tier_mix", "queue_delay_s", "point_index",
              "energy_j", "latency_s"),
    "span": ("name", "t0_s", "t1_s"),
    "spec": ("t_s", "policy", "n", "proposed", "accepted"),
    # a saved span file's header: the realtime clock less perf_counter
    "clock": ("clock_offset_ns",),
}


def _check_finite(value, path: str) -> None:
    """Recursively reject NaN/inf numeric leaves (bool is not numeric here).
    ``path`` names the offending key for the producer's error message."""
    if isinstance(value, bool):
        return
    if isinstance(value, (int, float)):
        if not math.isfinite(value):
            raise ValueError(f"non-finite value {value!r} at {path!r} "
                             "(trace records must be finite JSON numbers)")
    elif isinstance(value, dict):
        for k, v in value.items():
            _check_finite(v, f"{path}.{k}")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _check_finite(v, f"{path}[{i}]")


def _validate(record: dict) -> dict:
    kind = record.get("kind")
    if kind not in _SCHEMAS:
        raise ValueError(f"unknown trace record kind {kind!r} "
                         f"(want one of {sorted(_SCHEMAS)})")
    missing = [k for k in _SCHEMAS[kind] if k not in record]
    if missing:
        raise ValueError(f"{kind!r} record missing keys {missing}")
    for k, v in record.items():
        _check_finite(v, k)
    return record


class TraceStore:
    """Append-only telemetry store with optional JSONL persistence.

    ``path=None`` keeps everything in memory (tests, synthetic fixtures);
    with a path every `ingest` appends one JSON line, so a crashed run's
    traces survive and `TraceStore.load` resumes from them.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._records: List[dict] = []
        if path is not None and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        # resumed records go through the same schema gate as
                        # fresh ingests: a truncated/hand-edited trace fails
                        # here, not inside the fitter.
                        self._records.append(_validate(json.loads(line)))

    # ------------------------------------------------------------- ingestion
    def ingest(self, record: dict) -> dict:
        """Validate + append one record (and persist it when backed by a
        file). Returns the stored record."""
        self._records.append(_validate(record))
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record

    def ingest_many(self, records: Iterable[dict]) -> int:
        n = 0
        for r in records:
            self.ingest(r)
            n += 1
        return n

    # ---- producer adapters --------------------------------------------------
    def ingest_kernel_bench(self, results: dict) -> int:
        """Ingest `benchmarks.kernel_bench.run()` output (its ``records``
        list of per-rep kernel measurements)."""
        return self.ingest_many(results.get("records", []))

    def ingest_dryrun_artifact(self, artifact: dict) -> Optional[dict]:
        """Ingest one `repro_torch.launch.dryrun` artifact's compiled-HLO counts.
        Returns the stored record, or None when the artifact carries no
        usable ``cost_analysis`` (errored dry-run, CPU backend gaps)."""
        cost = artifact.get("cost_analysis") or {}
        if "flops" not in cost:
            return None
        return self.ingest({
            "kind": "dryrun",
            "arch": artifact.get("arch", "?"),
            "shape": artifact.get("shape", "?"),
            "mesh": artifact.get("mesh", "?"),
            "flops": float(cost["flops"]),
            # XLA reports HBM traffic under "bytes accessed"
            "bytes_accessed": float(cost.get("bytes accessed", 0.0)),
            "n_chips": artifact.get("n_chips"),
        })

    def ingest_step(self, report, signals: Optional[Dict[str, dict]] = None,
                    extra: Optional[dict] = None) -> dict:
        """Ingest one `ControlLoop` `StepReport` (plus optional per-stage
        `SignalSet.as_dict()` snapshots keyed by stage name)."""
        rec = {
            "kind": "step",
            "t_s": float(report.t_s),
            "load": float(report.load),
            "temps": {k: float(v) for k, v in report.temps.items()},
            "powers": {k: float(v) for k, v in report.powers.items()},
            "energy_j": float(report.energy_j),
            "inferences": float(report.inferences),
            "served": bool(report.served),
            "reannealed": bool(report.reannealed),
            "throttle_events": int(report.throttle_events),
            "drift": [ev.kind for ev in report.drift],
            "excluded": list(report.excluded),
        }
        if signals:
            rec["signals"] = signals
        if extra:
            rec.update(extra)
        return self.ingest(rec)

    def ingest_serve(self, record, signals: Optional[Dict[str, dict]] = None,
                     extra: Optional[dict] = None) -> dict:
        """Ingest one scheduler `BatchRecord` (plus optional per-stage
        `SignalSet.as_dict()` snapshots of the batch-workload costing)."""
        rec = {
            "kind": "serve",
            "t_s": float(record.t_s),
            "batch_id": int(record.batch_id),
            "bucket": int(record.bucket),
            "n_requests": int(record.n_requests),
            "n_sequences": int(record.n_sequences),
            "tier_mix": {k: int(v) for k, v in record.tier_mix.items()},
            "queue_delay_s": float(record.queue_delay_s),
            "point_index": int(record.point_index),
            "energy_j": float(record.energy_j),
            "latency_s": float(record.latency_s),
            "meets_caps": bool(record.meets_caps),
            "reroute": bool(record.reroute),
            # paged-KV occupancy: lets the calibration fitter see paging's
            # allocation pressure (CPQ residuals) alongside batch energy
            "prefill_bytes_saved": float(getattr(record,
                                                 "prefill_bytes_saved", 0.0)),
            # resident prefix pool: cross-batch block reuse and the LRU
            # evictions this batch's tails forced
            "pool_hit_blocks": int(getattr(record, "pool_hit_blocks", 0)),
            "pool_evictions": int(getattr(record, "pool_evictions", 0)),
            # serving formats (repro_torch.quant): per-format duty factors and the
            # effective bytes the energy model should price
            "quant": str(getattr(record, "quant", "bf16")),
            "kv_format": str(getattr(record, "kv_format", "bf16")),
        }
        # speculative decode plan (depth chosen at formation); measured
        # accept counts ride the separate retire-time "spec" record
        spec_n = int(getattr(record, "spec_n", 0) or 0)
        if spec_n:
            rec["spec_policy"] = str(getattr(record, "spec_policy", "off"))
            rec["spec_n"] = spec_n
        kv = getattr(record, "kv_blocks_in_use", None)
        if kv is not None:
            rec["kv_blocks_in_use"] = int(kv)
        wb = getattr(record, "weight_bytes", None)
        if wb is not None:
            rec["weight_bytes"] = int(wb)
        kvb = getattr(record, "kv_bytes_in_use", None)
        if kvb is not None:
            rec["kv_bytes_in_use"] = int(kvb)
        # per-member simulated queue delays: p95 queue delay is computable
        # from serve traces alone (no scheduler state re-derivation)
        entries = getattr(record, "request_entries", None)
        if entries:
            rec["requests"] = [dict(e) for e in entries]
        if signals:
            rec["signals"] = signals
        if extra:
            rec.update(extra)
        return self.ingest(rec)

    def ingest_spans(self, tracer) -> int:
        """Ingest every span a `repro_torch.obs.Tracer` collected (kind ``"span"``).
        Unneeded when the tracer was constructed with ``store=self`` — spans
        then mirror on emit."""
        return self.ingest_many(tracer.records())

    # --------------------------------------------------------------- queries
    def records(self, kind: Optional[str] = None) -> List[dict]:
        if kind is None:
            return list(self._records)
        return [r for r in self._records if r.get("kind") == kind]

    def __len__(self) -> int:
        return len(self._records)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self._records:
            out[r["kind"]] = out.get(r["kind"], 0) + 1
        return out

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> str:
        """Write every record as JSONL (full rewrite — for memory-backed
        stores; file-backed stores persist incrementally on ingest)."""
        with open(path, "w") as f:
            for r in self._records:
                f.write(json.dumps(r) + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "TraceStore":
        """Read-only view of an existing JSONL trace (records validated)."""
        store = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    store.ingest(json.loads(line))
        return store
