"""Multi-pod dry-run, ported from ``repro.launch.dryrun``.

Traces every (architecture x input shape) combination at full width
against the production mesh (16x16 single-pod, 2x16x16 multi-pod) on meta
tensors (`repro_torch.launch.specs`: shapes and dtypes, no storage) under
PyTorch's fake process group (``torch.testing._internal.distributed.
fake_pg``: a world of 256 or 512 ranks in one process, whose collectives
move nothing). This process is rank 0. Train shapes trace the sharded
train step (`repro_torch.distributed.step.make_sharded_train_step`, the
reference's remat on); prefill and decode shapes trace the sharded forward
with the policy's cache and logits placements. The model runs its plain
path: the kernels take no meta tensors.

XLA's analyses have no torch twin, so every measure is analytic (the
artifact's ``"analytic"`` list names them):

  * ``memory_analysis``: per-device bytes: params and AdamW moments at
    rest, the batch and cache shards (from the placements); what the traced
    step held: ``grad_bytes`` (its gradient shards), ``gathered_param_bytes``
    (the most gathered parameter bytes alive at once: about one
    super-block's compute layout, the embedding and the head) and, for a
    train shape, ``saved_bytes`` (saved for backward, one count a storage,
    through ``saved_tensors_hooks``: the blocks' inputs under remat plus
    one block's recompute, `repro_torch.distributed.step.
    block_saved_bytes`) and ``held_bytes`` (params, gradients, moments,
    gathered and saved); ``largest_gathered_leaf_bytes`` is the largest
    whole leaf;
  * ``cost_analysis``: ``flops`` (`torch.utils.flop_counter.FlopCounterMode`
    over the traced ops: matmuls, attention, convolutions, forward and
    backward) and ``bytes accessed`` (every traced op's operand and result
    bytes, views excepted, unfused) of rank 0's step, and ``flops_per_6NT``,
    the flops over ``6 * N * tokens / n_chips`` (N the active param count,
    ``active_param_count``: an MoE token runs only its top-k and shared
    experts, a dense model all its params; tokens the global batch's, one
    a row at decode); an MoE layer's compact dispatch, which cannot read a
    rank's expert counts from meta tensors, counts each local expert at a
    balanced router's share ``min(C, ceil(T * k / E))`` of the rank's T
    tokens (``moe_balanced_slots``);
  * ``collective_bytes``: the result bytes of every collective the traced
    step issued, under the keys of ``core/roofline.collective_bytes_from_hlo``.

``hlo_bytes`` and ``compile_s`` are null (no HLO, nothing compiles);
``lower_s`` is the trace's seconds. Artifacts land in
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` (git-ignored),
never in the reference's ``experiments/dryrun/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
      [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.distributed import ShardingPolicy, hints
from repro_torch.distributed.step import (block_saved_bytes,
                                          init_sharded_opt_state,
                                          make_sharded_forward,
                                          make_sharded_train_step,
                                          shard_batch, shard_params,
                                          sharded_bytes, sharded_cache)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (adapt_config, get_shape, input_specs,
                                      param_specs)
from repro_torch.models import Model
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.training import AdamWConfig

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "dryrun_torch")
WORLD = {"single": 256, "multi": 512}
ANALYTIC = ["memory_analysis", "cost_analysis", "collective_bytes",
            "grad_bytes", "gathered_param_bytes", "saved_bytes", "held_bytes",
            "flops_per_6NT", "active_param_count", "moe_balanced_slots"]
COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"),
               ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
               ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
               ("send", "collective-permute"), ("recv", "collective-permute"))


def _artifact_path(arch: str, shape: str, mesh_kind: str, tag: str = "",
                   out_dir: Optional[str] = None) -> str:
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def fake_world(mesh_kind: str) -> None:
    """This process as rank 0 of a fake process group of the mesh's world
    size (another world size is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = WORLD[mesh_kind]
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _Traffic(TorchDispatchMode):
    """Operand and result bytes of every traced op on plain tensors (views
    excepted), and the result bytes of every collective by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.coll = {"all-gather": 0.0, "all-reduce": 0.0,
                     "reduce-scatter": 0.0, "all-to-all": 0.0,
                     "collective-permute": 0.0}
        self.n_coll = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.name()
        if name.startswith(("_c10d_functional::", "c10d::")):
            kind = next((k for key, k in COLLECTIVES if key in name), None)
            if kind is not None:
                # functional ops return their result; c10d's in-place ones
                # write their first argument
                res = out if name.startswith("_c10d") else args[0]
                self.coll[kind] += sum(_nbytes(t) for t in tree_leaves(res))
                self.n_coll += 1
            return out
        flat = tree_leaves((args, kwargs, out))
        if not func.is_view and not any(isinstance(t, DTensor)
                                        for t in flat):
            self.bytes += sum(_nbytes(t) for t in flat)
        return out

    def collective_bytes(self) -> Dict[str, float]:
        out = dict(self.coll)
        out["total"] = sum(out.values())
        out["n_ops"] = self.n_coll
        return out


def lower_and_compile(arch: str, shape_name: str, mesh_kind: str = "single",
                      verbose: bool = True, fsdp: bool = True,
                      shard_hints: bool = False, mla_naive: bool = False,
                      ssm_split: bool = False, no_tp: bool = False,
                      microbatches: int = 1, cache_fp8: bool = False,
                      cross_cache: bool = False, moe_dense: bool = False,
                      dtype=torch.bfloat16) -> Dict:
    """One (arch x shape x mesh) dry-run (module docstring). Returns the
    artifact dict.

    Variant knobs, as the reference's:
      shard_hints — activation sharding constraints in the SSD block
      mla_naive   — decompressed (non-absorbed) MLA decode baseline
      fsdp=False  — tensor-parallel only (weights replicated over "data")
    """
    t0 = time.time()
    shape = get_shape(shape_name)
    cfg = adapt_config(get_config(arch), shape)
    if mla_naive:
        cfg = cfg.with_overrides(mla_absorbed=False)
    if ssm_split:
        cfg = cfg.with_overrides(ssm_split_proj=True)
    if cross_cache:
        cfg = cfg.with_overrides(cross_kv_cache=True)
    if moe_dense:
        cfg = cfg.with_overrides(moe_dense_decode=True)
    if shard_hints:
        hints.enable()
    else:
        hints.disable()
    fake_world(mesh_kind)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device="cpu")
    n_chips = mesh.size()
    policy = ShardingPolicy(mesh, fsdp_enabled=fsdp,
                            tensor_enabled=not no_tp)

    model = Model(cfg, dtype=dtype, device="meta",
                  remat=(shape.kind == "train"))
    params = shard_params(param_specs(model), policy)
    batch_specs, cache_specs = input_specs(
        cfg, shape, dtype,
        cache_dtype=torch.float8_e4m3fn if cache_fp8 else None)
    batch = shard_batch(batch_specs, policy)

    mem: Dict[str, Any] = {}
    mem["param_bytes"], mem["largest_gathered_leaf_bytes"] = \
        sharded_bytes(params)
    mem["batch_bytes"] = sharded_bytes(batch)[0]
    traffic = _Traffic()
    with FlopCounterMode(display=False) as flops, traffic:
        if shape.kind == "train":
            opt = init_sharded_opt_state(params)
            step = make_sharded_train_step(model, AdamWConfig(), policy,
                                           microbatches=microbatches)
            params, opt, _ = step(params, opt, batch)
            mem["opt_state_bytes"] = (sharded_bytes(opt["m"])[0] +
                                      sharded_bytes(opt["v"])[0] +
                                      _nbytes(opt["step"].to_local()))
            mem["grad_bytes"] = step.stats["grad_bytes"]
            mem["gathered_param_bytes"] = step.stats["gathered_bytes"]
            mem["saved_bytes"] = step.stats["saved_bytes"]
            out_bytes = mem["param_bytes"] + mem["opt_state_bytes"]
        else:
            cache = sharded_cache(cache_specs, policy)
            mem["cache_bytes"] = sharded_bytes(cache)[0]
            fwd = make_sharded_forward(
                model, policy, -1 if shape.kind == "prefill" else 0)
            logits, cache = fwd(params, batch, cache)
            mem["logits_bytes"] = _nbytes(logits.to_local())
            mem["gathered_param_bytes"] = fwd.stats["gathered_bytes"]
            out_bytes = mem["logits_bytes"] + mem["cache_bytes"]
    if shape.kind == "train":
        # what one block's recompute saves (outside the counters)
        if model.remat:
            mem["saved_bytes"] += block_saved_bytes(model, policy, params,
                                                    batch)
        mem["held_bytes"] = sum(mem[k] for k in (
            "param_bytes", "grad_bytes", "opt_state_bytes",
            "gathered_param_bytes", "saved_bytes"))
    t_lower = time.time() - t0
    mem["argument_size_in_bytes"] = sum(
        mem.get(k, 0) for k in ("param_bytes", "opt_state_bytes",
                                "batch_bytes", "cache_bytes"))
    mem["output_size_in_bytes"] = out_bytes
    mem["repr"] = ", ".join(f"{k}={v}" for k, v in mem.items())
    n_params = Model(cfg).param_count()
    n_active = Model(cfg).active_param_count()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    cost = {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(traffic.bytes)}
    cost["flops_per_6NT"] = cost["flops"] / (6 * n_active * tokens / n_chips)
    coll = traffic.collective_bytes()

    artifact = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "n_chips": int(n_chips),
        "kind": shape.kind,
        "param_count": n_params,
        "active_param_count": n_active,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "attn_window": cfg.attn_window,
        "fsdp": fsdp, "shard_hints": shard_hints, "mla_naive": mla_naive,
        "ssm_split": ssm_split, "no_tp": no_tp,
        "microbatches": microbatches, "cache_fp8": cache_fp8,
        "cross_cache": cross_cache, "moe_dense": moe_dense,
        "memory_analysis": mem,
        "cost_analysis": cost,
        "collective_bytes": coll,
        "hlo_bytes": None,
        "lower_s": round(t_lower, 2), "compile_s": None,
        "analytic": list(ANALYTIC),
        "backend": "meta tensors, fake process group (host only)",
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}"
              f" ({n_chips} ranks): trace {t_lower:.1f}s"
              f" flops={cost['flops']:.3e} coll_bytes={coll['total']:.3e}",
              flush=True)
        print(f"  memory_analysis: {mem['repr']}", flush=True)
    return artifact


def run_one(arch: str, shape_name: str, mesh_kind: str,
            force: bool = False, tag: str = "",
            out_dir: Optional[str] = None, **kw) -> Dict:
    path = _artifact_path(arch, shape_name, mesh_kind, tag, out_dir)
    if not force and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    try:
        artifact = lower_and_compile(arch, shape_name, mesh_kind, **kw)
    except Exception as e:      # recorded in the artifact; the run goes on
        artifact = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "error": repr(e), "traceback": traceback.format_exc()}
        print(f"[dryrun] FAILED {arch} x {shape_name} x {mesh_kind}: {e!r}",
              flush=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return artifact


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ASSIGNED_ARCHS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default "
                         "experiments/dryrun_torch)")
    ap.add_argument("--hints", action="store_true",
                    help="SSD activation-sharding constraints (the sharded "
                         "step splits the SSD's heads with or without them)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--mla-naive", action="store_true")
    ap.add_argument("--ssm-split", action="store_true")
    ap.add_argument("--no-tp", action="store_true",
                    help="pure data-parallel layout (model axis joins batch)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--cache-fp8", action="store_true")
    ap.add_argument("--cross-cache", action="store_true")
    ap.add_argument("--moe-dense", action="store_true")
    ap.add_argument("--trace", default=None,
                    help="append each artifact's FLOP/byte counts to this "
                         "JSONL telemetry trace "
                         "(repro_torch.qeil2.telemetry.TraceStore)")
    args = ap.parse_args(argv)

    trace_store = None
    if args.trace:
        from repro_torch.qeil2.telemetry import TraceStore
        trace_store = TraceStore(path=args.trace)

    archs = ASSIGNED_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    try:
        for mesh_kind in meshes:
            for arch in archs:
                for shape_name in shapes:
                    art = run_one(arch, shape_name, mesh_kind,
                                  force=args.force, tag=args.tag,
                                  out_dir=args.out, fsdp=not args.no_fsdp,
                                  shard_hints=args.hints,
                                  mla_naive=args.mla_naive,
                                  ssm_split=args.ssm_split,
                                  no_tp=args.no_tp,
                                  microbatches=args.microbatches,
                                  cache_fp8=args.cache_fp8,
                                  cross_cache=args.cross_cache,
                                  moe_dense=args.moe_dense)
                    if "error" in art:
                        failures.append((arch, shape_name, mesh_kind))
                    elif trace_store is not None:
                        trace_store.ingest_dryrun_artifact(art)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print(f"\nall {len(archs) * len(shapes) * len(meshes)} dry-runs passed")


if __name__ == "__main__":
    main()
