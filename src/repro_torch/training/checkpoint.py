"""Checkpointing in the reference's format (``repro.training.checkpoint``).

A checkpoint is a directory ``step_%08d`` holding ``arrays.npz`` and
``manifest.json``. Each array is stored under ``"{group}:{path}"`` (group
``params`` or ``opt_state``; the path as `repro_torch.training.tree.flatten`
builds it, e.g. ``params:prefix/0/attn/wq/w``), and the manifest records
the step and every array's shape and dtype. Each ``.npy`` member holds the
bytes the reference's ``np.savez`` writes: a bf16 leaf is its raw bits
under the descriptor ``<V2``, which numpy reads back as ``|V2``. The
directory is written under a temporary name and renamed, so a checkpoint
is whole or absent, and an existing step raises `FileExistsError`. Either
package reads the other's checkpoints.

Where the port departs from the reference, and why (ROADMAP.md §3, F11):
the reference cannot restore a bf16 entry (``jnp.asarray`` of a ``|V2``
array raises); the port restores it from the manifest's ``"bfloat16"`` by
viewing the raw bits as ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training.tree import flatten, unflatten


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """The array to store and its manifest dtype; bf16 as raw bits."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _write_npz(file: str, arrays: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """``np.savez``'s archive (stored members ``{key}.npy``), with bf16
    members written under the descriptor ml_dtypes' bfloat16 gives."""
    with zipfile.ZipFile(file, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dtype == "bfloat16":
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False,
                              "shape": arr.shape})
                    fid.write(arr.tobytes())
                else:
                    np.lib.format.write_array(fid, arr, allow_pickle=False)


def save_checkpoint(path: str, step: int, params: Any,
                    opt_state: Any = None) -> str:
    os.makedirs(path, exist_ok=True)
    groups = {"params": params}
    if opt_state is not None:
        groups["opt_state"] = opt_state
    arrays = {f"{group}:{key}": _to_numpy(leaf)
              for group, tree in groups.items()
              for key, leaf in flatten(tree)}
    manifest = {
        "step": step,
        "arrays": {k: {"shape": list(a.shape), "dtype": dt}
                   for k, (a, dt) in arrays.items()},
    }
    tmp = tempfile.mkdtemp(dir=path)
    _write_npz(os.path.join(tmp, "arrays.npz"), arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(path, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(tmp)
        raise FileExistsError(final)
    os.rename(tmp, final)
    return final


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    return os.path.join(path, steps[-1]) if steps else None


def restore_checkpoint(ckpt_dir: str, params_template: Any,
                       opt_template: Any = None,
                       device: DeviceLike = "cuda") -> Tuple[int, Any, Any]:
    """(step, params, opt_state) in the templates' nesting. A template leaf
    is a tensor, whose dtype and device the restored leaf takes, or a shape
    (``Model.param_shapes``, `opt_state_shapes`), for which it keeps the
    stored dtype and goes to ``device``. A shape that differs from the
    template's raises `ValueError`."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    entries = manifest["arrays"]

    with np.load(os.path.join(ckpt_dir, "arrays.npz")) as arrays:
        def rebuild(template: Any, group: str) -> Any:
            leaves = []
            for key, leaf in flatten(template):
                name = f"{group}:{key}"
                arr = arrays[name]
                want = tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                             else leaf)
                if tuple(arr.shape) != want:
                    raise ValueError(f"{key}: checkpoint {arr.shape} != "
                                     f"model {want}")
                if entries[name]["dtype"] == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                if isinstance(leaf, torch.Tensor):
                    t = t.to(device=leaf.device, dtype=leaf.dtype)
                else:
                    t = t.to(resolve_device(device))
                leaves.append(t)
            return unflatten(template, leaves)

        params = rebuild(params_template, "params")
        opt_state = (rebuild(opt_template, "opt_state")
                     if opt_template is not None else None)
    return manifest["step"], params, opt_state
