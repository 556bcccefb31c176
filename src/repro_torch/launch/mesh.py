"""Mesh construction, ported from ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group. A mesh is a `DeviceMesh` over the running process group
(``torch.distributed``), one rank a device: gloo ranks on the CPU, NCCL
ranks one a card (``cuda:rank``). Nothing on the machine tells a program of
a cluster: `init_world` takes the address, world size and rank, and
`run_debug_world` starts a debug world's ranks as processes of this host.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda") -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks over ("data", "model").
    Multi-pod: 2x16x16 = 512 ranks over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False,
                    device: DeviceLike = "cuda") -> DeviceMesh:
    """Small mesh over a running world of ``n_data * n_model`` ranks
    (twice that with ``multi_pod``)."""
    kind = torch.device(device).type
    if multi_pod:
        return init_device_mesh(kind, (2, n_data, n_model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(kind, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def init_world(rank: int, world_size: int, init_method: str,
               device: DeviceLike = "cuda") -> torch.device:
    """Join a process group: gloo on the CPU, NCCL on ``cuda:rank``.
    Returns this rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def check_cards(n_ranks: int, device: DeviceLike = "cuda") -> None:
    """Refuse a CUDA world with more ranks than cards: NCCL cannot place two
    ranks on one device, and the port never drops to the CPU."""
    if resolve_device(device).type != "cuda":
        return
    cards = torch.cuda.device_count()
    if cards < n_ranks:
        raise RuntimeError(f"a world of {n_ranks} ranks needs {n_ranks} "
                           f"cards, one a rank; this machine has {cards} "
                           f"card{'s' if cards != 1 else ''}")


def _rank_main(rank: int, fn: Callable, args: Sequence, world: int,
               init_method: str, device: str, mesh_kw: dict) -> None:
    dev = init_world(rank, world, init_method, device)
    try:
        fn(rank, make_debug_mesh(device=dev, **mesh_kw), *args)
    finally:
        dist.destroy_process_group()


def run_debug_world(fn: Callable, args: Sequence = (), *, n_data: int = 2,
                    n_model: int = 2, multi_pod: bool = False,
                    device: DeviceLike = "cuda") -> None:
    """Run ``fn(rank, mesh, *args)`` on every rank of a debug world of
    ``n_data x n_model`` ranks (x 2 with ``multi_pod``), each a spawned
    process of this host joined through a file store; returns when every
    rank has, and raises if one failed. ``fn`` and ``args`` must pickle."""
    world = n_data * n_model * (2 if multi_pod else 1)
    check_cards(world, device)
    with tempfile.TemporaryDirectory() as d:
        init_method = "file://" + os.path.join(d, "store")
        mp.start_processes(
            _rank_main, nprocs=world, start_method="spawn",
            args=(fn, tuple(args), world, init_method,
                  str(resolve_device(device)),
                  dict(n_data=n_data, n_model=n_model, multi_pod=multi_pod)))
