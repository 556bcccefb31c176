"""Decode attention wrappers: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors.

The kernels (``repro_torch/csrc/decode_attention.cu``) replace the TPU
kernels `decode_attention_pallas` and `paged_decode_attention_pallas` in
``src/repro/kernels/decode_attention/decode_attention.py``. Both split their
slot axis across blocks (`split.plan_splits`: the dense ring's W slots, the
nb * bs logical slots of a block-table row) and merge the splits' partials
in the same launch through a per-device workspace. Each
wrapper's ``launches`` attribute counts its kernel's launches, one a call;
a grouped paged call launches the prefix kernel besides, which
``paged_decode_attention_prefix.launches`` counts. The CPU path does not
count.
"""
from __future__ import annotations

import ctypes
import functools
import types
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_launch, check_tensors,
                                        stream_of, workspace)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.decode_attention.split import (
    groups_engage, min_shared_blocks, plan_prefix, plan_splits)
from repro_torch.obs.profiling import kernel_scope

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    lib.decode_attention_fwd.argtypes = [_P] * 8 + [_I] * 6 + [
        ctypes.c_float] + [_I] * 6 + [_P]
    lib.decode_attention_fwd.restype = _I
    lib.paged_decode_attention_fwd.argtypes = [_P] * 10 + [_I] * 8 + [
        ctypes.c_float] + [_I] * 7 + [_P]
    lib.paged_decode_attention_fwd.restype = _I
    lib.paged_decode_attention_smem_bytes.argtypes = [_I, _I, _I]
    lib.paged_decode_attention_smem_bytes.restype = ctypes.c_size_t
    lib.paged_decode_attention_blocks_per_sm.argtypes = [_I, _I, _I]
    lib.paged_decode_attention_blocks_per_sm.restype = _I
    lib.paged_decode_attention_prefix_smem_bytes.argtypes = [_I] * 4
    lib.paged_decode_attention_prefix_smem_bytes.restype = ctypes.c_size_t
    lib.paged_decode_attention_prefix_blocks_per_sm.argtypes = [_I] * 4
    lib.paged_decode_attention_prefix_blocks_per_sm.restype = _I
    lib.decode_attention_split_smem_bytes.argtypes = [_I, _I, _I]
    lib.decode_attention_split_smem_bytes.restype = ctypes.c_size_t
    lib.decode_attention_split_blocks_per_sm.argtypes = [_I, _I, _I, _I]
    lib.decode_attention_split_blocks_per_sm.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(group: int, D: int, Dv: int, is_bf16: bool) -> int:
    return _lib().decode_attention_split_blocks_per_sm(group, D, Dv,
                                                       int(is_bf16))


def split_plan(B: int, W: int, H: int, Hkv: int, D: int, Dv: int,
               dtype: torch.dtype,
               device: torch.device) -> Tuple[int, int, int]:
    """`plan_splits` as the dense wrapper calls it on ``device``: with the
    card's SM count and the kernel's occupancy at these head dims."""
    return plan_splits(B, Hkv, W, H // Hkv, _sm_count(device),
                       _blocks_per_sm(H // Hkv, D, Dv,
                                      dtype == torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _paged_blocks_per_sm(D: int, Dv: int, is_bf16: bool) -> int:
    return _lib().paged_decode_attention_blocks_per_sm(D, Dv, int(is_bf16))


def paged_split_plan(B: int, n_slots: int, H: int, Hkv: int, D: int,
                     Dv: int, dtype: torch.dtype,
                     device: torch.device) -> Tuple[int, int, int]:
    """`plan_splits` as the paged wrapper calls it on ``device``, over the
    ``n_slots = nb * bs`` logical slots of a table row: with the card's SM
    count and the paged kernel's occupancy at these head dims."""
    return plan_splits(B, Hkv, n_slots, H // Hkv, _sm_count(device),
                       _paged_blocks_per_sm(D, Dv, dtype == torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _prefix_blocks_per_sm(D: int, Dv: int, is_bf16: bool, B: int) -> int:
    return _lib().paged_decode_attention_prefix_blocks_per_sm(
        D, Dv, int(is_bf16), B)


def prefix_plan(B: int, n_split: int, D: int, Dv: int, dtype: torch.dtype,
                device: torch.device) -> Tuple[int, int]:
    """`plan_prefix` as the paged wrapper calls it on ``device``: the
    prefix kernel's one-wave grid and its splits' cap."""
    return plan_prefix(n_split, _sm_count(device),
                       _prefix_blocks_per_sm(D, Dv,
                                             dtype == torch.bfloat16, B))


def _check_q(op: str, q: torch.Tensor, kv_heads: int, d_k: int) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{op}: q must be (B, 1, H, D), got {tuple(q.shape)}")
    H, D = q.shape[2], q.shape[3]
    if kv_heads == 0 or H % kv_heads:
        raise ValueError(f"{op}: {H} heads not a multiple of {kv_heads} kv "
                         "heads")
    if D != d_k:
        raise ValueError(f"{op}: q head dim {D} != key head dim {d_k}")


def _check_smem(op: str, smem: int, group: int, D: int, Dv: int):
    if smem > build.MAX_SMEM_PER_BLOCK:
        raise ValueError(f"{op}: group {group}, D={D}, Dv={Dv} need {smem} B "
                         f"of shared memory per block "
                         f"(> {build.MAX_SMEM_PER_BLOCK})")


def decode_attention_cache(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           q_pos: torch.Tensor, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """q (B,1,H,D); k/v cache (B,W,Hkv,D|Dv); pos (B,W) int32 absolute
    position per slot (-1 = empty); q_pos (B,) int32. Returns (B,1,H,Dv)."""
    op = "decode_attention"
    if q.device.type == "cpu":
        with kernel_scope(op):
            return decode_attention_ref(q, k_cache, v_cache, pos, q_pos,
                                        scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {q.device}")
    check_tensors(op, [q, k_cache, v_cache], [pos, q_pos])
    if k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"{op}: caches must be (B, W, Hkv, D)")
    B, W, Hkv, D = k_cache.shape
    _check_q(op, q, Hkv, D)
    if q.shape[0] != B or tuple(v_cache.shape[:3]) != (B, W, Hkv) or \
            tuple(pos.shape) != (B, W) or tuple(q_pos.shape) != (B,):
        raise ValueError(f"{op}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"pos {tuple(pos.shape)}, q_pos "
                         f"{tuple(q_pos.shape)} disagree")
    if window is not None and window < 1:
        raise ValueError(f"{op}: window {window} must be >= 1")
    H, Dv = q.shape[2], v_cache.shape[3]
    is_bf16 = q.dtype == torch.bfloat16
    for n, name in ((D, "D"), (Dv, "Dv")):
        row = n * q.element_size()
        if row % 16 or row > 1024:
            raise ValueError(f"{op}: head dim {name}={n} gives {row}-byte "
                             "rows; the kernel takes multiples of 16 bytes "
                             "up to 1024")
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: q and the caches must start on a "
                             "16-byte boundary")
    lib = _lib()
    _check_smem(op, lib.decode_attention_split_smem_bytes(D, Dv, int(is_bf16)),
                H // Hkv, D, Dv)
    if scale is None:
        scale = D ** -0.5
    n_split, split_slots, n_hb = split_plan(B, W, H, Hkv, D, Dv, q.dtype,
                                            q.device)
    counters, part = workspace("decode_attention", q.device,
                               B * Hkv * n_hb, B * H * n_split * (Dv + 2))
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    with kernel_scope(op, cuda=True):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(),
            B, W, H, Hkv, D, Dv, float(scale), int(window is not None),
            int(window or 0), n_split, split_slots, n_hb, int(is_bf16),
            stream_of(q))
    check_launch(op, err)
    decode_attention_cache.launches += 1
    return out


decode_attention_cache.launches = 0


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, pos_pool: torch.Tensor,
                           block_table: torch.Tensor, q_pos: torch.Tensor, *,
                           scale: Optional[float] = None,
                           prefix_groups: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (B,1,H,D); pools (P,bs,Hkv,D|Dv) of fixed-size KV blocks; pos_pool
    (P,bs) int32 (-1 = empty); block_table (B,nb) int32 physical block per
    logical block; q_pos (B,) int32. Returns (B,1,H,Dv).

    Table entries are not range-checked here (that would read the table back
    from the card on every call): the serving backend builds the tables on
    the host from allocator ids below the pool size. The kernel and the
    plain version both read an entry outside [0, P) as an empty block.

    ``prefix_groups`` (B,2) int32 on the card (`split.prefix_groups`): each
    row's group's first row and shared blocks, the rows of a group
    consecutive and their tables equal over those blocks. With it, where
    `split.groups_engage` takes the shape (at most 32 query heads a kv
    head, a table longer than the shortest prefix grouped, enough (row, kv
    head) pairs), the call takes the grouped path: the shared blocks of a
    group at least `split.min_shared_blocks` long are read once for every
    row of a row tile, then each row walks its own tail. The launches
    depend on shapes only, never on the descriptor's contents, which
    nothing reads back to the host. Otherwise the per-row kernel alone.
    The CPU path is the plain version either way."""
    op = "paged_decode_attention"
    if q.device.type == "cpu":
        with kernel_scope(op):
            return paged_decode_attention_ref(q, k_pool, v_pool, pos_pool,
                                              block_table, q_pos, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {q.device}")
    check_tensors(op, [q, k_pool, v_pool],
                  [pos_pool, block_table, q_pos] +
                  ([] if prefix_groups is None else [prefix_groups]))
    if k_pool.dim() != 4 or v_pool.dim() != 4 or block_table.dim() != 2:
        raise ValueError(f"{op}: pools must be (P, bs, Hkv, D) and the "
                         "block table (B, nb)")
    P, bs, Hkv, D = k_pool.shape
    B, nb = block_table.shape
    _check_q(op, q, Hkv, D)
    if q.shape[0] != B or tuple(v_pool.shape[:3]) != (P, bs, Hkv) or \
            tuple(pos_pool.shape) != (P, bs) or tuple(q_pos.shape) != (B,):
        raise ValueError(f"{op}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"pos_pool {tuple(pos_pool.shape)}, table "
                         f"{tuple(block_table.shape)}, q_pos "
                         f"{tuple(q_pos.shape)} disagree")
    H, Dv = q.shape[2], v_pool.shape[3]
    is_bf16 = q.dtype == torch.bfloat16
    if D % 16 or Dv % 16 or Dv > 128:
        raise ValueError(f"{op}: head dims D={D}, Dv={Dv}; the kernel takes "
                         "multiples of 16, Dv at most 128")
    for t in (q, k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: q and the pools must start on a "
                             "16-byte boundary")
    lib = _lib()
    _check_smem(op, lib.paged_decode_attention_smem_bytes(D, Dv,
                                                          int(is_bf16)),
                H // Hkv, D, Dv)
    if scale is None:
        scale = D ** -0.5
    n_split, split_slots, n_hb = paged_split_plan(B, nb * bs, H, Hkv, D, Dv,
                                                  q.dtype, q.device)
    grouped = prefix_groups is not None and groups_engage(H // Hkv, nb * bs,
                                                          B * Hkv)
    grid, p_cap, min_shared, groups_ptr = 0, 0, 0, None
    if grouped:
        if tuple(prefix_groups.shape) != (B, 2):
            raise ValueError(f"{op}: prefix_groups must be ({B}, 2), got "
                             f"{tuple(prefix_groups.shape)}")
        _check_smem(op, lib.paged_decode_attention_prefix_smem_bytes(
            D, Dv, int(is_bf16), B), H // Hkv, D, Dv)
        grid, p_cap = prefix_plan(B, n_split, D, Dv, q.dtype, q.device)
        min_shared = min_shared_blocks(H // Hkv, bs)
        groups_ptr = prefix_groups.data_ptr()
    stride = n_split + p_cap
    counters, part = workspace("decode_attention", q.device,
                               B * Hkv * n_hb,
                               B * H * stride * (Dv + 2) + int(grouped))
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    with kernel_scope(op, cuda=True):
        err = lib.paged_decode_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pos_pool.data_ptr(), block_table.data_ptr(), groups_ptr,
            q_pos.data_ptr(), out.data_ptr(), part.data_ptr(),
            counters.data_ptr(), B, nb, bs, P, H, Hkv, D, Dv, float(scale),
            n_split, split_slots, n_hb, grid, p_cap, min_shared,
            int(is_bf16), stream_of(q))
    check_launch(op, err)
    paged_decode_attention.launches += 1
    paged_decode_attention_prefix.launches += int(grouped)
    return out


paged_decode_attention.launches = 0
#: the launches of the grouped path's prefix kernel, which a grouped
#: `paged_decode_attention` call makes before the per-row kernel's
paged_decode_attention_prefix = types.SimpleNamespace(launches=0)

__all__ = ["decode_attention_cache", "decode_attention_ref",
           "paged_decode_attention", "paged_decode_attention_prefix",
           "paged_decode_attention_ref",
           "split_plan", "paged_split_plan", "prefix_plan"]
