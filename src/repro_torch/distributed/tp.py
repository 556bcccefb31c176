"""Tensor-parallel compute for the sharded step: collectives with their
duals, a parameter leaf's gather from its at-rest placement to the layout a
layer computes in, and the bookkeeping that keeps gathered tensors out of
the autograd graph.

**Collectives.** Plain functions on tensors with an explicit process group;
each is a `torch.autograd.Function` whose backward is its dual:

  =====================  ==============================================
  forward                backward
  =====================  ==============================================
  `all_gather` (dim)     reduce-scatter (``dual="reduce_scatter"``: the
                         consumers' gradients are partial sums) or the
                         rank's own chunk (``dual="slice"``: every rank
                         holds the whole gradient)
  `reduce_scatter`       all-gather
  `copy_to` (identity)   all-reduce
  `reduce_from`          identity
  (all-reduce)
  `relayout` (all-to-all reverse all-to-all, overlaps summed
  to other index sets)
  =====================  ==============================================

A group of one rank (or None) makes every one of them the identity. The
convention is Megatron's: an activation that every rank of the tensor group
holds whole carries the whole gradient on every rank, and a sharded one
carries its shard's gradient.

**Leaves.** Under the sharded step the model's params tree holds `Leaf`
objects: this rank's at-rest shard (an autograd leaf in training) with its
placements. A layer asks `TensorParallel.take` for the part it computes
with: the whole leaf (``sets=None``) or, along one dim, an index set per
tensor rank (heads, a hidden range, a vocabulary range, a head-dim chunk of
every head). ``take`` all-gathers the non-tensor mesh dims (FSDP), then
moves the tensor dim from the at-rest chunks to the asked sets: nothing
when they are the at-rest chunks, an all-to-all when the leaf is sharded
there, a slice when it is replicated. The backward of each step is the
dual, so the leaf's gradient arrives at its at-rest placement, summed over
the batch axes; no rank ever holds a whole-model gradient.

**Freed after use.** A gathered tensor is registered (`Registry`); inside
`TensorParallel.saving` the autograd graph saves a token in its place (its
source shard and how to gather it again), and the backward gathers it again
when it needs it. So a super-block's gathered weights live while the block
runs and no longer, with or without remat, and a column-parallel product
saves its input's shard, not the gathered input. The registry also counts
the gathered parameter bytes alive at once and the bytes saved for backward
(one count a storage, parameters and tokens excepted).
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

# ------------------------------------------------------------------ helpers


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def split(total: int, n: int) -> List[range]:
    """``total`` split into ``n`` contiguous ranges, rank order (floor
    boundaries: even chunks when ``n`` divides ``total``)."""
    return [range(r * total // n, (r + 1) * total // n) for r in range(n)]


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if size(group) == 1:
        return x
    dim = dim % x.dim()
    return _gather0(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    y = x.movedim(dim, 0).contiguous()
    out = y.new_empty((y.shape[0] // n,) + tuple(y.shape[1:]))
    dist.reduce_scatter_tensor(out, y, group=group)
    return out.movedim(0, dim).contiguous()


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = size(group)
    if n == 1:
        return x
    c = x.shape[dim] // n
    return x.narrow(dim, rank(group) * c, c).contiguous()


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if size(group) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group (no gradient)."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


# ------------------------------------------------------------------ functions


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, dual):
        ctx.dim, ctx.group, ctx.dual = dim, group, dual
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.dual == "slice":
            return _chunk(g, ctx.dim, ctx.group), None, None, None
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, dim: int, group,
               dual: str = "reduce_scatter") -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim`` (rank order);
    backward: reduce-scatter, or the own chunk with ``dual="slice"``."""
    if size(group) == 1:
        return x
    return _AllGather.apply(x, dim, group, dual)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum of ``x``, this rank's chunk of ``dim``; backward:
    all-gather."""
    if size(group) == 1:
        return x
    return _ReduceScatter.apply(x, dim, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; backward: all-reduce (a whole activation feeding
    sharded compute)."""
    if size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum); backward: identity."""
    if size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def all_reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce whose backward all-reduces too: a sum over shards that
    sharded compute then reads (the RMSNorm's sum of squares)."""
    return copy_to(reduce_from(x, group), group)


# ------------------------------------------------------------------ relayout


class Sets:
    """One index set a tensor rank along some dim (sorted, unique within a
    set; sets may overlap), with the plans derived from them cached."""

    def __init__(self, arrays: Sequence):
        self.arrays = [np.asarray(a, dtype=np.int64) for a in arrays]
        self._memo: Dict = {}

    def __getitem__(self, r: int) -> np.ndarray:
        return self.arrays[r]

    def _cached(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def even(self, chunk: int) -> bool:
        """Whether rank r's set is ``[r * chunk, (r + 1) * chunk)``."""
        return self._cached(("even", chunk), lambda: all(
            len(a) == chunk and (chunk == 0 or (a[0] == r * chunk and
                                                a[-1] == (r + 1) * chunk - 1))
            for r, a in enumerate(self.arrays)))

    def span(self, r: int):
        """(start, length) when rank r's set is contiguous, else None."""
        def make():
            a = self.arrays[r]
            if len(a) == 0 or a[-1] - a[0] + 1 == len(a):
                return (int(a[0]) if len(a) else 0, len(a))
            return None
        return self._cached(("span", r), make)

    def index(self, r: int, device) -> torch.Tensor:
        return self._cached(("index", r, str(device)), lambda: torch.as_tensor(
            self.arrays[r], dtype=torch.long, device=device))

    def plan(self, same_dim: bool, chunk: int, me: int, device):
        """What this rank (``me``, holding ``[me * chunk, (me + 1) *
        chunk)`` of the source dim) sends each peer: index tensors along the
        destination dim (local offsets when the dims agree, global ones
        when they differ); and how long each peer's piece to it is along
        the source dim."""
        def make():
            lo, hi = me * chunk, (me + 1) * chunk
            n = len(self.arrays)
            if same_dim:
                send = [a[(a >= lo) & (a < hi)] - lo for a in self.arrays]
                mine = self.arrays[me]
                recv = [int(((mine >= s * chunk) &
                             (mine < (s + 1) * chunk)).sum())
                        for s in range(n)]
            else:
                send = list(self.arrays)
                recv = [chunk] * n
            return ([torch.as_tensor(x, dtype=torch.long, device=device)
                     for x in send], recv)
        return self._cached(("plan", same_dim, chunk, me, str(device)), make)


def select(x: torch.Tensor, dim: int, sets: Sets, r: int) -> torch.Tensor:
    """``x``'s indices ``sets[r]`` along ``dim``: a view when contiguous."""
    span = sets.span(r)
    if span is not None:
        return x.narrow(dim, span[0], span[1])
    return x.index_select(dim, sets.index(r, x.device))


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src_dim, dst_dim, sets):
        me = rank(group)
        chunk = x.shape[src_dim]
        same = src_dim == dst_dim
        send, recv_len = sets.plan(same, chunk, me, x.device)
        pieces = [x.index_select(dst_dim, s) for s in send]
        recv_shapes = []
        for k in recv_len:
            shape = list(x.shape)
            if not same:
                shape[dst_dim] = len(sets[me])
            shape[src_dim] = k
            recv_shapes.append(shape)
        in_split = [p.numel() for p in pieces]
        out_split = [int(torch.Size(s).numel()) for s in recv_shapes]
        flat = torch.cat([p.reshape(-1) for p in pieces])
        out = flat.new_empty(sum(out_split))
        dist.all_to_all_single(out, flat, out_split, in_split, group=group)
        parts = [t.reshape(s) for t, s in
                 zip(out.split(out_split), recv_shapes)]
        ctx.send = send
        ctx.meta = (group, src_dim, dst_dim, tuple(x.shape), in_split,
                    out_split, [p.shape for p in pieces], recv_len)
        return torch.cat(parts, dim=src_dim)

    @staticmethod
    def backward(ctx, g):
        (group, src_dim, dst_dim, shape, in_split, out_split, piece_shapes,
         recv_len) = ctx.meta
        parts = g.contiguous().split(recv_len, dim=src_dim)
        flat = torch.cat([p.reshape(-1) for p in parts])
        back = flat.new_empty(sum(in_split))
        dist.all_to_all_single(back, flat, in_split, out_split, group=group)
        grad = g.new_zeros(shape)
        for t, s, ps in zip(back.split(in_split), ctx.send, piece_shapes):
            if s.numel():
                grad.index_add_(dst_dim, s, t.reshape(ps))
        return grad, None, None, None, None


def relayout(x: torch.Tensor, group, src_dim: int, dst_dim: int,
             sets: Sets) -> torch.Tensor:
    """From even chunks of ``src_dim`` over the group (``x`` is this rank's
    chunk, whole along the other dims) to rank r's index set ``sets[r]``
    along ``dst_dim``, whole along ``src_dim``: one all-to-all. Sets may
    overlap; the backward sums the overlaps into the source chunk."""
    if size(group) == 1:
        return select(x, dst_dim, sets, 0)
    return _Relayout.apply(x, group, src_dim % x.dim(), dst_dim % x.dim(),
                           sets)


def gather_sets(x: torch.Tensor, dim: int, group, sets, total: int
                ) -> torch.Tensor:
    """The whole of ``dim`` (``total`` long) from every rank's part
    ``sets[r]`` of it: contiguous ranges, or the index arrays of a `Sets`
    (uneven or overlapping; an overlap holds the same values on every
    rank). Forward only."""
    n = size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    width = max(len(sets[r]) for r in range(n))
    if x.shape[dim] < width:
        pad = list(x.shape)
        pad[dim] = width - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    every = _gather(x, dim, group)
    shape = list(x.shape)
    shape[dim] = total
    out = x.new_empty(shape)
    for r in range(n):
        s = sets[r]
        part = every.narrow(dim, r * width, len(s))
        if isinstance(s, range):
            out.narrow(dim, s.start, len(s)).copy_(part)
        else:
            out.index_copy_(dim, sets.index(r, x.device), part)
    return out


def check_replicated(x: torch.Tensor, group, what: str) -> None:
    """Raise unless every rank of the group holds the same ``x`` (on when
    `CHECK_REPLICATED` is set: the tests set it)."""
    if not CHECK_REPLICATED or size(group) == 1:
        return
    every = _gather(x.detach().reshape(1, -1), 0, group)
    if not bool((every == every[:1]).all()):
        raise RuntimeError(f"{what} differs across the tensor group")


CHECK_REPLICATED = False


# ------------------------------------------------------------------ leaves


class Leaf:
    """A parameter's at-rest shard on this rank: ``local`` (an autograd leaf
    in training), its placements (one a mesh dim, dims of ``shape``) and
    its global ``shape``."""

    __slots__ = ("local", "placements", "shape", "path")

    def __init__(self, local: torch.Tensor, placements, shape, path: str):
        self.local = local
        self.placements = tuple(placements)
        self.shape = tuple(shape)
        self.path = path


class _Entry:
    __slots__ = ("source", "regather", "param", "path")

    def __init__(self, source, regather, param, path):
        self.source, self.regather = source, regather
        self.param, self.path = param, path


class _Token:
    __slots__ = ("entry", "size", "stride", "offset")

    def __init__(self, entry, t):
        self.entry = entry
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Registry:
    """Gathered tensors alive now (by storage), the gathered parameter
    bytes alive at once, and the bytes saved for backward."""

    def __init__(self):
        self.entries: Dict[int, _Entry] = {}
        self.live = 0
        self.peak = 0
        self.by_path: Dict[str, int] = {}
        self.saved = 0
        self._counted: set = set()
        self.params: set = set()

    def add(self, out: torch.Tensor, source: torch.Tensor,
            regather: Callable[[], torch.Tensor], param: bool,
            path: str = "") -> torch.Tensor:
        key = _key(out)
        self.entries[key] = _Entry(source, regather, param, path)
        nbytes = out.untyped_storage().nbytes()
        if param:
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            self.by_path[path] = max(self.by_path.get(path, 0), nbytes)
        weakref.finalize(out, self._drop, key, nbytes if param else 0)
        return out

    def _drop(self, key: int, nbytes: int) -> None:
        self.entries.pop(key, None)
        self.live -= nbytes

    def count(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self._counted or key in self.params:
            return
        self._counted.add(key)
        self.saved += t.untyped_storage().nbytes()

    def pack(self, t: torch.Tensor):
        entry = self.entries.get(_key(t))
        if entry is None:
            self.count(t)
            return t
        if not entry.param:
            self.count(entry.source)
        return _Token(entry, t)

    def unpack(self, obj):
        if isinstance(obj, _Token):
            entry = obj.entry
            with torch.no_grad():
                full = entry.regather()
            if entry.param:
                self.add(full, entry.source, entry.regather, True, entry.path)
            return full.as_strided(obj.size, obj.stride, obj.offset)
        return obj

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        self.unpack)


# ------------------------------------------------------------------ context


class TensorParallel:
    """The sharded step's compute context on one rank.

    ``tensor_dim``: the mesh dim of the tensor axis (None when the policy
    has none); ``batch_dims``: the mesh dims that split the batch. The
    groups are the mesh's own, which every rank created in mesh order
    (``init_device_mesh``). ``cache_dims``: for the sharded forward, the
    tensor-sharded dim of each cache entry of a layer (by name), or None.
    """

    def __init__(self, mesh, tensor_dim: Optional[int],
                 batch_dims: Sequence[int]):
        self.tensor_dim = tensor_dim
        self.batch_dims = set(batch_dims)
        self.group = mesh.get_group(tensor_dim) if tensor_dim is not None \
            else None
        self.n = size(self.group)
        self.rank = rank(self.group)
        self.groups = [mesh.get_group(i) for i in range(mesh.ndim)]
        self.registry = Registry()
        self.cache_dims: Dict[str, Optional[int]] = {}
        self._sets: Dict = {}

    # ---- index sets (memoised: their plans are cached on them)
    def _memo(self, key, make) -> Sets:
        if key not in self._sets:
            self._sets[key] = Sets(make())
        return self._sets[key]

    def ranges(self, total: int) -> List[range]:
        return split(total, self.n)

    def own(self, total: int) -> range:
        return self.ranges(total)[self.rank]

    def range_sets(self, total: int) -> Sets:
        """Even (floor) ranges of ``total``, one a rank."""
        return self._memo(("ranges", total), lambda: [
            np.arange(r.start, r.stop) for r in self.ranges(total)])

    def head_sets(self, ranges: Sequence[range], hd: int) -> Sets:
        """Flat indices into ``heads * hd`` of each rank's heads."""
        key = ("heads", tuple((r.start, r.stop) for r in ranges), hd)
        return self._memo(key, lambda: [
            np.arange(r.start * hd, r.stop * hd) for r in ranges])

    def every(self, total: int) -> Sets:
        """Every index of ``total`` on every rank: a leaf taken whole for
        compute whose consumers split over the tensor ranks (B and C of the
        SSD, MLA's rope key), so that the overlaps' partial gradients are
        summed back in the backward."""
        return self._memo(("every", total),
                          lambda: [np.arange(total)] * self.n)

    def index_sets(self, key, make: Callable[[], Sequence]) -> Sets:
        """A layer's own index sets (``make()``: one array a rank),
        memoised under ``key``."""
        return self._memo(("own",) + tuple(key), make)

    def chunk_sets(self, heads: int, hd: int) -> Sets:
        """Rank r's head-dim chunk of every head, as flat indices into
        ``heads * hd``."""
        c = hd // self.n

        def make():
            base = np.arange(heads)[:, None] * hd
            return [(base + r * c + np.arange(c)[None]).reshape(-1)
                    for r in range(self.n)]
        return self._memo(("chunks", heads, hd), make)

    # ---- leaves
    def take(self, w, dim: Optional[int] = None,
             sets: Optional[Sets] = None) -> torch.Tensor:
        """The part of leaf ``w`` this rank computes with (module
        docstring): whole (``sets=None``) or ``sets[rank]`` along ``dim``.
        A plain tensor comes back whole or sliced."""
        if not isinstance(w, Leaf):
            return w if sets is None else select(w, dim, sets, self.rank)
        x = self._gather(w, dim, sets)
        if _key(x) != _key(w.local):
            self.registry.add(x, w.local,
                              lambda: self._gather(w, dim, sets), True,
                              w.path)
        return x

    def _gather(self, w: Leaf, dim, sets) -> torch.Tensor:
        x = w.local
        for i, pl in enumerate(w.placements):
            if i == self.tensor_dim:
                continue
            batch = i in self.batch_dims
            if isinstance(pl, Shard):
                x = all_gather(x, pl.dim, self.groups[i],
                               "reduce_scatter" if batch else "slice")
            elif batch:
                x = copy_to(x, self.groups[i])
        pl = (w.placements[self.tensor_dim] if self.tensor_dim is not None
              else None)
        sharded = isinstance(pl, Shard) and self.n > 1
        if sets is None:
            return all_gather(x, pl.dim, self.group, "slice") if sharded \
                else x
        dim = dim % len(w.shape)
        if sharded:
            if pl.dim == dim and sets.even(w.shape[dim] // self.n):
                return x
            return relayout(x, self.group, pl.dim, dim, sets)
        if self.n == 1 and sets.span(0) == (0, w.shape[dim]):
            return x
        return select(copy_to(x, self.group), dim, sets, self.rank)

    def whole(self, tree):
        """Every leaf of a (sub)tree, taken whole."""
        if isinstance(tree, dict):
            return {k: self.whole(v) for k, v in tree.items()}
        return self.take(tree)

    def placement(self, w) -> Optional[int]:
        """The dim of leaf ``w`` that the tensor axis shards at rest."""
        if not isinstance(w, Leaf) or self.tensor_dim is None:
            return None
        pl = w.placements[self.tensor_dim]
        return pl.dim if isinstance(pl, Shard) else None

    # ---- activations
    def gather_input(self, x: torch.Tensor, dual: str = "reduce_scatter"
                     ) -> torch.Tensor:
        """The residual stream's d-shards of ``x`` all-gathered for the
        products that read it; saved for backward as the shard (gathered
        again in the backward)."""
        if self.n == 1:
            return x
        out = all_gather(x, -1, self.group, dual)
        return self.registry.add(out, x,
                                 lambda: _gather(x, -1, self.group), False)

    def saving(self):
        """Saved-tensor hooks: gathered tensors saved as tokens, the rest
        counted."""
        return self.registry.hooks()

    # ---- the collectives over the tensor group (the model's layers call
    # these; they import nothing of this package)
    def reduce_scatter(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return reduce_scatter(x, dim, self.group)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.group)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.group)

    def all_reduce_both(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_both(x, self.group)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(x, self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group, forward only."""
        return _all_reduce(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather along ``dim``, forward only."""
        return _gather(x, dim, self.group)

    def select(self, x: torch.Tensor, dim: int, sets: Sets) -> torch.Tensor:
        """This rank's set of ``dim`` of a tensor it holds whole, forward
        only."""
        return select(x, dim, sets, self.rank)

    def chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's even chunk of ``dim``, forward only."""
        return _chunk(x, dim % x.dim(), self.group)

    def gather_sets(self, x: torch.Tensor, dim: int, sets,
                    total: int) -> torch.Tensor:
        return gather_sets(x, dim, self.group, sets, total)

    def check_replicated(self, x: torch.Tensor, what: str) -> None:
        check_replicated(x, self.group, what)
