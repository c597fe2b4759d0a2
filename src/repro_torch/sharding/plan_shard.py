"""A RelationPlan partitioned over devices: sharded execution of one large
circuit (the reference's DESIGN.md §12), table for table the reference's
``repro/sharding/plan_shard.py``.

:func:`shard_relation_plan` splits a plan's super-arena by destination
row-block over ``n`` shards at pack time:

* Shard ``d`` owns the contiguous OUTPUT slab ``[d·T, (d+1)·T)`` of the
  relation-concat output space and the contiguous SOURCE slab
  ``[d·S, (d+1)·S)`` of the type-concat source space (``T``/``S`` are the
  ceil-divided slab sizes; the ragged tail is inert padding).
* Every edge lands on the shard owning its destination row.  Source rows a
  shard reads but does not own form its HALO: a per-owner sorted-unique
  request list, baked into two index tables:

    - ``send_idx[s, p]``: local rows (at owner ``s``) that peer ``p``
      requested, the owner's send gather (zero-filled past the list);
    - ``halo_rows[d, s]``: global source rows behind shard ``d``'s halo
      slots from owner ``s`` (-1 = padding), the audit table.

* Each shard's edges are re-packed (``pack_ell`` -> ``fuse_bucketed`` at
  the plan's chunk widths) into local forward and transposed arenas over
  the local source space ``[own slab | halo slab]`` (halo slot ``(s, j)``
  lives at ``S + s·H + j``).  Kernels 1 and 4 run on them unchanged, one
  launch per shard and direction.

The shards' arenas are padded to one shape, as the reference pads them
for ``shard_map`` (:func:`~repro_torch.graphs.ell.pad_fused_arena`: the
padding chunks are never walked), so that the tables, ``shard_bytes`` and
the ``arena.*`` gauges equal the reference's.  The port keeps the
per-shard arenas as a tuple, not stacked.

The executor (``kernels/ops.py::drspmm_multi_sharded``) runs in one
process: :meth:`ShardedRelationPlan.to` puts shard ``d``'s tables on
``devices[d]``, the forward exchange is ``index_select`` at the owner and
a copy to the reader, and the backward sends the halo segment of each
shard's dx slab home, where it is ``index_add_``-ed at ``send_idx``.
:func:`reference_forward` / :func:`reference_backward` re-enact the same
exchange in numpy on a dense operand (the tests' oracles).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graphs.ell import (FusedELL, RelationPlan, RelationSegment,
                                    _to_tensor, fuse_bucketed, pack_ell,
                                    pad_fused_arena, plan_to_coo)
from repro_torch.obs.metrics import DEFAULT_REGISTRY as _METRICS
from repro_torch.sharding.specs import shard_devices

_ARENA_TABLES = ("nbr", "w", "block_of", "start", "rows", "gather")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


def _arena_nbytes(f: FusedELL) -> int:
    """Device footprint of one arena's tables (slot tables dominate), as
    the reference counts it."""
    return sum(_nbytes(getattr(f, t)) for t in _ARENA_TABLES)


@dataclasses.dataclass(frozen=True)
class ShardedRelationPlan:
    """A :class:`RelationPlan` partitioned over ``n_shards`` devices.

    ``fwd[d]`` / ``bwd[d]`` are shard ``d``'s local forward and transposed
    arenas (padded to one shape across shards); ``send_idx`` (n, n, H) and
    ``halo_rows`` (n, n, H) are the host exchange tables.  A host plan has
    numpy tables and ``devices`` None; :meth:`to` gives the placed plan:
    shard ``d``'s arenas on ``devices[d]`` and ``send[s]``, owner ``s``'s
    (n, H) rows of ``send_idx``, on ``devices[s]``."""

    fwd: Tuple[FusedELL, ...]
    bwd: Tuple[FusedELL, ...]
    send_idx: np.ndarray         # (n, n, H) local rows owner s sends peer p
    halo_rows: np.ndarray        # (n, n, H) global src row per slot; -1 pad
    n_shards: int
    src_slab: int                # S
    out_slab: int                # T
    halo_pad: int                # H
    n_src_total: int
    n_out_total: int
    row_block: int
    fwd_chunk: int
    bwd_chunk: int
    # the unsharded plan's table footprint: the replication baseline
    full_arena_bytes: int
    segments: Tuple[RelationSegment, ...]
    src_types: Tuple[str, ...]
    src_off: Tuple[int, ...]
    src_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None
    send: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def local_src(self) -> int:
        """Local source-slab width: owned rows + owner-major halo slots."""
        return self.src_slab + self.n_shards * self.halo_pad

    def local_fwd(self, d: int) -> FusedELL:
        return self.fwd[d]

    def local_bwd(self, d: int) -> FusedELL:
        return self.bwd[d]

    def owned_src_rows(self, d: int) -> int:
        """Count of real (non-padding) source rows shard ``d`` owns."""
        return max(0, min(self.src_slab, self.n_src_total - d * self.src_slab))

    def shard_bytes(self, d: int) -> int:
        """Shard ``d``'s table footprint: its two arenas and its rows of
        the send table (the same for every shard: one padded shape)."""
        return _arena_nbytes(self.fwd[d]) + _arena_nbytes(self.bwd[d]) \
            + self.send_idx[d].nbytes

    def halo_stats(self) -> dict:
        shards = []
        for d in range(self.n_shards):
            owned = self.owned_src_rows(d)
            halo = int((self.halo_rows[d] >= 0).sum())
            shards.append(dict(
                shard=d, owned_rows=owned, halo_rows=halo,
                halo_owned_ratio=halo / max(1, owned),
                arena_bytes=self.shard_bytes(d)))
        return dict(shards=shards, halo_pad=self.halo_pad,
                    max_shard_bytes=max(s["arena_bytes"] for s in shards),
                    total_halo_rows=sum(s["halo_rows"] for s in shards),
                    full_arena_bytes=self.full_arena_bytes)

    def to(self, devices: Union[str, torch.device, Sequence]
           ) -> "ShardedRelationPlan":
        """The plan with shard ``d``'s tables on ``devices[d]``.  One device
        (``"cuda"``, ``"cpu"``) places the shards with
        :func:`~repro_torch.sharding.specs.shard_devices`: cycling over the
        visible cards from that one, or all on the CPU."""
        if isinstance(devices, (str, torch.device)):
            devs = shard_devices(self.n_shards, devices)
        else:
            devs = tuple(resolve_device(d) for d in devices)
        if len(devs) != self.n_shards:
            raise ValueError(f"{len(devs)} devices for {self.n_shards} "
                             f"shards")
        if devs == self.devices:
            return self
        send = np.ascontiguousarray(self.send_idx)
        return dataclasses.replace(
            self, devices=devs,
            fwd=tuple(f.to(dv) for f, dv in zip(self.fwd, devs)),
            bwd=tuple(f.to(dv) for f, dv in zip(self.bwd, devs)),
            send=tuple(_to_tensor(send[s], dv) for s, dv in enumerate(devs)))


def _relation_halo_counts(plan: RelationPlan, dst: np.ndarray,
                          src: np.ndarray, shard_of: np.ndarray,
                          owner_of: np.ndarray) -> Dict[str, dict]:
    """Per-relation halo accounting for the ``arena.halo_*`` gauges: a halo
    row is one distinct (reader shard, source row) pair that a cross-shard
    edge of the relation forces into a halo slab; ``owned_rows`` is the
    relation's distinct source rows (one row's bytes are the same either
    way, so the row ratio is the byte ratio)."""
    out = {}
    for seg in plan.segments:
        m = (dst >= seg.out_off) & (dst < seg.out_off + seg.n_dst)
        used = np.unique(src[m])
        cross = shard_of[m] != owner_of[m]
        pairs = np.unique(np.stack([shard_of[m][cross], src[m][cross]],
                                   axis=1), axis=0) if cross.any() else \
            np.zeros((0, 2), np.int64)
        out[seg.etype] = dict(halo_rows=int(pairs.shape[0]),
                              owned_rows=int(used.size))
    return out


def shard_relation_plan(plan: RelationPlan, n_shards: int, *,
                        registry=None) -> ShardedRelationPlan:
    """Partition a host plan (numpy or CPU-tensor tables) into per-shard
    local arenas and halo tables (pure numpy; the layout is in the module
    docstring).

    The partition is by global coordinates, not arena blocks: the fused
    arenas degree-sort rows, so each shard's edges are recovered from the
    plan's edge set (:func:`plan_to_coo`) and re-packed at the plan's chunk
    widths.  A sharded plan has no dense tier: every relation, one the
    plan routes dense included, goes into the local arenas.  Sets the
    ``arena.halo_rows`` / ``arena.halo_owned_byte_ratio`` /
    ``arena.shard_bytes`` gauges per shard and per relation and
    ``arena.halo_pad`` in ``registry`` (default: the process registry)."""
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be at least 1, got {n_shards}")
    reg = _METRICS if registry is None else registry
    fwd = plan.fwd
    br = fwd.row_block
    n_out, n_src = plan.n_out_total, plan.n_src_total
    t_slab = _ceil_div(n_out, n)
    s_slab = _ceil_div(n_src, n)

    dst, src, w = plan_to_coo(plan)
    shard_of = dst // t_slab
    owner_of = src // s_slab

    # per-shard edge sets + per-owner halo request lists (sorted unique)
    parts, req = [], []
    for d in range(n):
        m = shard_of == d
        sd, ss, sw, own = dst[m] - d * t_slab, src[m], w[m], owner_of[m]
        req.append([np.unique(ss[(own == s) & (own != d)])
                    for s in range(n)])
        parts.append((sd, ss, sw, own))
    h_pad = max(1, max((r.size for row in req for r in row), default=1))
    local_src = s_slab + n * h_pad

    # local re-pack: own rows keep [0, S); halo row j of owner s -> S + s·H + j
    fwd_arenas, bwd_arenas = [], []
    for d in range(n):
        sd, ss, sw, own = parts[d]
        loc = ss - d * s_slab
        for s in range(n):
            if s == d or req[d][s].size == 0:
                continue
            loc = np.where(own == s, s_slab + s * h_pad
                           + np.searchsorted(req[d][s], ss), loc)
        fwd_arenas.append(fuse_bucketed(
            pack_ell(sd, loc, sw, t_slab, local_src),
            row_block=br, chunk=fwd.chunk))
        bwd_arenas.append(fuse_bucketed(
            pack_ell(loc, sd, sw, local_src, t_slab),
            row_block=br, chunk=plan.bwd.chunk))

    cf = max(f.n_chunks for f in fwd_arenas)
    rf = max(f.n_arena_rows for f in fwd_arenas)
    cb = max(f.n_chunks for f in bwd_arenas)
    rb = max(f.n_arena_rows for f in bwd_arenas)

    send_idx = np.zeros((n, n, h_pad), np.int32)
    halo_rows = np.full((n, n, h_pad), -1, np.int32)
    for d in range(n):
        for s in range(n):
            r = req[d][s]
            if r.size:
                halo_rows[d, s, :r.size] = r
                send_idx[s, d, :r.size] = r - s * s_slab

    splan = ShardedRelationPlan(
        fwd=tuple(pad_fused_arena(f, cf, rf) for f in fwd_arenas),
        bwd=tuple(pad_fused_arena(f, cb, rb) for f in bwd_arenas),
        send_idx=send_idx, halo_rows=halo_rows,
        n_shards=n, src_slab=s_slab, out_slab=t_slab, halo_pad=h_pad,
        n_src_total=n_src, n_out_total=n_out, row_block=br,
        fwd_chunk=fwd.chunk, bwd_chunk=plan.bwd.chunk,
        full_arena_bytes=_arena_nbytes(fwd) + _arena_nbytes(plan.bwd)
        + _nbytes(plan.bwd_src_rows) + _nbytes(plan.dense_fwd)
        + _nbytes(plan.dense_bwd),
        segments=plan.segments, src_types=plan.src_types,
        src_off=plan.src_off, src_sizes=plan.src_sizes)

    # halo pressure per shard and per relation, at pack time
    for st in splan.halo_stats()["shards"]:
        d = str(st["shard"])
        reg.set("arena.halo_rows", float(st["halo_rows"]), shard=d)
        reg.set("arena.halo_owned_byte_ratio",
                float(st["halo_owned_ratio"]), shard=d)
        reg.set("arena.shard_bytes", float(st["arena_bytes"]), shard=d)
    for et, st in _relation_halo_counts(plan, dst, src, shard_of,
                                        owner_of).items():
        reg.set("arena.halo_rows", float(st["halo_rows"]), etype=et)
        reg.set("arena.halo_owned_byte_ratio",
                float(st["halo_rows"] / max(1, st["owned_rows"])), etype=et)
    reg.set("arena.halo_pad", float(h_pad), shards=str(n))
    return splan


# ---------------------------------------------------------------------------
# numpy re-enactments of the executor's exchange (the tests' oracles)
# ---------------------------------------------------------------------------

def _exchange(splan: ShardedRelationPlan, x_pad: np.ndarray,
              d: int) -> np.ndarray:
    """Shard ``d``'s local source slab ``[own | halo]``: halo slot (s, j)
    holds owner s's row ``send_idx[s, d, j]``."""
    n, s_slab = splan.n_shards, splan.src_slab
    own = x_pad[d * s_slab:(d + 1) * s_slab]
    halo = np.concatenate([x_pad[s * s_slab:(s + 1) * s_slab]
                           [splan.send_idx[s, d]] for s in range(n)])
    return np.concatenate([own, halo])


def _host_dense(f: FusedELL) -> np.ndarray:
    if isinstance(f.nbr, torch.Tensor):
        f = dataclasses.replace(f, **{t: np.asarray(getattr(f, t).cpu())
                                      for t in _ARENA_TABLES})
    return np.asarray(f.to_dense(), np.float32)


def reference_forward(splan: ShardedRelationPlan,
                      x: np.ndarray) -> np.ndarray:
    """Dense-operand sharded forward y = A @ x, shard by shard (each local
    arena's dense matrix times its exchanged slab)."""
    n, s_slab = splan.n_shards, splan.src_slab
    x = np.asarray(x, np.float32)
    x_pad = np.concatenate(
        [x, np.zeros((n * s_slab - x.shape[0],) + x.shape[1:], np.float32)])
    ys = [_host_dense(splan.fwd[d]) @ _exchange(splan, x_pad, d)
          for d in range(n)]
    return np.concatenate(ys)[:splan.n_out_total]


def reference_backward(splan: ShardedRelationPlan,
                       gy: np.ndarray) -> np.ndarray:
    """Dense-operand sharded backward dx = Aᵀ @ gy with the reversed
    exchange: each shard's halo dx segment is added back into the owner
    shard's rows at ``send_idx``."""
    n, s_slab, t_slab, h = (splan.n_shards, splan.src_slab, splan.out_slab,
                            splan.halo_pad)
    gy = np.asarray(gy, np.float32)
    gy_pad = np.concatenate(
        [gy, np.zeros((n * t_slab - gy.shape[0],) + gy.shape[1:],
                      np.float32)])
    dx = np.zeros((n * s_slab,) + gy.shape[1:], np.float32)
    for d in range(n):
        slab = _host_dense(splan.bwd[d]) @ gy_pad[d * t_slab:(d + 1) * t_slab]
        dx[d * s_slab:(d + 1) * s_slab] += slab[:s_slab]
        for s in range(n):            # the halo segment goes back to owner s
            seg = slab[s_slab + s * h: s_slab + (s + 1) * h]
            np.add.at(dx[s * s_slab:(s + 1) * s_slab],
                      splan.send_idx[s, d], seg)
    return dx[:splan.n_src_total]
