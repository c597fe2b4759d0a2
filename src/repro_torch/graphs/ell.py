"""Degree-bucketed ELL packing, the fused chunk arena and the relation plan.

Host-side numpy preprocessing, table for table the same as
``repro/graphs/ell.py``:

* :class:`BucketedELL` -- one ELL slab per degree bucket (rows binned by
  degree, each bin padded to its own max degree);
* :class:`FusedELL` -- every bucket re-chunked into one uniform
  ``(C, BR, Ec)`` chunk arena.  Chunks of one output row-block are stored
  consecutively, so one CUDA thread block per row-block walks its chunk run
  (``blk_ptr[b]..blk_ptr[b+1]``) and accumulates without atomics.  An
  edge-id arena (:func:`pack_fused_eid_pair`) also carries the canonical
  edge id of every slot, for learnable per-edge weights;
* :class:`RelationPlan` -- every relation of a hetero layer in one fwd/bwd
  super-arena pair plus a dense-tier table for relations small enough to
  run as one masked dense product (``DENSE_TIER_NNZ`` / ``DENSE_TIER_AREA``).

Tables stay numpy until ``.to(device)`` copies them into torch tensors
(pinned host memory and a non-blocking copy when the target is a card).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.obs.metrics import DEFAULT_REGISTRY as _METRICS

# Row-block granularity of the degree buckets.
ROW_BLOCK = 8
# Default degree-bucket upper bounds (inclusive); last bucket is open-ended.
DEFAULT_BOUNDS = (4, 16, 64, 256)
# Candidate arena chunk widths ``pick_chunk`` chooses between.
CHUNK_CANDIDATES = (4, 8, 16)
# Row-block height of the fused arena: one CUDA thread block per row-block,
# one warp per row.
FUSED_ROW_BLOCK = 8
# Dense-tier crossover: relations at or below this nnz run as one masked
# dense product instead of the chunk-walk arena.  Same constant as the
# reference so that plans match table for table.
DENSE_TIER_NNZ = 4096
# Never densify a relation whose n_dst * n_src exceeds this.
DENSE_TIER_AREA = 1 << 22


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    """numpy table -> tensor on ``device``.  Host tables are pinned and
    copied without blocking, so a copy issued on a side stream overlaps
    the kernels running on the compute stream."""
    t = a if isinstance(a, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class ELLBucket:
    """One degree bin: ``rows[r]`` is the destination row ``nbr[r]``
    describes.  Padded slots have weight 0 and index 0."""

    rows: np.ndarray   # (R,) int32 destination row ids
    nbr: np.ndarray    # (R, E) int32 source ids
    w: np.ndarray      # (R, E) float32 edge weights

    @property
    def n_rows(self) -> int:
        return self.rows.shape[0]

    @property
    def width(self) -> int:
        return self.nbr.shape[1]


@dataclasses.dataclass(frozen=True)
class BucketedELL:
    """A sparse (n_dst x n_src) matrix as a tuple of degree-bucketed ELL
    slabs; ``nnz`` is counted at pack time."""

    buckets: Tuple[ELLBucket, ...]
    n_dst: int
    n_src: int
    nnz: int = -1

    def to_dense(self) -> np.ndarray:
        a = np.zeros((self.n_dst, self.n_src), np.float32)
        for b in self.buckets:
            r = np.repeat(b.rows[:, None], b.width, axis=1)
            np.add.at(a, (r, b.nbr), b.w)
        return a


def pack_ell(dst: np.ndarray, src: np.ndarray, w: Optional[np.ndarray],
             n_dst: int, n_src: int,
             bounds: Sequence[int] = DEFAULT_BOUNDS,
             row_block: int = ROW_BLOCK) -> BucketedELL:
    """Pack COO edges (dst aggregates from src) into degree-bucketed ELL.
    ``w=None`` means unit weights; empty rows are dropped."""
    dst = np.asarray(dst, np.int64)
    src = np.asarray(src, np.int64)
    if w is None:
        w = np.ones(dst.shape[0], np.float32)
    w = np.asarray(w, np.float32)

    order = np.argsort(dst, kind="stable")
    dst, src, w = dst[order], src[order], w[order]
    deg = np.bincount(dst, minlength=n_dst)
    rowptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(deg, out=rowptr[1:])

    nonempty = np.nonzero(deg > 0)[0]
    buckets = []
    nnz = 0
    lo = 1
    bnds = list(bounds) + [int(deg.max()) if deg.size and deg.max() > 0 else 1]
    for hi in bnds:
        if hi < lo:
            continue
        rows = nonempty[(deg[nonempty] >= lo) & (deg[nonempty] <= hi)]
        lo = hi + 1
        if rows.size == 0:
            continue
        width = int(deg[rows].max())
        n_r = _round_up(rows.size, row_block)
        nbr = np.zeros((n_r, width), np.int32)
        wts = np.zeros((n_r, width), np.float32)
        rid = np.zeros(n_r, np.int32)
        rid[: rows.size] = rows
        # vectorised fill: slot j of row i holds that row's j-th edge
        d = deg[rows]
        i_of = np.repeat(np.arange(rows.size), d)
        j_of = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
        e_of = np.repeat(rowptr[rows], d) + j_of
        nbr[i_of, j_of] = src[e_of]
        wts[i_of, j_of] = w[e_of]
        nnz += int((wts != 0).sum())
        buckets.append(ELLBucket(rows=rid, nbr=nbr, w=wts))
    if not buckets:  # empty matrix -- keep one inert bucket for shape sanity
        buckets = [ELLBucket(rows=np.zeros((row_block,), np.int32),
                             nbr=np.zeros((row_block, 1), np.int32),
                             w=np.zeros((row_block, 1), np.float32))]
    return BucketedELL(buckets=tuple(buckets), n_dst=n_dst, n_src=n_src,
                       nnz=nnz)


def pack_ell_pair(dst, src, w, n_dst: int, n_src: int,
                  bounds: Sequence[int] = DEFAULT_BOUNDS
                  ) -> Tuple[BucketedELL, BucketedELL]:
    """Forward (A) and transposed (Aᵀ) packings -- the CSR/CSC pair."""
    return (pack_ell(dst, src, w, n_dst, n_src, bounds),
            pack_ell(src, dst, w, n_src, n_dst, bounds))


def pack_eid_slabs(dst, src, n_dst: int, n_src: int,
                   bounds: Sequence[int] = DEFAULT_BOUNDS):
    """Edge-id slabs aligned with :func:`pack_ell`'s bucketing: the slabs'
    ``w`` holds ``f32(id + 1)`` of each edge's index in the canonical
    (dst-stable-sorted) order, 0 on padding (exact up to 2^24 edges).
    Returns ``(fwd_slabs, bwd_slabs, order, nnz)``; ``order`` maps the
    canonical order back to the caller's COO order."""
    dst = np.asarray(dst, np.int64)
    src = np.asarray(src, np.int64)
    nnz = dst.shape[0]
    if nnz >= 1 << 24:
        raise ValueError(f"{nnz} edge ids exceed the f32 exact-integer range")
    order = np.argsort(dst, kind="stable")           # pack_ell's canonical
    eid = np.empty(nnz, np.int64)
    eid[order] = np.arange(nnz)                      # caller order -> canon
    ids = eid.astype(np.float32) + 1.0
    return (pack_ell(dst, src, ids, n_dst, n_src, bounds),
            pack_ell(src, dst, ids, n_src, n_dst, bounds), order, nnz)


def decode_eids(slab_w) -> np.ndarray:
    """f32-encoded ``id + 1`` slab -> int32 ids with -1 on padding."""
    return np.asarray(slab_w).astype(np.int32) - 1


def degree_stats(dst: np.ndarray, n_dst: int) -> dict:
    """Per-row degrees of a COO destination list, with their max and
    mean."""
    deg = np.bincount(np.asarray(dst, np.int64), minlength=n_dst)
    return dict(degrees=deg, max=int(deg.max()) if deg.size else 0,
                mean=float(deg.mean()) if deg.size else 0.0)


def ell_to_coo(adj: BucketedELL) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dst, src, w) of the non-zero slots -- the inverse of
    :func:`pack_ell` (zero-weight slots are padding by construction)."""
    ds, ss, ws = [], [], []
    for b in adj.buckets:
        w = np.asarray(b.w, np.float32)
        mask = w != 0
        if not mask.any():
            continue
        rows = np.broadcast_to(np.asarray(b.rows, np.int64)[:, None], w.shape)
        ds.append(rows[mask])
        ss.append(np.asarray(b.nbr, np.int64)[mask])
        ws.append(w[mask])
    if not ds:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    return np.concatenate(ds), np.concatenate(ss), np.concatenate(ws)


# ---------------------------------------------------------------------------
# FusedELL -- the single-launch chunk arena
# ---------------------------------------------------------------------------

def block_ptr(block_of: np.ndarray, n_blocks: int) -> np.ndarray:
    """(n_blocks + 1,) int32 chunk range per output row-block: block b owns
    chunks ``[blk_ptr[b], blk_ptr[b+1])``.  ``block_of`` is nondecreasing
    in every arena this module builds (a block's chunks are consecutive),
    so the range is a binary search; a block with no chunk gets an empty
    range and is written as zeros."""
    blk = np.asarray(block_of, np.int64)
    if blk.size and np.any(np.diff(blk) < 0):
        raise ValueError("arena chunks are not grouped by output row-block")
    return np.searchsorted(blk, np.arange(n_blocks + 1),
                           side="left").astype(np.int32)


@dataclasses.dataclass(frozen=True)
class FusedELL:
    """All degree buckets re-chunked into one uniform (C, BR, Ec) arena.

    ``block_of``/``start`` say which output row-block each chunk
    accumulates into and whether it opens that block; ``blk_ptr`` is the
    same information as a per-block chunk range.  The CUDA kernels walk
    ``blk_ptr[b]..walk_end[b]``: ``blk_end`` stops a padded arena's
    sentinel runs before their zero-weight padding chunks
    (:func:`pad_fused_arena`).  ``rows`` maps arena rows to original row ids and
    ``gather`` is its inverse (original rows absent from every bucket read
    the trailing all-zero sentinel block).  ``rel`` is the relation id per
    chunk in a super-arena.  Tables are numpy on the host and tensors after
    :meth:`to`."""

    nbr: np.ndarray       # (C, BR, Ec) int32 source ids
    w: np.ndarray         # (C, BR, Ec) f32 edge weights (0 = padding)
    block_of: np.ndarray  # (C,) int32 output row-block per chunk
    start: np.ndarray     # (C,) int32 1 iff chunk opens its row-block
    rows: np.ndarray      # (R_arena,) int32 original row per arena row
    gather: np.ndarray    # (n_dst,) int32 arena row per original row
    n_dst: int
    n_src: int
    nnz: int
    row_block: int
    chunk: int
    rel: Optional[np.ndarray] = None
    blk_ptr: Optional[np.ndarray] = None  # (n_blocks + 1,) int32
    # (C, BR, Ec) int32 canonical edge id per slot, -1 on padding (edge-id
    # arenas only; ``w`` is then the 0/1 real-slot mask)
    eid: Optional[np.ndarray] = None
    # (n_blocks,) int32 end of each block's walked chunk run (padded arenas
    # only; None: ``blk_ptr[1:]``)
    blk_end: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.blk_ptr is None:
            object.__setattr__(self, "blk_ptr", block_ptr(
                self.block_of, self.n_arena_rows // self.row_block))

    @property
    def n_chunks(self) -> int:
        return self.nbr.shape[0]

    @property
    def n_arena_rows(self) -> int:
        return self.rows.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.n_arena_rows // self.row_block

    @property
    def walk_end(self):
        """(n_blocks,) end of each block's walked chunk run."""
        return self.blk_ptr[1:] if self.blk_end is None else self.blk_end

    def to(self, device) -> "FusedELL":
        device = torch.device(device)
        conv = {f: _to_tensor(getattr(self, f), device)
                for f in ("nbr", "w", "block_of", "start", "rows", "gather",
                          "rel", "blk_ptr", "eid", "blk_end")
                if getattr(self, f) is not None}
        return dataclasses.replace(self, **conv)

    def to_dense(self) -> np.ndarray:
        """Host-side dense reconstruction (round-trip tests)."""
        a = np.zeros((self.n_dst, self.n_src), np.float32)
        d, s, w = fused_to_coo(self)
        np.add.at(a, (d, s), w)
        return a


def _effective_widths(w: np.ndarray) -> np.ndarray:
    """Per-row count of slots up to the last non-zero one."""
    nz = w != 0
    e = w.shape[1]
    return np.where(nz.any(axis=1), e - np.argmax(nz[:, ::-1], axis=1), 0)


def _block_widths(adj: BucketedELL, row_block: int) -> list:
    """Max effective width of each fused row-block after the descending
    degree sort each bucket undergoes inside :func:`fuse_bucketed`."""
    bws = []
    for b in adj.buckets:
        width_r = np.sort(_effective_widths(np.asarray(b.w, np.float32)))[::-1]
        rpad = _round_up(max(width_r.size, 1), row_block)
        width_r = np.concatenate(
            [width_r, np.zeros(rpad - width_r.size, np.int64)])
        bws.extend(width_r.reshape(-1, row_block).max(axis=1).tolist())
    return bws


def _min_slots(bws: Sequence[int], row_block: int,
               candidates: Sequence[int]) -> int:
    """Candidate chunk width minimising Σ_blocks BR·Ec·ceil(bw/Ec); ties go
    to the wider chunk."""
    bw = np.asarray(bws, np.int64)

    def slots(c):
        return row_block * c * int(np.maximum(1, -(-bw // c)).sum())
    return min(candidates, key=lambda c: (slots(c), -c))


def pick_chunk(adj: BucketedELL, row_block: int = None,
               candidates: Sequence[int] = CHUNK_CANDIDATES) -> int:
    """Slot-minimising arena chunk width for one packing."""
    if row_block is None:
        row_block = FUSED_ROW_BLOCK
    return _min_slots(_block_widths(adj, row_block), row_block, candidates)


def pick_chunk_multi(packings: Sequence[BucketedELL], row_block: int = None,
                     candidates: Sequence[int] = CHUNK_CANDIDATES) -> int:
    """Slot-minimising chunk width shared by every relation of a
    super-arena (the summed slot count over all packings)."""
    if row_block is None:
        row_block = FUSED_ROW_BLOCK
    bws = [bw for p in packings for bw in _block_widths(p, row_block)]
    return _min_slots(bws, row_block, candidates)


# id-keyed memo of fused arenas, guarded by a weakref to the packing (an
# entry goes when its packing dies, and a reused id never hits)
_FUSE_CACHE: Dict[tuple, tuple] = {}


def fuse_bucketed(adj: BucketedELL, row_block: int = None,
                  chunk: int = None, *, eids: bool = False) -> FusedELL:
    """Re-pack a :class:`BucketedELL` into the fused arena.  ``chunk=None``
    picks the slot-minimising width (:func:`pick_chunk`).

    ``eids=True`` reads ``adj`` as an edge-id slab packing
    (:func:`pack_eid_slabs`): the arena then carries the int32 ``eid``
    table (-1 on padding), chunked exactly like the weights, and ``w``
    becomes the 0/1 real-slot mask.  Results are memoised per (packing,
    layout)."""
    if row_block is None:
        row_block = FUSED_ROW_BLOCK
    key = (id(adj), row_block, chunk, eids)
    hit = _FUSE_CACHE.get(key)
    if hit is not None and hit[0]() is adj:
        return hit[1]
    if chunk is None:
        chunk = pick_chunk(adj, row_block)

    nbr_chunks, w_chunks, block_of, start = [], [], [], []
    rows_parts = []
    gather = np.full(adj.n_dst, -1, np.int64)
    blk = 0
    arena_off = 0
    for b in adj.buckets:
        nb = np.asarray(b.nbr)
        wt = np.asarray(b.w, np.float32)
        rid = np.asarray(b.rows, np.int64)
        r, e = nb.shape
        rpad = _round_up(max(r, 1), row_block)
        epad = _round_up(max(e, 1), chunk)
        nb_p = np.zeros((rpad, epad), np.int32)
        wt_p = np.zeros((rpad, epad), np.float32)
        nb_p[:r, :e] = nb
        wt_p[:r, :e] = wt
        rid_p = np.zeros(rpad, np.int32)
        rid_p[:r] = rid
        nz = wt_p != 0
        width_r = np.where(nz.any(axis=1),
                           epad - np.argmax(nz[:, ::-1], axis=1), 0)
        # order rows by effective width so each row-block's chunk count
        # tracks its own max degree, not the bucket's
        order = np.argsort(-width_r, kind="stable")
        nb_p, wt_p, rid_p, width_r = (nb_p[order], wt_p[order],
                                      rid_p[order], width_r[order])
        real = width_r > 0
        gather[rid_p[real]] = arena_off + np.nonzero(real)[0]
        rows_parts.append(rid_p)
        arena_off += rpad
        # each row-block keeps the chunks up to its own max width (>= 1,
        # so the block inits), block-major and chunk-minor
        n_blk, n_ck = rpad // row_block, epad // chunk
        bw = width_r.reshape(n_blk, row_block).max(axis=1)
        nch = np.maximum(1, -(-bw // chunk))
        keep = np.arange(n_ck)[None, :] < nch[:, None]
        tiles = lambda a: a.reshape(n_blk, row_block, n_ck, chunk) \
            .transpose(0, 2, 1, 3)[keep]
        nbr_chunks.append(tiles(nb_p))
        w_chunks.append(tiles(wt_p))
        block_of.append(np.repeat(np.arange(blk, blk + n_blk), nch))
        first = np.zeros(int(nch.sum()), np.int32)
        first[np.cumsum(nch) - nch] = 1
        start.append(first)
        blk += n_blk

    # trailing sentinel block: BR all-zero arena rows for empty original rows
    nbr_chunks.append(np.zeros((1, row_block, chunk), np.int32))
    w_chunks.append(np.zeros((1, row_block, chunk), np.float32))
    block_of.append(np.array([blk]))
    start.append(np.ones(1, np.int32))
    sentinel_row = arena_off
    rows_parts.append(np.zeros(row_block, np.int32))
    gather[gather < 0] = sentinel_row

    nnz = adj.nnz if adj.nnz >= 0 else int(
        sum(int((np.asarray(b.w) != 0).sum()) for b in adj.buckets))
    w_arena = np.concatenate(w_chunks)
    eid_arena = None
    if eids:
        eid_arena = w_arena.astype(np.int32) - 1
        w_arena = (w_arena != 0).astype(np.float32)
    fused = FusedELL(
        nbr=np.concatenate(nbr_chunks), w=w_arena,
        block_of=np.concatenate(block_of).astype(np.int32),
        start=np.concatenate(start).astype(np.int32),
        rows=np.concatenate(rows_parts).astype(np.int32),
        gather=gather.astype(np.int32),
        n_dst=adj.n_dst, n_src=adj.n_src, nnz=nnz,
        row_block=row_block, chunk=chunk, eid=eid_arena)
    _FUSE_CACHE[key] = (weakref.ref(adj, lambda _: _FUSE_CACHE.pop(key, None)),
                        fused)
    return fused


def arena_stats(f: FusedELL, bucketed: Optional[BucketedELL] = None) -> dict:
    """Pack-time efficiency of an arena: its ``C·BR·Ec`` slots, how many
    carry edges, the padding and the chunk width; with the source
    ``bucketed`` packing also the bucket slabs' slot count and
    ``slot_saving`` (slab slots per arena slot).  A padded arena (nnz -1)
    counts its non-zero weights."""
    c, br, ec = (int(s) for s in np.shape(f.nbr))
    slots = c * br * ec
    real = f.nnz if f.nnz >= 0 else int(np.count_nonzero(np.asarray(f.w)))
    out = dict(n_chunks=c, row_block=br, chunk=ec, slots=slots,
               real_slots=real, padded_slots=slots - real,
               fill_ratio=real / slots if slots else 0.0)
    if bucketed is not None:
        slab = sum(int(np.shape(b.nbr)[0]) * int(np.shape(b.nbr)[1])
                   for b in bucketed.buckets)
        out["slab_slots"] = slab
        out["slot_saving"] = slab / slots if slots else 0.0
    return out


def pack_fused(dst, src, w, n_dst: int, n_src: int,
               bounds: Sequence[int] = DEFAULT_BOUNDS,
               row_block: int = None, chunk: int = None) -> FusedELL:
    """COO -> fused arena (:func:`pack_ell`, then :func:`fuse_bucketed`)."""
    return fuse_bucketed(pack_ell(dst, src, w, n_dst, n_src, bounds),
                         row_block=row_block, chunk=chunk)


def pack_fused_pair(dst, src, w, n_dst: int, n_src: int,
                    bounds: Sequence[int] = DEFAULT_BOUNDS
                    ) -> Tuple[FusedELL, FusedELL]:
    """Fused forward (A) and transposed (Aᵀ) arenas."""
    return (pack_fused(dst, src, w, n_dst, n_src, bounds),
            pack_fused(src, dst, w, n_src, n_dst, bounds))


def pad_fused_arena(f: FusedELL, n_chunks: int, n_rows: int) -> FusedELL:
    """``f`` padded to ``n_chunks`` chunks and ``n_rows`` arena rows, table
    for table the reference's padding: the padding chunks carry zero
    weights (edge id -1) and extend the run of the arena's last block, the
    all-zero sentinel, with ``start`` 0; padding rows are appended, and no
    chunk or gather reads them.  ``nnz`` becomes -1, so that batches of one
    shape bucket, which differ in nnz, share one signature.

    The walked runs (``blk_end``) stop where the unpadded arena's did: the
    padding adds nothing, so the kernels skip it, and the padding rows'
    blocks walk no chunk (they are written as zeros)."""
    c, br, ec = f.nbr.shape
    r = f.n_arena_rows
    if n_rows % br or n_rows < r or n_chunks < c:
        raise ValueError(f"cannot pad a ({c} chunks, {r} rows) arena to "
                         f"({n_chunks}, {n_rows})")
    pad_chunks = n_chunks - c
    sentinel = r // br - 1
    zpad = lambda a, n, dt: np.concatenate(
        [np.asarray(a), np.zeros((n,) + np.asarray(a).shape[1:], dt)])
    eid = None if f.eid is None else np.concatenate(
        [np.asarray(f.eid), np.full((pad_chunks, br, ec), -1, np.int32)])
    rel = None if f.rel is None else np.concatenate(
        [np.asarray(f.rel),
         np.full(pad_chunks, int(np.asarray(f.rel)[-1]), np.int32)])
    blk_end = np.concatenate(
        [np.asarray(f.walk_end),
         np.full(n_rows // br - f.n_blocks, n_chunks)]).astype(np.int32)
    return FusedELL(
        nbr=zpad(f.nbr, pad_chunks, np.int32),
        w=zpad(f.w, pad_chunks, np.float32),
        block_of=np.concatenate([np.asarray(f.block_of),
                                 np.full(pad_chunks, sentinel, np.int32)]),
        start=np.concatenate([np.asarray(f.start),
                              np.zeros(pad_chunks, np.int32)]),
        rows=zpad(f.rows, n_rows - r, np.int32),
        gather=np.asarray(f.gather),
        n_dst=f.n_dst, n_src=f.n_src, nnz=-1,
        row_block=f.row_block, chunk=f.chunk, rel=rel, eid=eid,
        blk_end=blk_end)


def pack_fused_eid_pair(dst, src, n_dst: int, n_src: int,
                        bounds: Sequence[int] = DEFAULT_BOUNDS,
                        row_block: int = None,
                        chunk: Union[int, None, Tuple] = None
                        ) -> Tuple[FusedELL, FusedELL, np.ndarray, int]:
    """Fused edge-id arena pair (forward and transposed) for learnable
    per-edge weights: a canonical weight vector w (nnz,) gathers straight
    into either arena as ``w[eid]``.  ``chunk`` pins the chunk width (an
    int, or a ``(fwd, bwd)`` tuple).  Returns ``(fwd, bwd, order, nnz)``.

    Every canonical id occupies exactly one slot of each arena, so the
    per-slot dW of the forward arena reaches canonical order by a
    permutation; this is checked here."""
    fwd, bwd, order, nnz = pack_eid_slabs(dst, src, n_dst, n_src, bounds)
    ck_f, ck_b = chunk if isinstance(chunk, tuple) else (chunk, chunk)
    pair = (fuse_bucketed(fwd, row_block, ck_f, eids=True),
            fuse_bucketed(bwd, row_block, ck_b, eids=True))
    for f in pair:
        real = f.eid[f.eid >= 0]
        if real.size != nnz or np.any(np.bincount(real, minlength=nnz) != 1):
            raise AssertionError("edge ids are not one slot each")
    return pair + (order, nnz)


def fused_to_coo(f: FusedELL) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dst, src, w) of the non-zero arena slots, in the arena's own
    coordinates (relation-concat rows / type-concat sources for a
    super-arena)."""
    w = np.asarray(f.w, np.float32)                       # (C, BR, Ec)
    blk = np.asarray(f.block_of, np.int64)
    rows = np.asarray(f.rows, np.int64)
    br = f.row_block
    slot_row = rows[blk[:, None] * br + np.arange(br)]    # (C, BR)
    mask = w != 0
    dst = np.broadcast_to(slot_row[:, :, None], w.shape)[mask]
    src = np.asarray(f.nbr, np.int64)[mask]
    return dst, src, w[mask]


# ---------------------------------------------------------------------------
# RelationPlan -- cross-relation super-arena plus the dense tier
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RelationSegment:
    """Where one relation lives inside a :class:`RelationPlan`.

    ``out_off`` is the relation's row offset in the full output concat.
    Arena-tier segments carry ``arena_out_off`` (offset in the arena-only
    output concat) and ``src_out_off`` (offset in the arena dx concat);
    dense-tier segments carry ``dense_off`` (row offset in ``dense_fwd``).
    """

    etype: str
    src_type: str
    dst_type: str
    n_dst: int
    n_src: int
    out_off: int
    src_out_off: int
    fwd_chunks: Tuple[int, int]
    bwd_chunks: Tuple[int, int]
    fwd_rows: Tuple[int, int]
    bwd_rows: Tuple[int, int]
    tier: str = "arena"          # "arena" (chunk walk) | "dense" (product)
    dense_off: int = -1
    arena_out_off: int = -1


@dataclasses.dataclass(frozen=True)
class RelationPlan:
    """One hetero layer's whole message passing: a fwd/bwd super-arena pair
    over the type-concat source slab, the dense-tier tables, and the
    segment table.  ``bwd``, ``bwd_src_rows`` and ``dense_bwd`` serve the
    backward, which the training slice of the port adds."""

    fwd: FusedELL
    bwd: FusedELL
    bwd_src_rows: np.ndarray
    dense_fwd: np.ndarray    # (Σ dense n_dst, n_src_total) f32
    dense_bwd: np.ndarray    # dense_fwd.T, contiguous
    segments: Tuple[RelationSegment, ...]
    src_types: Tuple[str, ...]
    src_off: Tuple[int, ...]
    src_sizes: Tuple[int, ...]

    @property
    def n_src_total(self) -> int:
        return self.fwd.n_src

    @property
    def n_out_total(self) -> int:
        return self.segments[-1].out_off + self.segments[-1].n_dst \
            if self.segments else self.fwd.n_dst

    @property
    def arena_segments(self) -> Tuple[RelationSegment, ...]:
        return tuple(s for s in self.segments if s.tier == "arena")

    @property
    def dense_segments(self) -> Tuple[RelationSegment, ...]:
        return tuple(s for s in self.segments if s.tier == "dense")

    @property
    def has_arena(self) -> bool:
        return any(s.tier == "arena" for s in self.segments)

    @property
    def has_dense(self) -> bool:
        return any(s.tier == "dense" for s in self.segments)

    def segment(self, etype: str) -> RelationSegment:
        for s in self.segments:
            if s.etype == etype:
                return s
        raise KeyError(etype)

    def to(self, device) -> "RelationPlan":
        device = torch.device(device)
        return dataclasses.replace(
            self, fwd=self.fwd.to(device), bwd=self.bwd.to(device),
            bwd_src_rows=_to_tensor(self.bwd_src_rows, device),
            dense_fwd=_to_tensor(self.dense_fwd, device),
            dense_bwd=_to_tensor(self.dense_bwd, device))

    def to_dense(self) -> np.ndarray:
        """Full (n_out_total, n_src_total) block matrix across both tiers
        (host tables only)."""
        a = np.zeros((self.n_out_total, self.n_src_total), np.float32)
        if self.has_arena:
            fa = self.fwd.to_dense()
            for s in self.arena_segments:
                a[s.out_off:s.out_off + s.n_dst] = \
                    fa[s.arena_out_off:s.arena_out_off + s.n_dst]
        df = np.asarray(self.dense_fwd, np.float32)
        for s in self.dense_segments:
            a[s.out_off:s.out_off + s.n_dst] = \
                df[s.dense_off:s.dense_off + s.n_dst]
        return a


def _empty_super_arena(n_dst: int, n_src: int, row_block: int,
                       chunk: int) -> FusedELL:
    """Inert placeholder arena for a tier nothing landed in: one all-zero
    sentinel chunk/block.  ``plan.has_arena`` keeps it from launching."""
    return FusedELL(
        nbr=np.zeros((1, row_block, chunk), np.int32),
        w=np.zeros((1, row_block, chunk), np.float32),
        block_of=np.zeros(1, np.int32),
        start=np.ones(1, np.int32),
        rows=np.zeros(row_block, np.int32),
        gather=np.zeros(n_dst, np.int32),
        n_dst=n_dst, n_src=n_src, nnz=0,
        row_block=row_block, chunk=chunk,
        rel=np.zeros(1, np.int32))


def plan_to_coo(plan: RelationPlan
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dst, src, w) of every edge a host plan represents, across both
    tiers, in full-output-concat / type-concat-source coordinates."""
    ds, ss, ws = [], [], []
    if plan.has_arena:
        d, s, w = fused_to_coo(plan.fwd)
        shift = np.zeros(plan.fwd.n_dst, np.int64)
        for seg in plan.arena_segments:
            shift[seg.arena_out_off:seg.arena_out_off + seg.n_dst] = \
                seg.out_off - seg.arena_out_off
        ds.append(d + shift[d])
        ss.append(s)
        ws.append(w)
    if plan.has_dense:
        df = np.asarray(plan.dense_fwd, np.float32)
        for seg in plan.dense_segments:
            blk = df[seg.dense_off:seg.dense_off + seg.n_dst]
            r, c = np.nonzero(blk)
            ds.append(r.astype(np.int64) + seg.out_off)
            ss.append(c.astype(np.int64))
            ws.append(blk[r, c])
    if not ds:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    return np.concatenate(ds), np.concatenate(ss), np.concatenate(ws)


def _concat_arenas(arenas: Sequence[FusedELL], nbr_offs: Sequence[int],
                   rows_offs: Sequence[int], n_dst: int, n_src: int
                   ) -> Tuple[FusedELL, list]:
    """Concatenate per-relation arenas into one super-arena, shifting
    neighbour ids by ``nbr_offs`` and row ids by ``rows_offs``.  Returns
    the super-arena and the per-relation (chunk_off, row_off) pairs."""
    br = arenas[0].row_block
    ck = arenas[0].chunk
    if not all(a.row_block == br and a.chunk == ck for a in arenas):
        raise ValueError("super-arena members must share (row_block, chunk)")
    offs, c_off, r_off = [], 0, 0
    nbr, w, blk, start, rows, gather, rel = [], [], [], [], [], [], []
    ends = []
    for i, (a, no, ro) in enumerate(zip(arenas, nbr_offs, rows_offs)):
        offs.append((c_off, r_off))
        nbr.append(np.asarray(a.nbr) + np.int32(no))
        w.append(np.asarray(a.w))
        blk.append(np.asarray(a.block_of) + np.int32(r_off // br))
        start.append(np.asarray(a.start))
        rows.append(np.asarray(a.rows) + np.int32(ro))
        gather.append(np.asarray(a.gather) + np.int32(r_off))
        rel.append(np.full(a.n_chunks, i, np.int32))
        ends.append(np.asarray(a.walk_end) + np.int32(c_off))
        c_off += a.n_chunks
        r_off += a.n_arena_rows
    nnzs = [a.nnz for a in arenas]
    fused = FusedELL(
        nbr=np.concatenate(nbr), w=np.concatenate(w),
        block_of=np.concatenate(blk), start=np.concatenate(start),
        rows=np.concatenate(rows), gather=np.concatenate(gather),
        n_dst=n_dst, n_src=n_src,
        nnz=-1 if any(n < 0 for n in nnzs) else int(sum(nnzs)),
        row_block=br, chunk=ck, rel=np.concatenate(rel),
        blk_end=np.concatenate(ends).astype(np.int32)
        if any(a.blk_end is not None for a in arenas) else None)
    return fused, offs


def build_relation_plan(relations: Sequence[tuple], n_of: Dict[str, int], *,
                        bounds: Sequence[int] = DEFAULT_BOUNDS,
                        row_block: int = None,
                        chunk: Union[int, None, Tuple] = None,
                        pad=None,
                        packed: Dict[str, Tuple[BucketedELL,
                                                BucketedELL]] = None,
                        dense_threshold: int = None,
                        tiers: Dict[str, str] = None) -> RelationPlan:
    """Pack every relation of a hetero layer into one fwd/bwd super-arena
    plus a dense-tier table for relations at or below the crossover.

    ``relations`` is a sequence of ``(etype, src_type, dst_type, dst, src,
    w)`` COO lists (its order fixes the output concat); ``n_of`` is the
    ordered ``{node_type: count}`` fixing the source concat.  ``chunk``
    pins the shared chunk width (int, or a ``(fwd, bwd)`` tuple; ``None``
    picks it per direction), ``pad`` pads each relation's arenas before
    they are concatenated (:func:`pad_fused_arena`): a ``{etype: {"fwd" |
    "bwd": (n_chunks, n_rows)}}`` dict or a callable ``(etype, "fwd" |
    "bwd", arena) -> (n_chunks, n_rows)``, ``packed`` reuses already-built
    ``(fwd, bwd)`` packings per edge type, ``dense_threshold`` overrides
    :data:`DENSE_TIER_NNZ` (the :data:`DENSE_TIER_AREA` guard always
    applies) and ``tiers`` pins an edge type's tier outright."""
    if row_block is None:
        row_block = FUSED_ROW_BLOCK
    src_types = tuple(n_of)
    src_off, off = {}, 0
    for t in src_types:
        src_off[t] = off
        off += int(n_of[t])
    n_src_total = off
    thr = DENSE_TIER_NNZ if dense_threshold is None else int(dense_threshold)

    if packed is not None:
        fwd_b = [packed[r[0]][0] for r in relations]
        bwd_b = [packed[r[0]][1] for r in relations]
    else:
        fwd_b = [pack_ell(dst, src, w, int(n_of[dt]), int(n_of[st]), bounds)
                 for _et, st, dt, dst, src, w in relations]
        bwd_b = [pack_ell(src, dst, w, int(n_of[st]), int(n_of[dt]), bounds)
                 for _et, st, dt, dst, src, w in relations]

    tier_of = []
    for i, r in enumerate(relations):
        et, st, dt = r[0], r[1], r[2]
        nnz_i = fwd_b[i].nnz
        if nnz_i < 0:
            nnz_i = int(np.asarray(r[3]).shape[0])
        area = int(n_of[dt]) * int(n_of[st])
        t = "dense" if (nnz_i <= thr and area <= DENSE_TIER_AREA) else "arena"
        if tiers is not None and et in tiers:
            t = tiers[et]
        tier_of.append(t)
        # the tier each relation landed in, the nnz that decided it and the
        # crossover in force, as pack-time gauges
        for d in ("fwd", "bwd"):
            _METRICS.set("arena.tier", 1.0 if t == "dense" else 0.0,
                         etype=et, dir=d)
            _METRICS.set("arena.tier_nnz", float(nnz_i), etype=et, dir=d)
            _METRICS.set("arena.tier_threshold", float(thr), etype=et,
                         dir=d)
    arena_idx = [i for i, t in enumerate(tier_of) if t == "arena"]
    dense_idx = [i for i, t in enumerate(tier_of) if t == "dense"]

    ck_f, ck_b = chunk if isinstance(chunk, tuple) else (chunk, chunk)
    if ck_f is None:
        ck_f = pick_chunk_multi([fwd_b[i] for i in arena_idx], row_block)
    if ck_b is None:
        ck_b = pick_chunk_multi([bwd_b[i] for i in arena_idx], row_block)
    fwd_a = [fuse_bucketed(fwd_b[i], row_block, ck_f) for i in arena_idx]
    bwd_a = [fuse_bucketed(bwd_b[i], row_block, ck_b) for i in arena_idx]

    dense_offs, doff = {}, 0
    for i in dense_idx:
        dense_offs[i] = doff
        doff += int(n_of[relations[i][2]])
    dense_fwd = np.zeros((doff, n_src_total), np.float32)
    for i in dense_idx:
        d, s, wv = ell_to_coo(fwd_b[i])
        np.add.at(dense_fwd,
                  (d + dense_offs[i], s + src_off[relations[i][1]]), wv)
    dense_bwd = np.ascontiguousarray(dense_fwd.T)

    if pad is not None:
        target = pad if callable(pad) else (lambda et, d, _a: pad[et][d])
        fwd_a = [pad_fused_arena(a, *target(relations[i][0], "fwd", a))
                 for a, i in zip(fwd_a, arena_idx)]
        bwd_a = [pad_fused_arena(a, *target(relations[i][0], "bwd", a))
                 for a, i in zip(bwd_a, arena_idx)]

    out_offs = np.cumsum([0] + [int(n_of[r[2]]) for r in relations])
    arena_out_offs = np.cumsum([0] + [a.n_dst for a in fwd_a])
    src_out_offs = np.cumsum([0] + [a.n_dst for a in bwd_a])
    if arena_idx:
        fwd, f_offs = _concat_arenas(
            fwd_a,
            nbr_offs=[src_off[relations[i][1]] for i in arena_idx],
            rows_offs=[int(o) for o in arena_out_offs[:-1]],
            n_dst=int(arena_out_offs[-1]), n_src=n_src_total)
        bwd, b_offs = _concat_arenas(
            bwd_a,
            nbr_offs=[int(out_offs[i]) for i in arena_idx],
            rows_offs=[int(o) for o in src_out_offs[:-1]],
            n_dst=int(src_out_offs[-1]), n_src=int(out_offs[-1]))
        bwd_src_rows = np.concatenate(
            [np.asarray(a.rows) + np.int32(src_off[relations[i][1]])
             for a, i in zip(bwd_a, arena_idx)])
    else:
        fwd = _empty_super_arena(0, n_src_total, row_block, int(ck_f or 16))
        bwd = _empty_super_arena(0, int(out_offs[-1]), row_block,
                                 int(ck_b or 16))
        bwd_src_rows = np.zeros(row_block, np.int32)
        f_offs = b_offs = []

    segments = []
    a_pos = 0
    for i, (et, st, dt, _d, _s, _w) in enumerate(relations):
        if tier_of[i] == "arena":
            fa, ba = fwd_a[a_pos], bwd_a[a_pos]
            (fc, fr), (bc, brr) = f_offs[a_pos], b_offs[a_pos]
            segments.append(RelationSegment(
                etype=et, src_type=st, dst_type=dt,
                n_dst=fa.n_dst, n_src=fa.n_src,
                out_off=int(out_offs[i]),
                src_out_off=int(src_out_offs[a_pos]),
                fwd_chunks=(fc, fc + fa.n_chunks),
                bwd_chunks=(bc, bc + ba.n_chunks),
                fwd_rows=(fr, fr + fa.n_arena_rows),
                bwd_rows=(brr, brr + ba.n_arena_rows),
                tier="arena", dense_off=-1,
                arena_out_off=int(arena_out_offs[a_pos])))
            a_pos += 1
        else:
            segments.append(RelationSegment(
                etype=et, src_type=st, dst_type=dt,
                n_dst=int(n_of[dt]), n_src=int(n_of[st]),
                out_off=int(out_offs[i]), src_out_off=-1,
                fwd_chunks=(0, 0), bwd_chunks=(0, 0),
                fwd_rows=(0, 0), bwd_rows=(0, 0),
                tier="dense", dense_off=int(dense_offs[i]),
                arena_out_off=-1))
    return RelationPlan(fwd=fwd, bwd=bwd, bwd_src_rows=bwd_src_rows,
                        dense_fwd=dense_fwd, dense_bwd=dense_bwd,
                        segments=tuple(segments),
                        src_types=src_types,
                        src_off=tuple(src_off[t] for t in src_types),
                        src_sizes=tuple(int(n_of[t]) for t in src_types))
