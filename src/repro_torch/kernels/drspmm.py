"""DR-SpMM kernels: the chunk arena, the dense tier and the degree
buckets, forward and sampled backward.

Forward (Alg. 1):   Y[i, :] += w_ij * scatter(x_vals[j], x_idx[j])  over j ∈ N(i)
Backward (Alg. 2):  dV[j, t] = Σ_i w_ij * gY[i, x_idx[j, t]]  (SSpMM: Aᵀ·gY
                    sampled at each source row's own CBSR columns)

* :func:`drspmm_fwd_arena` replaces ``drspmm_fwd_fused`` (entered through
  ``drspmm_fwd_multi``, ``src/repro/kernels/drspmm.py``): the arena-ordered
  fp32 ``(R_arena, dim)`` output of a fused (super-)arena, one launch per
  direction-group.  CUDA source: ``csrc/drspmm_arena_fwd.cu``.
* :func:`drspmm_dense_tier_fwd` replaces ``drspmm_dense_tier_fwd``: the
  stacked dense-tier table times the CBSR operand, densified inside the
  kernel.  CUDA source: ``csrc/drspmm_dense_tier_fwd.cu``.
* :func:`drspmm_bwd_arena` replaces ``drspmm_bwd_fused`` (entered through
  ``drspmm_bwd_multi``): the arena-ordered fp32 ``(R_arena_bwd, k)`` dV of
  the transposed super-arena.  CUDA source: ``csrc/drspmm_arena_bwd.cu``.
* :func:`drspmm_dense_tier_bwd` replaces ``drspmm_dense_tier_bwd``: the
  stacked transposed dense-tier table times gY, sampled inside the kernel.
  CUDA source: ``csrc/drspmm_dense_tier_bwd.cu``.

* :func:`spmm_arena` replaces ``spmm_dense_fused``: the arena-ordered fp32
  ``(R_arena, dim)`` product of a fused arena with a dense operand, the
  executor of ``ops.spmm`` (D-ReLU off, the GCN and SAGE baselines).  CUDA
  source: ``csrc/spmm_arena.cu``.
* :func:`drspmm_fwd_learnable` replaces ``drspmm_fwd_learnable_fused``:
  kernel 1 over an edge-id arena, the weights gathered in the kernel as
  ``w_canon[eid]``.  CUDA source: ``csrc/drspmm_learnable_fwd.cu``.
* :func:`drspmm_bwd_learnable` replaces ``drspmm_bwd_learnable_fused``:
  kernel 4 over the transposed edge-id arena with ``w_canon[teid]``.  CUDA
  source: ``csrc/drspmm_learnable_bwd.cu``.
* :func:`drspmm_dw_learnable` replaces ``drspmm_dw_learnable_fused`` and
  its scatter to canonical order: the per-edge weight gradient ``(nnz,)``.
  CUDA source: ``csrc/drspmm_learnable_dw.cu``.

Per-degree-bucket kernels (``ops``' ``backend="bucket"``): each takes one
:class:`~repro_torch.graphs.ell.ELLBucket` whose ``(R, E)`` ``nbr``/``w``
slabs are tensors on the operands' device and returns bucket-local rows,
which the caller adds at the bucket's ``rows``.

* :func:`drspmm_fwd_bucket` replaces ``drspmm_fwd_bucket``: the fp32
  ``(R, dim)`` DR-SpMM of one bucket.  CUDA source:
  ``csrc/drspmm_bucket_fwd.cu``.
* :func:`drspmm_bwd_bucket` replaces ``drspmm_bwd_bucket``: the fp32
  ``(R, k)`` sampled backward of one transposed bucket at ``xi_rows``.
  CUDA source: ``csrc/drspmm_bucket_bwd.cu``.
* :func:`spmm_bucket` replaces ``spmm_dense_bucket``: the fp32 ``(R, D)``
  product of one bucket with a dense operand.  CUDA source:
  ``csrc/spmm_bucket.cu``.

Each wrapper runs its plain PyTorch version (``*_plain``) for a tensor on
the CPU and launches its kernel for a tensor on a card; it never falls back
from one to the other.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Dict

import torch

from repro_torch.graphs.ell import ELLBucket, FusedELL
from repro_torch.kernels import _build

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p


def _densify(x_vals: torch.Tensor, x_idx: torch.Tensor,
             dim: int) -> torch.Tensor:
    """CBSR (N, k) pair -> dense fp32 (N, dim); duplicate columns add."""
    xd = torch.zeros((x_vals.shape[0], dim), dtype=torch.float32,
                     device=x_vals.device)
    return xd.scatter_add_(1, x_idx.long(), x_vals.float())


def _check_cbsr(x_vals, x_idx, dim: int) -> None:
    if x_vals.dtype != torch.float32 or x_idx.dtype != torch.int32:
        raise TypeError(f"CBSR operands must be float32/int32, got "
                        f"{x_vals.dtype}/{x_idx.dtype}")
    if x_vals.shape != x_idx.shape or x_vals.dim() != 2:
        raise ValueError(f"CBSR shapes differ: {tuple(x_vals.shape)} vs "
                         f"{tuple(x_idx.shape)}")
    if not (x_vals.is_contiguous() and x_idx.is_contiguous()):
        raise ValueError("CBSR operands must be contiguous")
    if not 0 < dim <= 256:
        raise ValueError(f"dim {dim} outside the kernels' range (1..256)")


def _check_arena(f: FusedELL, *, eids: bool = False) -> None:
    """The arena tables a kernel walks: int32 ``nbr``/``blk_ptr`` (and
    ``eid``), float32 ``w``, chunk width 4/8/16, at most 8 rows a block."""
    c, br, ec = f.nbr.shape
    if f.nbr.dtype != torch.int32 or f.w.dtype != torch.float32 \
            or f.blk_ptr.dtype != torch.int32:
        raise TypeError("arena tables must be int32 nbr/blk_ptr, float32 w")
    if eids and (f.eid is None or f.eid.dtype != torch.int32
                 or f.eid.shape != f.nbr.shape):
        raise TypeError("learnable kernels need the arena's int32 eid table "
                        "(pack_fused_eid_pair)")
    if ec not in (4, 8, 16) or br > 8 \
            or f.blk_ptr.shape[0] != f.n_blocks + 1 \
            or f.walk_end.shape[0] != f.n_blocks:
        raise ValueError(f"arena geometry (BR={br}, Ec={ec}, blk_ptr "
                         f"{tuple(f.blk_ptr.shape)}, walk ends "
                         f"{tuple(f.walk_end.shape)}) not supported")


def _arena_rows(f: FusedELL) -> torch.Tensor:
    """(C, BR) arena row of each chunk slot row."""
    return (f.block_of.long()[:, None] * f.row_block
            + torch.arange(f.row_block, device=f.nbr.device)[None, :])


def _canon_slot_weights(f: FusedELL, nnz: int,
                        w_canon: torch.Tensor) -> torch.Tensor:
    """(C, BR, Ec) arena weights ``w_canon[eid]``, 0 where eid is -1."""
    wp = torch.cat([w_canon.float(), w_canon.new_zeros(1, dtype=torch.float32)])
    eid = f.eid.long()
    return wp[torch.where(eid < 0, nnz, eid)]


def _check_canon(w_canon: torch.Tensor, nnz: int, f: FusedELL) -> None:
    if w_canon.dtype != torch.float32 or w_canon.shape != (nnz,) \
            or not w_canon.is_contiguous():
        raise ValueError(f"w_canon must be a contiguous float32 ({nnz},) "
                         f"vector, got {w_canon.dtype} "
                         f"{tuple(w_canon.shape)}")
    if f.nnz >= 0 and f.nnz != nnz:
        raise ValueError(f"nnz {nnz} does not match the arena's {f.nnz}")


def _on_card(*ts) -> bool:
    """True for tensors on a card, False on the CPU; anything else (or a
    mix) raises -- there is no silent fallback between the two."""
    types = {t.device.type for t in ts}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"operands on unsupported or mixed devices: {types}")


# ---------------------------------------------------------------------------
# kernel 1: arena forward
# ---------------------------------------------------------------------------

def drspmm_fwd_arena_plain(fwd: FusedELL, x_vals: torch.Tensor,
                           x_idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Arena-ordered fp32 Y (R_arena, dim): densify the CBSR operand, then
    weight-sum each chunk row's neighbours and add chunks into their
    row-block."""
    xd = _densify(x_vals, x_idx, dim)
    br = fwd.row_block
    contrib = (xd[fwd.nbr.long()] * fwd.w[..., None]).sum(2)   # (C, BR, D)
    y = torch.zeros((fwd.n_blocks, br, dim), dtype=torch.float32,
                    device=x_vals.device)
    y.index_add_(0, fwd.block_of.long(), contrib)
    return y.reshape(fwd.n_arena_rows, dim)


def drspmm_fwd_arena(fwd: FusedELL, x_vals: torch.Tensor,
                     x_idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Arena-ordered fp32 Y (R_arena, dim) of a fused (super-)arena whose
    tables are tensors on the operands' device.  Read the caller-ordered
    output with ``y[fwd.gather]``."""
    if not _on_card(x_vals, x_idx, fwd.nbr, fwd.w, fwd.blk_ptr):
        return drspmm_fwd_arena_plain(fwd, x_vals, x_idx, dim)
    _check_cbsr(x_vals, x_idx, dim)
    _check_arena(fwd)
    c, br, ec = fwd.nbr.shape
    out = torch.empty((fwd.n_arena_rows, dim), dtype=torch.float32,
                      device=x_vals.device)
    lib = _arena_lib()
    rc = lib.drspmm_arena_fwd(
        _build.ptr(_arena_sched(fwd)), _build.ptr(fwd.nbr),
        _build.ptr(fwd.w), _build.ptr(x_vals),
        _build.ptr(x_idx), _build.ptr(out), fwd.n_blocks, br, ec,
        x_vals.shape[1], dim, _build.stream_of(out))
    _build.check(lib, rc, "drspmm_arena_fwd")
    drspmm_fwd_arena.launches += 1
    return out


drspmm_fwd_arena.launches = 0


def _arena_lib() -> ctypes.CDLL:
    lib = _build.library("drspmm_arena_fwd")
    fn = lib.drspmm_arena_fwd
    fn.argtypes = [_c_ptr] * 6 + [_c_int] * 5 + [_c_ptr]
    fn.restype = _c_int
    return lib


# id-keyed memo of the kernels' schedules and work lists, each guarded by
# weakrefs to the tables it was built from (an arena rewrapped around the
# same tables shares it; an entry goes when the first of them dies)
_SCHED: Dict[int, tuple] = {}


def _memo(parts, build) -> torch.Tensor:
    """``build()``'s tensor, built once while the tensors ``parts`` live
    (kept in ``_SCHED`` under the first's id), on their device without a
    host synchronisation; a launch on another stream than the one that
    built it waits for it.

    Under a CUDA-graph capture nothing is memoised or read from the memo:
    a captured graph's tables are its static inputs, whose contents change
    on every replay, so the build is captured with the launch and runs
    again on every replay."""
    if parts[0].is_cuda and torch.cuda.is_current_stream_capturing():
        return build()
    key = id(parts[0])
    hit = _SCHED.get(key)
    if hit is None or any(r() is not t for r, t in zip(hit[0], parts)):
        out = build()
        built = None
        if out.is_cuda:
            built = (torch.cuda.current_stream(out.device),
                     torch.cuda.Event())
            built[1].record(built[0])
        refs = (weakref.ref(parts[0], lambda _: _SCHED.pop(key, None)),
                *(weakref.ref(t) for t in parts[1:]))
        hit = (refs, out, built)
        _SCHED[key] = hit
    _, out, built = hit
    if built is not None:
        stream = torch.cuda.current_stream(out.device)
        if stream != built[0]:
            stream.wait_event(built[1])
    return out


def _arena_sched(f: FusedELL) -> torch.Tensor:
    """The order in which the arena walks (kernels 1, 4, 6, 7 and 8) take
    ``f``'s row-blocks: (n_blocks, 4) int32 rows (row-block, its first
    chunk, its walk end, 0), longest walked run first (ties in arena
    order), built once per ``blk_ptr`` / ``blk_end`` tensors (``_memo``).
    A padded arena's sentinel runs end before their padding chunks."""
    def build():
        begin = f.blk_ptr[:-1].long()
        end = f.walk_end.long()
        order = torch.argsort(end - begin, descending=True, stable=True)
        return torch.stack([order, begin[order], end[order],
                            torch.zeros_like(order)], 1).to(torch.int32)
    parts = (f.blk_ptr,) if f.blk_end is None else (f.blk_ptr, f.blk_end)
    return _memo(parts, build)


# ---------------------------------------------------------------------------
# kernel 2: dense-tier forward
# ---------------------------------------------------------------------------

def drspmm_dense_tier_fwd_plain(a_dense: torch.Tensor, x_vals: torch.Tensor,
                                x_idx: torch.Tensor,
                                dim: int) -> torch.Tensor:
    """fp32 Y (M, dim) = A_dense · densify(CBSR)."""
    return a_dense.float() @ _densify(x_vals, x_idx, dim)


def drspmm_dense_tier_fwd(a_dense: torch.Tensor, x_vals: torch.Tensor,
                          x_idx: torch.Tensor, dim: int) -> torch.Tensor:
    """fp32 Y (M, dim) = A_dense · densify(CBSR) for the stacked dense-tier
    table (the plan's ``dense_fwd``, (M, N) with N = the source slab)."""
    if not _on_card(a_dense, x_vals, x_idx):
        return drspmm_dense_tier_fwd_plain(a_dense, x_vals, x_idx, dim)
    _check_cbsr(x_vals, x_idx, dim)
    m, n = a_dense.shape
    if a_dense.dtype != torch.float32 or not a_dense.is_contiguous():
        raise TypeError("dense-tier table must be contiguous float32")
    if n != x_vals.shape[0]:
        raise ValueError(f"table has {n} source columns, operand "
                         f"{x_vals.shape[0]} rows")
    out = torch.empty((m, dim), dtype=torch.float32, device=x_vals.device)
    if m == 0:
        return out
    if n == 0:
        return out.zero_()
    lib = _dense_lib()
    rc = lib.drspmm_dense_tier_fwd(
        _build.ptr(a_dense), _build.ptr(x_vals), _build.ptr(x_idx),
        _build.ptr(out), m, n, x_vals.shape[1], dim, _build.stream_of(out))
    _build.check(lib, rc, "drspmm_dense_tier_fwd")
    drspmm_dense_tier_fwd.launches += 1
    return out


drspmm_dense_tier_fwd.launches = 0


def _dense_lib() -> ctypes.CDLL:
    lib = _build.library("drspmm_dense_tier_fwd")
    fn = lib.drspmm_dense_tier_fwd
    fn.argtypes = [_c_ptr] * 4 + [_c_int] * 4 + [_c_ptr]
    fn.restype = _c_int
    return lib


# ---------------------------------------------------------------------------
# kernel 4: arena sampled backward
# ---------------------------------------------------------------------------

def _check_bwd(gy: torch.Tensor, x_idx: torch.Tensor) -> None:
    if gy.dtype != torch.float32 or x_idx.dtype != torch.int32:
        raise TypeError(f"backward operands must be float32 gY and int32 "
                        f"indices, got {gy.dtype}/{x_idx.dtype}")
    if gy.dim() != 2 or x_idx.dim() != 2:
        raise ValueError(f"gY {tuple(gy.shape)} and indices "
                         f"{tuple(x_idx.shape)} must be matrices")
    if not (gy.is_contiguous() and x_idx.is_contiguous()):
        raise ValueError("backward operands must be contiguous")
    if not (0 < x_idx.shape[1] <= 256 and 0 < gy.shape[1] <= 256):
        raise ValueError(f"k {x_idx.shape[1]} or dim {gy.shape[1]} outside "
                         f"the kernels' range (1..256)")


def _check_src_rows(f: FusedELL, src_rows: torch.Tensor) -> None:
    if src_rows.dtype != torch.int32 or src_rows.shape != (f.n_arena_rows,):
        raise ValueError(f"source-row map must be int32 "
                         f"({f.n_arena_rows},), got {src_rows.dtype} "
                         f"{tuple(src_rows.shape)}")


def drspmm_bwd_arena_plain(bwd: FusedELL, bwd_src_rows: torch.Tensor,
                           gy_cat: torch.Tensor,
                           x_idx: torch.Tensor) -> torch.Tensor:
    """Arena-ordered fp32 dV (R_arena, k) of the transposed super-arena
    ``bwd``: each chunk slot samples its target's gY row at the CBSR
    columns of the arena row's source (``x_idx[bwd_src_rows[j]]``), and
    chunks add into their row-block."""
    br = bwd.row_block
    xi_arena = x_idx.long()[bwd_src_rows.long()]               # (R, k)
    xi_blocks = xi_arena[_arena_rows(bwd)]                     # (C, BR, k)
    sampled = gy_cat.float()[bwd.nbr.long()[..., None],
                             xi_blocks[:, :, None, :]]         # (C, BR, Ec, k)
    contrib = (sampled * bwd.w[..., None]).sum(2)              # (C, BR, k)
    dv = torch.zeros((bwd.n_blocks, br, x_idx.shape[1]), dtype=torch.float32,
                     device=gy_cat.device)
    dv.index_add_(0, bwd.block_of.long(), contrib)
    return dv.reshape(bwd.n_arena_rows, x_idx.shape[1])


def drspmm_bwd_arena(bwd: FusedELL, bwd_src_rows: torch.Tensor,
                     gy_cat: torch.Tensor,
                     x_idx: torch.Tensor) -> torch.Tensor:
    """Arena-ordered fp32 dV (R_arena, k) of a transposed (super-)arena
    whose tables are tensors on the operands' device.  ``gy_cat`` is the
    relation-concat output cotangent (M, dim), ``x_idx`` the type-concat
    CBSR indices (N, k) and ``bwd_src_rows`` maps arena rows to rows of
    ``x_idx``.  Read the caller-ordered dV with ``dv[bwd.gather]``."""
    if not _on_card(gy_cat, x_idx, bwd_src_rows, bwd.nbr, bwd.w,
                    bwd.blk_ptr):
        return drspmm_bwd_arena_plain(bwd, bwd_src_rows, gy_cat, x_idx)
    _check_bwd(gy_cat, x_idx)
    _check_arena(bwd)
    _check_src_rows(bwd, bwd_src_rows)
    c, br, ec = bwd.nbr.shape
    k = x_idx.shape[1]
    out = torch.empty((bwd.n_arena_rows, k), dtype=torch.float32,
                      device=gy_cat.device)
    lib = _arena_bwd_lib()
    rc = lib.drspmm_arena_bwd(
        _build.ptr(_arena_sched(bwd)), _build.ptr(bwd.nbr), _build.ptr(bwd.w), _build.ptr(bwd_src_rows),
        _build.ptr(gy_cat), _build.ptr(x_idx), _build.ptr(out),
        bwd.n_blocks, br, ec, k, gy_cat.shape[1], _build.stream_of(out))
    _build.check(lib, rc, "drspmm_arena_bwd")
    drspmm_bwd_arena.launches += 1
    return out


drspmm_bwd_arena.launches = 0


def _arena_bwd_lib() -> ctypes.CDLL:
    lib = _build.library("drspmm_arena_bwd")
    fn = lib.drspmm_arena_bwd
    fn.argtypes = [_c_ptr] * 7 + [_c_int] * 5 + [_c_ptr]
    fn.restype = _c_int
    return lib


# ---------------------------------------------------------------------------
# kernel 5: dense-tier sampled backward
# ---------------------------------------------------------------------------

def drspmm_dense_tier_bwd_plain(a_dense_t: torch.Tensor, gy: torch.Tensor,
                                x_idx: torch.Tensor) -> torch.Tensor:
    """fp32 dV (N, k) = (Aᵀ · gY) sampled at each row's CBSR columns."""
    return torch.gather(a_dense_t.float() @ gy.float(), 1, x_idx.long())


def drspmm_dense_tier_bwd(a_dense_t: torch.Tensor, gy: torch.Tensor,
                          x_idx: torch.Tensor) -> torch.Tensor:
    """fp32 dV (N, k) = sample(Aᵀ · gY, x_idx) for the stacked transposed
    dense-tier table (the plan's ``dense_bwd``, (N, M) with N = the source
    slab and M = the dense relations' output rows)."""
    if not _on_card(a_dense_t, gy, x_idx):
        return drspmm_dense_tier_bwd_plain(a_dense_t, gy, x_idx)
    _check_bwd(gy, x_idx)
    n, m = a_dense_t.shape
    if a_dense_t.dtype != torch.float32 or not a_dense_t.is_contiguous():
        raise TypeError("dense-tier table must be contiguous float32")
    if m != gy.shape[0] or n != x_idx.shape[0]:
        raise ValueError(f"table {tuple(a_dense_t.shape)} does not match gY "
                         f"{tuple(gy.shape)} and indices "
                         f"{tuple(x_idx.shape)}")
    k = x_idx.shape[1]
    if n == 0 or m == 0:
        return torch.zeros((n, k), dtype=torch.float32, device=gy.device)
    out = torch.empty((n, k), dtype=torch.float32, device=gy.device)
    lib = _dense_bwd_lib()
    rc = lib.drspmm_dense_tier_bwd(
        _build.ptr(a_dense_t), _build.ptr(gy), _build.ptr(x_idx),
        _build.ptr(out), n, m, k, gy.shape[1], _build.stream_of(out))
    _build.check(lib, rc, "drspmm_dense_tier_bwd")
    drspmm_dense_tier_bwd.launches += 1
    return out


drspmm_dense_tier_bwd.launches = 0


def _dense_bwd_lib() -> ctypes.CDLL:
    lib = _build.library("drspmm_dense_tier_bwd")
    fn = lib.drspmm_dense_tier_bwd
    fn.argtypes = [_c_ptr] * 4 + [_c_int] * 4 + [_c_ptr]
    fn.restype = _c_int
    return lib


# ---------------------------------------------------------------------------
# kernel 6: dense-operand arena SpMM
# ---------------------------------------------------------------------------

def spmm_arena_plain(f: FusedELL, x: torch.Tensor) -> torch.Tensor:
    """Arena-ordered fp32 Y (R_arena, D): weight-sum each chunk row's
    neighbour rows of ``x`` and add chunks into their row-block."""
    contrib = (x.float()[f.nbr.long()] * f.w[..., None]).sum(2)  # (C, BR, D)
    y = torch.zeros((f.n_blocks, f.row_block, x.shape[1]),
                    dtype=torch.float32, device=x.device)
    y.index_add_(0, f.block_of.long(), contrib)
    return y.reshape(f.n_arena_rows, x.shape[1])


def spmm_arena(f: FusedELL, x: torch.Tensor) -> torch.Tensor:
    """Arena-ordered fp32 Y (R_arena, D) = A · x of a fused arena whose
    tables are tensors on ``x``'s device, its row-blocks taken in
    ``_arena_sched``'s order.  Read the caller-ordered output with
    ``y[f.gather]``."""
    if not _on_card(x, f.nbr, f.w, f.blk_ptr):
        return spmm_arena_plain(f, x)
    _check_arena(f)
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"the operand must be a contiguous float32 matrix, "
                        f"got {x.dtype} {tuple(x.shape)}")
    if not 0 < x.shape[1] <= 256:
        raise ValueError(f"dim {x.shape[1]} outside the kernel's range "
                         f"(1..256)")
    c, br, ec = f.nbr.shape
    out = torch.empty((f.n_arena_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    lib = _spmm_lib()
    rc = lib.spmm_arena(
        _build.ptr(_arena_sched(f)), _build.ptr(f.nbr), _build.ptr(f.w),
        _build.ptr(x), _build.ptr(out), f.n_blocks, br, ec, x.shape[1],
        _build.stream_of(out))
    _build.check(lib, rc, "spmm_arena")
    spmm_arena.launches += 1
    return out


spmm_arena.launches = 0


def _spmm_lib() -> ctypes.CDLL:
    lib = _build.library("spmm_arena")
    fn = lib.spmm_arena
    fn.argtypes = [_c_ptr] * 5 + [_c_int] * 4 + [_c_ptr]
    fn.restype = _c_int
    return lib


# ---------------------------------------------------------------------------
# kernel 7: learnable-edge arena forward
# ---------------------------------------------------------------------------

def drspmm_fwd_learnable_plain(f: FusedELL, nnz: int, w_canon: torch.Tensor,
                               x_vals: torch.Tensor, x_idx: torch.Tensor,
                               dim: int) -> torch.Tensor:
    """Arena-ordered fp32 Y (R_arena, dim) of an edge-id arena with the
    weights ``w_canon[eid]``: kernel 1's plain version on those weights."""
    wa = _canon_slot_weights(f, nnz, w_canon)
    return drspmm_fwd_arena_plain(dataclasses.replace(f, w=wa), x_vals,
                                  x_idx, dim)


def drspmm_fwd_learnable(f: FusedELL, nnz: int, w_canon: torch.Tensor,
                         x_vals: torch.Tensor, x_idx: torch.Tensor,
                         dim: int) -> torch.Tensor:
    """Arena-ordered fp32 Y (R_arena, dim) = A(w)·densify(CBSR) over the
    forward edge-id arena ``f`` (tables on the operands' device), the
    canonical weights ``w_canon`` (nnz,) gathered in the kernel.  Read the
    caller-ordered output with ``y[f.gather]``."""
    if not _on_card(w_canon, x_vals, x_idx, f.nbr, f.eid, f.blk_ptr):
        return drspmm_fwd_learnable_plain(f, nnz, w_canon, x_vals, x_idx,
                                          dim)
    _check_cbsr(x_vals, x_idx, dim)
    _check_arena(f, eids=True)
    _check_canon(w_canon, nnz, f)
    c, br, ec = f.nbr.shape
    out = torch.empty((f.n_arena_rows, dim), dtype=torch.float32,
                      device=x_vals.device)
    lib = _learnable_lib("drspmm_learnable_fwd", 7)
    rc = lib.drspmm_learnable_fwd(
        _build.ptr(_arena_sched(f)), _build.ptr(f.nbr), _build.ptr(f.eid),
        _build.ptr(w_canon), _build.ptr(x_vals), _build.ptr(x_idx),
        _build.ptr(out), f.n_blocks, br, ec, x_vals.shape[1], dim,
        _build.stream_of(out))
    _build.check(lib, rc, "drspmm_learnable_fwd")
    drspmm_fwd_learnable.launches += 1
    return out


drspmm_fwd_learnable.launches = 0


def _learnable_lib(name: str, n_ptr: int, n_int: int = 5) -> ctypes.CDLL:
    lib = _build.library(name)
    fn = getattr(lib, name)
    fn.argtypes = [_c_ptr] * n_ptr + [_c_int] * n_int + [_c_ptr]
    fn.restype = _c_int
    return lib


# ---------------------------------------------------------------------------
# kernel 8: learnable-edge sampled backward (dL/dx_vals)
# ---------------------------------------------------------------------------

def drspmm_bwd_learnable_plain(ft: FusedELL, nnz: int, w_canon: torch.Tensor,
                               gy: torch.Tensor,
                               x_idx: torch.Tensor) -> torch.Tensor:
    """Arena-ordered fp32 dV (R_arena, k) of the transposed edge-id arena
    ``ft`` with the weights ``w_canon[teid]``; each arena row samples at
    ``x_idx[ft.rows[j]]``: kernel 4's plain version on those weights."""
    wa = _canon_slot_weights(ft, nnz, w_canon)
    return drspmm_bwd_arena_plain(dataclasses.replace(ft, w=wa), ft.rows,
                                  gy, x_idx)


def drspmm_bwd_learnable(ft: FusedELL, nnz: int, w_canon: torch.Tensor,
                         gy: torch.Tensor,
                         x_idx: torch.Tensor) -> torch.Tensor:
    """Arena-ordered fp32 dV (R_arena, k) = sample(A(w)ᵀ·gY, x_idx) over
    the transposed edge-id arena ``ft`` (tables on the operands' device).
    Read the caller-ordered dV with ``dv[ft.gather]``."""
    if not _on_card(w_canon, gy, x_idx, ft.nbr, ft.eid, ft.rows,
                    ft.blk_ptr):
        return drspmm_bwd_learnable_plain(ft, nnz, w_canon, gy, x_idx)
    _check_bwd(gy, x_idx)
    _check_arena(ft, eids=True)
    _check_src_rows(ft, ft.rows)
    _check_canon(w_canon, nnz, ft)
    c, br, ec = ft.nbr.shape
    k = x_idx.shape[1]
    out = torch.empty((ft.n_arena_rows, k), dtype=torch.float32,
                      device=gy.device)
    lib = _learnable_lib("drspmm_learnable_bwd", 8)
    rc = lib.drspmm_learnable_bwd(
        _build.ptr(_arena_sched(ft)), _build.ptr(ft.nbr), _build.ptr(ft.eid), _build.ptr(w_canon),
        _build.ptr(ft.rows), _build.ptr(gy), _build.ptr(x_idx),
        _build.ptr(out), ft.n_blocks, br, ec, k, gy.shape[1],
        _build.stream_of(out))
    _build.check(lib, rc, "drspmm_learnable_bwd")
    drspmm_bwd_learnable.launches += 1
    return out


drspmm_bwd_learnable.launches = 0


# ---------------------------------------------------------------------------
# kernel 9: learnable-edge weight gradient (dL/dw, canonical order)
# ---------------------------------------------------------------------------

def drspmm_dw_learnable_plain(f: FusedELL, nnz: int, gy: torch.Tensor,
                              x_vals: torch.Tensor,
                              x_idx: torch.Tensor) -> torch.Tensor:
    """fp32 gw (nnz,): each real slot of the forward edge-id arena ``f``
    samples its destination's gY row at its source's CBSR columns and dots
    it with the source's values; the slot sums land at their canonical ids
    (one slot per id, so a plain index copy)."""
    dst = f.rows.long()[_arena_rows(f)]                        # (C, BR)
    nbr = f.nbr.long()
    g = gy.float()[dst]                                        # (C, BR, D)
    cols = x_idx.long()[nbr]                                   # (C, BR, Ec, k)
    sampled = torch.gather(g[:, :, None, :].expand(*nbr.shape, g.shape[-1]),
                           3, cols)
    contrib = (sampled * x_vals.float()[nbr]).sum(-1)          # (C, BR, Ec)
    real = f.eid >= 0
    gw = torch.zeros(nnz, dtype=torch.float32, device=gy.device)
    return gw.index_copy_(0, f.eid[real].long(), contrib[real])


def _dw_sched(f: FusedELL) -> torch.Tensor:
    """Kernel 9's work list over the forward edge-id arena ``f``: (C * BR *
    Ec, 4) int32 rows (canonical id, source, destination gY row, 0), one a
    slot, the real slots sorted by destination row (ties in arena order:
    a row's slots together, so its gY row stays in L1) and the padding
    slots (id -1) last; built once per arena (its ``eid``, ``nbr``,
    ``block_of`` and ``rows`` tensors, ``_memo``)."""
    def build():
        eid = f.eid.reshape(-1)
        dst = f.rows[_arena_rows(f)][:, :, None].expand(f.nbr.shape)
        dst = dst.reshape(-1)
        order = torch.argsort(torch.where(eid >= 0, dst.long(), f.n_dst),
                              stable=True)
        return torch.stack([eid[order], f.nbr.reshape(-1)[order],
                            dst[order], torch.zeros_like(eid)],
                           1).contiguous()
    return _memo((f.eid, f.nbr, f.block_of, f.rows), build)


def drspmm_dw_learnable(f: FusedELL, nnz: int, gy: torch.Tensor,
                        x_vals: torch.Tensor,
                        x_idx: torch.Tensor) -> torch.Tensor:
    """fp32 dL/dw_canon (nnz,) of Y = A(w)·densify(CBSR) over the forward
    edge-id arena ``f`` (tables on the operands' device), given the
    caller-ordered cotangent ``gy`` (n_dst, dim)."""
    if not _on_card(gy, x_vals, x_idx, f.nbr, f.eid, f.rows, f.blk_ptr,
                    f.block_of):
        return drspmm_dw_learnable_plain(f, nnz, gy, x_vals, x_idx)
    _check_cbsr(x_vals, x_idx, gy.shape[1])
    _check_bwd(gy, x_idx)
    _check_arena(f, eids=True)
    _check_src_rows(f, f.rows)
    if f.nnz >= 0 and f.nnz != nnz:
        raise ValueError(f"nnz {nnz} does not match the arena's {f.nnz}")
    # every canonical id owns exactly one slot (pack_fused_eid_pair checks
    # it), so the kernel writes each entry once, taking the slots in the
    # order of _dw_sched; a collated arena's weight vector is padded past
    # its edges (nnz -1 on the arena), and those ids get no slot: zeros
    sched = _dw_sched(f)
    gw = (torch.empty if f.nnz == nnz else torch.zeros)(
        nnz, dtype=torch.float32, device=gy.device)
    lib = _learnable_lib("drspmm_learnable_dw", 5, 3)
    rc = lib.drspmm_learnable_dw(
        _build.ptr(sched), _build.ptr(gy), _build.ptr(x_vals),
        _build.ptr(x_idx), _build.ptr(gw), sched.shape[0], x_idx.shape[1],
        gy.shape[1], _build.stream_of(gw))
    _build.check(lib, rc, "drspmm_learnable_dw")
    drspmm_dw_learnable.launches += 1
    return gw


drspmm_dw_learnable.launches = 0


# ---------------------------------------------------------------------------
# kernels 10-12: one degree bucket's (R, E) slab
# ---------------------------------------------------------------------------

def _check_bucket(b: ELLBucket) -> None:
    """The slab tables a bucket kernel walks: contiguous int32 ``nbr`` and
    float32 ``w`` of one (R, E) shape, E >= 1."""
    if b.nbr.dtype != torch.int32 or b.w.dtype != torch.float32:
        raise TypeError(f"bucket slabs must be int32 nbr / float32 w, got "
                        f"{b.nbr.dtype}/{b.w.dtype}")
    if b.nbr.dim() != 2 or b.nbr.shape != b.w.shape or b.nbr.shape[1] < 1:
        raise ValueError(f"bucket slabs {tuple(b.nbr.shape)} / "
                         f"{tuple(b.w.shape)} must share one (R, E >= 1) "
                         f"shape")
    if not (b.nbr.is_contiguous() and b.w.is_contiguous()):
        raise ValueError("bucket slabs must be contiguous")


def drspmm_fwd_bucket_plain(b: ELLBucket, x_vals: torch.Tensor,
                            x_idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Bucket-local fp32 Y (R, dim): densify the CBSR operand, then
    weight-sum each slab row's neighbours."""
    xd = _densify(x_vals, x_idx, dim)
    return (xd[b.nbr.long()] * b.w.float()[..., None]).sum(1)


def drspmm_fwd_bucket(b: ELLBucket, x_vals: torch.Tensor,
                      x_idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Bucket-local fp32 Y (R, dim) = slab(A) · densify(CBSR) of one degree
    bucket whose slabs are tensors on the operands' device."""
    if not _on_card(x_vals, x_idx, b.nbr, b.w):
        return drspmm_fwd_bucket_plain(b, x_vals, x_idx, dim)
    _check_cbsr(x_vals, x_idx, dim)
    _check_bucket(b)
    r, e = b.nbr.shape
    out = torch.empty((r, dim), dtype=torch.float32, device=x_vals.device)
    lib = _bucket_lib("drspmm_bucket_fwd", 5, 4)
    rc = lib.drspmm_bucket_fwd(
        _build.ptr(b.nbr), _build.ptr(b.w), _build.ptr(x_vals),
        _build.ptr(x_idx), _build.ptr(out), r, e, x_vals.shape[1], dim,
        _build.stream_of(out))
    _build.check(lib, rc, "drspmm_bucket_fwd")
    drspmm_fwd_bucket.launches += 1
    return out


drspmm_fwd_bucket.launches = 0


def _bucket_lib(name: str, n_ptr: int, n_int: int) -> ctypes.CDLL:
    lib = _build.library(name)
    fn = getattr(lib, name)
    fn.argtypes = [_c_ptr] * n_ptr + [_c_int] * n_int + [_c_ptr]
    fn.restype = _c_int
    return lib


def drspmm_bwd_bucket_plain(b: ELLBucket, gy: torch.Tensor,
                            xi_rows: torch.Tensor) -> torch.Tensor:
    """Bucket-local fp32 dV (R, k): each slot samples its target's gY row
    at its slab row's CBSR columns ``xi_rows`` (R, k)."""
    sampled = gy.float()[b.nbr.long()[..., None],
                         xi_rows.long()[:, None, :]]           # (R, E, k)
    return (sampled * b.w.float()[..., None]).sum(1)


def drspmm_bwd_bucket(b: ELLBucket, gy: torch.Tensor,
                      xi_rows: torch.Tensor) -> torch.Tensor:
    """Bucket-local fp32 dV (R, k) = sample(slab(Aᵀ) · gY, xi_rows) of one
    transposed degree bucket whose slabs are tensors on the operands'
    device; ``xi_rows`` is the CBSR indices at the bucket's rows."""
    if not _on_card(gy, xi_rows, b.nbr, b.w):
        return drspmm_bwd_bucket_plain(b, gy, xi_rows)
    _check_bwd(gy, xi_rows)
    _check_bucket(b)
    r, e = b.nbr.shape
    if xi_rows.shape[0] != r:
        raise ValueError(f"xi_rows has {xi_rows.shape[0]} rows, the bucket "
                         f"{r}")
    k = xi_rows.shape[1]
    out = torch.empty((r, k), dtype=torch.float32, device=gy.device)
    lib = _bucket_lib("drspmm_bucket_bwd", 5, 4)
    rc = lib.drspmm_bucket_bwd(
        _build.ptr(b.nbr), _build.ptr(b.w), _build.ptr(gy),
        _build.ptr(xi_rows), _build.ptr(out), r, e, k, gy.shape[1],
        _build.stream_of(out))
    _build.check(lib, rc, "drspmm_bucket_bwd")
    drspmm_bwd_bucket.launches += 1
    return out


drspmm_bwd_bucket.launches = 0


def spmm_bucket_plain(b: ELLBucket, x: torch.Tensor) -> torch.Tensor:
    """Bucket-local fp32 Y (R, D): weight-sum each slab row's neighbour
    rows of ``x``."""
    return (x.float()[b.nbr.long()] * b.w.float()[..., None]).sum(1)


def spmm_bucket(b: ELLBucket, x: torch.Tensor) -> torch.Tensor:
    """Bucket-local fp32 Y (R, D) = slab(A) · x of one degree bucket whose
    slabs are tensors on ``x``'s device."""
    if not _on_card(x, b.nbr, b.w):
        return spmm_bucket_plain(b, x)
    _check_bucket(b)
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"the operand must be a contiguous float32 matrix, "
                        f"got {x.dtype} {tuple(x.shape)}")
    if not 0 < x.shape[1] <= 256:
        raise ValueError(f"dim {x.shape[1]} outside the kernel's range "
                         f"(1..256)")
    r, e = b.nbr.shape
    out = torch.empty((r, x.shape[1]), dtype=torch.float32, device=x.device)
    lib = _bucket_lib("spmm_bucket", 4, 3)
    rc = lib.spmm_bucket(_build.ptr(b.nbr), _build.ptr(b.w), _build.ptr(x),
                         _build.ptr(out), r, e, x.shape[1],
                         _build.stream_of(out))
    _build.check(lib, rc, "spmm_bucket")
    spmm_bucket.launches += 1
    return out


spmm_bucket.launches = 0
