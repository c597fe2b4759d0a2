"""Learnable edge weights through DR-SpMM.

The paper's adjacency values are fixed normalisation constants; here they
are a differentiable parameter vector w (nnz,) in canonical
(dst-stable-sorted) edge order:

    Y = A(w) · densify(CBSR(x))        with  dY/dw  and  dY/dx_vals

    dL/dx_vals[j,t] = Σ_{i∈N(j)} w_ij · dY[i, idx[j,t]]      (SSpMM, Alg. 2)
    dL/dw_ij        = Σ_t dY[i, idx[j,t]] · vals[j,t]        (sampled dot)

Both reuse the forward's CBSR indices.  Edge-id slabs
(``graphs/ell.py::pack_eid_slabs``) and their fused arenas
(``pack_fused_eid_pair``) keep the forward and transposed layouts
consistent: both gather from the same canonical w.  The op and its kernels
live in ``kernels/ops.py`` and ``kernels/drspmm.py``; this module holds
the per-bucket dL/dw reduction the ``"bucket"`` backend uses and the
public slab entry point, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.graphs.ell import BucketedELL


def _bwd_w(fwd_slabs: BucketedELL, gy: torch.Tensor, x_vals: torch.Tensor,
           x_idx: torch.Tensor, nnz: int) -> torch.Tensor:
    """dL/dw (nnz,) per canonical edge: each real slot of the edge-id slabs
    (tensors on ``gy``'s device, ``w`` = f32(id + 1), 0 on padding) samples
    its destination's gY row at its source's CBSR columns and dots it with
    the source's values; slot sums land at their ids (padding at a dropped
    extra entry)."""
    gw = torch.zeros(nnz + 1, dtype=torch.float32, device=gy.device)
    for b in fwd_slabs.buckets:
        ids = b.w.long() - 1                                   # (R, E)
        nbr = b.nbr.long()
        v = x_vals.float()[nbr]                                # (R, E, k)
        cols = x_idx.long()[nbr]                               # (R, E, k)
        g = gy.float()[b.rows.long()]                          # (R, D)
        sampled = torch.gather(
            g[:, None, :].expand(*nbr.shape, g.shape[1]), 2, cols)
        contrib = (sampled * v).sum(-1)                        # (R, E)
        gw.index_add_(0, torch.where(ids < 0, nnz, ids).reshape(-1),
                      contrib.reshape(-1))
    return gw[:nnz]


def drspmm_learnable(fwd_slabs, bwd_slabs, nnz: int, w_canon: torch.Tensor,
                     x_vals: torch.Tensor, x_idx: torch.Tensor, dim: int, *,
                     backend: str = "fused",
                     dense: bool = False) -> torch.Tensor:
    """Differentiable in both ``w_canon`` (nnz,) and ``x_vals`` (N, k);
    see :func:`repro_torch.kernels.ops.drspmm_learnable`."""
    from repro_torch.kernels import ops     # lazy: ops imports this module
    return ops.drspmm_learnable(fwd_slabs, bwd_slabs, nnz, w_canon, x_vals,
                                x_idx, dim, backend=backend, dense=dense)
