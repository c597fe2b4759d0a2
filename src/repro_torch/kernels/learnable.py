"""Learnable edge weights through DR-SpMM.

The paper's adjacency values are fixed normalisation constants; here they
are a differentiable parameter vector w (nnz,) in canonical
(dst-stable-sorted) edge order:

    Y = A(w) · densify(CBSR(x))        with  dY/dw  and  dY/dx_vals

    dL/dx_vals[j,t] = Σ_{i∈N(j)} w_ij · dY[i, idx[j,t]]      (SSpMM, Alg. 2)
    dL/dw_ij        = Σ_t dY[i, idx[j,t]] · vals[j,t]        (sampled dot)

Both reuse the forward's CBSR indices.  Edge-id arenas
(``graphs/ell.py::pack_fused_eid_pair``) keep the forward and transposed
layouts consistent: both gather from the same canonical w.  The op and its
kernels live in ``kernels/ops.py`` and ``kernels/drspmm.py``; this module
is its public entry point, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def drspmm_learnable(fwd, bwd, nnz: int, w_canon: torch.Tensor,
                     x_vals: torch.Tensor, x_idx: torch.Tensor, dim: int, *,
                     dense: bool = False) -> torch.Tensor:
    """Differentiable in both ``w_canon`` (nnz,) and ``x_vals`` (N, k);
    see :func:`repro_torch.kernels.ops.drspmm_learnable`."""
    return ops.drspmm_learnable(fwd, bwd, nnz, w_canon, x_vals, x_idx, dim,
                                dense=dense)
