"""CBSR -- Compressed Balanced Sparse Row format.

D-ReLU keeps exactly ``k`` non-zeros per row, so the survivors of an
``(N, D)`` embedding are a pair of dense ``(N, k)`` tensors: ``values``
and their column ``idx`` (ascending within a row).  Rows may hold
duplicate index-0 entries with zero value as padding; every consumer
accumulates, so such padding is inert.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CBSR:
    """A row-balanced sparse matrix: exactly ``k`` entries per row."""

    values: torch.Tensor   # (N, k) float
    idx: torch.Tensor      # (N, k) int32 column positions
    dim: int               # dense column count

    @property
    def n_rows(self) -> int:
        return self.values.shape[0]

    @property
    def k(self) -> int:
        return self.values.shape[1]

    def to_dense(self) -> torch.Tensor:
        """Scatter back to a dense (N, dim) matrix (``add`` tolerates the
        zero-value duplicate padding)."""
        out = torch.zeros((self.n_rows, self.dim), dtype=self.values.dtype,
                          device=self.values.device)
        return out.scatter_add_(1, self.idx.long(), self.values)


def cbsr_from_dense(x: torch.Tensor, k: int) -> CBSR:
    """Keep the top-``k`` entries of each row.

    Selection follows the reference's ``lax.top_k`` exactly: values are
    ranked in IEEE total order (-0.0 below +0.0) and ties go to the lower
    column index.  ``torch.topk`` promises neither, so the rank comes from
    a stable descending sort of the fp32 bit patterns mapped to a
    monotonic int32 key (bf16 and fp16 widen to fp32 exactly, so they rank
    the same way).  Survivors are then re-sorted by column index."""
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"cbsr_from_dense takes a float matrix, got {x.dtype}")
    n, d = x.shape
    k = min(k, d)
    bits = x.detach().float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=1, descending=True, stable=True).indices
    idx = torch.sort(idx[:, :k], dim=1).values
    return CBSR(values=torch.gather(x, 1, idx), idx=idx.to(torch.int32),
                dim=d)
