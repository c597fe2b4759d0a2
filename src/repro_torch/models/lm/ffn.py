"""FFN layers: SwiGLU and its D-ReLU-sparsified form (the paper's
technique on an LM's FFN hidden).

Port of the dense half of ``repro/models/lm/ffn.py``.  ``drelu_k`` keeps
the top-k entries of every token's hidden (balanced row sparsity, Eqs. 2-3
of the paper): prefill runs it as a masked dense product, decode gathers
only the k surviving rows of W_down (``vals . W_down[idx]``), the analogue
of DR-SpMM consuming CBSR operands.  The hidden is tagged for the ``proj``
remat policy, as the reference names it.  With no mesh the reference's
``_drelu_sharded`` is ``drelu_grouped``.  MoE is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.cbsr import cbsr_from_dense
from repro_torch.core.drelu import drelu_grouped
from repro_torch.models.lm.common import tag_proj


def _swiglu_hidden(x, w_gate, w_up):
    h = F.silu(torch.einsum("bsd,df->bsf", x, w_gate))
    return h * torch.einsum("bsd,df->bsf", x, w_up)


def swiglu_ffn(x, w_gate, w_up, w_down, drelu_k: int = 0,
               drelu_groups: int = 1):
    """(B,S,d) -> (B,S,d).  ``drelu_k`` > 0 sparsifies the hidden row-wise
    via grouped D-ReLU."""
    h = _swiglu_hidden(x, w_gate, w_up)
    if 0 < drelu_k < h.shape[-1]:
        h = drelu_grouped(h, drelu_k, drelu_groups)
    h = tag_proj(h)
    return torch.einsum("bsf,fd->bsd", h, w_down)


def swiglu_ffn_decode_sparse(x, w_gate, w_up, w_down, drelu_k: int):
    """Decode-path FFN exploiting D-ReLU sparsity structurally.

    x: (B, 1, d).  The down-projection touches only the k surviving rows of
    W_down per token: y = sum_t vals_t . W_down[idx_t]."""
    h = _swiglu_hidden(x, w_gate, w_up)
    b, s, f = h.shape
    if not (0 < drelu_k < f):
        return torch.einsum("bsf,fd->bsd", h, w_down)
    c = cbsr_from_dense(h.reshape(b * s, f), drelu_k)
    rows = w_down[c.idx.long()]                 # (B*S, k, d) weight gather
    y = torch.einsum("tk,tkd->td", c.values, rows)
    return y.reshape(b, s, -1)
