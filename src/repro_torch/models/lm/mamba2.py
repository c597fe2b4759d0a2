"""Mamba-2 SSD (state-space duality) core [arXiv:2405.21060].

Port of ``repro/models/lm/mamba2.py``: the chunked SSD for train/prefill (a
loop over chunks carrying the inter-chunk state, the reference's
``lax.scan``) and the O(1) recurrence for decode.  Plain PyTorch on both
devices, as the reference's core is plain ``jnp`` (no Pallas kernel): the
paper's DR-SpMM does not apply inside it.

Two deliberate differences from the reference, both where it fails:

* the intra-chunk decay masks ``seg`` *before* the exponential
  (``exp(where(tri, seg, -inf))``).  The reference exponentiates the whole
  chunk square and zeroes the upper triangle afterwards; above the
  diagonal ``seg`` is a positive sum of ``dt * |a|`` that passes fp32's
  ``exp`` limit at ``ssm_chunk = 256``, so its forward stays finite but its
  gradient is ``0 * inf = NaN``.  The port's forward is the same numbers
  and its gradient is finite;
* a sequence longer than the chunk that the chunk does not divide raises
  ``ValueError`` (the reference fails at a reshape); nothing is padded.

The three-operand contractions go in a stated order so no
(B, nc, C, C, H, P) intermediate forms: the (B, nc, C, C, H) decay is
weighted by C_i . B_j first, then contracted with x*dt over j.

Projections are separate (z/x/B/C/dt), as the reference keeps them.

Shapes (n_groups = 1):
    x   : (B, S, H, P)    -- P = ssm_head_dim, H = d_inner / P heads
    B,C : (B, S, N)       -- N = ssm_state
    dt  : (B, S, H)       -- softplus-positive step sizes
    A   : (H,)            -- negative decay rates (-exp(a_log))
state  : (B, H, P, N) f32
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.lm.common import rms_norm

CONV_K = 4          # depthwise causal conv width (mamba2 default)


class SSMCache(NamedTuple):
    state: torch.Tensor      # (B, H, P, N) f32
    conv_x: torch.Tensor     # (B, CONV_K-1, d_inner)
    conv_b: torch.Tensor     # (B, CONV_K-1, N)
    conv_c: torch.Tensor     # (B, CONV_K-1, N)


def causal_conv1d(x, w, b):
    """Depthwise causal conv in ``x``'s dtype.  x (B,S,C); w (CONV_K, C);
    b (C,)."""
    pad = F.pad(x, (0, 0, CONV_K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(CONV_K):
        out = out + pad[:, i: i + x.shape[1]] * w[i][None, None, :]
    return out + b[None, None, :]


def causal_conv1d_step(x_t, conv_state, w, b):
    """One-token conv, computed in fp32 and cast back to ``x_t``'s dtype.
    x_t (B,1,C); conv_state (B, CONV_K-1, C).
    Returns (out (B,1,C), new_conv_state)."""
    window = torch.cat([conv_state, x_t], dim=1)          # (B, K, C)
    out = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b
    return out[:, None, :].to(x_t.dtype), window[:, 1:]


def ssd_chunked(x, b_mat, c_mat, dt, a_log, d_skip, *, chunk: int,
                initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} does not split into chunks of "
                         f"{chunk} (ssm_chunk must divide a sequence "
                         f"longer than it)")
    nc = s // chunk
    a = -torch.exp(a_log.float())                             # (H,)

    dt = F.softplus(dt.float())                               # (B,S,H)
    xdt = x.float() * dt[..., None]                           # (B,S,H,P)
    da = dt * a[None, None, :]                                # (B,S,H) <= 0

    xdt = xdt.reshape(bsz, nc, chunk, h, p)
    da = da.reshape(bsz, nc, chunk, h)
    bm = b_mat.float().reshape(bsz, nc, chunk, n)
    cm = c_mat.float().reshape(bsz, nc, chunk, n)

    cum = torch.cumsum(da, dim=2)                             # (B,nc,C,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,i,j,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    # masked before the exponential: above the diagonal seg > 0 can
    # overflow, and exp(-inf) = 0 has a zero gradient
    decay = torch.exp(torch.where(tri, seg, float("-inf")))

    # intra-chunk: Y_i = sum_{j<=i} (C_i.B_j) decay_ij xdt_j, contracted as
    # ((C.B) * decay) over j against xdt
    g = torch.einsum("bniv,bnjv->bnij", cm, bm)               # (B,nc,C,C)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", g[..., None] * decay, xdt)

    # chunk-end states: S_n = sum_j exp(cum_end - cum_j) B_j (x) xdt_j
    end_decay = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,C,H)
    states = torch.einsum("bnjhp,bnjv->bnhpv", end_decay[..., None] * xdt,
                          bm)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)

    st = (initial_state.float() if initial_state is not None
          else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                           device=x.device))
    prev = []
    for c in range(nc):                                       # emit incoming
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,P,N)

    # inter-chunk: Y_i += (C_i . prev_state) exp(cum_i)
    in_decay = torch.exp(cum)                                 # (B,nc,C,H)
    y_inter = torch.einsum("bniv,bnhpv->bnihp", cm, prev_states) \
        * in_decay[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + x.float() * d_skip[None, None, :, None]
    return y.to(x.dtype), st


def ssd_decode_step(x_t, b_t, c_t, dt_t, a_log, d_skip, state):
    """O(1) recurrence: state <- state*exp(dt*a) + dt*(B (x) x); y = C.state.

    x_t (B,1,H,P); b_t/c_t (B,1,N); dt_t (B,1,H); state (B,H,P,N) f32."""
    a = -torch.exp(a_log.float())
    dt = F.softplus(dt_t.float())[:, 0]                       # (B,H)
    xf = x_t.float()[:, 0]                                    # (B,H,P)
    bf = b_t.float()[:, 0]                                    # (B,N)
    cf = c_t.float()[:, 0]
    decay = torch.exp(dt * a[None, :])                        # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", xf * dt[..., None], bf)
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, cf)
    y = y + xf * d_skip[None, :, None]
    return y[:, None].to(x_t.dtype), state


# ---------------------------------------------------------------------------
# full mamba2 block (split projections + conv + SSD + gate)
# ---------------------------------------------------------------------------

def mamba2_block(x, p, cfg, *, mode: str = "train",
                 cache: Optional[SSMCache] = None
                 ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """One mamba2 block.  x (B,S,d).

    mode: "train" (no cache), "prefill" (returns the cache: the final
    state and the last CONV_K-1 raw conv inputs), "decode" (consumes and
    returns a cache; S must be 1)."""
    bsz, s, d = x.shape
    di = cfg.ssm_expand * cfg.d_model
    p_hd = cfg.ssm_head_dim
    h = di // p_hd
    dt_ = x.dtype

    z = torch.einsum("bsd,de->bse", x, p["z_proj"].to(dt_))
    xc_raw = torch.einsum("bsd,de->bse", x, p["x_proj"].to(dt_))
    b_raw = torch.einsum("bsd,dv->bsv", x, p["b_proj"].to(dt_))
    c_raw = torch.einsum("bsd,dv->bsv", x, p["c_proj"].to(dt_))
    dt = (torch.einsum("bsd,dh->bsh", x, p["dt_proj"].to(dt_)).float()
          + p["dt_bias"][None, None, :])

    cw = {k: p[k].to(dt_) for k in
          ("conv_x_w", "conv_x_b", "conv_b_w", "conv_b_b",
           "conv_c_w", "conv_c_b")}
    if mode == "decode":
        if cache is None:
            raise ValueError("mode 'decode' needs a cache")
        xc, conv_x = causal_conv1d_step(xc_raw, cache.conv_x,
                                        cw["conv_x_w"], cw["conv_x_b"])
        bm, conv_b = causal_conv1d_step(b_raw, cache.conv_b,
                                        cw["conv_b_w"], cw["conv_b_b"])
        cm, conv_c = causal_conv1d_step(c_raw, cache.conv_c,
                                        cw["conv_c_w"], cw["conv_c_b"])
    else:
        xc = causal_conv1d(xc_raw, cw["conv_x_w"], cw["conv_x_b"])
        bm = causal_conv1d(b_raw, cw["conv_b_w"], cw["conv_b_b"])
        cm = causal_conv1d(c_raw, cw["conv_c_w"], cw["conv_c_b"])
        conv_x = xc_raw[:, -(CONV_K - 1):]
        conv_b = b_raw[:, -(CONV_K - 1):]
        conv_c = c_raw[:, -(CONV_K - 1):]

    xc = F.silu(xc)
    bm = F.silu(bm)
    cm = F.silu(cm)
    xh = xc.reshape(bsz, s, h, p_hd)

    new_cache = None
    if mode == "decode":
        y, new_state = ssd_decode_step(xh, bm, cm, dt, p["a_log"],
                                       p["d_skip"], cache.state)
        new_cache = SSMCache(state=new_state, conv_x=conv_x,
                             conv_b=conv_b, conv_c=conv_c)
    else:
        y, final_state = ssd_chunked(xh, bm, cm, dt, p["a_log"],
                                     p["d_skip"], chunk=cfg.ssm_chunk)
        if mode == "prefill":
            new_cache = SSMCache(state=final_state, conv_x=conv_x,
                                 conv_b=conv_b, conv_c=conv_c)

    y = y.reshape(bsz, s, di)
    y = y * F.silu(z)                           # gated
    y = rms_norm(y, p["ssd_norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dt_))
    return out, new_cache


def init_ssm_cache(bsz: int, cfg, dtype=torch.float32,
                   device="cuda") -> SSMCache:
    di = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    h = di // cfg.ssm_head_dim
    return SSMCache(
        state=torch.zeros((bsz, h, cfg.ssm_head_dim, n), dtype=torch.float32,
                          device=device),
        conv_x=torch.zeros((bsz, CONV_K - 1, di), dtype=dtype, device=device),
        conv_b=torch.zeros((bsz, CONV_K - 1, n), dtype=dtype, device=device),
        conv_c=torch.zeros((bsz, CONV_K - 1, n), dtype=dtype, device=device))
