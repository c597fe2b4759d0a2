"""Kernel 13 of the PyTorch port: the flash-attention forward.

On the CPU: the plain version beside the kernel against the reference's
Pallas ``flash_attention`` (interpret mode, as ``tests/test_flash_kernel.py``
runs it) at that file's four shapes, and the port's ``chunked_attention``
against the reference's at S 200 (the reference's chunk schedules, brick
and masked, causal and not, GQA heads 4 / KV 2; the port has no schedule).
The port takes k/v untiled, (B, Sk, KV, hd), q head h reading KV head
h % KV: ``chunked_attention`` and the plain version with KV 1, 2 and 4 of
4 heads against the reference on ``tile_kv``'s copies, and a case that
tells h % KV from h // (H / KV).  The backward: kernel 13b's plain
version against ``jax.vjp`` of the reference's ``chunked_attention`` and
against autograd through the plain forward, and the log-sum-exp it reads;
and the rounding scheme of 13b's bf16 kernel reproduced in plain torch (P
and dS as bf16 hi + lo into fp32 sums): within the card test's limit of
the plain version, where one bf16 rounding of P and dS is not.
The kernels themselves are held against
the plain versions on a card in ``tests/test_torch_cuda.py`` (which imports
no JAX, so it runs where the card is).  Tolerances: fp32 parity as
``_torch_port.assert_close`` (rtol 1e-5, atol 1e-5 scaled by the
magnitude); bf16 against the float64 oracle within two bf16 ulps at the
oracle's largest magnitude (``_torch_port.assert_bf16_close``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models.lm.attention import chunked_attention as j_chunked
from repro.models.lm.attention import tile_kv as j_tile_kv
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.lm.attention import chunked_attention, tile_kv
from _torch_port import assert_bf16_close, assert_close


def _qkv(rng, b, sq, sk, h, hd, kv=None):
    kv = kv or h
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32))


def _naive(q, k, v, causal, q_offset=0):
    """float64 softmax attention with the causal mask by absolute position."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    s = np.einsum("bqhd,bshd->bhqs", q, k) / np.sqrt(q.shape[-1])
    if causal:
        qp = q_offset + np.arange(q.shape[1])
        s = np.where((qp[:, None] >= np.arange(k.shape[1])[None, :])[None, None],
                     s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqs,bshd->bqhd", p / p.sum(-1, keepdims=True), v)


# the four shapes of tests/test_flash_kernel.py::test_flash_vs_naive
@pytest.mark.parametrize("sq,sk,causal", [
    (128, 128, True), (128, 128, False), (256, 256, True),
    (128, 256, False),
])
def test_plain_matches_pallas_kernel(sq, sk, causal):
    rng = np.random.default_rng(sq + sk)
    q, k, v = _qkv(rng, 2, sq, sk, 2, 64)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, interpret=True)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    assert out.dtype == torch.float32
    assert_close(out.numpy(), np.asarray(ref))


def test_tile_kv_is_jnp_tile():
    """q head h reads kv head h % KV (``jnp.tile``), not h // reps."""
    k = np.random.default_rng(0).normal(size=(2, 5, 2, 8)).astype(np.float32)
    out = tile_kv(torch.from_numpy(k), 4).numpy()
    np.testing.assert_array_equal(out, np.asarray(j_tile_kv(jnp.asarray(k), 4)))
    np.testing.assert_array_equal(out[:, :, 3], k[:, :, 1])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode,chunk", [("brick", 1024), ("brick", 64),
                                        ("brick", 40), ("masked", 1024),
                                        ("masked", 64), ("masked", 40)])
def test_chunked_attention_matches_reference(causal, mode, chunk):
    """S 200 under each of the reference's schedules (chunks of 200, 50 or
    40), GQA heads 4 / KV 2 tiled as the attention block tiles them."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 200, 200, 4, 32, kv=2)
    kt, vt = (j_tile_kv(jnp.asarray(a), 4) for a in (k, v))
    ref = j_chunked(jnp.asarray(q), kt, vt, causal=causal, q_chunk=chunk,
                    kv_chunk=chunk, causal_mode=mode)
    out = chunked_attention(
        torch.from_numpy(q), tile_kv(torch.from_numpy(k), 4),
        tile_kv(torch.from_numpy(v), 4), causal=causal)
    assert_close(out.numpy(), np.asarray(ref))


def test_chunked_attention_q_offset_matches_reference():
    """A q block placed after a prefix (the mask by absolute position)."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 1, 64, 192, 2, 32)
    ref = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, q_chunk=32, kv_chunk=64, q_offset=128)
    out = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True, q_offset=128)
    assert_close(out.numpy(), np.asarray(ref))


def test_plain_any_length_matches_oracle():
    """S 1000: the last kv tile of 64 is ragged (1000 = 15 x 64 + 40)."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 1, 1000, 1000, 2, 32)
    out = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    assert_close(out.numpy(), _naive(q, k, v, True))


def test_plain_keeps_bf16():
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 1, 96, 96, 2, 64))
    out = fa.flash_attention_plain(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    ref = _naive(q.float().numpy(), k.float().numpy(), v.float().numpy(), True)
    assert_bf16_close(out.float().numpy(), ref)


def test_cpu_path_is_differentiable():
    """On the CPU the attention's autograd Function runs the plain forward
    and the plain backward (the card runs kernels 13 and 13b)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(rng, 1, 32, 32, 2, 32))
    chunked_attention(q, k, v, causal=True).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


@pytest.mark.parametrize("kv", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,q_offset", [(96, 96, 0), (64, 128, 64)])
def test_untiled_kv_matches_reference(kv, causal, sq, sk, q_offset):
    """k/v at their KV heads against the reference's chunked_attention on
    the tiled copies (its q chunk 32 and kv chunk 64), with and without a
    q offset."""
    rng = np.random.default_rng(20 + kv + sk)
    q, k, v = _qkv(rng, 2, sq, sk, 4, 32, kv=kv)
    kt, vt = (j_tile_kv(jnp.asarray(a), 4) for a in (k, v))
    ref = np.asarray(j_chunked(jnp.asarray(q), kt, vt, causal=causal,
                               q_chunk=32, kv_chunk=64, q_offset=q_offset))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = chunked_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    plain = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                     q_offset=q_offset)
    assert out.shape == tq.shape
    assert_close(out.numpy(), ref)
    assert_close(plain.numpy(), ref)


def test_kv_head_mapping_is_modulo():
    """Head h reads KV head h % KV (jnp.tile), not h // (H / KV): with 4
    heads on 2 KV heads, heads 1 and 2 differ between the two rules."""
    rng = np.random.default_rng(30)
    q, k, v = _qkv(rng, 1, 48, 48, 4, 32, kv=2)
    out = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=True).numpy()
    for h in range(4):
        mod = _naive(q[:, :, h:h + 1], k[:, :, h % 2:h % 2 + 1],
                     v[:, :, h % 2:h % 2 + 1], True)
        div = _naive(q[:, :, h:h + 1], k[:, :, h // 2:h // 2 + 1],
                     v[:, :, h // 2:h // 2 + 1], True)
        assert_close(out[:, :, h:h + 1], mod)
        if h in (1, 2):
            assert np.abs(out[:, :, h:h + 1] - div).max() > 1e-2


def test_untiled_kv_rejects_bad_head_count():
    q = torch.zeros((1, 8, 4, 32))
    k = torch.zeros((1, 8, 3, 32))
    with pytest.raises(ValueError, match="KV head count"):
        chunked_attention(q, k, k)


# ---------------------------------------------------------------------------
# the backward (kernel 13b's plain version) and the log-sum-exp
# ---------------------------------------------------------------------------

def _fold(g, kv):
    """A gradient over tiled heads (B, S, H, hd) summed to the KV heads:
    tiled head r * KV + j reads KV head j."""
    b, s, h, hd = g.shape
    return g.reshape(b, s, h // kv, kv, hd).sum(2)


BWD_CASES = [  # sq, sk, h, kv, causal, q_offset
    (96, 96, 4, 2, True, 0), (96, 96, 4, 4, False, 0),
    (37, 101, 4, 1, True, 64), (70, 70, 3, 3, True, 0),
    (64, 128, 4, 2, False, 0), (1, 77, 2, 1, True, 76)]


@pytest.mark.parametrize("sq,sk,h,kv,causal,q_offset,hd", [
    c + (hd,) for c, hd in zip(BWD_CASES, (32, 64, 128, 32, 64, 128))])
def test_bwd_plain_matches_reference_vjp(sq, sk, h, kv, causal, q_offset,
                                         hd):
    """``flash_attention_bwd_plain`` (from the plain forward's o and lse)
    against ``jax.vjp`` of the reference's ``chunked_attention`` on the
    tiled k/v, its k/v gradients summed to the KV heads: GQA, causal and
    full, a q offset, ragged lengths, each case at one of the head dims
    (the next test takes every case at every head dim); fp32 as
    ``assert_close``."""
    rng = np.random.default_rng(hd + sq + sk + kv)
    q, k, v = _qkv(rng, 2, sq, sk, h, hd, kv=kv)
    do = rng.normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: j_chunked(
        a, b, c, causal=causal, q_chunk=32, kv_chunk=64, q_offset=q_offset),
        jnp.asarray(q), j_tile_kv(jnp.asarray(k), h),
        j_tile_kv(jnp.asarray(v), h))
    rq, rk, rv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      q_offset=q_offset, return_lse=True)
    dq, dk, dv = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                              causal=causal,
                                              q_offset=q_offset)
    assert dk.shape == tk.shape and dv.shape == tv.shape
    assert_close(dq.numpy(), rq)
    assert_close(dk.numpy(), _fold(rk, kv))
    assert_close(dv.numpy(), _fold(rv, kv))


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,h,kv,causal,q_offset", BWD_CASES)
def test_bwd_plain_matches_autograd_of_plain(hd, sq, sk, h, kv, causal,
                                             q_offset):
    """The plain backward against torch autograd through the plain
    forward in float64 (the same function differentiated op by op), and
    ``flash_attention``'s autograd Function on CPU tensors against both;
    fp32 as ``assert_close``."""
    rng = np.random.default_rng(100 + hd + sq + kv)
    q, k, v = _qkv(rng, 1, sq, sk, h, hd, kv=kv)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    x64 = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention_plain(*x64, causal=causal, q_offset=q_offset)
    ref = torch.autograd.grad(out, x64, do.double())
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      q_offset=q_offset, return_lse=True)
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, do,
                                         causal=causal, q_offset=q_offset)
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fa.flash_attention(*xs, causal=causal, q_offset=q_offset).backward(do)
    for a, b, c in zip(plain, (x.grad for x in xs), ref):
        assert_close(a.numpy(), c.double().numpy())
        assert np.array_equal(a.numpy(), b.numpy())


def test_lse_is_log_sum_exp_of_scaled_scores():
    """The plain version's lse: log sum_j exp(q.k_j / sqrt(hd)) over the
    visible keys, in float64 (the units kernel 13b exponentiates)."""
    rng = np.random.default_rng(40)
    q, k, v = _qkv(rng, 1, 50, 80, 2, 32, kv=1)
    _, lse = fa.flash_attention_plain(*(torch.from_numpy(a)
                                        for a in (q, k, v)),
                                      causal=True, q_offset=30,
                                      return_lse=True)
    s = np.einsum("bqhd,bshd->bhqs", q.astype(np.float64),
                  np.repeat(k, 2, axis=2).astype(np.float64)) / np.sqrt(32)
    vis = (30 + np.arange(50))[:, None] >= np.arange(80)[None, :]
    s = np.where(vis[None, None], s, -np.inf)
    ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    assert lse.shape == (1, 2, 50) and lse.dtype == torch.float32
    assert_close(lse.numpy(), ref)


def test_bf16_backward_keeps_dtypes():
    """bf16 q/k/v: the plain backward's gradients come back in bf16, at
    their inputs' shapes (k/v at the KV heads)."""
    rng = np.random.default_rng(41)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 1, 40, 40, 4, 64, kv=2))
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, torch.ones_like(o))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    """On a (monkeypatched) card tensor the backward wrapper raises before
    any launch on a head dim the kernel lacks, an lse of the wrong shape or
    dtype, or an o whose dtype differs from q's."""
    monkeypatch.setattr(fa, "_on_card", lambda *ts: True)

    def no_launch(*a, **k):
        raise AssertionError("launched")
    monkeypatch.setattr(fa, "_call", no_launch)
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    before = fa.flash_attention_bwd.launches
    for args, what in (
            ((q[..., :48], q[..., :48], q[..., :48], q[..., :48], lse,
              q[..., :48]), "head dim"),
            ((q, q, q, q, lse[:, :, :4], q), "lse"),
            ((q, q, q, q, lse.double(), q), "lse"),
            ((q, q, q, q.float(), lse, q), "do not fit")):
        with pytest.raises(ValueError, match=what):
            fa.flash_attention_bwd(*args)
    assert fa.flash_attention_bwd.launches == before


def _bwd_tensor_core_scheme(q, k, v, o, lse, do, causal, q_offset,
                            split=True):
    """Kernel 13b's bf16 arithmetic in plain torch: bf16 q/k/v/dO, fp32
    sums (S, dP, D, the products), P = exp2(S scale log2 e - lse log2 e)
    and dS = P (dP - D) in fp32, then each as bf16 hi + bf16 lo (``split``)
    or one bf16 rounding into dV = P^T dO, dK = dS^T Q scale and
    dQ = dS K scale; dK/dV folded to the KV heads in fp32, then rounded."""
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    kt, vt = (t.repeat(1, 1, h // n_kv, 1).float() for t in (k, v))
    qf, dof = q.float(), do.float()
    scale, log2e = 1.0 / hd ** 0.5, 1.4426950408889634
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    s = torch.einsum("bqhd,bshd->bhqs", qf, kt)
    p = torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None])
    if causal:
        vis = (q_offset + torch.arange(sq))[:, None] >= torch.arange(sk)
        p = torch.where(vis, p, torch.zeros(()))
    ds = p * (torch.einsum("bqhd,bshd->bhqs", dof, vt) - delta[..., None])

    def operand(x):
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float() if split else hi
    p, ds = operand(p), operand(ds)
    dv = torch.einsum("bhqs,bqhd->bshd", p, dof)
    dq = torch.einsum("bhqs,bshd->bqhd", ds, kt) * scale
    dk = torch.einsum("bhqs,bqhd->bshd", ds, qf) * scale
    fold = lambda t: t.reshape(b, sk, h // n_kv, n_kv, hd).sum(2)
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def _bf16_bwd_case(hd, sq, sk, h, kv, causal, q_offset):
    """Seeded bf16 q/k/v/dO, the plain forward's o and lse, and the plain
    backward's gradients."""
    rng = np.random.default_rng(hd + sq + sk + kv)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 2, sq, sk, h, hd, kv=kv))
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)) \
        .to(torch.bfloat16)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                      q_offset=q_offset, return_lse=True)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                       q_offset=q_offset)
    return (q, k, v, o, lse, do), ref


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,h,kv,causal,q_offset", BWD_CASES)
def test_bwd_hi_lo_scheme_within_one_bf16_ulp(hd, sq, sk, h, kv, causal,
                                              q_offset):
    """P and dS carried as bf16 hi + lo (kernel 13b's bf16 kernels) keep
    dq, dk and dv within the card test's limit of the plain version
    (``assert_bf16_close``: one bf16 ulp plus the fp32 slack)."""
    args, ref = _bf16_bwd_case(hd, sq, sk, h, kv, causal, q_offset)
    got = _bwd_tensor_core_scheme(*args, causal, q_offset)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert_bf16_close(a.float().numpy(), b.float().numpy(), name)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,h,kv,causal,q_offset", BWD_CASES)
def test_bwd_single_bf16_rounding_exceeds_the_limit(hd, sq, sk, h, kv,
                                                    causal, q_offset):
    """One bf16 rounding of P and dS (a single tensor-core pass each)
    leaves at least one of dq, dk, dv beyond that limit: the reason the
    kernels pay a second pass for every product that takes P or dS."""
    args, ref = _bf16_bwd_case(hd, sq, sk, h, kv, causal, q_offset)
    got = _bwd_tensor_core_scheme(*args, causal, q_offset, split=False)
    with pytest.raises(AssertionError, match="beyond one bf16 ulp"):
        for a, b in zip(got, ref):
            assert_bf16_close(a.float().numpy(), b.float().numpy())
