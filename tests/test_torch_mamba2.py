"""The port's Mamba-2 SSD core against the reference's, on the CPU.

``causal_conv1d`` and ``causal_conv1d_step`` (fp32 and bf16),
``ssd_chunked`` (against the reference and its float64 sequential
recurrence, ``tests/test_mamba2.py``'s oracle), ``ssd_decode_step``,
``mamba2_block`` in its three modes, ``init_ssm_cache``, the chunk-256
case where the reference's gradient is NaN and the port's is finite and
matches a float64 oracle's, and on the reduced mamba2-1.3b LM a decode
from a zero cache against a prefill of each prefix.  All inputs are
seeded numpy.  fp32 tolerances as ``_torch_port.assert_close`` (rtol 1e-5,
atol 1e-5 scaled by the magnitude); the block's bf16 output as far from
its fp32 output (relative L2) as the reference's bf16 is, times 1.25,
plus 1e-3.  At chunk 256 the two fp32 forwards differ by up to 3.4e-6
relative L2 because the reference's cumsum (a parallel prefix) rounds
differently from a sequential one (4.6e-5 apart on a 256-step sum), and
both are ~2.3e-6 from the float64 oracle: there the port is held within
1e-5 of the reference and within 1.25x the reference's own distance from
the oracle."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.lm import mamba2 as jm2
from repro.models.lm.model import build_lm as j_build_lm
from repro_torch.configs import base as tbase
from repro_torch.models.lm import mamba2 as tm2
from repro_torch.models.lm import serve
from repro_torch.models.lm.model import LM
from repro_torch.serve.engine import ServeEngine
from _torch_port import assert_close
from test_mamba2 import naive_ssd


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ssd_inputs(seed, s, b=2, h=3, p=4, n=5, a_scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, h)).astype(np.float32),
            (rng.normal(size=(h,)) * a_scale).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32))


# ---------------------------------------------------------------------------
# the conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_reference(dtype):
    """The full conv in the activation dtype; bf16 within one bf16
    rounding of the reference's (2^-7 relative, 1e-2 absolute)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 6)).astype(np.float32)
    w = rng.normal(size=(tm2.CONV_K, 6)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    ref = jm2.causal_conv1d(*(jnp.asarray(a, getattr(jnp, dtype))
                              for a in (x, w, bias)))
    out = tm2.causal_conv1d(*(_t(a).to(getattr(torch, dtype))
                              for a in (x, w, bias)))
    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert_close(out.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2.0 ** -7, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_step_matches_reference(dtype):
    """One-token steps from a zero window: the output (fp32 inside, cast
    back) and the window after each step."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 5)).astype(np.float32)
    w = rng.normal(size=(tm2.CONV_K, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    js = jnp.zeros((2, tm2.CONV_K - 1, 5), jd)
    ts = torch.zeros((2, tm2.CONV_K - 1, 5), dtype=td)
    for t in range(6):
        jo, js = jm2.causal_conv1d_step(jnp.asarray(x[:, t:t + 1], jd), js,
                                        jnp.asarray(w, jd),
                                        jnp.asarray(bias, jd))
        to, ts = tm2.causal_conv1d_step(_t(x[:, t:t + 1]).to(td), ts,
                                        _t(w).to(td), _t(bias).to(td))
        assert to.dtype == td
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js, np.float32))
        if dtype == "float32":
            assert_close(to.numpy(), np.asarray(jo), f"step {t}")
        else:
            np.testing.assert_allclose(to.float().numpy(),
                                       np.asarray(jo, np.float32),
                                       rtol=2.0 ** -7, atol=1e-2)


# ---------------------------------------------------------------------------
# the SSD core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 16), (32, 8), (12, 12),
                                     (8, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    """y and the final state against the reference's and the float64
    recurrence (the oracle at its tolerance, 2e-4)."""
    ins = _ssd_inputs(s * chunk, s)
    ry, rs = jm2.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    y, st = tm2.ssd_chunked(*map(_t, ins), chunk=chunk)
    assert_close(y.numpy(), np.asarray(ry))
    assert_close(st.numpy(), np.asarray(rs))
    oy, ost = naive_ssd(*ins)
    np.testing.assert_allclose(y.numpy(), oy, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.numpy(), ost, rtol=2e-4, atol=2e-4)


def test_ssd_chunked_initial_state_matches_reference():
    ins = _ssd_inputs(3, 16)
    s0 = np.random.default_rng(4).normal(size=(2, 3, 4, 5)).astype(np.float32)
    ry, rs = jm2.ssd_chunked(*map(jnp.asarray, ins), chunk=4,
                             initial_state=jnp.asarray(s0))
    y, st = tm2.ssd_chunked(*map(_t, ins), chunk=4, initial_state=_t(s0))
    assert_close(y.numpy(), np.asarray(ry))
    assert_close(st.numpy(), np.asarray(rs))


def test_ssd_chunk_must_divide():
    """A sequence longer than the chunk that the chunk does not divide
    raises (the reference fails at a reshape); nothing is padded."""
    with pytest.raises(ValueError, match="chunks of 5"):
        tm2.ssd_chunked(*map(_t, _ssd_inputs(5, 12)), chunk=5)


def test_ssd_decode_step_matches_reference():
    """Eight recurrence steps from a zero state: each y and state, and the
    steps together equal to the chunked form over the same tokens."""
    ins = _ssd_inputs(6, 8)
    x, bm, cm, dt, a_log, d_skip = ins
    jst = jnp.zeros((2, 3, 4, 5))
    st = torch.zeros(2, 3, 4, 5)
    ys = []
    for t in range(8):
        sl = lambda a: a[:, t:t + 1]
        jy, jst = jm2.ssd_decode_step(*(jnp.asarray(sl(a)) for a in
                                        (x, bm, cm, dt)),
                                      jnp.asarray(a_log), jnp.asarray(d_skip),
                                      jst)
        y, st = tm2.ssd_decode_step(*(_t(sl(a)) for a in (x, bm, cm, dt)),
                                    _t(a_log), _t(d_skip), st)
        assert_close(y.numpy(), np.asarray(jy), f"step {t}")
        assert_close(st.numpy(), np.asarray(jst), f"step {t}")
        ys.append(y)
    y_all, st_all = tm2.ssd_chunked(*map(_t, ins), chunk=4)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_all.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.numpy(), st_all.numpy(), rtol=2e-4,
                               atol=2e-4)


def _oracle_f64(x, bm, cm, dt, a_log, d_skip):
    """The sequential recurrence of tests/test_mamba2.py in float64 torch,
    differentiable."""
    a = -torch.exp(a_log)
    dtp = torch.nn.functional.softplus(dt)
    st = torch.zeros(x.shape[0], x.shape[2], x.shape[3], bm.shape[-1],
                     dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dtp[:, t] * a[None, :])
        upd = torch.einsum("bhp,bn->bhpn", x[:, t] * dtp[:, t][..., None],
                           bm[:, t])
        st = st * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", st, cm[:, t])
                  + x[:, t] * d_skip[None, :, None])
    return torch.stack(ys, 1)


def test_ssd_chunk_256_gradient_finite():
    """The configuration's own chunk (256) at S 512, N(0,1) dt, a_log 0:
    the reference's gradient w.r.t. dt is NaN in every element (exp of the
    unmasked upper triangle overflows); the port's forward is within 1e-5
    relative L2 of the reference's (and as close to the float64 oracle,
    within 1.25x), masking before the exponential changes no forward
    number (bit for bit against exponentiating first), and its gradients
    w.r.t. x, dt, B and C are finite and within 1e-4 relative L2 of the
    float64 oracle's."""
    ins = _ssd_inputs(7, 512, b=2, h=4, p=8, n=16, a_scale=0.0)
    x, bm, cm, dt, a_log, d_skip = ins
    ref_y, _ = jm2.ssd_chunked(*map(jnp.asarray, ins), chunk=256)
    ref_g = jax.grad(lambda d: jm2.ssd_chunked(
        jnp.asarray(x), jnp.asarray(bm), jnp.asarray(cm), d,
        jnp.asarray(a_log), jnp.asarray(d_skip), chunk=256)[0].sum())(
            jnp.asarray(dt))
    assert bool(jnp.isnan(ref_g).all())               # the reference fault

    leaves = [_t(a).requires_grad_(i in (0, 1, 2, 3))
              for i, a in enumerate(ins)]
    y, _ = tm2.ssd_chunked(*leaves, chunk=256)
    oracle_y = _oracle_f64(*(_t(a).double() for a in ins))
    assert _rel(y.detach().numpy(), np.asarray(ref_y)) <= 1e-5
    assert _rel(y.detach().numpy(), oracle_y.numpy()) <= \
        1.25 * _rel(np.asarray(ref_y), oracle_y.numpy())
    g = np.random.default_rng(8).normal(size=y.shape).astype(np.float32)
    grads = torch.autograd.grad(y, leaves[:4], _t(g))
    o_leaves = [_t(a).double().requires_grad_(i < 4)
                for i, a in enumerate(ins)]
    o_grads = torch.autograd.grad(_oracle_f64(*o_leaves), o_leaves[:4],
                                  _t(g).double())
    for name, a, b in zip(("x", "B", "C", "dt"), grads, o_grads):
        assert torch.isfinite(a).all(), name
        assert _rel(a.numpy(), b.numpy()) <= 1e-4, (name, _rel(a, b))

    # the mask before the exponential: the reference's numbers bit for bit
    cum = torch.cumsum(torch.randn(2, 1, 256, 4).abs().neg() * 2, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones(256, 256, dtype=torch.bool))[None, None, :,
                                                             :, None]
    assert torch.equal(torch.exp(torch.where(tri, seg, float("-inf"))),
                       torch.where(tri, torch.exp(seg), 0.0))


# ---------------------------------------------------------------------------
# the block and the cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    """The reduced mamba2-1.3b's first layer with the reference's weights."""
    cfg = jbase.reduced(jbase.get_config("mamba2-1.3b"))
    jlm = j_build_lm(cfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    lp = {k: np.asarray(v[0]) for k, v in jp["layers"].items()}
    # nonzero biases and decays, so each parameter is exercised
    rng = np.random.default_rng(9)
    for k in ("dt_bias", "a_log", "conv_x_b", "conv_b_b", "conv_c_b"):
        lp[k] = (rng.normal(size=lp[k].shape) * 0.3).astype(np.float32)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    return cfg, lp, x


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mamba2_block_matches_reference(block, mode):
    cfg, lp, x = block
    ry, rc = jm2.mamba2_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                               in lp.items()}, cfg, mode=mode)
    y, c = tm2.mamba2_block(_t(x), {k: _t(v) for k, v in lp.items()}, cfg,
                            mode=mode)
    assert_close(y.numpy(), np.asarray(ry))
    if mode == "train":
        assert c is None and rc is None
        return
    for k in tm2.SSMCache._fields:
        assert_close(getattr(c, k).numpy(), np.asarray(getattr(rc, k)), k)


def test_mamba2_block_decode_matches_reference(block):
    """Prefill 16 tokens, then decode 16 one at a time: each output and the
    cache after each step against the reference's."""
    cfg, lp, x = block
    jp = {k: jnp.asarray(v) for k, v in lp.items()}
    tp = {k: _t(v) for k, v in lp.items()}
    _, rc = jm2.mamba2_block(jnp.asarray(x[:, :16]), jp, cfg, mode="prefill")
    _, c = tm2.mamba2_block(_t(x[:, :16]), tp, cfg, mode="prefill")
    for t in range(16, 32):
        ry, rc = jm2.mamba2_block(jnp.asarray(x[:, t:t + 1]), jp, cfg,
                                  mode="decode", cache=rc)
        y, c = tm2.mamba2_block(_t(x[:, t:t + 1]), tp, cfg, mode="decode",
                                cache=c)
        assert_close(y.numpy(), np.asarray(ry), f"token {t}")
        for k in tm2.SSMCache._fields:
            assert_close(getattr(c, k).numpy(), np.asarray(getattr(rc, k)),
                         f"token {t} {k}")


def test_mamba2_block_bf16_close_to_reference(block):
    cfg, lp, x = block
    jp = {k: jnp.asarray(v) for k, v in lp.items()}
    f32, _ = jm2.mamba2_block(jnp.asarray(x), jp, cfg)
    ry, _ = jm2.mamba2_block(jnp.asarray(x, jnp.bfloat16), jp, cfg)
    y, _ = tm2.mamba2_block(_t(x).bfloat16(), {k: _t(v) for k, v in
                                               lp.items()}, cfg)
    assert y.dtype == torch.bfloat16
    ours, theirs = _rel(y.float().numpy(), f32), _rel(
        np.asarray(ry, np.float32), f32)
    assert ours <= 1.25 * theirs + 1e-3, (ours, theirs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssm_cache_matches_reference(dtype):
    cfg = SimpleNamespace(ssm_expand=2, d_model=24, ssm_state=8,
                          ssm_head_dim=6)
    ref = jm2.init_ssm_cache(3, cfg, getattr(jnp, dtype))
    ours = tm2.init_ssm_cache(3, cfg, getattr(torch, dtype), device="cpu")
    for k in tm2.SSMCache._fields:
        a, r = getattr(ours, k), getattr(ref, k)
        assert tuple(a.shape) == r.shape and not a.any()
        assert str(a.dtype)[6:] == str(r.dtype), k


# ---------------------------------------------------------------------------
# the reduced mamba2-1.3b LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssm_lm():
    jlm = j_build_lm(jbase.reduced(jbase.get_config("mamba2-1.3b")))
    jp = jlm.init(jax.random.PRNGKey(0))
    lm = LM.from_jax_params(tbase.reduced(tbase.get_config("mamba2-1.3b")),
                            jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(1).integers(0, lm.cfg.vocab, (2, 16))
    return lm, _t(tokens).long()


def test_decode_from_zero_cache_matches_prefill(ssm_lm):
    """Decode every token from a zero cache; after each, the logits and
    the whole cache match a prefill over that prefix (the reference's
    teacher-forcing property; 2e-4, the recurrence against the chunked
    form)."""
    lm, tok = ssm_lm
    p = lm.params()
    cache = serve.cache_zeros(lm, 2, 16)
    for pos in range(16):
        cache, lg = serve.decode_step(lm, p, cache, tok[:, pos:pos + 1], pos)
        if pos >= 3:
            ref_c, ref = serve.prefill(lm, p, tok[:, :pos + 1])
            np.testing.assert_allclose(lg.numpy(), ref.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=f"pos {pos}")
            for k, v in ref_c.items():
                np.testing.assert_allclose(cache[k].numpy(), v.numpy(),
                                           rtol=2e-4, atol=2e-4,
                                           err_msg=f"pos {pos} {k}")


def test_decode_ignores_pos(ssm_lm):
    lm, tok = ssm_lm
    p = lm.params()
    outs = []
    for pos in (0, 7, torch.tensor([3, 9])):
        cache, _ = serve.prefill(lm, p, tok)
        outs.append(serve.decode_step(lm, p, cache, tok[:, :1], pos)[1])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_serve_engine_refuses_recurrent_cache(ssm_lm):
    """A reused slot would keep the previous request's state: the engine
    raises citing ROADMAP.md instead."""
    lm, _ = ssm_lm
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(lm, lm.params(), max_batch=2, s_max=16, device="cpu")
