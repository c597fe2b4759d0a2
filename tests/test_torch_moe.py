"""The port's MoE FFN against the reference's, on the CPU.

``moe_capacity``, ``_route`` (ties go to the lower expert, as
``lax.top_k``), ``_expert_ffn``, the capacity keep set (compared mask for
mask, with drops and without), ``_moe_local`` (all experts, and the two
halves of an expert split summing to it), ``moe_ffn``'s (y, aux) and its
``jax.vjp`` gradients, the dense no-drop oracle of ``tests/test_moe.py``,
and, on the reduced granite and moonshot LMs, ``ServeEngine`` against the
reference engine.  All inputs are seeded numpy.  fp32 tolerances as
``_torch_port.assert_close`` (rtol 1e-5, atol 1e-5 scaled by the
magnitude); a bf16 output rounded once within one bf16 rounding (2^-7
relative), one that rounds at every product as far from the fp32 result
(relative L2) as the reference's bf16 is, times 1.25, plus 1e-3 (the two
frameworks round at other places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.lm import ffn as jffn
from repro.models.lm.model import build_lm as j_build_lm
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import base as tbase
from repro_torch.models.lm import ffn as tffn
from repro_torch.models.lm.model import LM
from repro_torch.serve.engine import ServeEngine
from _torch_port import assert_close
from test_moe import dense_moe_oracle

BF16_RTOL = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_as_far(out, ref_bf16, ref_f32):
    ours, theirs = _rel(out, ref_f32), _rel(ref_bf16, ref_f32)
    assert ours <= 1.25 * theirs + 1e-3, (ours, theirs)


def _operands(seed, t=32, d=16, f=24, e=8, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t // 2, d)).astype(np.float32) * 0.5
    rw = rng.normal(size=(d, e)).astype(np.float32) * scale
    wg, wu = (rng.normal(size=(e, d, f)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.normal(size=(e, f, d)).astype(np.float32) * 0.3
    return x, rw, wg, wu, wd


def _ref_keep(ids, e_local, e_offset, cap):
    """``_moe_local``'s keep set (src/repro/models/lm/ffn.py:152-162), from
    the reference's routing ids."""
    flat = ids.reshape(-1)
    local = (flat >= e_offset) & (flat < e_offset + e_local)
    el = jnp.where(local, flat - e_offset, e_local)
    onehot = jax.nn.one_hot(el, e_local + 1, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    p = jnp.take_along_axis(pos, el[:, None], axis=1)[:, 0]
    keep = local & (p < cap)
    return (np.asarray(jnp.where(keep, el, e_local)),
            np.asarray(jnp.where(keep, p, cap)), np.asarray(keep))


@pytest.mark.parametrize("t,e,k,cf", [(4096, 32, 8, 1.25), (4096, 64, 6, 1.25),
                                      (8, 64, 6, 1.25), (100, 4, 2, 0.5),
                                      (33, 8, 2, 100.0), (1, 32, 8, 1.25)])
def test_moe_capacity_matches_reference(t, e, k, cf):
    assert tffn.moe_capacity(t, e, k, cf) == jffn.moe_capacity(t, e, k, cf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(dtype):
    """probs (in the activation dtype), ids exactly, full fp32 probs."""
    x, rw, *_ = _operands(0)
    x2d = x.reshape(-1, x.shape[-1])
    jp, ji, jf = jffn._route(jnp.asarray(x2d, getattr(jnp, dtype)),
                             jnp.asarray(rw), 3)
    tp, ti, tf = tffn._route(_t(x2d).to(getattr(torch, dtype)), _t(rw), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tp.dtype == getattr(torch, dtype) and tf.dtype == torch.float32
    assert_close(tf.numpy(), np.asarray(jf))
    if dtype == "float32":
        assert_close(tp.numpy(), np.asarray(jp))
    else:
        np.testing.assert_allclose(tp.float().numpy(),
                                   np.asarray(jp, np.float32),
                                   rtol=BF16_RTOL, atol=1e-6)


def test_route_ties_go_to_the_lower_expert():
    """A zero router makes every expert tie: both pick experts 0..k-1, and
    a tie between experts 5 and 2 picks 2 first."""
    x = np.random.default_rng(1).normal(size=(6, 8)).astype(np.float32)
    rw = np.zeros((8, 8), np.float32)
    _, ji, _ = jffn._route(jnp.asarray(x), jnp.asarray(rw), 3)
    _, ti, _ = tffn._route(_t(x), _t(rw), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() == np.arange(3)).all()
    rw[:, 5] = rw[:, 2] = 1.0
    x = np.abs(x)
    _, ji, _ = jffn._route(jnp.asarray(x), jnp.asarray(rw), 2)
    _, ti, _ = tffn._route(_t(x), _t(rw), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() == [2, 5]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_reference(dtype):
    rng = np.random.default_rng(2)
    buf = rng.normal(size=(4, 8, 16)).astype(np.float32)
    _, _, wg, wu, wd = _operands(2, e=4)
    ref = jffn._expert_ffn(*(jnp.asarray(a, getattr(jnp, dtype))
                             for a in (buf, wg, wu, wd)))
    out = tffn._expert_ffn(*(_t(a).to(getattr(torch, dtype))
                             for a in (buf, wg, wu, wd)))
    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert_close(out.numpy(), np.asarray(ref))
    else:
        f32 = jffn._expert_ffn(*map(jnp.asarray, (buf, wg, wu, wd)))
        _bf16_as_far(out.float().numpy(), np.asarray(ref, np.float32), f32)


@pytest.mark.parametrize("cf,e_offset,e_local", [(100.0, 0, 8), (1.25, 0, 8),
                                                 (0.5, 0, 8), (0.5, 4, 4),
                                                 (1.0, 2, 3)])
def test_keep_masks_match_reference(cf, e_offset, e_local):
    """The capacity keep set, each assignment's expert and slot, equal to
    the reference's exactly: without drops (cf 100), with a few (1.25),
    with many (0.5), and on a shard of the experts."""
    x, rw, *_ = _operands(3, t=64, scale=2.0)
    x2d = x.reshape(-1, x.shape[-1])
    _, ids, _ = jffn._route(jnp.asarray(x2d), jnp.asarray(rw), 2)
    cap = jffn.moe_capacity(x2d.shape[0], 8, 2, cf)
    el, p, keep = _ref_keep(ids, e_local, e_offset, cap)
    _, tids, _ = tffn._route(_t(x2d), _t(rw), 2)
    tel, tp, tkeep = tffn._slots(tids, e_local, e_offset, cap)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(tel.numpy(), el)
    np.testing.assert_array_equal(tp.numpy(), p)
    local = (np.asarray(ids).reshape(-1) >= e_offset) & \
        (np.asarray(ids).reshape(-1) < e_offset + e_local)
    if cf == 100.0:
        assert keep.all()
    elif cf == 0.5:
        assert (~keep & local).sum() > 0              # capacity drops


def test_dispatch_fills_each_slot_once():
    """Every kept assignment's slot holds its token; empty slots are zero;
    dropped assignments write nowhere."""
    x, rw, *_ = _operands(4, t=64, scale=2.0)
    x2d = _t(x.reshape(-1, x.shape[-1]))
    _, ids, _ = tffn._route(x2d, _t(rw), 2)
    cap = tffn.moe_capacity(64, 8, 2, 0.5)
    el, p, keep = tffn._slots(ids, 8, 0, cap)
    buf = tffn._dispatch(x2d, el, p, keep, 8, cap, 2)
    want = torch.zeros(8, cap, x2d.shape[1])
    tok = torch.arange(64).repeat_interleave(2)
    for i in torch.nonzero(keep)[:, 0].tolist():
        want[el[i], p[i]] = x2d[tok[i]]
    assert torch.equal(buf, want)
    assert int(keep.sum()) < keep.numel()


@pytest.mark.parametrize("cf", [100.0, 0.5])
def test_moe_local_matches_reference(cf):
    """All experts at once, and two shards of experts (e_offset 0 and 4)
    whose sum is the whole (the psum identity behind expert parallelism)."""
    ops = _operands(5)
    ref = jffn._moe_local(*map(jnp.asarray, ops), 2, cf, 0, 8)
    out = tffn._moe_local(*map(_t, ops), 2, cf, 0, 8)
    assert_close(out.numpy(), np.asarray(ref))
    x, rw, wg, wu, wd = map(_t, ops)
    halves = sum(tffn._moe_local(x, rw, wg[o:o + 4], wu[o:o + 4],
                                 wd[o:o + 4], 2, cf, o, 8) for o in (0, 4))
    ref_h = sum(jffn._moe_local(*map(jnp.asarray, (ops[0], ops[1])),
                                *(jnp.asarray(w[o:o + 4]) for w in ops[2:]),
                                2, cf, o, 8) for o in (0, 4))
    assert_close(halves.numpy(), np.asarray(ref_h))


def test_moe_matches_dense_oracle():
    """No drops (cf 100): the dense every-expert oracle of tests/test_moe.py
    (rtol / atol 2e-4, its tolerance)."""
    x, rw, wg, wu, wd = _operands(6)
    y = tffn._moe_local(*map(_t, (x, rw, wg, wu, wd)), 2, 100.0, 0, 8)
    ref = dense_moe_oracle(x.reshape(-1, x.shape[-1]), rw, wg, wu, wd, 2)
    np.testing.assert_allclose(y.numpy().reshape(ref.shape), ref,
                               rtol=2e-4, atol=2e-4)


def test_capacity_drops_tokens():
    """tests/test_moe.py's case: every token routes to expert 0, capacity 8
    of 16 assignments; the later tokens are dropped (zero), the kept rows
    equal."""
    t, d, f = 16, 4, 6
    rw = torch.zeros(d, 2)
    rw[:, 0] = 10.0
    y = tffn._moe_local(torch.ones(1, t, d), rw, torch.ones(2, d, f) * 0.1,
                        torch.ones(2, d, f) * 0.1, torch.ones(2, f, d) * 0.1,
                        1, 0.5, 0, 2)[0]
    kept = y.abs().sum(-1) > 0
    assert int(kept.sum()) == tffn.moe_capacity(t, 2, 1, 0.5)
    assert kept[:8].all() and not kept[8:].any()
    assert torch.equal(y[kept], y[kept][:1].expand_as(y[kept]))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_and_grads_match_reference(cf):
    """(y, aux) and the gradients of every operand under seeded cotangents
    of both, against ``jax.vjp`` of the reference's ``moe_ffn``."""
    ops = _operands(7, scale=2.0)
    kw = dict(n_experts=8, top_k=2, capacity_factor=cf)
    (ry, raux), vjp = jax.vjp(lambda *a: jffn.moe_ffn(*a, **kw),
                              *map(jnp.asarray, ops))
    rng = np.random.default_rng(8)
    gy = rng.normal(size=ry.shape).astype(np.float32)
    gaux = np.float32(0.7)
    ref_g = vjp((jnp.asarray(gy), jnp.asarray(gaux)))
    tops = [_t(a).requires_grad_() for a in ops]
    y, aux = tffn.moe_ffn(*tops, **kw)
    assert_close(y.detach().numpy(), np.asarray(ry))
    assert_close(aux.detach().numpy(), np.asarray(raux))
    grads = torch.autograd.grad((y, aux), tops,
                                (_t(gy), torch.tensor(gaux)))
    for name, g, r in zip(("x", "router", "w_gate", "w_up", "w_down"),
                          grads, ref_g):
        assert_close(g.numpy(), np.asarray(r), name)


def test_moe_ffn_bf16_close_to_reference():
    ops = _operands(9)
    kw = dict(n_experts=8, top_k=2, capacity_factor=1.25)
    ry, raux = jffn.moe_ffn(jnp.asarray(ops[0], jnp.bfloat16),
                            jnp.asarray(ops[1]),
                            *(jnp.asarray(a, jnp.bfloat16) for a in ops[2:]),
                            **kw)
    y, aux = tffn.moe_ffn(_t(ops[0]).bfloat16(), _t(ops[1]),
                          *(_t(a).bfloat16() for a in ops[2:]), **kw)
    assert y.dtype == torch.bfloat16
    f32, _ = jffn.moe_ffn(*map(jnp.asarray, ops), **kw)
    _bf16_as_far(y.float().numpy(), np.asarray(ry, np.float32), f32)
    assert_close(aux.numpy(), np.asarray(raux))


# ---------------------------------------------------------------------------
# the serve engine over the reduced MoE LMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "moonshot-v1-16b-a3b"])
def test_serve_engine_matches_reference(arch):
    """Three ragged requests on two slots (a queue, slot reuse; inactive
    slots feed token 0 and compete for capacity, as in the reference):
    the same generations as the reference engine."""
    jlm = j_build_lm(jbase.reduced(jbase.get_config(arch)))
    jp = jlm.init(jax.random.PRNGKey(0))
    lm = LM.from_jax_params(tbase.reduced(tbase.get_config(arch)),
                            jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, lm.cfg.vocab, n).tolist() for n in (3, 7, 5)]
    ref = JServeEngine(jlm, jp, max_batch=2, s_max=32)
    ours = ServeEngine(lm, lm.params(), max_batch=2, s_max=32, device="cpu")
    jr = [ref.submit(q, 6) for q in prompts]
    tr = [ours.submit(q, 6) for q in prompts]
    jo, to = ref.run(), ours.run()
    assert [to[r].generated for r in tr] == [jo[r].generated for r in jr]
