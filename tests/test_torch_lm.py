"""The PyTorch port's dense LM against the reference, on the CPU.

Configs and templates (all four dense configs at full size, built on the
meta device: no allocation), the numerics (``rms_norm``, ``head_rms_norm``,
``rope``, ``drelu_grouped``, bf16 CBSR), and, from the reduced qwen3-0.6b
config with the reference's weights carried by ``LM.from_jax_params``:
the SwiGLU FFN with D-ReLU, ``forward``, ``prefill`` (logits and cache),
``decode_step`` at a scalar and at a per-slot ``pos``, decode reproducing
prefill, the sparse decode FFN, and ``ServeEngine`` against the reference
engine; and the MoE, SSM, hybrid (also with a tail), VLM and audio
families from their reduced configs (forward, cache template, prefill,
three decode steps at scalar and per-slot positions, bf16), and
``ServeEngine`` refusing the hybrid, VLM and audio families.  fp32
tolerances as ``_torch_port.assert_close``; where a test
says bf16, one bf16 rounding (2^-7 relative) or, for a whole model whose
two frameworks round at other places, 5e-2 relative L2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core.cbsr import cbsr_from_dense as j_cbsr
from repro.core.drelu import drelu_grouped as j_drelu_grouped
from repro.models.lm import common as jcommon
from repro.models.lm import ffn as jffn
from repro.models.lm import serve as jserve
from repro.models.lm.model import build_lm as j_build_lm
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import base as tbase
from repro_torch.core.cbsr import cbsr_from_dense
from repro_torch.core.drelu import drelu_grouped
from repro_torch.models.lm import common as tcommon
from repro_torch.models.lm import ffn as tffn
from repro_torch.models.lm import serve
from repro_torch.models.lm.model import LM, build_lm
from repro_torch.serve.engine import ServeEngine
from _torch_port import assert_close, lm_extras, nonzero_gates

DENSE = ("qwen3-0.6b", "qwen3-1.7b", "minitron-4b", "minicpm-2b")
# the MoE, SSM, hybrid, VLM and audio families
FAMILIES = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "mamba2-1.3b",
            "zamba2-1.2b", "llama-3.2-vision-90b", "whisper-large-v3")
# the reduced configs of the family tests, and the hybrid with a tail:
# 3 layers at attn_every 2 are one group and a tail of one, so the shared
# block runs twice (``reduced()`` alone gives one group and no tail)
FAMILY_CASES = [pytest.param((a, {}), id=a) for a in FAMILIES] + [
    pytest.param(("zamba2-1.2b", {"n_layers": 3}), id="zamba2-1.2b-tail")]
BF16_RTOL = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# configs and templates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_match_reference(arch):
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    ours, ref = tbase.get_config(arch), jbase.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tbase.reduced(ours)) == \
        dataclasses.asdict(jbase.reduced(ref))
    assert ours.param_count() == ref.param_count()
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
@pytest.mark.parametrize("tp", [1, 16])
def test_templates_match_reference(arch, tp):
    """Full size, compared as specs and as the module's (meta) tensors."""
    ours = LM(tbase.get_config(arch), tp, device="meta")
    ref = j_build_lm(jbase.get_config(arch), tp)
    flat = {}
    for k, v in ref.template.items():
        for n, s in (v.items() if isinstance(v, dict) else [(None, v)]):
            flat[k if n is None else f"{k}.{n}"] = dataclasses.astuple(s)
    mine = {}
    for k, v in ours.template.items():
        for n, s in (v.items() if isinstance(v, dict) else [(None, v)]):
            mine[k if n is None else f"{k}.{n}"] = dataclasses.astuple(s)
    assert mine == flat
    shapes = {k: tuple(t.shape) for k, t in ours.state_dict().items()}
    assert shapes == {k: s[0] for k, s in flat.items()}
    assert (ours.h_pad, ours.kv_pad, ours.v_pad) == \
        (ref.h_pad, ref.kv_pad, ref.v_pad)


@pytest.mark.parametrize("arch,why", [
    ("zamba2-1.2b", "recurrent state"),
    ("llama-3.2-vision-90b", "empty image memory"),
    ("whisper-large-v3", "empty audio memory")])
def test_engine_refuses_family(arch, why):
    """``ServeEngine`` refuses the hybrid (a reused slot keeps its
    recurrent state) and the VLM and audio families (an engine that only
    decodes leaves the cross caches zero), each for its own reason;
    ``build_lm`` builds all three."""
    lm = build_lm(tbase.reduced(tbase.get_config(arch)), device="cpu")
    with pytest.raises(NotImplementedError, match=f"{why}.*ROADMAP"):
        ServeEngine(lm, lm.params(), max_batch=2, s_max=16, device="cpu")


def test_init_follows_template():
    lm = build_lm(tbase.reduced(tbase.get_config("qwen3-0.6b")), device="cpu")
    p = lm.init(torch.Generator().manual_seed(3))
    assert torch.equal(p["final_norm"], torch.ones_like(p["final_norm"]))
    assert torch.equal(p["layers"]["qk_q"], torch.ones_like(p["layers"]["qk_q"]))
    assert abs(float(p["layers"]["wq"].detach().std()) - 0.02) < 2e-3
    again = build_lm(lm.cfg, device="cpu")
    again.init(torch.Generator().manual_seed(3))        # the same draws
    ref = again.state_dict()
    for k, v in lm.state_dict().items():
        assert torch.equal(v, ref[k]), k


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32) * 3
    g = rng.normal(size=(32,)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    for jf, tf in ((jcommon.rms_norm, tcommon.rms_norm),
                   (jcommon.head_rms_norm, tcommon.head_rms_norm)):
        ref = np.asarray(jf(jx, jnp.asarray(g)), np.float32)
        out = tf(tx, _t(g))
        assert out.dtype == tx.dtype
        if dtype == "float32":
            assert_close(out.numpy(), ref)
        else:
            np.testing.assert_allclose(out.float().numpy(), ref,
                                       rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64])
def test_rope_matches_reference(dtype, hd):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    ref = np.asarray(jcommon.rope(jnp.asarray(x, getattr(jnp, dtype)),
                                  jnp.asarray(pos), 1e6), np.float32)
    out = tcommon.rope(_t(x).to(getattr(torch, dtype)), _t(pos), 1e6)
    if dtype == "float32":
        assert_close(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref,
                                   rtol=BF16_RTOL, atol=1e-2)


@pytest.mark.parametrize("groups", [1, 4])
def test_drelu_grouped_matches_reference(groups):
    x = np.random.default_rng(groups).normal(size=(3, 4, 64)).astype(np.float32)
    ref = j_drelu_grouped(jnp.asarray(x), 16, groups)
    assert_close(drelu_grouped(_t(x), 16, groups).numpy(), np.asarray(ref))


def test_cbsr_bf16_matches_reference():
    """bf16 rows rank as ``lax.top_k`` ranks them, ties included."""
    x = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
    x[:, 5] = x[:, 9]                                   # ties
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = j_cbsr(xb, 12)
    ours = cbsr_from_dense(_t(x).to(torch.bfloat16), 12)
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(ours.values.float().numpy(),
                                  np.asarray(ref.values, np.float32))


# ---------------------------------------------------------------------------
# the reduced qwen3-0.6b with the reference's weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg = jbase.reduced(jbase.get_config("qwen3-0.6b"))
    jlm = j_build_lm(jcfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    lm = LM.from_jax_params(tbase.reduced(tbase.get_config("qwen3-0.6b")),
                            jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    return jlm, jp, lm, lm.params(), tokens


def test_from_jax_params_carries_weights(pair):
    jlm, jp, lm, p, _ = pair
    np.testing.assert_array_equal(p["embed"].detach().numpy(), jp["embed"])
    np.testing.assert_array_equal(p["layers"]["wq"].detach().numpy(),
                                  jp["layers"]["wq"])
    assert set(p["layers"]) == set(jp["layers"])


def test_swiglu_ffn_drelu_matches_reference(pair):
    jlm, jp, lm, p, _ = pair
    x = np.random.default_rng(2).normal(size=(2, 7, 128)).astype(np.float32)
    w = [np.asarray(jp["layers"][n][0]) for n in ("w_gate", "w_up", "w_down")]
    k = lm.cfg.drelu_k
    ref = jffn.swiglu_ffn(jnp.asarray(x), *map(jnp.asarray, w), drelu_k=k)
    out = tffn.swiglu_ffn(_t(x), *map(_t, w), drelu_k=k)
    assert_close(out.numpy(), np.asarray(ref))


def test_forward_matches_reference(pair):
    jlm, jp, lm, p, tokens = pair
    ref, _ = jlm.forward(jp, jnp.asarray(tokens))
    with torch.no_grad():
        out, aux = lm(p, _t(tokens).long())
    assert_close(out.numpy(), np.asarray(ref))
    assert float(aux) == 0.0


def test_cache_template_matches_reference(pair):
    jlm, jp, lm, p, _ = pair
    ref = jserve.cache_template(jlm, 3, 24)
    ours = serve.cache_template(lm, 3, 24)
    assert {k: v[:2] for k, v in ours.items()} == \
        {k: v[:2] for k, v in ref.items()}
    assert all(t.shape == ref[k][0] and t.dtype == torch.float32
               for k, t in serve.cache_zeros(lm, 3, 24).items())


def test_prefill_matches_reference(pair):
    jlm, jp, lm, p, tokens = pair
    jc, jl = jserve.prefill(jlm, jp, jnp.asarray(tokens))
    c, lg = serve.prefill(lm, p, _t(tokens).long())
    assert lg.shape == jl.shape and c["k"].shape == jc["k"].shape
    assert_close(lg.numpy(), np.asarray(jl))
    assert_close(c["k"].numpy(), np.asarray(jc["k"]))
    assert_close(c["v"].numpy(), np.asarray(jc["v"]))


def test_prefill_attends_untiled_kv(pair, monkeypatch):
    """The prefill hands kernel 13's entry k/v at their KV heads (2 of 4
    in the reduced qwen3-0.6b), with no tiled copy, and its logits and
    cache still match the reference's."""
    from repro_torch.kernels import flash_attention as tfa
    jlm, jp, lm, p, tokens = pair
    seen, real = [], tfa.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], v.shape[2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    c, lg = serve.prefill(lm, p, _t(tokens).long())
    assert seen == [(lm.cfg.n_heads, lm.cfg.n_kv, lm.cfg.n_kv)] * \
        lm.cfg.n_layers and lm.cfg.n_kv < lm.cfg.n_heads
    jc, jl = jserve.prefill(jlm, jp, jnp.asarray(tokens))
    assert_close(lg.numpy(), np.asarray(jl))
    assert_close(c["k"].numpy(), np.asarray(jc["k"]))
    assert_close(c["v"].numpy(), np.asarray(jc["v"]))


@pytest.mark.parametrize("vector", [False, True])
def test_decode_step_matches_reference(pair, vector):
    """Two decode steps after the prefill: a scalar position, or every
    slot at its own position (the engine's vector ``pos``)."""
    jlm, jp, lm, p, tokens = pair
    jc, _ = jserve.prefill(jlm, jp, jnp.asarray(tokens), s_max=16)
    c, _ = serve.prefill(lm, p, _t(tokens).long(), s_max=16)
    for step, tok in enumerate((tokens[:, -1:], tokens[:, :1])):
        pos = (np.array([15 - step, 3 + step], np.int32) if vector
               else np.int32(15 - step))
        jc, jl = jserve.decode_step(jlm, jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos))
        c, lg = serve.decode_step(lm, p, c, _t(tok).long(),
                                  _t(pos).long() if vector else int(pos))
        assert_close(lg.numpy(), np.asarray(jl), f"step {step}")
        assert_close(c["k"].numpy(), np.asarray(jc["k"]), f"step {step}")
        assert_close(c["v"].numpy(), np.asarray(jc["v"]), f"step {step}")


def test_decode_reproduces_prefill(pair):
    """The invariant of tests/test_serve.py, on the port alone."""
    jlm, jp, lm, p, tokens = pair
    cache, lp = serve.prefill(lm, p, _t(tokens).long())
    _, ld = serve.decode_step(lm, p, cache, _t(tokens[:, -1:]).long(), 15)
    np.testing.assert_allclose(ld.numpy(), lp.numpy(), rtol=2e-3, atol=2e-3)


def test_decode_from_scratch_matches_prefill(pair):
    """Decode every token from a zero cache; each step's logits match a
    prefill over that prefix."""
    jlm, jp, lm, p, tokens = pair
    tok = _t(tokens[:1, :8]).long()
    cache = serve.cache_zeros(lm, 1, 8)
    for pos in range(8):
        cache, lg = serve.decode_step(lm, p, cache, tok[:, pos:pos + 1], pos)
        if pos >= 2:
            _, ref = serve.prefill(lm, p, tok[:, :pos + 1])
            np.testing.assert_allclose(lg.numpy(), ref.numpy(),
                                       rtol=3e-3, atol=3e-3)


def test_sparse_decode_close_to_dense():
    """The CBSR-gather decode FFN == the masked dense FFN (same math), and
    both equal the reference's."""
    rng = np.random.default_rng(0)
    d, f, k = 16, 64, 16
    x = rng.normal(size=(4, 1, d)).astype(np.float32)
    w = [rng.normal(size=s).astype(np.float32) * 0.3
         for s in ((d, f), (d, f), (f, d))]
    dense = tffn.swiglu_ffn(_t(x), *map(_t, w), drelu_k=k)
    sparse = tffn.swiglu_ffn_decode_sparse(_t(x), *map(_t, w), k)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-4)
    ref = jffn.swiglu_ffn_decode_sparse(jnp.asarray(x), *map(jnp.asarray, w), k)
    assert_close(sparse.numpy(), np.asarray(ref))


def test_serve_engine_matches_reference(pair):
    """Three ragged requests on two slots (a queue, slot reuse): the same
    generations as the reference engine, and as each request alone."""
    jlm, jp, lm, p, _ = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, lm.cfg.vocab, n).tolist() for n in (3, 7, 5)]
    ref = JServeEngine(jlm, jp, max_batch=2, s_max=32)
    ours = ServeEngine(lm, p, max_batch=2, s_max=32, device="cpu")
    jr = [ref.submit(q, 6) for q in prompts]
    tr = [ours.submit(q, 6) for q in prompts]
    jo, to = ref.run(), ours.run()
    assert [to[r].generated for r in tr] == [jo[r].generated for r in jr]
    for q, r in zip(prompts, tr):
        alone = ServeEngine(lm, p, max_batch=1, s_max=32, device="cpu")
        rid = alone.submit(q, 6)
        assert alone.run()[rid].generated == to[r].generated


def test_serve_engine_cache_bound(pair):
    jlm, jp, lm, p, _ = pair
    eng = ServeEngine(lm, p, max_batch=1, s_max=8, device="cpu")
    rid = eng.submit([1, 2, 3, 4], 100)
    out = eng.run()
    assert len(out[rid].generated) <= 8


def test_bf16_prefill_close_to_reference():
    """The bf16 config end to end: the same weights give logits within
    5e-2 relative L2 of the reference's bf16 prefill (the frameworks round
    at other places), and decode stays finite."""
    jcfg = dataclasses.replace(jbase.reduced(jbase.get_config("qwen3-0.6b")),
                               dtype="bfloat16")
    jlm = j_build_lm(jcfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    lm = LM.from_jax_params(
        dataclasses.replace(tbase.reduced(tbase.get_config("qwen3-0.6b")),
                            dtype="bfloat16"),
        jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 16))
    jc, jl = jserve.prefill(jlm, jp, jnp.asarray(tokens, jnp.int32))
    c, lg = serve.prefill(lm, lm.params(), _t(tokens).long())
    assert c["k"].dtype == torch.bfloat16 and lg.dtype == torch.float32
    assert _rel_l2(lg.numpy(), jl) < 5e-2
    _, ld = serve.decode_step(lm, lm.params(), c, _t(tokens[:, -1:]).long(), 15)
    assert torch.isfinite(ld).all()


# ---------------------------------------------------------------------------
# the reduced MoE, SSM, hybrid, VLM and audio LMs with the reference's weights
# ---------------------------------------------------------------------------

def _cfg(mod, arch, over, **more):
    return dataclasses.replace(mod.reduced(mod.get_config(arch)), **over,
                               **more)


@pytest.fixture(scope="module", params=FAMILY_CASES)
def fam(request):
    """(reference LM, its weights, the port's LM holding them, its tree,
    tokens (2, 32), the seeded extras as numpy): the VLM's cross gates and
    whisper's GELU biases drawn nonzero."""
    arch, over = request.param
    jlm = j_build_lm(_cfg(jbase, arch, over))
    jp = nonzero_gates(jlm.init(jax.random.PRNGKey(0)), seed=2)
    lm = LM.from_jax_params(_cfg(tbase, arch, over), jp, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, lm.cfg.vocab, (2, 32)).astype(np.int32)
    return jlm, jp, lm, lm.params(), tokens, lm_extras(lm.cfg, (2,), 3)


def _extra(extra, jax_side):
    if not extra:
        return None
    return {k: jnp.asarray(v) if jax_side else _t(v)
            for k, v in extra.items()}


def test_family_from_jax_params_carries_weights(fam):
    """Every subtree (``layers``, and the hybrid's ``shared``, the VLM's
    ``cross``, whisper's ``enc_layers`` / ``enc_norm``) leaf for leaf."""
    jlm, jp, lm, p, _, _ = fam
    assert set(p) == set(jp)
    for name, tree in p.items():
        if not isinstance(tree, dict):
            np.testing.assert_array_equal(tree.detach().numpy(), jp[name])
            continue
        assert set(tree) == set(jp[name]), name
        for k, v in tree.items():
            np.testing.assert_array_equal(v.detach().numpy(), jp[name][k])
    if "cross" in p:
        assert (p["cross"]["gate_attn"] != 0).all()


def test_family_forward_matches_reference(fam):
    """Hidden states and the aux loss (MoE: the layers' load-balance sum;
    the others: 0)."""
    jlm, jp, lm, p, tokens, extra = fam
    ref, ref_aux = jlm.forward(jp, jnp.asarray(tokens), _extra(extra, True))
    with torch.no_grad():
        out, aux = lm(p, _t(tokens).long(), _extra(extra, False))
    assert_close(out.numpy(), np.asarray(ref))
    assert_close(aux.numpy(), np.asarray(ref_aux))
    assert (float(aux) > 0) == (lm.cfg.family == "moe")


def test_family_cache_template_matches_reference(fam):
    jlm, jp, lm, p, _, _ = fam
    ref = jserve.cache_template(jlm, 3, 24)
    ours = serve.cache_template(lm, 3, 24)
    assert {k: v[:2] for k, v in ours.items()} == \
        {k: v[:2] for k, v in ref.items()}
    assert {k: str(v[2])[6:] for k, v in ours.items()} == \
        {k: np.dtype(v[2]).name for k, v in ref.items()}
    zeros = serve.cache_zeros(lm, 3, 24)
    assert all(tuple(t.shape) == ref[k][0] and not t.any()
               for k, t in zeros.items())


def test_family_prefill_matches_reference(fam):
    """The last logits and every cache entry (the hybrid's ``sk`` / ``sv``,
    the VLM's and whisper's ``xk`` / ``xv``)."""
    jlm, jp, lm, p, tokens, extra = fam
    jc, jl = jserve.prefill(jlm, jp, jnp.asarray(tokens),
                            _extra(extra, True))
    c, lg = serve.prefill(lm, p, _t(tokens).long(), _extra(extra, False))
    assert lg.shape == jl.shape and set(c) == set(jc)
    assert_close(lg.numpy(), np.asarray(jl))
    for k in c:
        assert c[k].shape == jc[k].shape, k
        assert_close(c[k].numpy(), np.asarray(jc[k]), k)


@pytest.mark.parametrize("vector", [False, True])
def test_family_decode_step_matches_reference(fam, vector):
    """Three decode steps after the prefill (a scalar position, or every
    slot at its own), logits and the whole cache after each (the port
    writes it in place)."""
    jlm, jp, lm, p, tokens, extra = fam
    jc, _ = jserve.prefill(jlm, jp, jnp.asarray(tokens), _extra(extra, True))
    c, _ = serve.prefill(lm, p, _t(tokens).long(), _extra(extra, False))
    for step in range(3):
        tok = tokens[:, step:step + 1]
        pos = (np.array([31 - step, 5 + step], np.int32) if vector
               else np.int32(31 - step))
        jc, jl = jserve.decode_step(jlm, jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos))
        c2, lg = serve.decode_step(lm, p, c, _t(tok).long(),
                                   _t(pos).long() if vector else int(pos))
        assert c2 is c
        assert_close(lg.numpy(), np.asarray(jl), f"step {step}")
        for k in c:
            assert_close(c[k].numpy(), np.asarray(jc[k]), f"step {step} {k}")


def test_family_bf16_prefill_close_to_reference(fam):
    """bf16 end to end: logits within 5e-2 relative L2 of the reference's
    bf16 prefill (the frameworks round at other places), decode finite."""
    _, jp, lm32, _, tokens, extra = fam
    over = {"n_layers": lm32.cfg.n_layers, "dtype": "bfloat16"}
    jlm = j_build_lm(_cfg(jbase, lm32.cfg.name, over))
    lm = LM.from_jax_params(_cfg(tbase, lm32.cfg.name, over), jp,
                            device="cpu")
    jc, jl = jserve.prefill(jlm, jp, jnp.asarray(tokens), _extra(extra, True))
    c, lg = serve.prefill(lm, lm.params(), _t(tokens).long(),
                          _extra(extra, False))
    assert lg.dtype == torch.float32
    assert {k: v.dtype for k, v in c.items()} == {
        k: torch.float32 if k == "state" else torch.bfloat16 for k in c}
    assert _rel_l2(lg.numpy(), jl) < 5e-2
    _, ld = serve.decode_step(lm, lm.params(), c, _t(tokens[:, -1:]).long(),
                              31)
    assert torch.isfinite(ld).all()
