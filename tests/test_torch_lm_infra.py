"""The port's LM training infrastructure against the reference, on the CPU:
the token pipeline (its arrays equal to the reference's), checkpoints
(``tests/test_infra.py``'s round trip, GC and atomicity, the reference's
file set for the same state, and a checkpoint written by either package
restored into the other's state, bf16 leaves included), and the training
entry point ``launch.train.main`` on ``--device cpu``
(``tests/test_system.py``'s loss-decreases and kill-and-restart tests).
Exact comparisons: every array here is numpy or a stored copy."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models.lm.model import build_lm as j_build_lm
from repro.optim import adamw_init as j_adamw_init
from repro.train import lm_step as jstep
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import main as train_main
from repro_torch.models.lm.model import LM
from repro_torch.optim.adamw import AdamWState, adamw_init, tree_leaves
from repro_torch.train import lm_step
from _torch_port import lm_extras


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,shards", [
    (1000, 32, 8, 4), (50, 16, 2, 1), (151936, 128, 4, 2)])
def test_pipeline_arrays_equal_reference(vocab, seq, batch, shards):
    cfg = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=7,
               n_shards=shards)
    ours = tpipe.TokenPipeline(tpipe.DataConfig(**cfg))
    ref = jpipe.TokenPipeline(jpipe.DataConfig(**cfg))
    np.testing.assert_array_equal(ours.motifs, ref.motifs)
    for step in (0, 5):
        for shard in range(shards):
            a, b = ours.shard_batch(step, shard), ref.shard_batch(step, shard)
            for k in ("tokens", "targets"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        a, b = ours.global_batch(step), ref.global_batch(step)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    it_a, it_b = iter(ours), iter(ref)
    for _ in range(2):
        np.testing.assert_array_equal(next(it_a)["targets"],
                                      next(it_b)["targets"])


def test_pipeline_determinism_and_shifted_targets():
    cfg = tpipe.DataConfig(vocab=1000, seq_len=32, global_batch=8,
                           n_shards=4)
    p1, p2 = tpipe.TokenPipeline(cfg), tpipe.TokenPipeline(cfg)
    b1 = p1.shard_batch(5, 2)
    np.testing.assert_array_equal(b1["tokens"], p2.shard_batch(5, 2)["tokens"])
    assert not np.array_equal(b1["tokens"], p1.shard_batch(5, 3)["tokens"])
    assert not np.array_equal(b1["tokens"], p1.shard_batch(6, 2)["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
    assert b1["tokens"].min() >= 0 and b1["tokens"].max() < 1000


def test_prefetching_loader_matches_pipeline():
    pipe = tpipe.TokenPipeline(tpipe.DataConfig(vocab=100, seq_len=8,
                                                global_batch=2))
    loader = tpipe.PrefetchingLoader(pipe, start_step=3)
    try:
        for step in (3, 4, 5):
            b = loader.next()
            assert b["_step"] == step
            np.testing.assert_array_equal(
                b["tokens"], pipe.global_batch(step)["tokens"])
    finally:
        loader.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """A tree of fp32, bf16 and a tuple, and an int, restored into tensors
    of the same shapes in place, and into meta leaves as new tensors."""
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "nested": {"b": torch.linspace(-3, 3, 4).to(torch.bfloat16)},
             "t": (torch.zeros(()), torch.ones((2,))), "n": 5}
    save_checkpoint(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    like = {"a": torch.empty(2, 3), "nested": {"b": torch.empty(
        4, dtype=torch.bfloat16)}, "t": (torch.empty(()), torch.empty(2)),
        "n": 0}
    restored = restore_checkpoint(str(tmp_path), 7, like)
    assert restored["a"] is like["a"] and restored["n"] == 5
    meta = {"a": torch.empty(2, 3, device="meta"),
            "nested": {"b": torch.empty(4, dtype=torch.bfloat16,
                                        device="meta")},
            "t": (torch.empty((), device="meta"),
                  torch.empty(2, device="meta")), "n": 0}
    for r in (restored, restore_checkpoint(str(tmp_path), 7, meta)):
        for a, b in zip(tree_leaves(state), tree_leaves(r)):
            if isinstance(a, int):
                assert a == b
            else:
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_manager_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    state = {"w": torch.ones((2,))}
    for step in range(5):
        mgr.maybe_save(step, state)
    mgr.finalize()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones((2,))})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_checkpoint_copies_at_save(tmp_path):
    """The async writer sees the state as it was when ``save_checkpoint``
    was called, even if the caller updates it in place right after."""
    w = torch.ones(1000)
    t = save_checkpoint(str(tmp_path), 2, {"w": w}, blocking=False)
    w.add_(1.0)
    t.join()
    out = restore_checkpoint(str(tmp_path), 2, {"w": torch.empty(1000)})
    assert torch.equal(out["w"], torch.ones(1000))


def _states(arch="qwen3-0.6b"):
    """The reference's train state of a reduced config after one AdamW
    step (so m, v and step are not trivial; the VLM and audio families on
    seeded ``image_emb`` / ``frames``) and a fresh port state of the same
    config."""
    jc = jbase.reduced(jbase.get_config(arch))
    jlm = j_build_lm(jc)
    params = jlm.init(jax.random.PRNGKey(1))
    step_fn = jax.jit(jstep.make_train_step(jlm, lr=1e-3, total_steps=10))
    b = tpipe.TokenPipeline(tpipe.DataConfig(vocab=jc.vocab, seq_len=16,
                                             global_batch=2)).global_batch(0)
    b.update(lm_extras(jc, (2,)))
    j_state, _ = step_fn(jstep.TrainState(params, j_adamw_init(params)),
                         {k: jnp.asarray(v) for k, v in b.items()})
    lm = LM(tbase.reduced(tbase.get_config(arch)), device="cpu")
    t_state = lm_step.TrainState(lm.params(), adamw_init(lm.params()))
    return j_state, t_state


def _assert_states_equal(j_state, t_state):
    assert int(j_state.opt.step) == t_state.opt.step
    for j_tree, t_tree in ((j_state.params, t_state.params),
                           (j_state.opt.m, t_state.opt.m),
                           (j_state.opt.v, t_state.opt.v)):
        ja, ta = jax.tree.leaves(j_tree), tree_leaves(t_tree)
        assert len(ja) == len(ta)
        for a, b in zip(ja, ta):
            np.testing.assert_array_equal(np.asarray(a),
                                          b.detach().numpy())


def test_reference_checkpoint_restores_into_port_state(tmp_path):
    """The reference's checkpoint of a train state restores into the
    port's state of the same config, every leaf equal, in place."""
    j_state, t_state = _states()
    j_save(str(tmp_path), 1, j_state)
    embed = t_state.params["embed"]
    restored = restore_checkpoint(str(tmp_path), 1, t_state)
    assert restored.params["embed"] is embed
    assert isinstance(restored.opt, AdamWState)
    _assert_states_equal(j_state, restored)


def test_port_checkpoint_restores_into_reference_state(tmp_path):
    """The port writes the reference's file set for the same state (file
    names, manifest leaves with shape and dtype), and the reference
    restores it leaf for leaf."""
    j_state, t_state = _states()
    j_save(str(tmp_path / "ref"), 1, j_state)
    restore_checkpoint(str(tmp_path / "ref"), 1, t_state)
    save_checkpoint(str(tmp_path / "port"), 1, t_state)
    names = lambda d: sorted(os.listdir(tmp_path / d / "step_1"))
    assert names("port") == names("ref")
    leaves = lambda d: json.loads((tmp_path / d / "step_1" /
                                   "manifest.json").read_text())["leaves"]
    assert leaves("port") == leaves("ref")
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        j_state)
    _assert_states_equal(j_restore(str(tmp_path / "port"), 1, like), t_state)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-1.3b",
                                  "zamba2-1.2b", "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_family_checkpoint_crosses_packages(tmp_path, arch):
    """A MoE (router, stacked experts), an SSM, a hybrid (``shared``), a
    VLM (``cross``) and an audio (``enc_layers``, ``enc_norm``) train
    state: the reference's checkpoint restores into the port's state leaf
    for leaf, the port writes the reference's file set, and the reference
    restores the port's."""
    j_state, t_state = _states(arch)
    j_save(str(tmp_path / "ref"), 1, j_state)
    restored = restore_checkpoint(str(tmp_path / "ref"), 1, t_state)
    _assert_states_equal(j_state, restored)
    save_checkpoint(str(tmp_path / "port"), 1, restored)
    leaves = lambda d: json.loads((tmp_path / d / "step_1" /
                                   "manifest.json").read_text())["leaves"]
    assert leaves("port") == leaves("ref")
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        j_state)
    _assert_states_equal(j_restore(str(tmp_path / "port"), 1, like),
                         restored)


def test_bf16_leaves_cross_packages(tmp_path):
    """bf16 leaves round-trip between the packages through the raw bytes
    (the port has no ml_dtypes: a 16-bit integer view)."""
    x = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    j_save(str(tmp_path / "ref"), 3, {"w": jnp.asarray(x, jnp.bfloat16)})
    out = restore_checkpoint(str(tmp_path / "ref"), 3,
                             {"w": torch.empty(3, 4, dtype=torch.bfloat16)})
    assert torch.equal(out["w"], torch.from_numpy(x).to(torch.bfloat16))
    save_checkpoint(str(tmp_path / "port"), 3, out)
    back = j_restore(str(tmp_path / "port"), 3,
                     {"w": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  np.asarray(jnp.asarray(x, jnp.bfloat16),
                                             np.float32))


# ---------------------------------------------------------------------------
# the training entry point
# ---------------------------------------------------------------------------

def test_lm_training_loss_decreases():
    losses = train_main(["--arch", "qwen3-0.6b", "--reduced",
                         "--steps", "30", "--batch", "4", "--seq", "64",
                         "--lr", "1e-3", "--log-every", "100",
                         "--device", "cpu"])
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-1.3b"])
def test_family_training_loss_decreases(arch):
    """``launch.train.main --reduced`` trains the MoE and the SSM families:
    10 steps at lr 3e-3 (seeded weights and batches), finite losses whose
    last three average below the first three."""
    losses = train_main(["--arch", arch, "--reduced", "--steps", "10",
                         "--batch", "4", "--seq", "64", "--lr", "3e-3",
                         "--log-every", "100", "--device", "cpu"])
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_family_training_runs_with_extras(arch):
    """``launch.train.main --reduced`` on the VLM and audio families: the
    entry point adds zero ``image_emb`` / ``frames`` (the reference's
    ``_maybe_add_extras``, one memory a sequence, also under the
    microbatch split's leading dims) to each batch; 3 steps give finite
    losses."""
    losses = train_main(["--arch", arch, "--reduced", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--log-every",
                         "100", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    from repro_torch.launch.train import _maybe_add_extras
    cfg = tbase.reduced(tbase.get_config(arch))
    batch = {"tokens": torch.zeros((2, 3, 16), dtype=torch.long)}
    _maybe_add_extras(cfg, batch, LM(cfg, device="meta"))
    (name, x), = [(k, v) for k, v in batch.items() if k != "tokens"]
    n = cfg.n_img_tokens if cfg.family == "vlm" else cfg.enc_frames
    assert name == ("image_emb" if cfg.family == "vlm" else "frames")
    assert x.shape == (2, 3, n, cfg.d_model) and not x.any()


def test_lm_checkpoint_restart_continues(tmp_path):
    """Kill-and-restart: the restored run continues from the checkpoint
    (steps 11-15 only), and the restored state is the saved one."""
    d = str(tmp_path / "ckpt")
    args = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2",
            "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "5",
            "--log-every", "100", "--device", "cpu"]
    train_main(args + ["--steps", "11"])
    assert latest_step(d) == 10
    assert sorted(os.listdir(d)) == ["step_0", "step_10", "step_5"]
    losses = train_main(args + ["--steps", "16"])    # restores step 10
    assert len(losses) == 5                           # only 11..15 run
    assert latest_step(d) == 15


def test_grad_accum_and_refusals():
    """``--grad-accum 2`` splits each batch into two microbatches;
    ``--model-parallel`` above 1 and the default card without one raise."""
    losses = train_main(["--reduced", "--steps", "2", "--batch", "4",
                         "--seq", "16", "--grad-accum", "2", "--device",
                         "cpu", "--log-every", "100"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_main(["--reduced", "--model-parallel", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["--reduced", "--steps", "1"])
