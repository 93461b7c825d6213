"""The port's checkpoints and training loop (repro_torch.checkpoint,
repro_torch.train.loop) on the CPU: the reference's on-disk layout, atomic
commit, garbage collection, async save, bfloat16 leaves, a checkpoint the
reference wrote resumed by the port, TrainLoop resume, the watchdog."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import steps as jax_steps
from repro.train.loop import StragglerWatchdog as JaxStragglerWatchdog
from repro_torch.checkpoint import (CheckpointManager, flatten, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, \
    train_state_from_reference
from repro_torch.data import SyntheticLM
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import ref_order_groups
from repro_torch.train import steps
from repro_torch.train.loop import LoopConfig, StragglerWatchdog, TrainLoop

# a resumed run against the reference's own continuation: the train-step
# tolerances of tests/test_torch_train.py
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-4
OPT_KW = dict(lr=3e-3, total_steps=10, warmup_steps=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (the suite runs several workers,
    and a worker's idle pool threads spinning against the others' slow
    the training's many small operations many times over); restored after
    the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "h": torch.linspace(-2, 2, 5).to(torch.bfloat16)},
            "layers": [{"a": torch.ones(2)}, {"a": torch.zeros(2)}],
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


def test_layout_and_roundtrip(tmp_path):
    """The reference's layout (step_%08d, manifest.json, proc_0.npz,
    COMMIT); a bfloat16 leaf comes back bit for bit with its dtype, or as
    float32 values without a template; the reference reads the file."""
    base = str(tmp_path / "ckpt")
    d = save_checkpoint(base, 123, _tree(), metadata={"loss": 1.5})
    assert os.path.basename(d) == "step_00000123"
    assert sorted(os.listdir(d)) == ["COMMIT", "manifest.json", "proc_0.npz"]
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert man["keys"] == sorted(["params/w", "params/h", "layers/0/a",
                                  "layers/1/a", "step"])
    assert man["dtypes"]["params/h"] == "bfloat16"
    assert latest_step(base) == 123
    got, meta = load_checkpoint(base, 123, _tree())
    assert _equal(got, _tree()) and meta["loss"] == 1.5
    flat, _ = load_checkpoint(base, 123)
    np.testing.assert_array_equal(flat["params/h"],
                                  _tree()["params"]["h"].float().numpy())
    jflat, jmeta = jax_load_checkpoint(
        base, 123, {"params": {"w": jnp.zeros((2, 3))},
                    "layers": [{"a": jnp.zeros(2)}, {"a": jnp.zeros(2)}],
                    "step": jnp.zeros((), jnp.int32)})
    np.testing.assert_array_equal(jflat["params"]["w"],
                                  np.arange(6.0).reshape(2, 3))


def test_atomic_commit_and_shape_check(tmp_path):
    """A torn save (a tmp dir, or a renamed dir without COMMIT) is
    invisible; a template of another shape is refused."""
    base = str(tmp_path / "ckpt")
    save_checkpoint(base, 1, _tree())
    os.makedirs(os.path.join(base, "step_00000002.tmp0"))
    os.makedirs(os.path.join(base, "step_00000003"))
    assert latest_step(base) == 1
    with pytest.raises(FileNotFoundError):
        load_checkpoint(base, 3, _tree())
    wrong = _tree()
    wrong["params"]["w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError):
        load_checkpoint(base, 1, wrong)
    assert latest_step(str(tmp_path / "none")) is None


def test_manager_async_save_gc_and_restore(tmp_path):
    """An async save holds the state as it was when save() returned, even
    when the caller then updates it in place; GC keeps the newest two;
    restore_or_init fills init_fn's tensors in place."""
    base = str(tmp_path / "ckpt")
    mgr = CheckpointManager(base, keep=2, save_every=10)
    state = _tree()
    for step in (10, 20, 30):
        mgr.save(step, state, blocking=False)
        state["params"]["w"].add_(1.0)          # the loop's in-place update
    mgr.wait()
    assert latest_step(base) == 30
    assert sorted(n for n in os.listdir(base)) == ["step_00000020",
                                                   "step_00000030"]
    assert mgr.should_save(40) and not mgr.should_save(41)
    assert not mgr.should_save(0)
    fresh = _tree()
    got, start = mgr.restore_or_init(lambda: fresh)
    assert start == 30 and got["params"]["w"] is fresh["params"]["w"]
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3) + 2.0)
    empty = CheckpointManager(str(tmp_path / "empty"))
    assert empty.restore_or_init(_tree)[1] == 0


def _batch(cfg, step):
    tb = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=4).batch_at(
        step)
    return {"tokens": tb.tokens, "labels": tb.labels}


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains reduced llama3_8b 2 steps and saves; the port
    loads the flat arrays, carries them into its TrainState and continues 3
    steps, equal to the reference's own continuation within the train-step
    tolerances."""
    jcfg, cfg = (jax_get_config("llama3_8b").reduced(),
                 get_config("llama3_8b").reduced())
    base = str(tmp_path / "ref")
    jst = jax_steps.init_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_steps.make_train_step(jcfg, JaxAdamWConfig(**OPT_KW)))
    for s in range(2):
        jst, _ = jstep(jst, jax.tree.map(jnp.asarray, _batch(cfg, s)))
    jax_save_checkpoint(base, 2, jst)
    step, = [latest_step(base)]
    flat, _ = load_checkpoint(base, step)
    st = train_state_from_reference(flat, cfg, device="cpu")
    assert int(st.opt.step) == 2
    pstep = steps.make_train_step(cfg, AdamWConfig(**OPT_KW))
    for s in range(2, 5):
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, _batch(cfg, s)))
        st, m = pstep(st, _batch(cfg, s))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
    want = params_from_reference(jax.tree.map(np.asarray, jst.params), cfg,
                                 device="cpu")
    for a, b in zip((p for g in ref_order_groups(st.params) for p in g),
                    (p for g in ref_order_groups(want) for p in g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_ATOL)


def test_train_loop_resume_equals_uninterrupted_run(tmp_path):
    """A 6-step TrainLoop interrupted after step 3 and resumed (async
    checkpoints every 3 steps) ends bit for bit where the uninterrupted
    6-step run ends; the loss history carries on."""
    cfg = get_config("llama3_8b").reduced()
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=4)
    step_fn = steps.make_train_step(cfg, AdamWConfig(**OPT_KW),
                                    microbatches=2, remat=True)
    init = lambda: steps.init_train_state(cfg, 3, device="cpu")
    logs = []
    run = lambda total, d: TrainLoop(
        step_fn, data, ckpt_dir=d, log_fn=logs.append,
        cfg=LoopConfig(total_steps=total, log_every=1, ckpt_every=3))
    full_loop = run(6, None)
    full = full_loop.run(init)
    base = str(tmp_path / "ckpt")
    run(3, base).run(init)
    assert latest_step(base) == 3
    second = run(6, base)
    resumed = second.run(init)
    assert "[loop] resumed from step 3" in logs
    assert [h["step"] for h in second.history] == [3, 4, 5]
    assert [h["loss"] for h in second.history] == \
        [h["loss"] for h in full_loop.history[3:]]
    assert _equal(resumed, full)
    assert latest_step(base) == 6


def test_watchdog_matches_reference():
    """The same step times give the reference's decisions and events."""
    times = [0.1] * 20 + [0.5, 0.5, 0.5, 0.1, 0.5, 0.05, 0.3, 0.3, 0.3, 0.3]
    ours, ref = StragglerWatchdog(window=16), JaxStragglerWatchdog(window=16)
    got = [ours.observe(i, t) for i, t in enumerate(times)]
    want = [ref.observe(i, t) for i, t in enumerate(times)]
    assert got == want
    assert got[20:23] == ["warn", "warn", "rebalance"] and got[23] is None
    assert [(e.step, e.action) for e in ours.events] == \
        [(e.step, e.action) for e in ref.events]
