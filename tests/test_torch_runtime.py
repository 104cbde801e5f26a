"""The port's runtime substrate against the JAX package, on the CPU: the
streaming pipeline's determinism, checkpoints (round trip, the async
writer's garbage collection, restore onto another device, a snapshot that
in-place updates cannot reach, the on-disk layout that both packages
read), restart after an injected failure, and a loss that falls on
learnable data.  The port's counterparts of ``tests/test_runtime.py``'s
pipeline, checkpoint and training tests."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import init_params as jinit
from repro.optim import adamw_init as jadamw_init
from repro.runtime import checkpoint as jckpt
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.data import SyntheticLM, make_batch_stream
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.runtime import (AsyncCheckpointer, FaultTolerantRunner,
                                 Heartbeat, latest_step, restore, save_sync)
from repro_torch.tree import tree_leaves_with_path

from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


# -- data pipeline -----------------------------------------------------------
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "musicgen-medium",
                                  "llama-3.2-vision-90b"])
def test_synthetic_batches_equal_the_reference_bit_for_bit(arch):
    a = SyntheticLM(ARCHS[arch].smoke(), batch=2, seq=8, seed=42)(7)
    b = JSyntheticLM(JARCHS[arch].smoke(), batch=2, seq=8, seed=42)(7)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_pipeline_deterministic_replay():
    cfg = ARCHS["phi3-mini-3.8b"].smoke()
    src = SyntheticLM(cfg, batch=2, seq=8, seed=42)
    np.testing.assert_array_equal(src(7)["tokens"], src(7)["tokens"])
    # stream from step 3 matches direct source calls
    pipe = make_batch_stream(cfg, 2, 8, seed=42, start_step=3, n_steps=4)
    got = list(pipe)
    assert [s for s, _ in got] == [3, 4, 5, 6]
    np.testing.assert_array_equal(got[0][1]["tokens"], src(3)["tokens"])


def test_pipeline_labels_are_shifted_tokens():
    cfg = ARCHS["phi3-mini-3.8b"].smoke()
    b = SyntheticLM(cfg, batch=2, seq=8, seed=0)(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# -- checkpointing ------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "nested": {"b": torch.ones(5, dtype=torch.bfloat16)},
             "step": torch.tensor(7, dtype=torch.int32)}
    save_sync(state, 7, str(tmp_path))
    assert latest_step(str(tmp_path)) == 7
    got = restore(state, str(tmp_path))
    assert torch.equal(got["w"], state["w"])
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32


def test_async_checkpointer_writes_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in [10, 20, 30, 40]:
        ck.save({"x": torch.full((4,), float(s))}, s)
    ck.wait()
    ck.close()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [30, 40]  # older ones garbage-collected
    got = restore({"x": torch.zeros(4)}, str(tmp_path))
    assert torch.equal(got["x"], torch.full((4,), 40.0))


def test_restore_onto_another_device(tmp_path):
    """Elastic restart: the reference restores with the target shardings;
    the port places every leaf on the ``device`` given, here from a
    template that lives on no device at all (``meta``)."""
    state = {"w": torch.arange(8.0)}
    save_sync(state, 1, str(tmp_path))
    template = {"w": torch.empty(8, device="meta")}
    got = restore(template, str(tmp_path), device=CPU)
    assert got["w"].device.type == "cpu"
    assert torch.equal(got["w"], torch.arange(8.0))


def test_checkpoint_is_a_snapshot_of_the_state_at_save(tmp_path):
    """The port's steps update the state in place: what ``save`` enqueued
    must not see the updates that follow it."""
    w = torch.zeros(1000)
    ck = AsyncCheckpointer(str(tmp_path))
    saved = {}
    for s in range(1, 6):
        w.add_(1.0)
        saved[s] = w.clone()
        ck.save({"w": w}, s)
        w.mul_(100.0)                      # the next step, right away
    ck.wait()
    ck.close()
    for s in range(3, 6):                  # keep=3
        got = restore({"w": w}, str(tmp_path), s)
        assert torch.equal(got["w"], saved[s]), s
    assert not torch.equal(w, saved[5])


def _smoke_state(arch="phi3-mini-3.8b"):
    """The same smoke train state in both packages: {"params", "opt"}."""
    jcfg, cfg = JARCHS[arch].smoke(), ARCHS[arch].smoke()
    jp = jinit(jcfg, jax.random.PRNGKey(1))
    jo = jadamw_init(jp)
    jo = jo._replace(step=jnp.int32(5),
                     mu=jax.tree.map(lambda m: m + 0.25, jo.mu))
    jstate = {"params": jp, "opt": jo}
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = {"params": convert.params_from_numpy(np_state["params"], cfg, device=CPU),
              "opt": convert.opt_state_from_numpy(np_state["opt"], cfg, device=CPU)}
    return jstate, tstate


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _smoke_state()
    jckpt.save_sync(jstate, 5, str(tmp_path))
    got = restore(tstate, str(tmp_path))
    assert int(got["opt"].step) == 5 and got["opt"].step.dtype == torch.int32
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    want = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}
    have = dict(tree_leaves_with_path(got))
    assert have.keys() == want.keys()
    for key, g in have.items():
        assert g.dtype == dict(tree_leaves_with_path(tstate))[key].dtype, key
        np.testing.assert_array_equal(g.float().numpy(),
                                      want[key].astype(np.float32), err_msg=key)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = _smoke_state()
    save_sync(tstate, 5, str(tmp_path))
    got = jckpt.restore(jstate, str(tmp_path))
    assert int(got["opt"].step) == 5
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))
    with np.load(os.path.join(tmp_path, "step_000000005", "arrays.npz")) as z:
        keys = set(z.files)
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    assert keys == {jax.tree_util.keystr(p) for p, _ in flat}


def test_fault_tolerant_runner_replays_from_the_last_checkpoint(tmp_path):
    """A step that fails once: the runner restores the last checkpoint
    (every 2 steps) and replays, so each step's update lands exactly once
    although the state is updated in place."""
    state = {"x": torch.zeros(3)}
    calls = []

    def step_fn(st, step):
        calls.append(step)
        st["x"].add_(float(step))
        if step == 5 and calls.count(5) == 1:
            raise RuntimeError("injected")
        return st

    runner = FaultTolerantRunner(str(tmp_path), ckpt_every=2)
    out = runner.run(step_fn, state, 0, 8)
    assert runner.restarts == 1
    assert calls == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert torch.equal(out["x"], torch.full((3,), float(sum(range(8)))))
    hb = Heartbeat(["emitter", "collector"], timeout=60.0)
    hb.beat("emitter")
    assert hb.dead() == []


# -- fault tolerance: end-to-end train with injected failure -------------------
def test_train_restarts_from_checkpoint_after_failure(tmp_path):
    cfg = ARCHS["mamba2-130m"].smoke()
    kw = dict(steps=20, batch=2, seq=16, seed=3, device=CPU)
    # run A: uninterrupted 20 steps
    _, losses_a = train(cfg, ckpt_dir=None, **kw)
    # run B: fails at step 12, restarts from the checkpoint at 10, finishes
    ckpt = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected"):
        train(cfg, ckpt_dir=ckpt, ckpt_every=10, inject_failure_at=12, **kw)
    assert latest_step(ckpt) == 10
    _, losses_b = train(cfg, ckpt_dir=ckpt, ckpt_every=10, **kw)
    assert len(losses_b) == 10
    # deterministic pipeline + restore => identical final loss
    np.testing.assert_allclose(losses_a[-1], losses_b[-1], rtol=1e-4)


def test_train_loss_decreases_on_learnable_data():
    """A tiny model memorises a repeating synthetic stream."""
    cfg = ARCHS["phi3-mini-3.8b"].smoke().replace(vocab_size=64)
    t = np.random.default_rng(0).integers(0, 64, (4, 17), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(t[:, :-1]),
             "labels": torch.from_numpy(t[:, 1:])}    # the SAME batch every step
    params = init_params(cfg, 0, device=CPU)
    opt = adamw_init(params)
    step = make_train_step(cfg, peak_lr=5e-3, warmup=5, total_steps=60)
    losses = []
    for _ in range(60):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])
