"""A run with the timed path broken underneath comes out not correct: the
harness drives the rest of a run (no look for a card, tiny sizes on the
CPU) with one fault planted in the program at a time."""
import functools

import pytest
import torch

from bench import harness
from bench.tests import tiny


def _run(cell, seed=123):
    return harness.run_cell(cell, seed, 0.3, False, t_process=0.0,
                            device=torch.device("cpu"), overrides=tiny.overrides(cell),
                            log=lambda s: None)


def _sw_fault(kind, sw_batch):
    first = {}

    @functools.wraps(sw_batch)
    def broken(profile, subjects, lengths=None, **kw):
        out = sw_batch(profile, subjects, lengths, **kw).clone()
        if kind == "answer_altered":
            out[0] += 1
        elif kind == "half_batch_left_out":
            out[out.shape[0] // 2:] = 0
        elif kind == "state_unchanged":      # every search returns the first's
            out = first.setdefault(subjects.data_ptr(), out)
        return out
    return broken


@pytest.mark.parametrize("kind", ["answer_altered", "half_batch_left_out", "state_unchanged",
                                  "chunks_out_of_order"])
def test_search_fault_is_not_correct(kind, monkeypatch):
    from repro_torch import core
    from repro_torch.kernels import smith_waterman as sw
    assert _run("sw-swissprot-search")["correct"]
    if kind == "chunks_out_of_order":
        wait = core.TaskFarm.run_and_wait
        monkeypatch.setattr(core.TaskFarm, "run_and_wait", lambda self: wait(self)[::-1])
    else:
        monkeypatch.setattr(sw, "sw_batch", _sw_fault(kind, sw.sw_batch))
    out = _run("sw-swissprot-search")
    assert not out["correct"] and out["checks"]["score_gap"]["value"] != 0


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch_left_out", "second_moment_b2"])
def test_train_fault_is_not_correct(kind, monkeypatch):
    from repro_torch.launch import steps, train as train_mod
    if kind == "second_moment_b2":     # an optimizer that decays nu at another rate
        monkeypatch.setattr(steps, "adamw_update",
                            functools.partial(steps.adamw_update, b2=0.99))
        out = _run("phi3-train-4k")
        assert not out["correct"] and out["checks"]["nu_gap"]["value"] > 0.1
        return
    make = steps.make_train_step

    def broken_make(cfg, **kw):
        step = make(cfg, **kw)

        def broken(params, opt, batch):
            if kind == "half_batch_left_out":
                half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
                return step(params, opt, half)
            loss, metrics, _ = steps.loss_and_grads(params, batch, cfg)
            return params, opt, {"loss": loss, "lr": torch.zeros(()), **metrics,
                                 "grad_norm": torch.zeros(())}
        return broken

    monkeypatch.setattr(train_mod, "make_train_step", broken_make)
    out = _run("phi3-train-4k")
    assert not out["correct"]


def test_train_refuses_an_optimizer_block_the_program_does_not_run():
    """The program's ``train`` takes no optimizer settings, so a
    configuration that states others than the program runs is refused."""
    from bench.runners import train
    ov = tiny.overrides("phi3-train-4k")
    ov["config"]["training"]["optimizer"]["weight_decay"] = 0.01
    with pytest.raises(ValueError, match="weight_decay"):
        harness.run_cell("phi3-train-4k", 5, 0.3, False, t_process=0.0,
                         device=torch.device("cpu"), overrides=ov, log=lambda s: None)
    assert train.program_optimizer() == {
        k: v for k, v in tiny.TRAIN["config"]["training"]["optimizer"].items()
        if k not in ("undecayed", "total_steps")}
