"""The controls at a size a test run holds, on the CPU: the reference in
the next lower precision, put in the program's place, fails the cell's
limits (bench/control.py reads the same at the cells' sizes on the card)."""
import torch

from bench import control, harness
from bench.runners import train
from bench.tests import tiny


def test_train_control_in_float8_fails_the_limits():
    env = harness.make_env("phi3-train-4k", 2**31 + 3, 0.0, False, torch.device("cpu"),
                           overrides=tiny.overrides("phi3-train-4k"), log=lambda s: None)
    judged = control.judge(train, train.control(env))
    assert judged.keys() == {"control_fp8", "fault_half_batch"}
    assert not any(r["correct"] for r in judged.values())


def test_search_control_in_bfloat16_fails_the_exact_limit(monkeypatch):
    from bench.runners import sw_search
    monkeypatch.setattr(sw_search, "SAMPLE_SEARCHES", 2)
    monkeypatch.setattr(sw_search, "SAMPLE_SUBJECTS", 64)
    monkeypatch.setattr(sw_search, "LONGEST", 8)
    ov = tiny.overrides("sw-swissprot-search")
    ov["config"]["database"].update(mean_len=300, max_len=600)
    ov["traffic"]["query_lengths"] = [400]
    env = harness.make_env("sw-swissprot-search", 2**31 + 5, 0.0, False, torch.device("cpu"),
                           overrides=ov, log=lambda s: None)
    judged = control.judge(sw_search, sw_search.control(env))
    assert judged["control_bf16"]["score_gap"] > 0 and not judged["control_bf16"]["correct"]
