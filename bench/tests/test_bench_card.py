"""On the card: a tiny search cell through the harness is correct, and its
control (the reference in bfloat16) is not.  Skips without a card."""
import pytest
import torch

from bench import harness
from bench.reference import sw as ref
from bench.tests import tiny


@pytest.mark.gpu
def test_tiny_search_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ov = tiny.overrides("sw-swissprot-search")
    ov["traffic"]["query_lengths"] = [300, 1100]        # the warp and the block kernel
    out = harness.run_cell("sw-swissprot-search", 2**31 + 11, 0.5, False, t_process=0.0,
                           device=torch.device("cuda", 0), overrides=ov, log=lambda s: None)
    assert out["correct"] and out["attempted"] >= 2
    q = torch.randint(0, 20, (400,), device="cuda", dtype=torch.int32)
    subj = torch.stack([q, torch.randint(0, 20, (400,), device="cuda", dtype=torch.int32)])
    lens = torch.tensor([400, 400], device="cuda")
    exact = ref.sw_scores([q], [(5.0, 2.0)], subj, lens)
    low = ref.sw_scores([q], [(5.0, 2.0)], subj, lens, dtype=torch.bfloat16)
    assert ref.worst_gap(low.float(), exact) > 0
