"""Card-only tests of the PyTorch port: the CUDA Smith-Waterman kernel held
against its plain PyTorch version on the card, exactly, and the farm search
launching it once per task.  They carry the ``gpu`` marker and skip where
there is no card.  This file imports neither jax nor the reference package,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import FnNode, TaskFarm
from repro_torch.kernels import ops
from repro_torch.kernels import smith_waterman as sw

pytestmark = pytest.mark.gpu
GAPS = [(10.0, 2.0), (5.0, 2.0)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _codes(rng, n):
    return torch.from_numpy(rng.integers(0, 20, n).astype(np.int32))


@pytest.mark.parametrize("qlen", [1, 144, 1000, 4000])
def test_kernel_equals_plain_on_card(dev, qlen):
    rng = np.random.default_rng(qlen)
    prof, q_len = ops.build_profile(_codes(rng, qlen).to(dev),
                                    ops.BLOSUM50.to(dev))
    lens = [1, 17, 352, 513]
    batch = torch.full((4, 513), 24, dtype=torch.int32)
    for i, n in enumerate(lens):
        batch[i, :n] = _codes(rng, n)
    batch = batch.to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    for go, ge in GAPS:
        got = sw.sw_batch(prof, batch, lengths, gap_open=go, gap_extend=ge,
                          q_len=q_len)
        want = sw.sw_plain(prof, batch, go, ge, q_len)
        assert torch.equal(got, want)


def test_wrapper_refuses_non_contiguous_on_card(dev):
    prof, q_len = ops.build_profile(torch.zeros(5, dtype=torch.int32, device=dev),
                                    ops.BLOSUM50.to(dev))
    subj = torch.zeros((8, 2), dtype=torch.int32, device=dev).T
    with pytest.raises(ValueError, match="contiguous"):
        sw.sw_batch(prof, subj, gap_open=10.0, gap_extend=2.0, q_len=q_len)


def test_sw_search_via_farm_on_card(dev):
    rng = np.random.default_rng(0)
    query = _codes(rng, 144).to(dev)
    db = [_codes(rng, n).to(dev) for n in (2, 352, 700, 2000, 17)]
    before = sw.launch_count()
    farm = TaskFarm(2, preserve_order=True)
    farm.add_stream(db)
    farm.add_worker(FnNode(lambda s: float(ops.smith_waterman(query, s))))
    got = farm.run_and_wait()
    assert sw.launch_count() - before == len(db)
    prof, q_len = ops.build_profile(query, ops.BLOSUM50.to(dev))
    assert got == [float(sw.sw_plain(prof, s, 10.0, 2.0, q_len)) for s in db]
