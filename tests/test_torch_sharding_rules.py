"""The port's sharding-token trees (``models.model.params_pspecs``,
``cache_pspecs``, ``batch_pspecs``) against the reference's, token for
token, for every arch; and the reference's invariants
(``tests/test_sharding_rules.py``): the token tree has the parameter
tree's structure, every ``"mp"``/``"dp"`` dim divides the production
mesh (16 × 16, or a data axis of 32 over two pods), the head and vocab
padding, integral GQA groups, the ``long_500k`` policy, and 33 of the
40 (arch × shape) cells runnable — on the port's configs, which the dry
run (``launch/dryrun.py``) reads."""
import pytest

from repro.configs import ARCHS as JARCHS
from repro.models import model as JM
from repro_torch.configs import ARCHS, SHAPES, SUBQUADRATIC, cell_applicable
from repro_torch.models import model as M
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import pad_to
from repro_torch.models.model import init_params_spec
from repro_torch.parallel.context import is_spec_leaf
from repro_torch.tree import tree_leaves_with_path

DP, MP = 16, 16         # single-pod production mesh
POD = 2


def _plain(tree):
    """A token tree as nested dicts of tuples, whichever package made it."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    assert is_spec_leaf(tree), tree
    return tree


@pytest.mark.parametrize("mp", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_pspecs_equal_the_reference(arch, mp):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    assert _plain(M.params_pspecs(cfg, mp)) == _plain(JM.params_pspecs(jcfg, mp))
    for batch in (1, 4, 6):
        for dp in (1, 2, 4):
            assert M.batch_pspecs(cfg, batch, dp) == JM.batch_pspecs(jcfg, batch, dp)
        for div in (False, True):
            assert M.cache_pspecs(cfg, batch, div) == JM.cache_pspecs(jcfg, batch, div)
    served = cfg.replace(serve_params_replicated=True)
    assert _plain(M.params_pspecs(served, mp)) == _plain(
        JM.params_pspecs(jcfg.replace(serve_params_replicated=True), mp))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_pspecs_tree_matches_params_tree(arch):
    cfg = ARCHS[arch].smoke()
    specs = dict(tree_leaves_with_path(M.params_pspecs(cfg, MP)))
    shapes = dict(tree_leaves_with_path(init_params_spec(cfg)))
    assert specs.keys() == shapes.keys(), f"{arch}: params vs pspecs drift"
    for path, toks in specs.items():
        assert toks is None or len(toks) <= len(shapes[path][0]), path


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_sharded_dims_divide_production_mesh(arch, multi_pod):
    """Dims marked 'mp' divide 16; dims marked 'dp' divide 16 (32 over two
    pods), with the configs' head and vocab padding."""
    cfg = ARCHS[arch]
    dp = DP * (POD if multi_pod else 1)
    specs = dict(tree_leaves_with_path(M.params_pspecs(cfg, MP)))
    for path, (shape, _) in tree_leaves_with_path(init_params_spec(cfg)):
        for dim, tok in enumerate(specs[path] or ()):
            if tok == "mp":
                assert shape[dim] % MP == 0, (arch, path, shape, dim)
            elif tok == "dp":
                assert shape[dim] % dp == 0, (arch, path, shape, dim)


def test_head_and_vocab_padding_rules():
    assert ARCHS["deepseek-coder-33b"].n_heads_padded == 64      # 56 → 64
    assert ARCHS["starcoder2-7b"].n_heads_padded == 48           # 36 → 48
    assert ARCHS["musicgen-medium"].n_heads_padded == 32         # 24 → 32 (MHA: kv too)
    assert ARCHS["phi3-mini-3.8b"].n_heads_padded == 32          # no padding
    assert ARCHS["mamba2-130m"].vocab_padded == pad_to(50_280, 16)
    assert ARCHS["kimi-k2-1t-a32b"].vocab_padded == 163_840      # already divisible


def test_gqa_groups_integral_after_padding():
    for arch, cfg in ARCHS.items():
        if cfg.family == "ssm":
            continue
        kv = cfg.n_heads_padded if cfg.n_kv_heads == cfg.n_heads else cfg.n_kv_heads
        assert cfg.n_heads_padded % kv == 0, arch


def test_long_context_cell_policy():
    ran, skipped = set(), set()
    for arch in ARCHS:
        ok, _ = cell_applicable(arch, next(s for s in SHAPES
                                           if s.name == "long_500k"))
        (ran if ok else skipped).add(arch)
    assert ran == SUBQUADRATIC
    assert "phi3-mini-3.8b" in skipped and "kimi-k2-1t-a32b" in skipped
    for s in SHAPES:
        if s.name != "long_500k":
            assert all(cell_applicable(a, s)[0] for a in ARCHS)


def test_40_cells_accounted():
    total = len(ARCHS) * len(SHAPES)
    assert total == 40
    runnable = sum(cell_applicable(a, s)[0] for a in ARCHS for s in SHAPES)
    assert runnable == 33 and total - runnable == 7
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
