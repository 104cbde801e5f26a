"""The CUDA build's cache key: a shared library is named by a hash of its
source and every local header that source includes, so an edit to
``csrc/fa_hopper.cuh`` rebuilds both flash-attention libraries, and one to
``csrc/ssd_tiles.cuh`` both SSD libraries (``csrc/ssd_mma.cuh`` only the
backward's).  The build keeps ptxas's register and spill counts beside a
library, for a process that reuses it, and the variants that
``tools/ssd_bwd_variants.py`` times still apply to the sources.

The table of kernels: every source under ``csrc/`` has a row, every
wrapper reads the counter its rows name and binds only those sources, a
counter loses no launch across threads, a rank reports every counter, and
a launch's nonzero return raises with the C function's name and error."""
import importlib.util
import shutil
import sys
import threading
import types
from pathlib import Path

import pytest

import _torch_rank_jobs as J
from repro_torch.core import ranks
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gated_norm as gn
from repro_torch.kernels import smith_waterman as sw
from repro_torch.kernels import ssd_scan as ssd

ROOT = Path(__file__).resolve().parents[1]


def test_sources_list_the_headers_they_include():
    inputs = {n: [p.name for p in _build._inputs(_build.CSRC / f"{n}.cu")]
              for n in _build.SOURCES}
    assert inputs == {
        "smith_waterman": ["smith_waterman.cu"],
        "flash_attention": ["flash_attention.cu", "fa_hopper.cuh"],
        "flash_attention_bwd": ["flash_attention_bwd.cu", "fa_hopper.cuh"],
        "ssd_scan": ["ssd_scan.cu", "ssd_tiles.cuh"],
        "ssd_scan_bwd": ["ssd_scan_bwd.cu", "ssd_mma.cuh", "ssd_tiles.cuh"],
        "gated_norm": ["gated_norm.cu"],
    }


def test_header_edit_changes_the_digest_of_its_includers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = ("flash_attention", "flash_attention_bwd", "ssd_scan")
    before = {n: _build._digest(csrc / f"{n}.cu") for n in names}
    assert before["flash_attention"] == _build._digest(
        _build.CSRC / "flash_attention.cu")
    with open(csrc / "fa_hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._digest(csrc / f"{n}.cu") for n in names}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["flash_attention_bwd"] != before["flash_attention_bwd"]
    assert after["ssd_scan"] == before["ssd_scan"]


def test_ssd_header_edit_changes_the_digest_of_both_ssd_sources(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = ("flash_attention", "ssd_scan", "ssd_scan_bwd")
    before = {n: _build._digest(csrc / f"{n}.cu") for n in names}
    with open(csrc / "ssd_tiles.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._digest(csrc / f"{n}.cu") for n in names}
    assert after["ssd_scan"] != before["ssd_scan"]
    assert after["ssd_scan_bwd"] != before["ssd_scan_bwd"]
    assert after["flash_attention"] == before["flash_attention"]


def test_ssd_mma_header_edit_rebuilds_only_the_backward(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = ("ssd_scan", "ssd_scan_bwd")
    before = {n: _build._digest(csrc / f"{n}.cu") for n in names}
    with open(csrc / "ssd_mma.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._digest(csrc / f"{n}.cu") for n in names}
    assert after["ssd_scan_bwd"] != before["ssd_scan_bwd"]
    assert after["ssd_scan"] == before["ssd_scan"]


_PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z8k_kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z8k_kernelv
    8 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 360 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_Z8j_kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z8j_kernelv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 360 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_entry_and_skips_other_functions():
    assert _build.ptxas_usage(_PTXAS_LOG) == {
        "_Z8k_kernelv": (96, 24, 20), "_Z8j_kernelv": (128, 0, 0)}
    assert _build.ptxas_usage("reused /x/lib.so\n") == {}


def test_reused_library_keeps_its_ptxas_counts(tmp_path, monkeypatch):
    calls = []

    def fake_compile(src, out):
        calls.append(src.name)
        out.write_bytes(b"")
        return 1.5, _PTXAS_LOG

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "compile_source", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_INFO", {})
    first = _build._build("ssd_scan_bwd")
    assert _build.build_info("ssd_scan_bwd") == (1.5, _PTXAS_LOG)
    again = _build._build("ssd_scan_bwd")
    secs, log = _build.build_info("ssd_scan_bwd")
    assert calls == ["ssd_scan_bwd.cu"] and again == first and secs == 0.0
    assert log.startswith(f"reused {first}")
    assert _build.ptxas_usage(log) == _build.ptxas_usage(_PTXAS_LOG)


def _variants_tool():
    spec = importlib.util.spec_from_file_location(
        "ssd_bwd_variants", ROOT / "tools" / "ssd_bwd_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_every_ssd_backward_variant_still_matches_the_sources():
    tool = _variants_tool()
    texts = {f: (_build.CSRC / f).read_text() for f in tool.EDITED}
    for name in tool.VARIANTS:
        out = tool.variant_sources(name, texts)
        assert (out == texts) == (name == "base"), name
    with pytest.raises(ValueError, match="substitution not found"):
        tool.VARIANTS["stale"] = [("no such text", "")]
        tool.variant_sources("stale", texts)


WRAPPERS = {"sw": sw, "fa": fa, "ssd": ssd, "gated_norm": gn}


def _libraries(module):
    return [v for v in vars(module).values() if isinstance(v, _build.Library)]


def test_every_source_has_a_row_and_every_wrapper_reads_its_counter():
    assert sorted(_build.SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert set(WRAPPERS) == set(_build.COUNTERS)
    assert _build.LAUNCH_KEYS == ("sw", "fa", "fa_bwd", "ssd", "ssd_bwd",
                                  "gated_norm", "gated_norm_bwd")
    assert sw.PATHS == ("warp", "strip", "block")
    for name, mod in WRAPPERS.items():
        assert sorted(lib.source for lib in _libraries(mod)) == sorted(
            src for src, row in _build.KERNELS.items() if row.counter == name)
        counter = _build.COUNTERS[name]
        _build.reset_launch_counts()
        try:
            for key in counter.keys:
                counter.add(key)
            fwd = sum(k != "bwd" for k in counter.keys)
            assert mod.launch_count() == fwd
            bwd = {f"{name}_bwd": 1} if "bwd" in counter.keys else {}
            if bwd:
                assert mod.bwd_launch_count() == 1
            assert _build.launch_counts() == {
                **dict.fromkeys(_build.LAUNCH_KEYS, 0), name: fwd, **bwd}
            mod.reset_launch_count()
            assert not any(_build.launch_counts().values())
        finally:
            _build.reset_launch_counts()


@pytest.mark.parametrize("name", list(_build.COUNTERS))
def test_launch_count_loses_no_update_across_threads(name):
    """Farm workers count launches from several threads at once: the
    forward and backward counts, and Smith-Waterman's tally by path, alike."""
    counter, mod = _build.COUNTERS[name], WRAPPERS[name]
    keys = (counter.keys * 16)[:16]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mod.reset_launch_count()
        threads = [threading.Thread(target=lambda k=k: [counter.add(k)
                                                        for _ in range(2000)])
                   for k in keys]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert counter.counts() == {k: keys.count(k) * 2000 for k in counter.keys}
        assert mod.launch_count() == sum(k != "bwd" for k in keys) * 2000
        if name == "sw":
            assert sw.launch_counts() == {"warp": 6 * 2000, "strip": 5 * 2000,
                                          "block": 5 * 2000}
        else:
            assert mod.bwd_launch_count() == 8 * 2000
    finally:
        sys.setswitchinterval(switch)
        mod.reset_launch_count()
    assert counter.counts() == dict.fromkeys(counter.keys, 0)


def test_a_rank_reports_every_counter_in_the_table():
    p = ranks.RankPool(1, device="cpu", transport="gloo")
    try:
        assert tuple(p.launches) == _build.LAUNCH_KEYS
        p.run(J.count_launches, "gated_norm", ("fwd", "bwd", "bwd"))
        p.run(J.count_launches, "sw", ("strip",))
        assert p.launches == {**dict.fromkeys(_build.LAUNCH_KEYS, 0), "sw": 1,
                              "gated_norm": 1, "gated_norm_bwd": 2}
        p.reset_counts()
        assert p.launches == dict.fromkeys(_build.LAUNCH_KEYS, 0)
    finally:
        p.close()


class _Stub:
    """A library object whose ``fn`` returns ``err`` and records its
    arguments, and whose ``<prefix>_error_string`` names the code."""

    def __init__(self, prefix, fn, err):
        self.calls = []
        setattr(self, fn, lambda *args: self.calls.append(args) or err)
        setattr(self, f"{prefix}_error_string",
                lambda code: f"stub error {code}".encode())


@pytest.mark.parametrize("source,fn,err,want", [
    ("smith_waterman", "sw_launch", 2, "CUDA error 2 (stub error 2)"),
    ("flash_attention", "fa_launch", 700, "CUDA error 700 (stub error 700)"),
    ("flash_attention_bwd", "fa_bwd_launch", 1001,
     "CUresult 1 encoding a tensor map (stub error 1001)"),
    ("ssd_scan_bwd", "ssd_bwd_launch", 1001, "CUDA error 1001 (stub error 1001)"),
    ("gated_norm", "gn_backward", 9, "CUDA error 9 (stub error 9)"),
])
def test_a_failed_launch_raises_with_the_function_and_its_error(source, fn,
                                                                err, want):
    lib = _build.Library(source, {})
    lib.cdll = _Stub(_build.KERNELS[source].prefix, fn, err)
    with pytest.raises(RuntimeError) as e:
        lib.launch(fn, 1, None, 2.5)
    assert str(e.value) == f"{fn} failed: {want}"
    assert lib.cdll.calls == [(1, None, 2.5)]
    lib.cdll = _Stub(_build.KERNELS[source].prefix, fn, 0)
    assert lib.launch(fn, 3) is None and lib.cdll.calls == [(3,)]


@pytest.mark.parametrize("lib", [lib for mod in WRAPPERS.values()
                                 for lib in _libraries(mod)],
                         ids=lambda lib: lib.source)
def test_bind_declares_every_signature_and_the_error_string(lib):
    fns = {fn: types.SimpleNamespace() for fn in lib.signatures}
    bound = lib.bind(types.SimpleNamespace(**fns))
    prefix = _build.KERNELS[lib.source].prefix
    assert f"{prefix}_error_string" in fns
    for fn, (restype, argtypes) in lib.signatures.items():
        assert (getattr(bound, fn).restype, getattr(bound, fn).argtypes) == (
            restype, argtypes)
    assert lib.signatures[f"{prefix}_error_string"][0] is _build.ctypes.c_char_p
