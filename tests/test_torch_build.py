"""The CUDA build's cache key: a shared library is named by a hash of its
source and every local header that source includes, so an edit to
``csrc/fa_hopper.cuh`` rebuilds both flash-attention libraries, and one to
``csrc/ssd_tiles.cuh`` both SSD libraries (``csrc/ssd_mma.cuh`` only the
backward's).  The build keeps ptxas's register and spill counts beside a
library, for a process that reuses it, and the variants that
``tools/ssd_bwd_variants.py`` times still apply to the sources."""
import importlib.util
import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import _build

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
