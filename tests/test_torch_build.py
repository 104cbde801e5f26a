"""The CUDA build's cache key: a shared library is named by a hash of its
source and every local header that source includes, so an edit to
``csrc/fa_hopper.cuh`` rebuilds both flash-attention libraries, and one to
``csrc/ssd_tiles.cuh`` both SSD libraries."""
import shutil

from repro_torch.kernels import _build


def test_sources_list_the_headers_they_include():
    inputs = {n: [p.name for p in _build._inputs(_build.CSRC / f"{n}.cu")]
              for n in _build.SOURCES}
    assert inputs == {
        "smith_waterman": ["smith_waterman.cu"],
        "flash_attention": ["flash_attention.cu", "fa_hopper.cuh"],
        "flash_attention_bwd": ["flash_attention_bwd.cu", "fa_hopper.cuh"],
        "ssd_scan": ["ssd_scan.cu", "ssd_tiles.cuh"],
        "ssd_scan_bwd": ["ssd_scan_bwd.cu", "ssd_tiles.cuh"],
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
