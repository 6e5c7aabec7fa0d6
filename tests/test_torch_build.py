"""The kernel build's cache key (``repro_torch.kernels.build``), on the CPU.

A library's file name carries a hash of its source, of the headers the
sources share and of the nvcc flags: an edited header must rebuild every
library rather than reuse a stale one left in the build directory.
"""

import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return copy


HEADERS = ["tf32x3.cuh", "attention_tc.cuh", "bf16_mma.cuh", "wgmma.cuh",
           "attention_wgmma.cuh", "ragged_split.cuh"]


def test_sources_and_headers_are_in_the_package():
    assert {p.stem for p in build.CSRC.glob("*.cu")} == set(build.SOURCES)
    assert {p.name for p in build.CSRC.glob("*.cuh")} == set(HEADERS)


@pytest.mark.parametrize("header", HEADERS)
def test_editing_a_header_changes_every_library_path(csrc, header):
    before = {s: build.library_path(s) for s in build.SOURCES}
    assert all(p.parent == build.BUILD_DIR for p in before.values())
    assert {s: build.library_path(s) for s in build.SOURCES} == before  # stable
    with open(csrc / header, "a") as f:
        f.write("\n// touched\n")
    after = {s: build.library_path(s) for s in build.SOURCES}
    assert all(after[s] != before[s] for s in build.SOURCES)
    assert all(after[s].name.startswith(f"lib{s}-") for s in build.SOURCES)


def test_editing_a_source_changes_only_its_library_path(csrc):
    before = {s: build.library_path(s) for s in build.SOURCES}
    with open(csrc / "ragged_extend.cu", "a") as f:
        f.write("\n// touched\n")
    after = {s: build.library_path(s) for s in build.SOURCES}
    assert [s for s in build.SOURCES if after[s] != before[s]] == ["ragged_extend"]
