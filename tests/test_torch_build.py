"""PyTorch port: the CUDA build cache (matrel_tpu_torch/utils/cuda_build.py).

A library is named by a digest of its source, of every header beside
it (``csrc/*.cuh``) and of nvcc's flags, so that editing a header that a
source includes never loads a library built from the old header. The
digest is computed here on the CPU; nothing is compiled.
"""

import shutil

import pytest

from matrel_tpu_torch.utils import cuda_build

CSRC = cuda_build.CSRC_DIR
SOURCES = sorted(p.name for p in CSRC.glob("*.cu"))


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ under a temporary directory, as CSRC_DIR."""
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", copy)
    return copy


def test_sources_and_shared_header_present():
    assert {"spmv_compact.cu", "spmv_routed.cu"} <= set(SOURCES)
    header = CSRC / "csr_walk.cuh"
    for name in ("spmv_compact.cu", "spmv_routed.cu"):
        text = (CSRC / name).read_text()
        assert '#include "csr_walk.cuh"' in text, name
    assert "template <bool SPLIT_X>" in header.read_text()


def test_tile_body_headers_shared_by_b1_and_b4_to_b7():
    """B1 and B4–B7 share one f32 tile body and one bf16 one: both headers
    sit in csrc/ and both kernel sources include both."""
    assert {"bf16_tile_wgmma.cuh", "f32_tile_simt.cuh"} <= {
        p.name for p in CSRC.glob("*.cuh")}
    for name in ("spmm_blocksparse.cu", "spgemm_registry.cu"):
        text = (CSRC / name).read_text()
        assert '#include "bf16_tile_wgmma.cuh"' in text, name
        assert '#include "f32_tile_simt.cuh"' in text, name
    assert "f32_tile_kernel" in (CSRC / "f32_tile_simt.cuh").read_text()
    assert "spmm_f32_kernel" not in (CSRC / "spmm_blocksparse.cu").read_text()


@pytest.mark.parametrize("source", SOURCES)
def test_header_edit_renames_library(csrc_copy, source):
    src = csrc_copy / source
    before = cuda_build.library_path(src)
    # the same bytes in another directory: the same library
    assert before == cuda_build.library_path(CSRC / source)
    assert before == cuda_build.library_path(src)           # stable
    header = csrc_copy / "csr_walk.cuh"
    header.write_text(header.read_text().replace("UNROLL = 4", "UNROLL = 8"))
    after = cuda_build.library_path(src)
    assert after != before and after.parent == cuda_build.BUILD_DIR
    assert after.name.startswith(f"lib{src.stem}-")


@pytest.mark.parametrize("source", SOURCES)
def test_new_header_and_source_edit_rename_library(csrc_copy, source):
    src = csrc_copy / source
    before = cuda_build.library_path(src)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    with_header = cuda_build.library_path(src)
    assert with_header != before
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build.library_path(src) not in (before, with_header)
