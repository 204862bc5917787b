"""The kernel build cache is keyed by every source a library compiles from:
the .cu, each header it includes from csrc/ (transitively) and the flags.
Nothing here runs nvcc."""

import subprocess

import pytest

from parakeet_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "gemm.cuh"\nint k() { return 1; }\n')
    (tmp_path / "gemm.cuh").write_text('#pragma once\n#include "util.cuh"\n')
    (tmp_path / "util.cuh").write_text("inline int u() { return 0; }\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def no_nvcc(*args, **kw):
        raise AssertionError(f"nvcc must not run: {args}")

    monkeypatch.setattr(subprocess, "run", no_nvcc)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    return tmp_path


def test_sources_follow_quoted_includes(csrc):
    assert [p.name for p in _build.sources("k")] == ["k.cu", "gemm.cuh", "util.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "gemm.cuh", "util.cuh"])
def test_editing_any_included_source_renames_the_library(csrc, edited):
    before = _build.library_path("k")
    assert before.parent == csrc / "build" and before.name.startswith("libk-")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert _build.library_path("k") != before


def test_unrelated_header_and_flags(csrc, monkeypatch):
    before = _build.library_path("k")
    (csrc / "other.cuh").write_text("// edited, still not included\n")
    assert _build.library_path("k") == before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("k") != before


def test_existing_library_is_reused_without_nvcc(csrc):
    lib = _build.library_path("k")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert _build.build("k") == lib


def test_repo_sources_resolve():
    """Every library of the package hashes its headers as well."""
    for cu in sorted(_build._CSRC.glob("*.cu")):
        names = [p.name for p in _build.sources(cu.stem)]
        assert names[0] == cu.name
        for header in _build._INCLUDE.findall(cu.read_bytes()):
            assert header.decode() in names


@pytest.mark.parametrize("name, headers", [
    ("feed_forward", ["feed_forward.cuh", "ffn_gemm.cuh", "async_copy.cuh", "gemm.cuh"]),
    ("rel_attention", ["rel_attention.cuh", "ffn_gemm.cuh", "async_copy.cuh", "gemm.cuh"]),
    ("conv_module", ["conv_module.cuh", "ffn_gemm.cuh", "async_copy.cuh", "gemm.cuh"]),
    ("conv_ffn_final", ["conv_module.cuh", "ffn_gemm.cuh", "async_copy.cuh", "gemm.cuh",
                        "feed_forward.cuh"]),
    ("ffn_attention", ["feed_forward.cuh", "ffn_gemm.cuh", "async_copy.cuh", "gemm.cuh",
                       "rel_attention.cuh"]),
])
def test_composed_kernels_hash_the_sequences_they_include(name, headers):
    """K6, K1 and K5 run their launch sequences and the shared tiled GEMM
    from their headers (K4 and K7 compose K5's, K6's and K1's), so an edit
    to any of those rebuilds them too; K8 and K3, which stay on gemm.cuh's
    small GEMM, do not hash the tiled GEMM's header, so their sources and
    outputs stay as they were."""
    assert [p.name for p in _build.sources(name)] == [f"{name}.cu", *headers]
    for other in ("subsample", "log_mel"):
        names = [p.name for p in _build.sources(other)]
        assert names == [f"{other}.cu", "gemm.cuh"], other
    assert [p.name for p in _build.sources("rel_attention_v1")] == [
        "rel_attention_v1.cu", "async_copy.cuh", "gemm.cuh"]
