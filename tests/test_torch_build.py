"""The kernel build cache is keyed by every source a library compiles from:
the .cu, each header it includes from csrc/ (transitively) and the flags.
Nothing here runs nvcc."""

import re
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


GEMM_HEADERS = ["ffn_gemm.cuh", "async_copy.cuh", "gemm.cuh"]


@pytest.mark.parametrize("name, headers", [
    ("feed_forward", ["feed_forward.cuh", *GEMM_HEADERS]),
    ("rel_attention", ["rel_attention.cuh", *GEMM_HEADERS]),
    ("conv_module", ["conv_module.cuh", *GEMM_HEADERS]),
    ("conv_ffn_final", ["conv_module.cuh", *GEMM_HEADERS, "feed_forward.cuh"]),
    ("ffn_attention", ["feed_forward.cuh", *GEMM_HEADERS, "rel_attention.cuh"]),
    ("subsample", GEMM_HEADERS),
    ("log_mel", GEMM_HEADERS),
])
def test_composed_kernels_hash_the_sequences_they_include(name, headers):
    """Every kernel runs its GEMMs on ffn_gemm.cuh: K6, K1 and K5 on the
    tiled GEMM from their launch sequences' headers, K8's conv2 and K3's
    DFT on it directly, K4 and K7 on its Hopper GEMM in bf16 and on K5's,
    K6's and K1's sequences in f32 (through those headers), so an edit to
    any of those headers rebuilds each library that reaches it. K2 runs
    K1's f32 core and the pieces of its wgmma core (rel_attention.cuh)."""
    assert [p.name for p in _build.sources(name)] == [f"{name}.cu", *headers]
    assert [p.name for p in _build.sources("rel_attention_v1")] == [
        "rel_attention_v1.cu", "rel_attention.cuh", *GEMM_HEADERS]


def test_one_gemm_design_in_the_sources():
    """The 64x64 GEMM that K8 and K3 ran on is gone: ffn_gemm.cuh is the
    port's one GEMM header (the tiled GEMM, and the Hopper GEMM of the bf16
    sublayers with every wgmma, TMA and mbarrier instruction of the port),
    and gemm.cuh keeps the helpers and the LayerNorm. In bf16 (run_hopper,
    and K6's and K5's Hopper sequences run_ffn_hopper and run_conv_hopper,
    which K7 and K4 call) the GEMMs run on the Hopper GEMM alone: no
    LayerNorm launch, no split-K closing pass, none of K6's, K1's or K5's
    tiled launch sequences; in f32 (run_tiled) K7 and K4 run those
    sequences."""
    text = {p.name: p.read_text() for p in _build._CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for word in (r"\bgemm_nt_kernel\b", r"\bGemmArgs\b", r"\blaunch_gemm\b", r"\bGBM\b", r"\bEPI_"):
        assert not [name for name, src in text.items() if re.search(word, src)], word
    assert "layer_norm_rows_kernel" in text["gemm.cuh"] and "FfnGemmArgs" not in text["gemm.cuh"]
    for name in ("subsample.cu", "log_mel.cu"):
        assert "launch_tiled_gemm_rows<" in text[name], name
    for word in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.", "hopper_gemm_kernel<"):
        assert [name for name, src in text.items() if word in src] == ["ffn_gemm.cuh"], word

    def body(src, fn):
        rest = src[src.index(f"int {fn}("):]
        return rest[:rest.index("\n}\n")]

    sequences = text["feed_forward.cuh"] + text["conv_module.cuh"]

    def with_sequences(src):
        """A body with the bodies of the Hopper sequences it calls."""
        return src + "".join(body(sequences, seq) for seq in ("run_ffn_hopper", "run_conv_hopper")
                             if re.search(rf"\b{seq}\(", src))

    bodies = {name: with_sequences(body(text[name], "run_hopper")) for name in ("ffn_attention.cu", "conv_ffn_final.cu")}
    for name, seq in (("feed_forward.cu", "run_ffn_hopper"), ("conv_module.cu", "run_conv_hopper")):
        assert re.search(rf"\b{seq}\(", body(text[name], "pk_" + name[:-3])), name
        bodies[name] = with_sequences(f"{seq}(")
    for name, hopper in bodies.items():
        assert re.search(r"\blaunch_hopper_gemm(_ln)?<", hopper) and "launch_cluster_linear(" in hopper, name
        for word in ("launch_layer_norm_rows", "launch_gemm_reduce", "launch_linear", "launch_tiled_gemm",
                     "run_ffn", "run_block", "run_conv"):
            assert not re.search(rf"\b{word}\b", hopper), (name, word)
    for name, seqs in (("ffn_attention.cu", ("run_ffn", "run_block")), ("conv_ffn_final.cu", ("run_conv", "run_ffn"))):
        tiled = body(text[name], "run_tiled")
        assert [w for w in seqs if re.search(rf"\b{w}<", tiled)] == list(seqs), name
        assert "hopper" not in tiled, name
