"""The kernel build's cache key (frosting_tpu_torch/_build.py): a library is
named by a hash of its source and of every header beside it, so an edited
header rebuilds the kernels that include it. Needs no nvcc."""

from frosting_tpu_torch import _build


def test_library_path_follows_the_source_and_its_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("constexpr float kCutoff = 1.0f / 255.0f;\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")

    header.write_text("constexpr float kCutoff = 1.0f / 256.0f;\n")
    edited = _build.library_path("k")
    assert edited != first

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, edited)


def test_host_library_path_follows_its_headers(tmp_path, monkeypatch):
    """A g++ source (csrc/<name>.cpp) is keyed by the host headers it
    includes (as vp8.h is shared by the WebP decoder and writer), and not
    by a header beside it that it does not include."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "d.cpp").write_text('#include <cstdint>\n#include "tables.h"\n')
    header = tmp_path / "tables.h"
    header.write_text("static const int kDc[2] = {4, 5};\n")
    other = tmp_path / "other.h"
    other.write_text("static const int kOther = 1;\n")
    first = _build.library_path("d")
    assert first.name.startswith("libd-")
    other.write_text("static const int kOther = 2;\n")
    assert _build.library_path("d") == first
    header.write_text("static const int kDc[2] = {4, 6};\n")
    assert _build.library_path("d") != first
