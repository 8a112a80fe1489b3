"""The port's kernel library is keyed by what it is built from.

kernels.build_key hashes every csrc source and header, the nvcc flags and
the nvcc path; the library's file name carries the key, so editing a
source or a flag builds a new library instead of loading an old one. No
nvcc is needed: the key is computed, not the build.
"""

import shutil

import pytest

from flow_pipeline_tpu_torch import kernels

NVCC = "/usr/local/cuda/bin/nvcc"


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, dst)
    return dst


def test_key_is_stable(csrc):
    assert kernels.build_key(NVCC, csrc) == kernels.build_key(NVCC, csrc)
    # the copy holds the same bytes as the package's own sources
    assert kernels.build_key(NVCC, csrc) == kernels.build_key(NVCC)


@pytest.mark.parametrize("name", ["cms_conservative.cu", "cms_linear.cu",
                                  "cms_hash.cuh", "cms_kernel.cuh"])
def test_key_changes_with_one_source_byte(csrc, name):
    before = kernels.build_key(NVCC, csrc)
    path = csrc / name
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 1
    path.write_bytes(bytes(data))
    assert kernels.build_key(NVCC, csrc) != before


def test_key_changes_with_a_new_header(csrc):
    before = kernels.build_key(NVCC, csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert kernels.build_key(NVCC, csrc) != before


@pytest.mark.parametrize("flags", [
    kernels.NVCC_FLAGS + ("-lineinfo",),
    tuple(f if f != "-O3" else "-O2" for f in kernels.NVCC_FLAGS),
    kernels.NVCC_FLAGS[:-2],
])
def test_key_changes_with_one_flag(csrc, flags):
    assert flags != kernels.NVCC_FLAGS
    assert (kernels.build_key(NVCC, csrc, flags)
            != kernels.build_key(NVCC, csrc))


def test_key_changes_with_the_compiler_path(csrc):
    assert (kernels.build_key("/usr/local/cuda-12.8/bin/nvcc", csrc)
            != kernels.build_key(NVCC, csrc))


def test_library_name_carries_the_key(monkeypatch, tmp_path):
    """build() looks for the library its key names, so a library built
    from other inputs is never taken for it."""
    monkeypatch.setattr(kernels, "_nvcc", lambda: NVCC)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    key = kernels.build_key(NVCC)
    lib = tmp_path / f"libfpt_kernels-{key}.so"
    lib.write_bytes(b"")  # as if built earlier from these inputs
    info = kernels.build()
    assert info.path == lib and info.seconds == 0.0
