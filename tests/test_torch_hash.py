"""Port parity: murmur3 key hashing and CMS buckets, torch (CPU) against
the JAX package. Tolerance: none — every hash and bucket is bit-equal.

Also builds csrc/cms_hash.cuh (the CUDA kernel's index math, written
__host__ __device__) with g++ and holds its buckets to the JAX package's.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.ops import cms as jcms
from flow_pipeline_tpu.ops import segment as jseg
from flow_pipeline_tpu.schema import keys as jkeys
from flow_pipeline_tpu_torch.ops import cms as tcms
from flow_pipeline_tpu_torch.ops import segment as tseg
from flow_pipeline_tpu_torch.schema import keys as tkeys

CSRC = Path(tkeys.__file__).resolve().parents[1] / "csrc"


def _lanes(rng, n, w):
    """Random uint32 lanes plus the extreme rows: all zeros, all ones,
    and single-word extremes."""
    keys = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    extreme = np.array([[0] * w, [0xFFFFFFFF] * w,
                        [0xFFFFFFFF] + [0] * (w - 1),
                        [0] * (w - 1) + [0x80000000]], dtype=np.uint32)
    return np.concatenate([keys, extreme])


@pytest.mark.parametrize("w", [1, 4, 11])
@pytest.mark.parametrize("seed", [0, 3, 0xFFFFFFFF])
def test_hash_words_bit_equal(w, seed):
    keys = _lanes(np.random.default_rng(w), 256, w)
    want = np.asarray(jkeys.hash_words(jnp.asarray(keys), seed=seed))
    got = tkeys.hash_words(torch.from_numpy(keys.astype(np.int64)),
                           seed=seed)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_hash_words_takes_int32_bit_patterns():
    keys = _lanes(np.random.default_rng(7), 64, 4)
    from_i32 = tkeys.hash_words(torch.from_numpy(keys.view(np.int32)))
    from_i64 = tkeys.hash_words(torch.from_numpy(keys.astype(np.int64)))
    assert torch.equal(from_i32, from_i64)


@pytest.mark.parametrize("w", [1, 4, 11])
def test_hash_lanes_bit_equal(w):
    keys = _lanes(np.random.default_rng(10 + w), 512, w)
    j1, j2 = jseg.hash_lanes(jnp.asarray(keys))
    t1, t2 = tseg.hash_lanes(torch.from_numpy(keys.astype(np.int64)))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2).astype(np.int64))


@pytest.mark.parametrize("w,depth,width", [(4, 4, 65536), (11, 4, 4096),
                                           (2, 3, 1000), (11, 8, 12345)])
def test_cms_buckets_bit_equal(w, depth, width):
    keys = _lanes(np.random.default_rng(w * depth), 512, w)
    want = np.asarray(jcms.cms_buckets(jnp.asarray(keys), depth, width))
    got = tcms.cms_buckets(torch.from_numpy(keys.astype(np.int64)), depth,
                           width)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


_HOST_SHIM = r"""
#include "cms_hash.cuh"

// The kernels' instantiation for a key of WK words: mix each word once,
// then one murmur3 per depth row.
template <int WK>
static void buckets_of(const uint32_t* keys, int n, int depth, int width,
                       int32_t* out) {
    for (int i = 0; i < n; ++i) {
        uint32_t k[WK];
        for (int j = 0; j < WK; ++j) k[j] = fpt_mix_word(keys[i * WK + j]);
        for (int r = 0; r < depth; ++r)
            out[r * n + i] = fpt_cms_bucket<WK>(k, WK, r, width);
    }
}

// The generic instantiation: room for 16 words, the count at run time.
static void buckets_generic(const uint32_t* keys, int n, int wk, int depth,
                            int width, int32_t* out) {
    for (int i = 0; i < n; ++i) {
        uint32_t k[16] = {0};
        for (int j = 0; j < wk; ++j) k[j] = fpt_mix_word(keys[i * wk + j]);
        for (int r = 0; r < depth; ++r)
            out[r * n + i] = fpt_cms_bucket<16>(k, wk, r, width);
    }
}

extern "C" int host_buckets(const uint32_t* keys, int n, int wk, int depth,
                            int width, int generic, int32_t* out) {
    if (generic) {
        buckets_generic(keys, n, wk, depth, width, out);
        return 0;
    }
    switch (wk) {
        case 1: buckets_of<1>(keys, n, depth, width, out); return 0;
        case 4: buckets_of<4>(keys, n, depth, width, out); return 0;
        case 11: buckets_of<11>(keys, n, depth, width, out); return 0;
        default: return 1;
    }
}
"""


@pytest.fixture
def host_lib(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: cannot build csrc/cms_hash.cuh on the "
                    "host")
    src = tmp_path / "shim.cc"
    src.write_text(_HOST_SHIM)
    lib = tmp_path / "libshim.so"
    proc = subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                           "-I", str(CSRC), str(src), "-o", str(lib)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    handle = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.host_buckets.argtypes = [p, i, i, i, i, i, p]
    handle.host_buckets.restype = i
    return handle


def _header_buckets(host_lib, keys, depth, width, generic):
    out = np.empty((depth, len(keys)), dtype=np.int32)
    assert host_lib.host_buckets(keys.ctypes.data, len(keys), keys.shape[1],
                                 depth, width, int(generic),
                                 out.ctypes.data) == 0
    return out


@pytest.mark.parametrize("wk", [1, 4, 11])
@pytest.mark.parametrize("width", [65536, 4096, 1000])
def test_cuda_header_buckets_match_reference(host_lib, wk, width):
    """The templated hash (Wk as a template argument, the kernels' main
    instantiations) equals the JAX package's cms_buckets."""
    depth = 4
    keys = np.ascontiguousarray(_lanes(np.random.default_rng(wk), 1024, wk))
    want = np.asarray(jcms.cms_buckets(jnp.asarray(keys), depth, width))
    np.testing.assert_array_equal(
        _header_buckets(host_lib, keys, depth, width, False), want)


@pytest.mark.parametrize("wk,depth", [(1, 2), (4, 8), (11, 3), (16, 4)])
def test_cuda_header_generic_buckets_match_reference(host_lib, wk, depth):
    """The generic instantiation (16 words of room, the key width and
    depth at run time) equals cms_buckets too."""
    width = 12345
    keys = np.ascontiguousarray(_lanes(np.random.default_rng(40 + wk), 512,
                                       wk))
    want = np.asarray(jcms.cms_buckets(jnp.asarray(keys), depth, width))
    np.testing.assert_array_equal(
        _header_buckets(host_lib, keys, depth, width, True), want)
