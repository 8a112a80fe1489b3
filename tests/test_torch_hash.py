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
extern "C" void host_buckets(const uint32_t* keys, int n, int wk, int depth,
                             int width, int32_t* out) {
    for (int r = 0; r < depth; ++r)
        for (int i = 0; i < n; ++i)
            out[r * n + i] = fpt_cms_bucket(keys + (size_t)i * wk, wk, r,
                                            width);
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
    handle.host_buckets.argtypes = [p, i, i, i, i, p]
    handle.host_buckets.restype = None
    return handle


@pytest.mark.parametrize("wk", [4, 11])
@pytest.mark.parametrize("width", [65536, 4096, 1000])
def test_cuda_header_buckets_match_reference(host_lib, wk, width):
    depth = 4
    keys = np.ascontiguousarray(_lanes(np.random.default_rng(wk), 1024, wk))
    out = np.empty((depth, len(keys)), dtype=np.int32)
    host_lib.host_buckets(keys.ctypes.data, len(keys), wk, depth, width,
                          out.ctypes.data)
    want = np.asarray(jcms.cms_buckets(jnp.asarray(keys), depth, width))
    np.testing.assert_array_equal(out, want)
