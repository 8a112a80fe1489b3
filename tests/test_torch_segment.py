"""Port parity: hash and lexicographic groupby, torch (CPU) against the JAX
package. Group order is part of the contract (the top-K merge breaks rank
ties by position), so outputs are compared slot for slot. Tolerance:
none — integer-valued float planes below 2^24 are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.ops import segment as jseg
from flow_pipeline_tpu_torch.ops import segment as tseg


def _case(rng, n, w, n_keys, p=3, valid_frac=0.8):
    pool = rng.integers(0, 2**32, size=(n_keys, w), dtype=np.uint32)
    keys = pool[rng.integers(0, n_keys, n)]
    vals = rng.integers(0, 1500, size=(n, p)).astype(np.float32)
    valid = rng.random(n) < valid_frac
    return keys, vals, valid


def _to_torch(keys, vals, valid):
    return (torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(vals),
            torch.from_numpy(valid))


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype))


@pytest.mark.parametrize("n,w,n_keys", [(256, 4, 40), (512, 11, 300),
                                        (64, 1, 64), (128, 2, 5)])
def test_hash_groupby_float_bit_equal(n, w, n_keys):
    keys, vals, valid = _case(np.random.default_rng(n + w), n, w, n_keys)
    want = jseg.hash_groupby_float(jnp.asarray(keys), jnp.asarray(vals),
                                   jnp.asarray(valid))
    got = tseg.hash_groupby_float(*_to_torch(keys, vals, valid))
    _assert_same(got, want)


def test_hash_sort_orders_high_h1_unsigned():
    # enough random keys that h1 >= 2^31 occurs on both sides of the sign
    # bit; the sorted hash pairs must match the reference exactly
    keys, _, valid = _case(np.random.default_rng(9), 1024, 4, 1024)
    j_sh, _ = jseg.hash_sort(jnp.asarray(keys), jnp.asarray(valid))
    t_sh, _ = tseg.hash_sort(torch.from_numpy(keys.astype(np.int64)),
                             torch.from_numpy(valid))
    j_sh = np.asarray(j_sh).astype(np.int64)
    assert (j_sh[:, 0] >= 2**31).any() and (j_sh[:, 0] < 2**31).any()
    np.testing.assert_array_equal(t_sh.numpy(), j_sh)


@pytest.mark.parametrize("n,w,n_keys", [(256, 4, 40), (300, 11, 300),
                                        (64, 1, 8)])
def test_sort_groupby_float_bit_equal(n, w, n_keys):
    keys, vals, valid = _case(np.random.default_rng(100 + n), n, w, n_keys)
    want = jseg.sort_groupby_float(jnp.asarray(keys), jnp.asarray(vals),
                                   jnp.asarray(valid))
    got = tseg.sort_groupby_float(*_to_torch(keys, vals, valid))
    _assert_same(got, want)


def test_sort_groupby_float_high_lanes_and_sentinel_key():
    # lanes >= 2^31 must sort unsigned; a valid all-1s key shares the
    # padding segment and still counts (reality judged by counts)
    rng = np.random.default_rng(11)
    keys = np.array([[0x80000000, 1], [0x7FFFFFFF, 2], [0xFFFFFFFF, 0],
                     [0xFFFFFFFF, 0xFFFFFFFF], [0, 0], [0x80000000, 1],
                     [0xFFFFFFFE, 5], [0xFFFFFFFF, 0xFFFFFFFF]],
                    dtype=np.uint32)
    vals = rng.integers(1, 100, size=(len(keys), 2)).astype(np.float32)
    valid = np.array([1, 1, 1, 1, 0, 1, 1, 0], dtype=bool)
    want = jseg.sort_groupby_float(jnp.asarray(keys), jnp.asarray(vals),
                                   jnp.asarray(valid))
    got = tseg.sort_groupby_float(*_to_torch(keys, vals, valid))
    _assert_same(got, want)
    assert int(got[2][got[2] > 0].sum()) == int(valid.sum())


def test_all_invalid_is_all_padding():
    keys, vals, _ = _case(np.random.default_rng(2), 32, 4, 8)
    valid = np.zeros(32, dtype=bool)
    for jfn, tfn in ((jseg.hash_groupby_float, tseg.hash_groupby_float),
                     (jseg.sort_groupby_float, tseg.sort_groupby_float)):
        want = jfn(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
        got = tfn(*_to_torch(keys, vals, valid))
        _assert_same(got, want)
        assert int(got[2].sum()) == 0
