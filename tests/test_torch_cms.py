"""Port parity: count-min sketch ops, torch (CPU) against the JAX package.

The port's plain conservative update is held against both the JAX XLA
op (ops/cms.py) and the TPU kernel it replaces
(cms_add_conservative_pallas, run in interpret mode as
tests/test_cms_pallas.py runs it). Inputs are integer-valued floats below
2^24, so every comparison is bit-equal (tolerance: none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.ops import cms as jcms
from flow_pipeline_tpu.ops.cms_pallas import cms_add_conservative_pallas
from flow_pipeline_tpu.schema.keys import hash_words_np
from flow_pipeline_tpu_torch.ops import cms as tcms
from flow_pipeline_tpu_torch.ops import cms_cuda


def _inputs(rng, n, planes, wk=4, valid_frac=0.8):
    keys = rng.integers(0, 2**32, size=(n, wk), dtype=np.uint32)
    values = rng.integers(1, 1500, size=(n, planes)).astype(np.float32)
    valid = rng.random(n) < valid_frac
    return keys, values, valid


def _colliding_keys(rng, n, wk, depth, width):
    """n unique keys searched so that many share a bucket with another
    key in EVERY depth row (a 'full' collision the estimate cannot avoid)
    and the rest share rows 0 and 1."""
    pool = rng.integers(0, 2**32, size=(200_000, wk), dtype=np.uint32)
    b = np.stack([hash_words_np(pool, seed=d) % width for d in range(depth)])
    # group the pool by (b0, b1): pairs inside a group collide in rows 0, 1
    code = b[0].astype(np.int64) * width + b[1]
    order = np.argsort(code, kind="stable")
    code_sorted = code[order]
    dup = np.flatnonzero(code_sorted[1:] == code_sorted[:-1])
    picked = []
    for i in dup:
        picked += [order[i], order[i + 1]]
        if len(picked) >= n:
            break
    picked = np.unique(np.array(picked[:n]))
    keys = pool[picked]
    assert len(keys) >= n // 2
    return keys


def _state(rng, planes, depth, width):
    """A non-empty sketch: integer cells, as an earlier update leaves."""
    return rng.integers(0, 5000, size=(planes, depth, width)).astype(
        np.float32)


def _jax(fn, counts, keys, values, valid, **kw):
    return np.asarray(fn(jnp.asarray(counts), jnp.asarray(keys),
                         jnp.asarray(values), jnp.asarray(valid), **kw))


def _torch(fn, counts, keys, values, valid):
    out = fn(torch.from_numpy(counts.copy()),
             torch.from_numpy(keys.astype(np.int64)),
             torch.from_numpy(values), torch.from_numpy(valid))
    return out.numpy()


@pytest.mark.parametrize("n,planes,depth,width", [(64, 1, 2, 256),
                                                  (200, 3, 4, 512)])
def test_cms_query_bit_equal(n, planes, depth, width):
    rng = np.random.default_rng(n)
    counts = _state(rng, planes, depth, width)
    keys, _, _ = _inputs(rng, n, planes)
    want = np.asarray(jcms.cms_query(jnp.asarray(counts), jnp.asarray(keys)))
    got = tcms.cms_query(torch.from_numpy(counts),
                         torch.from_numpy(keys.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,planes,depth,width", [(64, 1, 2, 256),
                                                  (300, 3, 4, 512)])
def test_cms_add_linear_bit_equal(n, planes, depth, width):
    rng = np.random.default_rng(n + 1)
    counts = _state(rng, planes, depth, width)
    keys, values, valid = _inputs(rng, n, planes)
    want = _jax(jcms.cms_add, counts, keys, values, valid)
    got = _torch(tcms.cms_add, counts, keys, values, valid)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,planes,depth,width,wk", [
    (64, 1, 2, 256, 2), (128, 3, 4, 512, 4), (200, 3, 4, 1024, 11)])
def test_cms_add_conservative_matches_xla_and_pallas(n, planes, depth, width,
                                                     wk):
    rng = np.random.default_rng(n * wk)
    counts = _state(rng, planes, depth, width)
    keys, values, valid = _inputs(rng, n, planes, wk)
    xla = _jax(jcms.cms_add_conservative, counts, keys, values, valid)
    pallas = _jax(cms_add_conservative_pallas, counts, keys, values, valid,
                  tile=128, chunk=64, interpret=True)
    plain = _torch(tcms.cms_add_conservative, counts, keys, values, valid)
    wrapper = _torch(cms_cuda.cms_add_conservative, counts, keys, values,
                     valid)
    np.testing.assert_array_equal(plain, xla)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(wrapper, plain)


@pytest.mark.parametrize("wk", [4, 11])
def test_conservative_forced_collisions(wk):
    planes, depth, width = 3, 4, 256
    rng = np.random.default_rng(wk)
    keys = _colliding_keys(rng, 96, wk, depth, width)
    n = len(keys)
    values = rng.integers(1, 1500, size=(n, planes)).astype(np.float32)
    valid = rng.random(n) < 0.8
    counts = _state(rng, planes, depth, width)
    # the search worked: some valid keys share both row-0 and row-1 cells
    b = np.stack([hash_words_np(keys, seed=d) % width for d in range(2)])
    pairs = set(zip(b[0][valid], b[1][valid]))
    assert len(pairs) < int(valid.sum())
    xla = _jax(jcms.cms_add_conservative, counts, keys, values, valid)
    pallas = _jax(cms_add_conservative_pallas, counts, keys, values, valid,
                  tile=128, chunk=32, interpret=True)
    plain = _torch(tcms.cms_add_conservative, counts, keys, values, valid)
    np.testing.assert_array_equal(plain, xla)
    np.testing.assert_array_equal(plain, pallas)


def test_conservative_repeated_and_mixed_calls():
    """Three rounds; the JAX side alternates its XLA and Pallas updates on
    one sketch, the port applies its plain update each round."""
    planes, depth, width = 3, 4, 512
    rng = np.random.default_rng(42)
    j_counts = jcms.cms_init(planes, depth, width)
    t_counts = tcms.cms_init(planes, depth, width, device="cpu")
    pool = rng.integers(0, 2**32, size=(500, 4), dtype=np.uint32)
    for rnd in range(3):
        idx = rng.choice(len(pool), 128, replace=False)  # unique per call
        keys = pool[idx]
        values = rng.integers(1, 1500, size=(128, planes)).astype(np.float32)
        valid = rng.random(128) < 0.8
        args = (jnp.asarray(keys), jnp.asarray(values), jnp.asarray(valid))
        if rnd % 2:
            j_counts = cms_add_conservative_pallas(
                j_counts, *args, tile=128, chunk=64, interpret=True)
        else:
            j_counts = jcms.cms_add_conservative(j_counts, *args)
        cms_cuda.cms_add_conservative(
            t_counts, torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(values), torch.from_numpy(valid))
        np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    est = tcms.cms_query(t_counts, torch.from_numpy(pool.astype(np.int64)))
    want = jcms.cms_query(j_counts, jnp.asarray(pool))
    np.testing.assert_array_equal(est.numpy(), np.asarray(want))


def test_wrapper_counts_no_launch_on_cpu():
    rng = np.random.default_rng(3)
    keys, values, valid = _inputs(rng, 32, 3)
    before = cms_cuda.LAUNCHES
    _torch(cms_cuda.cms_add_conservative, _state(rng, 3, 4, 256), keys,
           values, valid)
    assert cms_cuda.LAUNCHES == before


@pytest.mark.parametrize("bad", ["counts_f64", "keys_float", "values_shape",
                                 "valid_dtype", "noncontig"])
def test_wrapper_rejects_bad_inputs(bad):
    counts = torch.zeros((3, 4, 256))
    keys = torch.zeros((8, 4), dtype=torch.int64)
    values = torch.ones((8, 3))
    valid = torch.ones(8, dtype=torch.bool)
    if bad == "counts_f64":
        counts = counts.double()
    elif bad == "keys_float":
        keys = keys.float()
    elif bad == "values_shape":
        values = torch.ones((8, 2))
    elif bad == "valid_dtype":
        valid = valid.to(torch.int32)
    elif bad == "noncontig":
        keys = torch.zeros((4, 8), dtype=torch.int64).T
    with pytest.raises(ValueError):
        cms_cuda.cms_add_conservative(counts, keys, values, valid)
