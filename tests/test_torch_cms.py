"""Port parity: count-min sketch ops, torch (CPU) against the JAX package.

The port's plain updates, linear and conservative, are held against both
the JAX XLA ops (ops/cms.py) and the TPU kernels they replace
(cms_add_pallas, cms_add_conservative_pallas, run in interpret mode as
tests/test_cms_pallas.py runs them). Inputs are integer-valued floats and
every cell stays below 2^24, so every comparison is bit-equal
(tolerance: none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.ops import cms as jcms
from flow_pipeline_tpu.ops.cms_pallas import (cms_add_conservative_pallas,
                                              cms_add_pallas)
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
    before = dict(cms_cuda.LAUNCHES)
    for fn in (cms_cuda.cms_add_conservative, cms_cuda.cms_add):
        _torch(fn, _state(rng, 3, 4, 256), keys, values, valid)
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


@pytest.mark.parametrize("n,planes,depth,width,wk", [
    (64, 1, 2, 256, 2), (128, 3, 4, 512, 4), (200, 3, 4, 1024, 11)])
def test_cms_add_linear_matches_xla_and_pallas(n, planes, depth, width, wk):
    rng = np.random.default_rng(7 * n + wk)
    counts = _state(rng, planes, depth, width)
    keys, values, valid = _inputs(rng, n, planes, wk)
    xla = _jax(jcms.cms_add, counts, keys, values, valid)
    pallas = _jax(cms_add_pallas, counts, keys, values, valid, tile=128,
                  interpret=True)
    plain = _torch(tcms.cms_add, counts, keys, values, valid)
    wrapper = _torch(cms_cuda.cms_add, counts, keys, values, valid)
    np.testing.assert_array_equal(plain, xla)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(wrapper, plain)


@pytest.mark.parametrize("wk", [4, 11])
def test_linear_forced_collisions(wk):
    planes, depth, width = 3, 4, 256
    rng = np.random.default_rng(50 + wk)
    keys = _colliding_keys(rng, 96, wk, depth, width)
    n = len(keys)
    values = rng.integers(1, 1500, size=(n, planes)).astype(np.float32)
    valid = rng.random(n) < 0.8
    counts = _state(rng, planes, depth, width)
    xla = _jax(jcms.cms_add, counts, keys, values, valid)
    pallas = _jax(cms_add_pallas, counts, keys, values, valid, tile=128,
                  interpret=True)
    plain = _torch(tcms.cms_add, counts, keys, values, valid)
    np.testing.assert_array_equal(plain, xla)
    np.testing.assert_array_equal(plain, pallas)
    # every valid key's cells took its value: the sketch grew by exactly
    # the valid mass in each depth row
    grown = (plain - counts).sum(axis=2)
    want = (values * valid[:, None]).sum(axis=0)[:, None]
    np.testing.assert_array_equal(grown, np.broadcast_to(want, grown.shape))


def test_linear_repeated_and_mixed_calls():
    """Three rounds with repeated keys across calls; the JAX side
    alternates its XLA and Pallas updates on one sketch, the port's
    wrapper updates its own in place."""
    planes, depth, width = 3, 4, 512
    rng = np.random.default_rng(43)
    j_counts = jcms.cms_init(planes, depth, width)
    t_counts = tcms.cms_init(planes, depth, width, device="cpu")
    pool = rng.integers(0, 2**32, size=(300, 4), dtype=np.uint32)
    for rnd in range(3):
        keys = pool[rng.choice(len(pool), 128, replace=False)]
        values = rng.integers(1, 1500, size=(128, planes)).astype(np.float32)
        valid = rng.random(128) < 0.8
        args = (jnp.asarray(keys), jnp.asarray(values), jnp.asarray(valid))
        if rnd % 2:
            j_counts = cms_add_pallas(j_counts, *args, tile=128,
                                      interpret=True)
        else:
            j_counts = jcms.cms_add(j_counts, *args)
        cms_cuda.cms_add(t_counts, torch.from_numpy(keys.astype(np.int64)),
                         torch.from_numpy(values), torch.from_numpy(valid))
        np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    est = tcms.cms_query(t_counts, torch.from_numpy(pool.astype(np.int64)))
    want = jcms.cms_query(j_counts, jnp.asarray(pool))
    np.testing.assert_array_equal(est.numpy(), np.asarray(want))


def test_linear_is_exactly_mergeable():
    """The sketches of two halves of a batch sum to the sketch of the
    whole, bit for bit (integer addends, cells below 2^24): the property
    the sharded path's psum relies on."""
    planes, depth, width = 3, 4, 1024
    rng = np.random.default_rng(44)
    keys, values, valid = _inputs(rng, 400, planes, 4)
    zero = np.zeros((planes, depth, width), np.float32)
    whole = _torch(cms_cuda.cms_add, zero, keys, values, valid)
    a = _torch(cms_cuda.cms_add, zero, keys[:200], values[:200], valid[:200])
    b = _torch(cms_cuda.cms_add, zero, keys[200:], values[200:], valid[200:])
    assert whole.max() < 2**24
    np.testing.assert_array_equal(a + b, whole)
    np.testing.assert_array_equal(
        whole, _jax(jcms.cms_add, zero, keys, values, valid))


@pytest.mark.parametrize("bad", ["counts_f64", "keys_float", "values_shape",
                                 "valid_dtype", "noncontig"])
def test_linear_wrapper_rejects_bad_inputs(bad):
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
        cms_cuda.cms_add(counts, keys, values, valid)


def test_wrappers_refuse_other_devices():
    counts = torch.zeros((3, 4, 256), device="meta")
    keys = torch.zeros((8, 4), dtype=torch.int64, device="meta")
    values = torch.ones((8, 3), device="meta")
    for fn in (cms_cuda.cms_add, cms_cuda.cms_add_conservative):
        with pytest.raises(ValueError, match="no kernel"):
            fn(counts, keys, values)


# ---- the estimate form: the update, then the estimates of every row ------

_WRAPPERS = {"conservative": cms_cuda.cms_add_conservative,
             "linear": cms_cuda.cms_add}


def _pallas_then_query(kernel, counts, keys, values, valid):
    """The JAX package: the TPU kernel (interpret mode), then cms_query on
    the updated sketch."""
    args = (jnp.asarray(counts), jnp.asarray(keys), jnp.asarray(values),
            jnp.asarray(valid))
    if kernel == "conservative":
        upd = cms_add_conservative_pallas(*args, tile=128, chunk=64,
                                          interpret=True)
    else:
        upd = cms_add_pallas(*args, tile=128, interpret=True)
    return np.asarray(upd), np.asarray(jcms.cms_query(upd, args[1]))


def _with_padding(keys, values, valid, pad=24):
    """Rows as hash_groupby_float pads them: invalid, all-ones key lanes
    (the sentinel), zero sums."""
    wk, planes = keys.shape[1], values.shape[1]
    return (np.concatenate([keys, np.full((pad, wk), 0xFFFFFFFF, np.uint32)]),
            np.concatenate([values, np.zeros((pad, planes), np.float32)]),
            np.concatenate([valid, np.zeros(pad, bool)]))


@pytest.mark.parametrize("kernel", ["conservative", "linear"])
@pytest.mark.parametrize("wk,collide", [(1, False), (4, False), (11, False),
                                        (4, True), (11, True)])
def test_estimate_form_matches_pallas_then_query(kernel, wk, collide):
    """with_estimate=True returns the sketch the TPU kernel returns and,
    for every row (padding included), cms_query of the updated sketch."""
    planes, depth = 3, 4
    rng = np.random.default_rng(60 + wk + 7 * collide)
    if collide:
        width = 256
        keys = _colliding_keys(rng, 96, wk, depth, width)
    else:
        width = 512
        keys = np.unique(rng.integers(0, 2**32, size=(160, wk),
                                      dtype=np.uint32), axis=0)
        keys = keys[rng.permutation(len(keys))]
    values = rng.integers(1, 1500, size=(len(keys), planes)).astype(
        np.float32)
    keys, values, valid = _with_padding(keys, values,
                                        rng.random(len(keys)) < 0.8)
    counts = _state(rng, planes, depth, width)
    want_counts, want_est = _pallas_then_query(kernel, counts, keys, values,
                                               valid)
    got_counts, est = _WRAPPERS[kernel](
        torch.from_numpy(counts.copy()),
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(values),
        torch.from_numpy(valid), with_estimate=True)
    assert est.shape == (len(keys), planes) and est.dtype == torch.float32
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)
    np.testing.assert_array_equal(est.numpy(), want_est)


@pytest.mark.parametrize("kernel", ["conservative", "linear"])
def test_estimate_form_repeated_calls(kernel):
    """Three rounds on one sketch: each round's estimates equal the JAX
    package's update-then-query, and the sketch stays equal too."""
    planes, depth, width = 3, 4, 512
    rng = np.random.default_rng(45)
    j_counts = np.asarray(jcms.cms_init(planes, depth, width))
    t_counts = tcms.cms_init(planes, depth, width, device="cpu")
    pool = rng.integers(0, 2**32, size=(400, 11), dtype=np.uint32)
    for _ in range(3):
        keys = pool[rng.choice(len(pool), 128, replace=False)]
        values = rng.integers(1, 1500, size=(128, planes)).astype(np.float32)
        keys, values, valid = _with_padding(keys, values,
                                            rng.random(128) < 0.8, pad=16)
        j_counts, want_est = _pallas_then_query(kernel, j_counts, keys,
                                                values, valid)
        _, est = _WRAPPERS[kernel](
            t_counts, torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(values), torch.from_numpy(valid),
            with_estimate=True)
        np.testing.assert_array_equal(t_counts.numpy(), j_counts)
        np.testing.assert_array_equal(est.numpy(), want_est)


@pytest.mark.parametrize("kernel", ["conservative", "linear"])
def test_estimate_form_empty_batch(kernel):
    counts = torch.ones((3, 4, 64))
    keys = torch.zeros((0, 4), dtype=torch.int64)
    out, est = _WRAPPERS[kernel](counts, keys, torch.zeros((0, 3)),
                                 torch.zeros(0, dtype=torch.bool),
                                 with_estimate=True)
    assert out is counts and est.shape == (0, 3)
    assert torch.equal(counts, torch.ones((3, 4, 64)))
