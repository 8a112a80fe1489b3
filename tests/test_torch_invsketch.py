"""The port's invertible-sketch twin (flow_pipeline_tpu_torch/ops/
invsketch.py, int64 tensors holding uint64 bits) against the JAX
package's jnp twin (run under ``jax.enable_x64(True)``), the port's
numpy twins (hostsketch/engine.py np_inv_*) and its native kernels
(hs_inv_*; those cases skip only where the port's native library cannot
be built), on the CPU. Tolerance: none, every plane and every decoded
key and value bit for bit.

Cases: the key hash at the uint32 lane extremes; the addend clamp at 0,
negatives, NaN, 2^63, the largest float32 below 2^64, 2^64 and inf;
counts whose products wrap past 2^64; ``valid`` masks; the merge as a
wrap sum; the decode after peels (keys colliding in some rows), and an
empty one. Decoded inputs draw the count plane >= 1, as the pipeline
makes it (see tests/test_torch_hostsketch.py). The key widths are the
families' (11 lanes: the 5-tuple; 4: one address) and the reference
suite's 5.
"""

import jax
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.ops import invsketch as jinv
from flow_pipeline_tpu_torch import native
from flow_pipeline_tpu_torch.hostsketch.engine import (
    _addend_u64 as np_addend_u64,
    np_inv_decode,
    np_inv_key_hash,
    np_inv_update,
)
from flow_pipeline_tpu_torch.hostsketch.state import HostInvState
from flow_pipeline_tpu_torch.ops import invsketch as tinv
import torch_cpu  # noqa: F401  (one torch thread; see the module)

PLANES, DEPTH, WIDTH = 3, 4, 1 << 10
EDGES = np.array([0.0, -1.0, -3.4e38, np.nan, 1.5, 2.0**24 + 2,
                  2.0**63, 2.0**63 * 1.5, 1.8446742e19, 2.0**64, np.inf,
                  -np.inf], np.float32)


def _groups(n, kw, seed, heavy_counts=False):
    """(keys [n, kw] uint32, distinct; vals [n, PLANES] float32 with the
    count plane last, >= 1)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**32, size=(n, kw), dtype=np.uint64)
                     .astype(np.uint32), axis=0)
    rng.shuffle(keys)
    vals = rng.integers(1, 1500, size=(len(keys), PLANES)).astype(np.float32)
    vals[:, -1] = rng.integers(1, 64, size=len(keys))
    if heavy_counts:
        # products lane * count and hash * count wrap past 2^64
        vals[:, -1] = rng.choice(EDGES[6:9], size=len(keys))
    return keys, vals


def _np_state(kw):
    return HostInvState(np.zeros((PLANES, DEPTH, WIDTH), np.uint64),
                        np.zeros((DEPTH, WIDTH, kw), np.uint64),
                        np.zeros((DEPTH, WIDTH), np.uint64))


def _torch_update(keys, vals, valid=None, state=None, kw=None):
    st = state or tinv.inv_init(PLANES, DEPTH, WIDTH, kw or keys.shape[1],
                                device="cpu")
    return tinv.inv_update(*st, torch.from_numpy(keys),
                           torch.from_numpy(vals),
                           None if valid is None else torch.from_numpy(valid))


def _jax_update(keys, vals, valid=None):
    """The JAX twin's state as numpy uint64, x64 on inside the call."""
    import jax.numpy as jnp

    with jax.enable_x64(True):
        st = jinv.inv_init(PLANES, DEPTH, WIDTH, keys.shape[1])
        st = jinv.inv_update(*st, jnp.asarray(keys), jnp.asarray(vals),
                             None if valid is None else jnp.asarray(valid))
        return tuple(np.asarray(a) for a in st)


def _jax_decode(state):
    import jax.numpy as jnp

    with jax.enable_x64(True):
        return jinv.inv_decode(*(jnp.asarray(a) for a in state))


def _u64(state):
    return tuple(tinv.to_u64(a) for a in state)


def _assert_planes(got, want):
    for g, w, name in zip(got, want, ("cms", "keysum", "keycheck")):
        assert g.dtype == np.uint64 and np.array_equal(g, w), name


def _native_state(keys, vals, valid=None):
    if not native.inv_available():
        pytest.skip("the port's native library is not built")
    st = _np_state(keys.shape[1])
    native.hs_inv_update(st.cms, st.keysum, st.keycheck, keys, vals, valid)
    return st.cms, st.keysum, st.keycheck


def test_x64_is_scoped():
    """The JAX twin's x64 mode stays inside its block."""
    _jax_update(*_groups(8, 4, seed=0))
    assert not jax.config.jax_enable_x64


def test_key_hash_at_lane_extremes():
    lanes = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                      0xFFFFFFFF], np.uint32)
    keys = np.stack(np.meshgrid(lanes, lanes, lanes, lanes),
                    -1).reshape(-1, 4)
    want = np_inv_key_hash(keys)
    import jax.numpy as jnp

    with jax.enable_x64(True):
        jwant = np.asarray(jinv.inv_key_hash(jnp.asarray(keys)))
    assert np.array_equal(want, jwant)
    for dtype in (torch.int64, torch.int32):  # int32 holds the u32 bits
        src = torch.from_numpy(keys.astype(np.int64)).to(dtype) \
            if dtype == torch.int64 else torch.from_numpy(keys.view(np.int32))
        assert np.array_equal(tinv.to_u64(tinv.inv_key_hash(src)), want)


def test_addend_clamp_at_u64_edges():
    want = np_addend_u64(EDGES)
    assert want[6] == 1 << 63 and want[9] == want[10] == (1 << 64) - 1
    assert want[8] == int(np.float32(1.8446742e19))
    with jax.enable_x64(True):
        jwant = np.asarray(jinv._addend_u64(EDGES))
    assert np.array_equal(want, jwant)
    got = tinv._addend_u64(torch.from_numpy(EDGES))
    assert np.array_equal(tinv.to_u64(got), want)


@pytest.mark.parametrize("kw", [11, 4, 5])
def test_update_equals_every_twin(kw):
    keys, vals = _groups(400, kw, seed=kw)
    vals[:len(EDGES), 0] = EDGES  # a value plane through every clamp
    got = _u64(_torch_update(keys, vals))
    ref = _np_state(kw)
    np_inv_update(ref, keys, vals)
    want = (ref.cms, ref.keysum, ref.keycheck)
    _assert_planes(got, want)
    _assert_planes(_jax_update(keys, vals), want)
    _assert_planes(_native_state(keys, vals), want)


def test_counts_wrap_past_2_64():
    keys, vals = _groups(300, 11, seed=3, heavy_counts=True)
    got = _u64(_torch_update(keys, vals))
    ref = _np_state(11)
    np_inv_update(ref, keys, vals)
    # the products do wrap: lane * count passes 2^64
    cnt = np_addend_u64(vals[:, -1])
    assert max(int(k) * int(c) for k, c in zip(keys[:, 0], cnt)) >= 1 << 64
    want = (ref.cms, ref.keysum, ref.keycheck)
    _assert_planes(got, want)
    _assert_planes(_jax_update(keys, vals), want)
    _assert_planes(_native_state(keys, vals), want)
    k, v = tinv.inv_decode(*_torch_update(keys, vals))
    nk, nv = np_inv_decode(*want)
    assert np.array_equal(k, nk) and np.array_equal(v, nv)


def test_valid_mask_equals_the_sliced_rows():
    keys, vals = _groups(200, 11, seed=11)
    valid = np.zeros(len(keys), bool)
    valid[:137] = True
    valid[150] = True
    got = _u64(_torch_update(keys, vals, valid=valid))
    ref = _np_state(11)
    np_inv_update(ref, keys[valid], vals[valid])
    want = (ref.cms, ref.keysum, ref.keycheck)
    _assert_planes(got, want)
    _assert_planes(_jax_update(keys, vals, valid=valid), want)
    _assert_planes(_native_state(keys, vals, valid=valid), want)


def test_merge_is_a_wrap_sum():
    ka, va = _groups(100, 4, seed=1, heavy_counts=True)
    kb, vb = _groups(100, 4, seed=2, heavy_counts=True)
    a, b = _torch_update(ka, va), _torch_update(kb, vb)
    merged = _u64(tinv.inv_merge(a, b))
    with np.errstate(over="ignore"):
        want = tuple(x + y for x, y in zip(_u64(a), _u64(b)))
    _assert_planes(merged, want)
    # one pass over both inputs gives the same state
    both = _torch_update(np.concatenate([ka, kb]),
                         np.concatenate([va, vb]))
    _assert_planes(_u64(both), want)
    import jax.numpy as jnp

    with jax.enable_x64(True):
        jm = jinv.inv_merge(tuple(jnp.asarray(x) for x in _u64(a)),
                            tuple(jnp.asarray(x) for x in _u64(b)))
        _assert_planes(tuple(np.asarray(x) for x in jm), want)
    assert tinv.inv_merge(a)[0] is a[0]


@pytest.mark.parametrize("kw,n,width", [(11, 300, WIDTH), (4, 900, WIDTH),
                                        (5, 2500, 256)],
                         ids=["wk11", "wk4", "wk5-crowded"])
def test_decode_after_peels_equals_every_twin(kw, n, width):
    """A sparse sketch decodes in one round; a crowded one (2,500 keys
    over 4 x 256 buckets) needs peels and leaves keys it cannot
    recover."""
    keys, vals = _groups(n, kw, seed=n)
    st = tinv.inv_init(PLANES, DEPTH, width, kw, device="cpu")
    st = tinv.inv_update(*st, torch.from_numpy(keys), torch.from_numpy(vals))
    before = _u64(st)
    before = tuple(a.copy() for a in before)
    got_k, got_v = tinv.inv_decode(*st)
    _assert_planes(_u64(st), before)  # the inputs stay as they are
    want_k, want_v = np_inv_decode(*before)
    assert got_k.dtype == np.uint32 and got_v.dtype == np.uint64
    assert np.array_equal(got_k, want_k) and np.array_equal(got_v, want_v)
    jk, jv = _jax_decode(before)
    assert np.array_equal(got_k, jk) and np.array_equal(got_v, jv)
    recovered = len(got_k)
    assert recovered > 0
    if width == WIDTH:
        assert recovered == len(keys)
    else:
        assert recovered < len(keys)
    # every decoded key carries its exact sums
    index = {k.tobytes(): i for i, k in enumerate(keys)}
    for k, v in zip(got_k, got_v):
        assert np.array_equal(v, vals[index[k.tobytes()]].astype(np.uint64))
    if native.inv_available():
        nk, nv = native.hs_inv_decode(*before)
        order = np.lexsort(nk.T[::-1])
        assert np.array_equal(nk[order], got_k)
        assert np.array_equal(nv[order], got_v)


def test_empty_decode():
    st = tinv.inv_init(PLANES, DEPTH, WIDTH, 11, device="cpu")
    k, v = tinv.inv_decode(*st)
    assert k.shape == (0, 11) and k.dtype == np.uint32
    assert v.shape == (0, PLANES) and v.dtype == np.uint64
    jk, jv = _jax_decode(_u64(st))
    assert jk.shape == k.shape and jv.shape == v.shape


def test_unsigned_division_and_order():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**64, size=20000, dtype=np.uint64)
    b = rng.integers(1, 2**64, size=20000, dtype=np.uint64)
    b[:5000] = rng.integers(1, 1 << 20, size=5000).astype(np.uint64)
    b[5000:5100] = 1
    a[:4] = [0, 2**64 - 1, 2**63, 2**63 - 1]
    b[:4] = [2**63, 2**64 - 1, 2**63 + 1, 1]
    ta, tb = tinv.from_u64(a), tinv.from_u64(b)
    assert np.array_equal(tinv.to_u64(tinv._udiv(ta, tb)), a // b)
    assert np.array_equal(tinv._ult(ta, tb).numpy(), a < b)


def test_planes_must_be_int64():
    cms, ks, kc = tinv.inv_init(PLANES, DEPTH, 64, 4, device="cpu")
    keys, vals = _groups(4, 4, seed=0)
    with pytest.raises(TypeError, match="int64"):
        tinv.inv_update(cms.float(), ks, kc, torch.from_numpy(keys),
                        torch.from_numpy(vals))
    with pytest.raises(TypeError, match="int64"):
        tinv.inv_decode(cms, ks.to(torch.int32), kc)
