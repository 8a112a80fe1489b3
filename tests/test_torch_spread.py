"""The port's spread family against the JAX package, on the CPU.

Same seeded numpy inputs through both packages (tolerance: none; the
registers are integer maxima and the decode is the same float64 numpy
arithmetic):

- the torch register update equals the reference's jnp update and its
  numpy twin, padded rows included;
- the host decode equals the reference's bit for bit, on random register
  planes and on the stream (n_elems=120, seed=0, key=0) where the
  reference's estimate falls as registers grow (copied as it is);
- windowed superspreader and portscan detectors give the reference's rows
  in every window; the state does not depend on chunking; the presets
  match; the generator's spreader legs rank first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.gen import FlowGenerator as JGen
from flow_pipeline_tpu.gen import ZipfProfile as JZipf
from flow_pipeline_tpu.hostsketch import engine as jeng
from flow_pipeline_tpu.models import scan as jscan
from flow_pipeline_tpu.models import spread as jspread
from flow_pipeline_tpu.models import superspreader as jss
from flow_pipeline_tpu.ops import spread as jops
from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch
from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.hostsketch import engine as teng
from flow_pipeline_tpu_torch.models import scan as tscan
from flow_pipeline_tpu_torch.models import spread as tspread
from flow_pipeline_tpu_torch.models import superspreader as tss
from flow_pipeline_tpu_torch.ops import spread as tops
from flow_pipeline_tpu_torch.schema.batch import FlowBatch
import torch_cpu  # noqa: F401  (one torch thread; see the module)

T0 = 1_699_999_800  # window-aligned stream start


def _pairs(n, kw, ew, seed, key_space=60, elem_space=5000):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_space, (n, kw), dtype=np.uint32)
    elems = rng.integers(0, elem_space, (n, ew), dtype=np.uint32)
    # full-range words too: the hashes see every bit
    keys[::7] = rng.integers(0, 2**32, (len(keys[::7]), kw), dtype=np.uint32)
    elems[::5] = rng.integers(0, 2**32, (len(elems[::5]), ew),
                              dtype=np.uint32)
    return keys, elems


def _zipf(n, seed, spread=0.25, rate=1e9, t0=T0):
    """The same seeded Zipf stream with spreader legs from both packages'
    generators (all rows in one window at the default rate)."""
    prof = dict(n_keys=2000, spread_fraction=spread)
    tb = FlowGenerator(ZipfProfile(**prof), seed=seed, t0=t0,
                       rate=rate).batch(n)
    jb = JGen(JZipf(**prof), seed=seed, t0=t0, rate=rate).batch(n)
    for name, col in jb.columns.items():
        assert np.array_equal(tb.columns[name], col), name
    return tb, jb


@pytest.mark.parametrize("kw,ew,masked", [(1, 1, False), (4, 4, True),
                                          (4, 1, True), (2, 3, False)])
def test_spread_update_matches_reference(kw, ew, masked):
    """Registers equal: port torch update == reference jnp update ==
    numpy twin (padded rows contribute nothing)."""
    keys, elems = _pairs(3000, kw, ew, seed=kw * 10 + ew)
    rng = np.random.default_rng(5)
    valid = rng.random(len(keys)) < 0.7 if masked else None
    regs = rng.integers(0, 6, (2, 64, 32), dtype=np.uint8)
    before = regs.copy()
    got = tops.spread_update(
        torch.from_numpy(regs), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(elems.astype(np.int64)),
        None if valid is None else torch.from_numpy(valid))
    want = np.asarray(jops.spread_update(
        jnp.asarray(regs), jnp.asarray(keys), jnp.asarray(elems),
        None if valid is None else jnp.asarray(valid)))
    twin = regs.copy()
    sel = slice(None) if valid is None else valid
    teng.np_spread_update(twin, keys[sel], elems[sel])
    ref_twin = regs.copy()
    jeng.np_spread_update(ref_twin, keys[sel], elems[sel])
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(twin, want)
    assert np.array_equal(ref_twin, want)
    assert not np.array_equal(want, before)  # the update did something
    assert np.array_equal(regs, before)  # and wrote new planes


def test_spread_merge_and_bit_length_match_reference():
    rng = np.random.default_rng(2)
    a, b, c = (rng.integers(0, 40, (2, 16, 8), dtype=np.uint8)
               for _ in range(3))
    got = tops.spread_merge(*(torch.from_numpy(x) for x in (a, b, c)))
    want = np.asarray(jops.spread_merge(*(jnp.asarray(x) for x in (a, b, c))))
    assert np.array_equal(got.numpy(), want)
    h = np.concatenate([[0, 1, 2, 3, 2**31, 2**32 - 1],
                        rng.integers(0, 2**32, 5000)]).astype(np.uint32)
    want = np.asarray(jops._bit_length_u32(jnp.asarray(h)))
    got = tops._bit_length_u32(torch.from_numpy(h.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(teng._np_bit_length_u32(h), want)
    assert tops.SPREAD_REG_SEED == jops.SPREAD_REG_SEED
    assert tops.SPREAD_RHO_SEED == jops.SPREAD_RHO_SEED
    assert tops.SPREAD_RHO_ZERO == jops.SPREAD_RHO_ZERO


@pytest.mark.parametrize("m", [16, 32, 64, 128])
def test_spread_decode_bit_equal(m):
    """spread_estimate / spread_decode / np_spread_query equal the
    reference's bytes: empty rows, linear counting, the harmonic mean,
    saturated and large-range rows."""
    rng = np.random.default_rng(m)
    regs = rng.integers(0, 12, (3, 40, m), dtype=np.uint8)
    regs[0, :10] = 0                       # empty buckets
    regs[1, :8] = rng.integers(0, 2, (8, m), dtype=np.uint8)  # sparse
    regs[2, :4] = 255                      # saturated
    regs[2, 4:8] = 33
    assert tops._hll_alpha(m) == jops._hll_alpha(m)
    got = tops.spread_estimate(regs)
    want = jops.spread_estimate(regs)
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()
    buckets = rng.integers(0, 40, (3, 500))
    assert tops.spread_decode(regs, buckets).tobytes() == \
        jops.spread_decode(regs, buckets).tobytes()
    keys = rng.integers(0, 2**32, (300, 4), dtype=np.uint32)
    assert teng.np_spread_query(regs, keys).tobytes() == \
        jeng.np_spread_query(regs, keys).tobytes()


def test_spread_decode_follows_reference_step_by_step():
    """The stream n_elems=120, seed=0, key=0 of the reference's property
    test: each decoded estimate equals the reference's bit for bit,
    including the step where the reference's estimate falls as the
    registers grow (ROADMAP Queue 3: copied, not corrected)."""
    rng = np.random.default_rng(0)
    n = 120
    elems = rng.choice(2**32, size=n, replace=False).astype(
        np.uint32).reshape(-1, 1)
    keys = np.zeros((n, 1), np.uint32)
    regs_t = np.zeros((2, 32, 32), np.uint8)
    regs_j = np.zeros((2, 32, 32), np.uint8)
    got, want = [], []
    for s in range(0, n, 50):
        teng.np_spread_update(regs_t, keys[s:s + 50], elems[s:s + 50])
        jeng.np_spread_update(regs_j, keys[s:s + 50], elems[s:s + 50])
        assert np.array_equal(regs_t, regs_j)
        got.append(teng.np_spread_query(regs_t, keys[:1])[0])
        want.append(jeng.np_spread_query(regs_j, keys[:1])[0])
    assert np.array(got).tobytes() == np.array(want).tobytes()


def test_table_merge_matches_reference():
    rng = np.random.default_rng(4)
    cap = 16
    tk = np.full((cap, 4), 0xFFFFFFFF, np.uint32)
    tm = np.zeros(cap, np.float32)
    jk, jm = tk.copy(), tm.copy()
    for _ in range(5):
        cand = rng.integers(0, 30, (40, 4), dtype=np.uint32)
        cand = np.unique(cand, axis=0)
        counts = rng.integers(1, 50, len(cand)).astype(np.float32)
        tk, tm = teng.np_spread_table_merge(tk, tm, cand, counts)
        jk, jm = jeng.np_spread_table_merge(jk, jm, cand, counts)
        assert np.array_equal(tk, jk) and np.array_equal(tm, jm)


def _windowed(pkg, which, batch_size):
    if pkg == "port":
        mod, cfg_fn = ((tss.superspreader_model, tss.superspreader_config)
                       if which == "ss" else
                       (tscan.scan_model, tscan.scan_config))
        return mod(cfg_fn(width=512, capacity=64, batch_size=batch_size),
                   k=24, device="cpu")
    mod, cfg_fn = ((jss.superspreader_model, jss.superspreader_config)
                   if which == "ss" else (jscan.scan_model, jscan.scan_config))
    return mod(cfg_fn(width=512, capacity=64, batch_size=batch_size), k=24)


@pytest.mark.parametrize("which", ["ss", "scan"])
def test_windowed_spread_model_matches_reference(which):
    """Three 5-minute windows (and late rows of a closed one) through the
    windowed detector in both packages: every emitted window's rows are
    equal, column for column."""
    tb, jb = _zipf(30_000, seed=11, spread=0.1, rate=40.0)
    port, ref = _windowed("port", which, 2048), _windowed("jax", which, 2048)
    step = 4096
    for s in range(0, len(tb), step):
        port.update(tb.slice(s, s + step))
        ref.update(JBatch({k: v[s:s + step] for k, v in jb.columns.items()},
                          jb.partition))
        # a late slice of the first window, after it closed
        if s == 6 * step:
            late = np.flatnonzero(tb.columns["time_received"] < T0 + 300)[:50]
            port.update(FlowBatch({k: v[late] for k, v in
                                   tb.columns.items()}))
            ref.update(JBatch({k: v[late] for k, v in jb.columns.items()}))
    got, want = port.flush(force=True), ref.flush(force=True)
    assert len(want) >= 3 and len(got) == len(want)
    assert port.late_flows_dropped == ref.late_flows_dropped > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for col in w:
            assert g[col].dtype == w[col].dtype, col
            assert np.array_equal(g[col], w[col]), col
        assert w["valid"].any()
    s_ref = ref.model.state
    assert np.array_equal(port.model.state.regs, s_ref.regs)


def test_chunking_invariance():
    """The registers and the top rows (keys, decoded spreads) do not
    depend on the chunk size: the max monoid is order- and grouping-free.
    Only the admission metric ``pairs``, a sum of per-chunk distinct
    counts, does."""
    tb, _ = _zipf(12_000, seed=3)
    tops_ = []
    regs = []
    for bs in (512, 3000, 16384):
        m = tspread.SpreadModel(tspread.SpreadConfig(
            width=256, capacity=4096, batch_size=bs))
        for s in range(0, len(tb), 5000):
            m.update(tb.slice(s, s + 5000))
        regs.append(m.state.regs.copy())
        tops_.append(m.top(32))
    for r, t in zip(regs[1:], tops_[1:]):
        assert np.array_equal(r, regs[0])
        for col in ("src_addr", "spread", "valid"):
            assert np.array_equal(t[col], tops_[0][col]), col


def test_presets_match_reference():
    assert tss.SUPERSPREADER_MODEL == jss.SUPERSPREADER_MODEL \
        == "superspreaders"
    assert tscan.SCAN_MODEL == jscan.SCAN_MODEL == "portscan"
    for t_cfg, j_cfg in ((tss.superspreader_config(),
                          jss.superspreader_config()),
                         (tscan.scan_config(), jscan.scan_config())):
        for f in ("key_cols", "elem_col", "depth", "width", "registers",
                  "capacity", "batch_size"):
            assert getattr(t_cfg, f) == getattr(j_cfg, f), f
    for t_fn, j_fn, name in ((tss.superspreader_model,
                              jss.superspreader_model, "superspreaders"),
                             (tscan.scan_model, jscan.scan_model,
                              "portscan")):
        t, j = t_fn(device="cpu"), j_fn()
        assert t.model.metric_label == j.model.metric_label == name
        assert (t.k, t.window_seconds) == (j.k, j.window_seconds)
        assert t.model.snapshot_kind == j.model.snapshot_kind \
            == "windowed_spread"
    with pytest.raises(ValueError, match="cannot be a key"):
        tspread.spread_init(tspread.SpreadConfig(elem_col="src_addr"))


def test_spread_legs_rank_first():
    """The generator's harmonic fan-out legs own the top of both
    detectors: superspreaders take the even ranks, scanners the odd."""
    tb, _ = _zipf(40_000, seed=7)
    ss, sc = tss.superspreader_model(device="cpu"), tscan.scan_model(
        device="cpu")
    ss.update(tb)
    sc.update(tb)
    for model, want_even in ((ss, True), (sc, False)):
        top = model.model.top(4)
        suf = np.asarray(top["src_addr"])[:, 3]
        assert ((suf & 0xF000) == 0xF000).all()
        assert (((suf & 0xFFF) % 2 == 0) == want_even).all()
        # every reported spread is the register decode of its key
        keys = np.ascontiguousarray(top["src_addr"], np.uint32)
        again = teng.np_spread_query(model.model.state.regs, keys)
        assert np.array_equal(top["spread"], again.astype(np.float32))


def test_state_carried_between_packages_mid_window():
    """A reference spread state carried into the port mid-window (and the
    port's back) through interop: the next updates and the top rows match
    the reference's; the carried arrays keep the reference's dtypes."""
    from flow_pipeline_tpu_torch import interop

    tb, jb = _zipf(12_000, seed=9)
    cfg = dict(width=512, capacity=128, batch_size=2048)
    ref = jspread.SpreadModel(jspread.SpreadConfig(**cfg))
    port = tspread.SpreadModel(tspread.SpreadConfig(**cfg))
    half = 6000
    ref.update(JBatch({k: v[:half] for k, v in jb.columns.items()}))
    port.state = interop.spread_state_from_checkpoint(ref.state._asdict())
    ref.update(JBatch({k: v[half:] for k, v in jb.columns.items()}))
    port.update(tb.slice(half, len(tb)))
    back = interop.spread_state_to_checkpoint(port.state)
    for name, want in ref.state._asdict().items():
        got = getattr(back, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    got, want = port.top(32), ref.top(32)
    for col in want:
        assert np.array_equal(got[col], want[col]), col
    with pytest.raises(ValueError, match="uint8"):
        interop.spread_state_from_checkpoint(
            dict(ref.state._asdict(), regs=ref.state.regs.astype(np.int32)))
