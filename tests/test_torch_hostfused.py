"""The port's host-grouped pipeline (engine/hostfused.py) and its host
grouping (ops/hostgroup.py, the native hash-group, ingest/shard.py)
against the JAX package's, on the CPU.

- group_by_key equals the reference's and a dict oracle, numpy and
  native, with hash collisions forced (a constant hash) to exercise the
  lexicographic regroup and the exact=False merge;
- the native hash-group equals the numpy grouping (groups, order, sums)
  at any thread count;
- sharded grouping equals serial grouping;
- HostGroupPipeline over batches that cross window slots and DDoS
  sub-windows, with late rows and the spread detectors, flushes the rows
  of the port's FusedPipeline and of the reference's HostGroupPipeline;
- ``eligible`` and the lazy window close (rows extracted after the next
  window's first update equal an eager extraction).

Every value sum stays inside the 2^24 integer envelope (tolerance: none).
"""

import numpy as np
import pytest
import torch

from flow_pipeline_tpu.engine.hostfused import HostGroupPipeline as JHost
from flow_pipeline_tpu.models import scan as jscan
from flow_pipeline_tpu.models import superspreader as jss
from flow_pipeline_tpu.ops import hostgroup as jhg
from flow_pipeline_tpu_torch import native
from flow_pipeline_tpu_torch.engine import FusedPipeline as TFused
from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
from flow_pipeline_tpu_torch.engine import hostfused as thf
from flow_pipeline_tpu_torch.engine.windowed import LazyWindowTop
from flow_pipeline_tpu_torch.ingest import ShardPool, group_by_key_sharded
from flow_pipeline_tpu_torch.models import HeavyHitterConfig
from flow_pipeline_tpu_torch.models import scan as tscan
from flow_pipeline_tpu_torch.models import superspreader as tss
from flow_pipeline_tpu_torch.obs.metrics import REGISTRY
from flow_pipeline_tpu_torch.ops import hostgroup as thg
from flow_pipeline_tpu_torch.ops import cms_cuda

from test_torch_fused import BS, _flush_all, _models, _port_batch, _stream
import torch_cpu  # noqa: F401  (one torch thread; see the module)


def _oracle(lanes, planes):
    acc: dict[tuple, list] = {}
    for i, row in enumerate(map(tuple, lanes)):
        slot = acc.setdefault(row, [0] + [np.zeros(p.shape[1:])
                                          for p in planes])
        slot[0] += 1
        for j, p in enumerate(planes):
            slot[j + 1] = slot[j + 1] + p[i].astype(np.float64)
    return acc


def _check_oracle(lanes, planes, out):
    uniq, sums, counts = out
    want = _oracle(lanes, planes)
    assert len(uniq) == len(want) == len({tuple(r) for r in uniq})
    for i, row in enumerate(map(tuple, uniq)):
        assert counts[i] == want[row][0]
        for j in range(len(planes)):
            np.testing.assert_array_equal(sums[j][i], want[row][j + 1])


@pytest.mark.parametrize("native_group", [False, True])
def test_group_by_key_matches_reference_and_oracle(native_group):
    rng = np.random.default_rng(1)
    lanes = rng.integers(0, 7, (3000, 3)).astype(np.uint32)
    lanes[::11] = rng.integers(0, 2**32, (len(lanes[::11]), 3))
    pf = rng.integers(0, 50, (3000, 2)).astype(np.float32)
    pu = rng.integers(0, 50, 3000).astype(np.uint64)
    got = thg.group_by_key(lanes, [pf, pu], native=native_group)
    want = jhg.group_by_key(lanes, [pf, pu])
    _check_oracle(lanes, [pf, pu], got)
    np.testing.assert_array_equal(got[0], want[0])  # same groups, order
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[1], want[1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    empty = thg.group_by_key(np.zeros((0, 2), np.uint32),
                             [np.zeros(0, np.float32)], native=native_group)
    assert empty[0].shape == (0, 2) and len(empty[2]) == 0


def test_forced_collision_stays_exact(monkeypatch):
    """A constant hash makes every distinct key a collision: exact
    grouping regroups lexicographically (the reference's result), and
    exact=False merges them into one group, as documented."""
    rng = np.random.default_rng(2)
    lanes = rng.integers(0, 5, (64, 2)).astype(np.uint32)
    vals = rng.integers(0, 9, 64).astype(np.uint64)
    for mod in (thg, jhg):
        monkeypatch.setattr(mod, "hash_u64",
                            lambda ln: np.zeros(ln.shape[0], np.uint64))
    got = thg.group_by_key(lanes, [vals])
    _check_oracle(lanes, [vals], got)
    want = jhg.group_by_key(lanes, [vals])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][0], want[1][0])
    merged = thg.group_by_key(lanes, [np.ones(64, np.float32)], exact=False)
    assert len(merged[0]) == 1 and merged[1][0][0] == 64.0


def test_select_lanes_matches_reference():
    widths = {"src_addr": 4, "dst_addr": 4, "src_port": 1, "proto": 1}
    key_cols = ("src_addr", "dst_addr", "src_port", "proto")
    for subset in (("dst_addr",), ("proto", "src_addr"), ("src_port",)):
        assert thg.select_lanes(key_cols, widths, subset) == \
            jhg.select_lanes(key_cols, widths, subset)
    assert thg.select_lanes(key_cols, widths, ("dst_addr",)) == [4, 5, 6, 7]
    with pytest.raises(KeyError):
        thg.select_lanes(key_cols, widths, ("dst_port",))


@pytest.mark.parametrize("n,w", [(1, 1), (300, 2), (20_000, 11),
                                 (50_000, 4)])
def test_native_hash_group_matches_numpy(n, w):
    """The native kernel (serial and partitioned) gives the numpy
    grouping's groups in the same hash order, and the same permutation at
    any thread count; no duplicate keys within a chunk collide."""
    rng = np.random.default_rng(n)
    lanes = rng.integers(0, max(2, n // 8), (n, w)).astype(np.uint32)
    perm, starts, collided = native.hash_group(lanes)
    assert perm.dtype == np.int32 and starts.dtype == np.int32
    assert not collided
    sh = thg.hash_u64(lanes)[perm]
    assert (sh[1:] >= sh[:-1]).all()  # ascending 64-bit hash
    np_perm, np_starts = thg.grouping_perm(lanes, exact=True)
    np.testing.assert_array_equal(starts, np_starts)
    np.testing.assert_array_equal(lanes[perm[starts]], lanes[np_perm[
        np_starts]])
    for threads in (2, 4):
        p2, s2, c2 = native.hash_group(lanes, threads=threads)
        np.testing.assert_array_equal(p2, perm)
        np.testing.assert_array_equal(s2, starts)
        assert c2 == collided


def test_sharded_grouping_equals_serial():
    rng = np.random.default_rng(3)
    lanes = rng.integers(0, 500, (40_000, 4)).astype(np.uint32)
    vals = rng.integers(0, 100, (40_000, 2)).astype(np.float32)
    serial = thg.group_by_key(lanes, [vals], exact=True)
    with ShardPool(4) as pool:
        for shards in (0, 3, 8):
            got = group_by_key_sharded(lanes, [vals], pool, shards,
                                       exact=True)
            for a, b in ((got[0], serial[0]), (got[1][0], serial[1][0]),
                         (got[2], serial[2])):
                np.testing.assert_array_equal(a, b)
        small = group_by_key_sharded(lanes[:100], [vals[:100]], pool)
        np.testing.assert_array_equal(
            small[0], thg.group_by_key(lanes[:100], [vals[:100]])[0])


def _with_spread(models, port: bool):
    kw = dict(width=256, capacity=64, batch_size=BS)
    if port:
        models["superspreaders"] = tss.superspreader_model(
            tss.superspreader_config(**kw), k=20, device="cpu")
        models["portscan"] = tscan.scan_model(tscan.scan_config(**kw), k=20,
                                              device="cpu")
    else:
        models["superspreaders"] = jss.superspreader_model(
            jss.superspreader_config(**kw), k=20)
        models["portscan"] = jscan.scan_model(jscan.scan_config(**kw), k=20)
    return models


def _assert_rows_equal(got, want):
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):  # flows_5m
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=name)
            continue
        assert len(g) == len(w), name
        for gw, ww in zip(g, w):
            assert gw.keys() == ww.keys(), name
            for k in ww:
                np.testing.assert_array_equal(np.asarray(gw[k]),
                                              np.asarray(ww[k]),
                                              err_msg=f"{name} {k}")


@pytest.mark.parametrize("sub_seconds", [10, 300])
def test_pipeline_matches_fused_and_reference(sub_seconds):
    """HostGroupPipeline.update across slot rolls, sub-window closes and
    late rows, with the spread detectors: every flushed row, late count
    and alert equals the port's FusedPipeline's and the reference's
    HostGroupPipeline's; each applied chunk is one CMS update per hh
    family."""
    batches = _stream(seed=7, n_keys=100)
    host = _with_spread(_models("default", port=True,
                                sub_seconds=sub_seconds), True)
    fused = _with_spread(_models("default", port=True,
                                 sub_seconds=sub_seconds), True)
    ref = _with_spread(_models("default", port=False,
                               sub_seconds=sub_seconds), False)
    tpipe = thf.HostGroupPipeline(host, native_group=True)
    fpipe, jpipe = TFused(fused), JHost(ref)
    assert tpipe._fam_plan == jpipe._fam_plan
    assert tpipe._ddos_plan == jpipe._ddos_plan
    for b in batches:
        jpipe.update(b)
        fpipe.update(_port_batch(b))
        prep = tpipe.prepare(_port_batch(b))  # host numpy only
        tpipe.apply(prep)
    for name in ref:
        assert getattr(host[name], "late_flows_dropped", 0) == \
            getattr(ref[name], "late_flows_dropped", 0) == \
            getattr(fused[name], "late_flows_dropped", 0), name
    assert host["top_talkers"].model.chunk_updates == tpipe.applied_chunks
    want = _flush_all(ref)
    _assert_rows_equal(_flush_all(host), want)
    _assert_rows_equal(_flush_all(fused), want)
    assert len(want["superspreaders"]) == 3
    assert 'native_path_degraded{feature="group"} 0' in \
        REGISTRY.render().splitlines()


def test_pipeline_apply_copies_to_the_models_device(monkeypatch):
    """prepare returns host numpy only; apply moves the padded tables to
    the models' device and runs one CMS update per family per chunk."""
    batches = _stream(seed=3, n_keys=100, late=False)
    models = _models("hh_only", port=True)
    pipe = thf.HostGroupPipeline(models)
    prep = pipe.prepare(_port_batch(batches[0]))
    for _, _, _, chunks in prep.parts:
        for ch in chunks:
            for u, s, g in ch.hh_in:
                assert isinstance(u, np.ndarray) and u.dtype == np.uint32
                assert u.shape[0] == thf._pow2_bucket(g, hi=max(BS, 1024))
    calls = []
    orig = cms_cuda.cms_add_conservative

    def counted(counts, keys, *a, **kw):
        calls.append((counts.device.type, keys.dtype, keys.shape[0]))
        return orig(counts, keys, *a, **kw)

    monkeypatch.setattr(cms_cuda, "cms_add_conservative", counted)
    pipe.apply(prep)
    assert calls and all(c[:2] == ("cpu", torch.int64) for c in calls)
    assert len(calls) == 2 * pipe.applied_chunks  # two conservative fams
    assert {c[2] for c in calls} <= {1024, 2048, 4096}


def test_pow2_bucket():
    assert thf._pow2_bucket(0, 32768) == 1024
    assert thf._pow2_bucket(1025, 32768) == 2048
    assert thf._pow2_bucket(32768, 32768) == 32768
    assert thf._pow2_bucket(5000, 4096) == 4096


def test_eligible_modes():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert thf.HostGroupPipeline.eligible("on", cuda)
    assert thf.HostGroupPipeline.eligible("on", cpu)
    assert not thf.HostGroupPipeline.eligible("off", cpu)
    assert thf.HostGroupPipeline.eligible("auto", cpu)
    assert not thf.HostGroupPipeline.eligible("auto", cuda)
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        thf.HostGroupPipeline.eligible("always", cpu)


def test_lazy_close_survives_the_next_windows_updates():
    """A window closed lazily (the pipelined runtime's close) and
    extracted only after the next window's first updates gives the rows
    an eager close gives: the CMS kernels write the CURRENT state in
    place, and reset() bound fresh tensors before the next update."""
    batches = _stream(seed=5, n_keys=100, late=False)
    cfg = HeavyHitterConfig(key_cols=("src_addr",), batch_size=BS,
                            width=1 << 10, capacity=64)
    lazy = WindowedHeavyHitter(cfg, k=20, device="cpu")
    eager = WindowedHeavyHitter(cfg, k=20, device="cpu")
    lazy.lazy_extract = True
    handles, rows = [], []
    for b in batches:
        tb = _port_batch(b)
        lazy.update(tb)
        eager.update(tb)
        handles.extend(lazy.flush())
        rows.extend(eager.flush())
    assert len(handles) >= 2 and all(isinstance(h, LazyWindowTop)
                                     for h in handles)
    # every handle is resolved after later windows were updated in place
    for h, want in zip(handles, rows):
        got = h.resolve()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
