"""The port's fused native pass (native/flowfused.cc through
native/__init__.py: fpt_ff_fused_update, fpt_ff_group_sum[_mt] and the
lane builders) against its staged engine and the JAX package's numpy
twins, on the CPU.

- HostSketchPipeline with -ingest.fused auto (one native call per family
  tree) and off (the staged prepare/apply), at 1 and 4 threads, over
  batches that cross window slots and DDoS sub-windows, with the table
  and the invertible families: every family's sketch state equal to the
  reference's staged numpy engine's after every batch, and the DDoS
  state too (the per-dst side table feeds it);
- the one-pass exact groupby and the lane builders against the numpy
  grouping and lane layouts of both packages, at any thread count;
- a grouping-only pass (a late part) and a plan whose lane selection is
  out of range.

Every sum stays inside the 2^24 integer envelope (tolerance: none).
"""

import numpy as np
import pytest

from flow_pipeline_tpu.engine import hostfused as jhf
from flow_pipeline_tpu.hostsketch import HostSketchPipeline as JHSP
from flow_pipeline_tpu.ops import hostgroup as jhg
from flow_pipeline_tpu_torch import interop, native
from flow_pipeline_tpu_torch.engine import hostfused as thf
from flow_pipeline_tpu_torch.hostsketch import HostSketchPipeline as THSP
from flow_pipeline_tpu_torch.ops import hostgroup as thg

from test_torch_fused import _port_batch, _stream
from test_torch_hostsketch import _hs_models
import torch_cpu  # noqa: F401  (one torch thread; see the module)


def _states_equal(tpipe, jpipe, where):
    for i, ((name, _), t, j) in enumerate(zip(
            tpipe._hh, tpipe._engine.states, jpipe._engine.states)):
        if t is None:
            assert j is None, (where, name)
            continue
        fields = ("cms", "keysum", "keycheck") if hasattr(t, "keysum") \
            else ("cms", "table_keys", "table_vals")
        for f in fields:
            assert np.array_equal(getattr(t, f), getattr(j, f)), \
                (where, name, f)
    for (name, td), (_, jd) in zip(tpipe._ddos, jpipe._ddos):
        for f, got, want in zip(jd.state._fields,
                                interop.ddos_state_to_reference(td.state),
                                jd.state):
            assert np.array_equal(got, np.asarray(want)), (where, name, f)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("invertible", [False, True],
                         ids=["table", "invertible"])
def test_fused_pass_matches_staged_engine(invertible, threads):
    """After every batch, the fused pass's and the staged engine's states
    equal the reference's staged numpy engine's, bit for bit."""
    batches = _stream(seed=21, n_keys=150)
    jpipe = JHSP(_hs_models(False, invertible), sketch_native="numpy",
                 fused="off")
    pipes = {mode: THSP(_hs_models(True, invertible), native_group=True,
                        fused=mode, threads=threads)
             for mode in ("auto", "off")}
    assert pipes["auto"]._fused and not pipes["off"]._fused
    trees = [ms for ms, _ in pipes["auto"]._fused_trees]
    assert trees == [[0, 1, 2]]  # the 5-tuple roots its cascade
    for k, b in enumerate(batches):
        jpipe.update(b)
        for mode, pipe in pipes.items():
            pipe.update(_port_batch(b))
            _states_equal(pipe, jpipe, f"batch {k} ingest.fused={mode}")
    assert pipes["auto"].applied_chunks == pipes["off"].applied_chunks
    assert pipes["auto"].rest_steps > 0


def test_grouping_only_pass_and_ddos_side_table():
    """do_sketch=False (a late part that still feeds DDoS) groups without
    touching any state and returns the per-dst side table of the staged
    cascade; do_ddos=False returns no table."""
    batches = _stream(seed=23, n_keys=150, late=False)
    pipe = THSP(_hs_models(True, False), fused="auto")
    staged = THSP(_hs_models(True, False), fused="off")
    cols = _port_batch(batches[0]).columns
    (ms, plan), = pipe._fused_trees
    lanes, vals = pipe._prepare_chunk(cols, len(batches[0])).fused_in[0]
    res = native.fused_update(lanes, vals, plan, None, do_sketch=False)
    want = staged._group_families(cols)[-1]
    assert np.array_equal(res[0], want[0])
    assert np.array_equal(res[1], want[1])
    assert native.fused_update(lanes, vals, plan, None, do_sketch=False,
                               do_ddos=False) is None
    assert all(st is None for st in pipe._engine.states)


def test_fused_update_rejects_an_out_of_range_plan():
    pipe = THSP(_hs_models(True, False), fused="auto")
    (ms, plan), = pipe._fused_trees
    for i in ms:
        pipe._engine.reset(i)
    states = [pipe._engine.states[i] for i in ms]
    before = [s.cms.copy() for s in states]
    bad = plan.__class__(**{**plan.__dict__,
                            "sel": plan.sel + 100})  # past the parent
    rng = np.random.default_rng(1)
    lanes = rng.integers(0, 9, (500, 11)).astype(np.uint32)
    vals = rng.integers(0, 9, (500, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="fpt_ff_fused_update"):
        native.fused_update(lanes, vals, bad, states, do_sketch=True)
    with pytest.raises(ValueError, match="rows"):
        native.fused_update(lanes, vals[:10], plan, states, do_sketch=True)
    # the root family is folded before the bad child is checked; the
    # children are untouched
    assert all(np.array_equal(s.cms, b) for s, b in
               zip(states[1:], before[1:]))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("n,w", [(1, 1), (3000, 3), (20_000, 8)])
def test_group_sum_matches_numpy(n, w, threads):
    """The one-pass exact groupby: the numpy exact grouping's groups, in
    the same hash order, with uint64 sums and counts, in both packages."""
    rng = np.random.default_rng(n + w)
    lanes = rng.integers(0, max(2, n // 6), (n, w)).astype(np.uint32)
    vals = rng.integers(0, 2**32, (n, 2), dtype=np.uint64)
    stats = native.new_stats()
    got = native.group_sum(lanes, vals, stats=stats, threads=threads)
    want = thg.group_by_key(lanes, [vals], exact=True)
    ref = jhg.group_by_key(lanes, [vals], exact=True)
    for a, b, c in zip(got, (want[0], want[1][0], want[2]),
                       (ref[0], ref[1][0], ref[2])):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert stats[native.FF_STAT_ROWS] == n
    assert stats[native.FF_STAT_GROUPS] == len(got[0])


@pytest.mark.parametrize("threads", [1, 4])
def test_lane_builders_match_numpy(threads):
    """build_lanes / build_planes_f32 / build_planes_u64 off decoded
    columns (u64 saturation, address words, the slot transform, the
    sampling-rate scale) equal the numpy layouts of both packages."""
    batch = _port_batch(_stream(seed=29, n_keys=150)[2])
    cols = dict(batch.columns)
    cols["bytes"] = cols["bytes"].copy()
    cols["bytes"][:7] = 2**40  # saturates at U32_MAX
    key_cols = ("src_addr", "dst_addr", "src_port", "dst_port", "proto")
    got = native.build_lanes([cols[c] for c in key_cols], threads=threads)
    assert np.array_equal(got, thf._key_lanes_into(cols, key_cols))
    assert np.array_equal(got, jhf._key_lanes_into(cols, key_cols))
    planes = native.build_planes_f32([cols["bytes"], cols["packets"]],
                                     scale=cols["sampling_rate"],
                                     threads=threads)
    want = thf._value_planes_np(cols, ("bytes", "packets"), "sampling_rate")
    assert np.array_equal(planes, want)
    assert np.array_equal(planes, jhf._value_planes_np(
        cols, ("bytes", "packets"), "sampling_rate"))
    cfg = _hs_models(True, False)["flows_5m"].config
    pipe = THSP(_hs_models(True, False), threads=threads)
    lanes, u64 = pipe._build_wagg_inputs(cfg, cols, len(batch))
    w_lanes, w_u64 = thf._wagg_inputs_np(cfg, cols, len(batch))
    assert np.array_equal(lanes, w_lanes) and np.array_equal(u64, w_u64)
    with pytest.raises(ValueError, match="rows"):
        native.build_lanes([cols["src_port"], cols["proto"][:5]])


def test_hash_group_accumulates_phase_counters():
    rng = np.random.default_rng(31)
    lanes = rng.integers(0, 50, (9000, 2)).astype(np.uint32)
    stats = native.new_stats()
    for threads in (1, 4):
        perm, starts, _ = native.hash_group(lanes, threads=threads,
                                            stats=stats)
    assert stats[native.FF_STAT_ROWS] == 2 * len(lanes)
    assert stats[native.FF_STAT_GROUPS] == 2 * len(starts)
    assert stats[native.FF_STAT_SLOTS["radix"]] > 0
    with pytest.raises(ValueError, match="new_stats"):
        native.hash_group(lanes, stats=np.zeros(3, np.int64))
