"""HostSketchPipeline: the ``-sketch.backend host`` dataplane.

Counterpart of flow_pipeline_tpu/hostsketch/pipeline.py. A
HostGroupPipeline whose heavy-hitter half runs on the
HOST sketch engine (hostsketch/engine.py, native/hostsketch.cc) instead
of the device step: the prepare half (grouping, the family cascade,
padding) is inherited, so both backends consume the same group tables.
The dense port scatters and the DDoS accumulate keep the device step
(``_cached_apply`` with no heavy-hitter family); flows_5m bypasses the
device already on the host-grouped pipeline.

``fused`` (``-ingest.fused``): "auto" and "on" run every family tree
through ONE native call per chunk (native/flowfused.cc: radix grouping,
cascade regroup and the CMS / prefilter / top-K or invertible update),
and the prepare half only builds lanes and value planes; "off" keeps the
staged prepare/apply split, which is the bit-exact reference of the
fused pass.

The sketch audit (``audit``, obs/audit.py) samples the staged group
tables as its base does, or on the fused pass each family's raw key lanes
(the root's lanes, a cascade member's projection of its parent's), on
the prepare half; every 8th audited chunk it notes the host tables'
churn. A close reads the models' state after ``sync_states()``.

State ownership: while streaming, sketch state lives in the engine's
uint64 buffers and the wrapped models' ``.state`` goes stale; every read
syncs first (``_advance_hh`` before a window close, the worker's
``sync_sketch_states()`` before snapshots, forced flushes and
checkpoints). Staleness is tracked by object identity: ``model.reset()``
and ``worker.restore()`` REPLACE the state object, which the next apply
detects and imports again.

Where the reference degrades to numpy because its library lacks a
feature, the port raises (engine/hostfused.py report_native_degradation);
the numpy twins serve only when asked for (``sketch_native="numpy"``).
While the native features serve, ``native_path_degraded{feature}`` is
published as 0 for each.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..engine.hostfused import (HostGroupPipeline, PreparedChunk,
                                _cached_apply, _degradation_reason,
                                mark_native_serving,
                                report_native_degradation)
from ..families import registry
from ..ingest.shard import ShardPool
from ..models.spread import SpreadState, spread_key_width
from ..obs import families
from ..obs.metrics import REGISTRY
from .engine import (HostSketchEngine, np_spread_table_merge,
                     spread_apply_update)
from .state import HostInvState

# The in-kernel phase attribution (ns by phase, rows and groups) that the
# native kernels accumulate into their stats buffer, published as
# counters per stage; labels are the FF_STAT phase names.
PHASE_COUNTERS = {
    "host_fused": families.HOST_FUSED_COUNTERS[0],
    "host_sketch": (
        "host_sketch_phase_ns_total",
        "host_sketch (staged engine) wall ns by in-kernel phase"),
    "host_group": (
        "host_group_phase_ns_total",
        "host_group ff_group_sum wall ns by in-kernel phase"),
}
ROWS_COUNTER = families.HOST_FUSED_COUNTERS[1]
GROUPS_COUNTER = families.HOST_FUSED_COUNTERS[2]

# a registry native probe's feature -> the port's native availability gate
_PROBE_AVAIL = {
    "fused": "fused_available",
    "invsketch": "inv_available",
    "spread": "spread_available",
}


def _probe_reason(kind: str, feature: str) -> str:
    """Why a registered family's native probe cannot serve (the family
    descriptor owns the symbol and its revision)."""
    for feat, symbol, rev in registry.family(kind).native_probes:
        if feat == feature:
            return _degradation_reason(symbol, rev)
    raise KeyError(f"family {kind!r} has no native probe {feature!r}")


def _publish_stats(stage: str, stats) -> None:
    """Fold one zeroed-then-accumulated stats buffer into the stage's
    phase counters."""
    from .. import native

    ctr = REGISTRY.counter(*PHASE_COUNTERS[stage])
    for phase, slot in native.FF_STAT_SLOTS.items():
        v = int(stats[slot])
        if v:
            ctr.inc(v, phase=phase)
    if stage == "host_fused":
        rows = int(stats[native.FF_STAT_ROWS])
        groups = int(stats[native.FF_STAT_GROUPS])
        if rows:
            REGISTRY.counter(*ROWS_COUNTER).inc(rows)
        if groups:
            REGISTRY.counter(*GROUPS_COUNTER).inc(groups)


class HostSketchPipeline(HostGroupPipeline):
    """Host-grouped pipeline with the host sketch engine as its
    heavy-hitter half. ``sketch_native``: auto | native | numpy (the
    engine's backend); ``fused``: auto | on | off; ``threads``: the one
    thread count of the engine kernels, the fused pass, the lane builders
    and the flows_5m fold (0: the engine's default)."""

    # families whose fold runs on the host outside the hh plan, each with
    # its own thread count and stats buffer
    _FOLD_FAMILIES = ("spread",)

    def __init__(self, models: dict, shards: int = 0,
                 native_group: bool = False,
                 pool: Optional[ShardPool] = None,
                 sketch_native: str = "auto", fused: str = "auto",
                 audit: str = "off", threads: int = 0):
        super().__init__(models, shards=shards, native_group=native_group,
                         pool=pool, audit=audit)
        self._engine = HostSketchEngine(
            [w.config for _, w in self._hh], use_native=sketch_native,
            threads=threads)
        self._native_ladder("sketch", self._engine.native,
                            _degradation_reason("fpt_hs_cms_update", "r8"),
                            sketch_native)
        # the device step covers what the engine does not: the dense port
        # scatters and the DDoS accumulate
        self._apply_rest = _cached_apply(
            (), tuple(w.config for _, w in self._dense),
            tuple(d.config for _, d in self._ddos),
        ) if (self._dense or self._ddos) else None
        # the state objects the engine's buffers mirror: `model.state is
        # not token` means reset() or restore() replaced it
        self._shadow: list = [None] * len(self._hh)
        self._sketch_dirty: list = [False] * len(self._hh)
        self._fused = False
        self._fused_trees: list = []
        # phase-counter buffers, one per thread: the apply half (worker
        # thread) and the prepare half (group thread)
        self._apply_stats = None
        self._group_stats = None
        self._spread_threads = 1
        self._spread_stats = None
        self._native_lanes = False
        self.rest_steps = 0  # chunks that ran the device rest-step
        self._audit_chunks = 0  # audited chunks (the churn probe's clock)
        if self._engine.native:
            from .. import native

            self._apply_stats = native.new_stats()
            self._group_stats = native.new_stats()
            self._native_lanes = self._native_ladder(
                "lanes", native.lanes_available(),
                _degradation_reason("fpt_ff_build_lanes", "r19"),
                sketch_native)
        self._init_fused(fused, sketch_native)
        self._init_family_folds(sketch_native)

    # ---- native feature probes ---------------------------------------------

    def _native_ladder(self, feature: str, available: bool, reason: str,
                       sketch_native: str) -> bool:
        """A serving feature publishes its gauge at 0; one that cannot
        serve under a native backend raises (the port's rule); the numpy
        opt-out stays quiet. Returns whether the feature serves."""
        if available:
            mark_native_serving(feature)
            return True
        if sketch_native != "numpy":
            report_native_degradation(feature, reason)
        return False

    def _init_family_folds(self, sketch_native: str) -> None:
        """Thread count and stats buffer of every standalone family fold
        (the spread registers), from the registry's native probes."""
        from .. import native

        for kind in self._FOLD_FAMILIES:
            setattr(self, f"_{kind}_threads", self._engine.threads)
            if not getattr(self, f"_{kind}") or not self._engine.native:
                continue
            for feature, symbol, rev in registry.family(kind).native_probes:
                avail = getattr(native, _PROBE_AVAIL[feature])()
                if self._native_ladder(
                        feature, avail, _degradation_reason(symbol, rev),
                        sketch_native):
                    setattr(self, f"_{kind}_stats", native.new_stats())

    def _fold_spread(self, ch: PreparedChunk) -> None:
        """The spread registers through the native fold (the numpy twin
        under ``sketch_native="numpy"``), then the candidate table."""
        stats = self._spread_stats
        if stats is not None:
            stats[:] = 0
        with self.stages.stage("host_spread"):
            for (name, w), (pairs, cand_keys, cand_counts, aud) in zip(
                    self._spread, ch.spread_in):
                m = w.model
                kw = spread_key_width(w.config)
                spread_apply_update(m.state.regs, pairs[:, :kw],
                                    pairs[:, kw:],
                                    threads=self._spread_threads,
                                    stats=stats,
                                    use_native=self._engine.native)
                tk, tm = np_spread_table_merge(
                    m.state.table_keys, m.state.table_metric, cand_keys,
                    cand_counts)
                m.state = SpreadState(m.state.regs, tk, tm)
                if aud is not None:
                    self.spread_audit.fold_prepared(name, aud)
        if stats is not None:
            _publish_stats("host_sketch", stats)

    # ---- native lane building ---------------------------------------------

    def _native_build(self, fn, *args, **kw):
        """One lane-builder kernel on the prepare half's stats buffer, its
        `lanes` phase published under host_group."""
        stats = self._group_stats
        if stats is not None:
            stats[:] = 0
        out = fn(*args, threads=self._engine.threads, stats=stats, **kw)
        if stats is not None:
            _publish_stats("host_group", stats)
        return out

    def _build_key_lanes(self, cols, key_cols):
        if not self._native_lanes:
            return super()._build_key_lanes(cols, key_cols)
        from .. import native

        return self._native_build(native.build_lanes,
                                  [cols[name] for name in key_cols])

    def _build_value_planes(self, cols, value_cols, scale_col):
        if not self._native_lanes:
            return super()._build_value_planes(cols, value_cols, scale_col)
        from .. import native

        return self._native_build(
            native.build_planes_f32, [cols[name] for name in value_cols],
            scale=cols[scale_col] if scale_col else None)

    def _build_wagg_inputs(self, cfg, cols, n):
        if not self._native_lanes:
            return super()._build_wagg_inputs(cfg, cols, n)
        from .. import native

        columns = [cols["time_received"]]
        mods = [cfg.window_seconds]
        for name in cfg.key_cols:
            columns.append(cols[name])
            mods.append(0)
        if cfg.scale_col:
            columns.append(cols[cfg.scale_col])
            mods.append(0)
        lanes = self._native_build(native.build_lanes, columns, mods=mods)
        planes = self._native_build(native.build_planes_u64,
                                    [cols[name] for name in cfg.value_cols])
        return lanes, planes

    # ---- the fused pass's plan --------------------------------------------

    def _init_fused(self, fused: str, sketch_native: str) -> None:
        """Resolve -ingest.fused and build the per-tree FusedPlan blocks
        (static per pipeline; only lanes, planes and state buffers change
        per chunk)."""
        from .. import native

        if fused not in ("auto", "on", "off"):
            raise ValueError(f"fused must be auto|on|off, got {fused!r}")
        cfgs = [w.config for _, w in self._hh]
        any_inv = any(c.hh_sketch == "invertible" for c in cfgs)
        engine_native = self._engine.native
        can = engine_native and native.fused_available()
        if any_inv and can and not native.inv_available():
            can = False
        if fused == "on" and not can:
            raise RuntimeError(
                "ingest.fused=on but the fused native pass cannot serve: "
                + ("the sketch engine is not native" if not engine_native
                   else _probe_reason("hh", "fused")
                   if not native.fused_available()
                   else _probe_reason("hh", "invsketch")))
        self._fused = fused != "off" and can
        if any_inv and engine_native:
            # the staged engine folds invertible families natively too
            self._native_ladder("invsketch", native.inv_available(),
                                _probe_reason("hh", "invsketch"),
                                sketch_native)
        if fused == "auto" and not can and sketch_native != "numpy":
            report_native_degradation(
                "fused", _probe_reason("hh", "fused")
                if not native.fused_available()
                else _probe_reason("hh", "invsketch"))
        elif self._fused:
            mark_native_serving("fused")
        if not self._fused:
            return
        # family trees from _fam_plan: each "own" family roots a tree and
        # every cascade family joins its (possibly chained) parent's tree,
        # parents before children (the order fpt_ff_fused_update needs)
        members: dict[int, list[int]] = {}
        root_of: dict[int, int] = {}
        for i, plan in enumerate(self._fam_plan):
            if plan[0] == "own":
                members[i] = [i]
                root_of[i] = i
        pending = [i for i, pl in enumerate(self._fam_plan)
                   if pl[0] == "cascade"]
        while pending:
            rest = []
            for i in pending:
                parent = self._fam_plan[i][1]
                if parent in root_of:
                    r = root_of[parent]
                    members[r].append(i)
                    root_of[i] = r
                else:
                    rest.append(i)
            if len(rest) == len(pending):
                raise ValueError("cascade chain has no root")
            pending = rest
        for root in sorted(members):
            ms = members[root]
            pos = {fam: k for k, fam in enumerate(ms)}
            parent = [-1]
            sel: list[int] = []
            sel_off = [0, 0]  # the root consumes no selection
            for fam in ms[1:]:
                _, par, fsel = self._fam_plan[fam]
                parent.append(pos[par])
                sel.extend(fsel)
                sel_off.append(len(sel))
            ddos_parent, ddos_sel, ddos_plane = -1, None, -1
            if (self._ddos_plan is not None
                    and self._ddos_plan[0] == "cascade"
                    and self._ddos_plan[1] in pos):
                _, dpar, dsel, dplane = self._ddos_plan
                ddos_parent = pos[dpar]
                ddos_sel = np.asarray(dsel, np.int64)
                ddos_plane = dplane
            self._fused_trees.append((ms, native.FusedPlan(
                parent=np.asarray(parent, np.int64),
                sel=np.asarray(sel, np.int64),
                sel_off=np.asarray(sel_off, np.int64),
                depth=np.asarray([cfgs[f].depth for f in ms], np.int64),
                width=np.asarray([cfgs[f].width for f in ms], np.int64),
                cap=np.asarray([cfgs[f].capacity for f in ms], np.int64),
                conservative=np.asarray(
                    [cfgs[f].conservative for f in ms], np.uint8),
                prefilter=np.asarray(
                    [cfgs[f].table_prefilter for f in ms], np.uint8),
                admission_plain=np.asarray(
                    [cfgs[f].table_admission == "plain" for f in ms],
                    np.uint8),
                ddos_parent=ddos_parent, ddos_sel=ddos_sel,
                ddos_plane=ddos_plane,
                invertible=np.asarray(
                    [cfgs[f].hh_sketch == "invertible" for f in ms],
                    np.uint8))))

    # ---- prepare half (fused: lanes only) ---------------------------------

    def _prepare_chunk(self, cols: dict, n: int) -> PreparedChunk:
        if not self._fused:
            return super()._prepare_chunk(cols, n)
        # no hh group tables: grouping, cascade and sketch run in one
        # native pass at apply time; the prepare half builds the lanes and
        # keeps what the device rest-step needs
        wagg = [self._wagg_rows(m, cols, n) for _, m in self._waggs]
        ddos_in = None
        if self._ddos_plan is not None and self._ddos_plan[0] == "own":
            # no hh family carries dst_addr: group raw rows as the staged
            # path does (this table never rides the fused pass)
            dcfg = self._ddos[0][1].config
            lanes = self._build_key_lanes(cols, ("dst_addr",))
            vals = self._build_value_planes(
                cols, (dcfg.value_col,), dcfg.scale_col)[:, 0]
            uniq, sums, _ = self._group(lanes, [vals], False)
            ddos_in = self._pad_ddos(uniq, sums[0].astype(np.float32))
        fused_in = []
        for ms, _plan in self._fused_trees:
            cfg = self._hh[ms[0]][1].config
            fused_in.append((self._build_key_lanes(cols, cfg.key_cols),
                             self._build_value_planes(
                                 cols, cfg.value_cols, cfg.scale_col)))
        audit_in = None
        if self.audit is not None:
            # the audit's hash and mask over the raw lanes, here on the
            # group thread
            audit_in = [(name, self.audit.prepare_rows(name, fl, vals))
                        for tree, (lanes, vals) in zip(self._fused_trees,
                                                       fused_in)
                        for name, fl in self._audit_family_lanes(tree,
                                                                 lanes)]
        # the spread families keep their staged pair grouping: their
        # (key, element) grouping key cannot ride the hh family trees
        return PreparedChunk(wagg, None, self._prep_dense(cols, n), ddos_in,
                             spread_in=(self._prep_spread(cols)
                                        if self._spread else None),
                             fused_in=fused_in, audit_in=audit_in)

    def _audit_family_lanes(self, tree, lanes: np.ndarray):
        """(family name, key-lane view) of every member of one fused
        tree: the root's raw lanes, each cascade member its (possibly
        chained) parent's projection. Views only: the audit copies just
        the sampled rows."""
        ms, plan = tree
        proj = [lanes]
        for k, fam in enumerate(ms):
            if k > 0:
                sel = [int(x) for x in plan.sel[
                    int(plan.sel_off[k]):int(plan.sel_off[k + 1])]]
                proj.append(proj[int(plan.parent[k])][:, sel])
            yield self._hh[fam][0], proj[k]

    def _group_exact_planes(self, lanes: np.ndarray, planes: np.ndarray):
        if self._fused:
            from .. import native

            stats = self._group_stats
            if stats is not None:
                stats[:] = 0
            res = native.group_sum(lanes, planes, stats=stats,
                                   threads=self._engine.threads)
            if stats is not None:
                _publish_stats("host_group", stats)
            if res is not None:
                return res
            # a 64-bit hash collision between distinct keys: the staged
            # path's exact lexicographic regroup
        return super()._group_exact_planes(lanes, planes)

    # ---- apply half -------------------------------------------------------

    def _timed_apply_chunk(self, ch: PreparedChunk, do_hh: bool,
                           do_dd: bool) -> None:
        # the stages are split inside: host_fused (the fused pass),
        # host_sketch (the staged engine) and device_apply (the rest-step)
        self._apply_chunk(ch, do_hh, do_dd)

    def _run_fused(self, ch: PreparedChunk, do_hh: bool, do_dd: bool):
        """The one native pass per family tree. Returns the padded DDoS
        table when a tree carries the per-dst cascade (else ch.ddos_in,
        the "own"-grouped table or None)."""
        from .. import native

        ddos_in = ch.ddos_in
        need_ddos = do_dd and any(
            plan.ddos_parent >= 0 for _, plan in self._fused_trees)
        if not (do_hh or need_ddos):
            return ddos_in
        stats = self._apply_stats
        if stats is not None:
            stats[:] = 0
        with self.stages.stage("host_fused"):
            for (ms, plan), (lanes, vals) in zip(self._fused_trees,
                                                 ch.fused_in):
                tree_ddos = plan.ddos_parent >= 0
                if not (do_hh or (need_ddos and tree_ddos)):
                    continue
                states = None
                if do_hh:
                    for i in ms:
                        self._ensure_imported(i)
                    states = [self._engine.states[i] for i in ms]
                res = native.fused_update(
                    lanes, vals, plan, states, do_sketch=do_hh,
                    do_ddos=need_ddos and tree_ddos,
                    threads=self._engine.threads, stats=stats)
                if do_hh:
                    for i in ms:
                        self._sketch_dirty[i] = True
                if res is not None:
                    ddos_in = self._pad_ddos(res[0], res[1])
        if stats is not None:
            _publish_stats("host_fused", stats)
        return ddos_in

    def _apply_chunk(self, ch: PreparedChunk, do_hh: bool,
                     do_dd: bool) -> None:
        raw_ddos = ch.ddos_in
        if ch.fused_in is not None:
            raw_ddos = self._run_fused(ch, do_hh, do_dd)
        elif do_hh and ch.hh_in is not None:
            stats = self._apply_stats
            if stats is not None:
                stats[:] = 0
            with self.stages.stage("host_sketch"):
                for i, (u, s, g) in enumerate(ch.hh_in):
                    self._ensure_imported(i)
                    self._engine.update(i, u, s, g, stats=stats)
                    self._sketch_dirty[i] = True
            if stats is not None:
                _publish_stats("host_sketch", stats)
        self.applied_chunks += 1
        # do_hh False is a late part: the device step would merge
        # all-invalid candidates, a no-op, so skipping it is exact
        if self._apply_rest is None:
            return
        dense_in = None
        if self._dense and do_hh and ch.dense_in is not None:
            dcols, dvalid = ch.dense_in
            dense_in = ({k: self._tensor(a) for k, a in dcols.items()},
                        self._tensor(dvalid))
        ddos_in = None
        if raw_ddos is not None and do_dd:
            u, s, g = raw_ddos
            v = np.zeros(u.shape[0], bool)
            v[:g] = True
            ddos_in = (self._tensor(u), self._tensor(s), self._tensor(v))
        if dense_in is None and ddos_in is None:
            return
        with self.stages.stage("device_apply"):
            states = ((), tuple(w.model.totals for _, w in self._dense),
                      tuple(d.state for _, d in self._ddos))
            _, new_dense, new_ddos = self._apply_rest(
                states, (), dense_in, ddos_in)
            if dense_in is not None:
                for (_, w), tot in zip(self._dense, new_dense):
                    w.model.totals = tot
            for (_, d), st in zip(self._ddos, new_ddos):
                d.state = st
        self.rest_steps += 1

    # ---- the sketch audit -------------------------------------------------

    def _audit_chunk(self, ch: PreparedChunk) -> None:
        """The extraction's fold (on a fused chunk, of raw rows: each
        adds its u64 addends and a count of 1, which inside the integer
        envelope sums to what the staged group tables fold), then every
        8th chunk the admission churn of the engine's host tables
        (current after the fold)."""
        super()._audit_chunk(ch)
        self._audit_chunks += 1
        if self._audit_chunks % 8 == 1:
            for i, (name, _) in enumerate(self._hh):
                st = self._engine.states[i]
                if st is not None and not isinstance(st, HostInvState):
                    # an invertible family has no candidate table
                    self.audit.note_table(name, st.table_keys)

    # ---- state synchronisation --------------------------------------------

    def _ensure_imported(self, i: int) -> None:
        model = self._hh[i][1].model
        if model.state is not self._shadow[i]:
            # reset() or restore() replaced the state object: adopt it
            self._engine.import_state(i, model.state)
            self._shadow[i] = model.state
            self._sketch_dirty[i] = False

    def sync_states(self) -> None:
        """Export engine state back into the wrapped models, so reads
        (window close, checkpoint) see current sketches. Cheap when
        nothing was folded since the last sync."""
        for i, (_, w) in enumerate(self._hh):
            if not self._sketch_dirty[i]:
                continue
            state = self._engine.export_state(i, self._device)
            w.model.state = state
            self._shadow[i] = state
            self._sketch_dirty[i] = False

    def _advance_hh(self, slot: int, n_rows: int) -> bool:
        cur = self._whh[0].current_slot if self._whh else None
        if cur is not None and slot > cur:
            # the close extracts the top-K from model state: sync first
            self.sync_states()
        return super()._advance_hh(slot, n_rows)
