"""Host-grouped fused step: batches grouped on the host, only the compact
group tables sent to the device step.

Counterpart of flow_pipeline_tpu/engine/hostfused.py. It IS a
FusedPipeline (the same
window lifecycle: slot and sub-window splitting, closes, late drops) with
another pre-aggregation: each chunk is grouped with numpy or the port's
native hash-group kernel (ops/hostgroup.py, sharded by ingest/shard.py),
and the device step (``_cached_apply``) takes what is left: the CMS
update (the conservative kernel on a card, at group-table shapes padded
to a power of two from 1,024 rows), the top-K table merges, the dense
port scatters and the DDoS accumulate. Beyond that:

- flows_5m skips the device: the host groupby is exact in uint64, so
  its rows fold straight into the window store
  (WindowAggregator.add_host_rows);
- the heavy-hitter families cascade: the family with the most key
  columns groups the raw rows, and every family whose key set is a
  strict subset (same value planes) regroups its parent's group table;
  the DDoS per-dst sums ride the dst family's table;
- the spread detectors fold their prepared pair tables on the host;
- with ``audit`` (``-obs.audit``, default sample in the worker) the
  sketch audit (obs/audit.py) samples the group tables on the prepare
  half, folds the sample after each applied chunk (the ``sketch_audit``
  stage) and evaluates it at every window close (``sketch_audit_close``,
  through the wrapped models' ``audit_hook``); the spread detectors get
  the spread audit. It only reads: the rows are the same with it off.

The split into ``prepare`` (pure host numpy, no model state: the ingest
runtime runs it on its ``ingest-group`` thread) and ``apply`` (window
lifecycle, host-to-device copies and the device step, on the worker
thread, in batch order) is what lets grouping of the next batch overlap
this one's device step. ``update(batch)`` is ``apply(prepare(batch))``.

The worker selects this pipeline with ``-processor.hostassist``: ``on``
on any device, ``auto`` when the models live on the CPU (as the
reference does on a CPU backend), ``off`` never. Its subclass
hostsketch/pipeline.py HostSketchPipeline (``-sketch.backend host``)
overrides the seams below: the lane builders, the exact flows_5m
grouping and the apply of a chunk.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ingest.shard import ShardPool, group_by_key_sharded, shared_pool
from ..models import heavy_hitter as hh
from ..models.ddos import _accumulate_grouped
from ..models.dense_top import dense_update
from ..models.spread import spread_fold, spread_key_width, spread_prepare
from ..obs import families
from ..obs.audit import SketchAudit, SpreadAudit
from ..obs.metrics import REGISTRY
from ..obs.tracing import StageTimer
from ..ops.hostgroup import select_lanes
from ..schema.batch import FlowBatch, lane_width
from .fused import FusedPipeline


def mark_native_serving(feature: str) -> None:
    """Publish ``native_path_degraded{feature=...} 0``: the native
    feature serves."""
    REGISTRY.gauge(*families.DEGRADED_GAUGE).set(0, feature=feature)


def report_native_degradation(feature: str, reason: str) -> None:
    """A requested native feature that cannot serve. The reference
    publishes ``native_path_degraded{feature=...} 1`` and goes on with
    numpy; the port publishes the 1 and raises: it has no quiet
    fallback."""
    REGISTRY.gauge(*families.DEGRADED_GAUGE).set(1, feature=feature)
    raise RuntimeError(f"native {feature} cannot serve: {reason}")


def _degradation_reason(symbol: str, since: str) -> str:
    """Why a native feature cannot serve (``since``: the reference
    revision that added ``symbol``)."""
    from .. import native

    if not native.available():
        return "the port's native library cannot be built (no g++ on PATH)"
    return (f"the loaded native library has no {symbol} export "
            f"(added in {since})")


class PreparedChunk(NamedTuple):
    """Host pre-aggregation of one device-sized chunk: everything apply
    needs, no model state touched. Group tables are built whether or not
    the chunk's window turns out late (only apply's lifecycle knows);
    apply gates them with the do_hh / do_dd valid planes."""
    wagg: list                 # per flows_5m model: (keys, sums, counts)
    hh_in: Optional[list]      # per hh family: (u [B, W], s [B, P+1], g)
    dense_in: Optional[tuple]  # (dcols padded, dvalid) or None
    ddos_in: Optional[tuple]   # (u [B, 4], s [B], g) or None
    # per spread family: (pairs [G, kw+ew] u32 unique (key, element)
    # rows, cand_keys [Gk, kw] u32, cand_counts [Gk] f32)
    spread_in: Optional[list] = None
    # the fused native pass (hostsketch/pipeline.py, -ingest.fused): per
    # family tree (root lanes [N, W] u32, value planes [N, P] f32); the
    # grouping, cascade and sketch updates run in one native call at
    # apply time, so no hh group tables exist. None: the staged path.
    fused_in: Optional[list] = None
    # the sketch audit's extraction, made on the prepare half: per hh
    # family (name, (sampled rows, u64 addends) | None). None: audit off.
    audit_in: Optional[list] = None


class PreparedBatch(NamedTuple):
    batch: FlowBatch  # the polled batch (offsets, counts)
    parts: list       # [(slot, sub, n_rows, [PreparedChunk])]
    watermark: int


_U32_MAX = np.uint64(0xFFFFFFFF)


def _u32_lane(col: np.ndarray) -> np.ndarray:
    """A raw host column as uint32 lane(s), uint64 columns saturated as
    FlowBatch.device_columns saturates them."""
    if col.dtype == np.uint64:
        return np.minimum(col, _U32_MAX).astype(np.uint32)
    return col.astype(np.uint32, copy=False)


def _fill_lanes(out: np.ndarray, off: int, lanes) -> int:
    """Write 1-D / 2-D uint32 lane arrays into the columns of ``out``
    from ``off``; returns the next free column."""
    for a in lanes:
        if a.ndim == 1:
            out[:, off] = a
            off += 1
        else:
            w = a.shape[1]
            out[:, off:off + w] = a
            off += w
    return off


def _key_lanes_into(cols: dict, key_cols) -> np.ndarray:
    """[N, W] uint32 key lanes in key-column order, written into one
    preallocated C-contiguous buffer (no concatenate pass)."""
    lanes = [_u32_lane(cols[name]) for name in key_cols]
    n = lanes[0].shape[0]
    total = sum(1 if a.ndim == 1 else a.shape[1] for a in lanes)
    out = np.empty((n, total), np.uint32)
    _fill_lanes(out, 0, lanes)
    return out


def _value_planes_np(cols: dict, value_cols,
                     scale_col: str | None = None) -> np.ndarray:
    """[N, P] float32 value planes with the device path's u32 saturation,
    times max(<scale_col>, 1) with sampling scaling (the device step's
    float32 factor)."""
    planes = np.stack([_u32_lane(cols[name]).astype(np.float32)
                       for name in value_cols], axis=1)
    if scale_col:
        r = np.maximum(_u32_lane(cols[scale_col]).astype(np.float32), 1.0)
        planes = planes * r[:, None]
    return np.ascontiguousarray(planes, dtype=np.float32)


def _wagg_inputs_np(cfg, cols: dict, n: int):
    """(lanes [N, 1 + W (+1)] u32, planes [N, P] u64) of one flows_5m
    model: the slot first, the key lanes, the rate lane last
    (window_agg.group_cols' layout)."""
    t = np.minimum(cols["time_received"], _U32_MAX).astype(np.uint32)
    slot = t - t % np.uint32(cfg.window_seconds)
    key_lanes = [_u32_lane(cols[name]) for name in cfg.key_cols]
    total = 1 + sum(1 if a.ndim == 1 else a.shape[1]
                    for a in key_lanes) + (1 if cfg.scale_col else 0)
    lanes = np.empty((n, total), np.uint32)
    lanes[:, 0] = slot
    off = _fill_lanes(lanes, 1, key_lanes)
    if cfg.scale_col:
        lanes[:, off] = _u32_lane(cols[cfg.scale_col])
    planes = [np.minimum(cols[name], _U32_MAX) for name in cfg.value_cols]
    return lanes, np.stack(planes, axis=1)


def _pow2_bucket(n: int, hi: int, lo: int = 1024) -> int:
    """Smallest power of two >= n in [lo, hi] (hi is at least any n: a
    chunk of N rows groups into at most N)."""
    b = lo
    while b < n and b < hi:
        b <<= 1
    return b


@functools.lru_cache(maxsize=None)
def _cached_apply(hh_cfgs: tuple, dense_cfgs: tuple, ddos_cfgs: tuple):
    """The device step over pre-grouped inputs, for one model spec:
    ``apply(states, hh_in, dense_in, ddos_in) -> (hh states, dense
    totals, ddos states)`` with

    hh_in:    per family (uniq [B, W] int64 u32 lanes, sums [B, P+1]
              float32, valid [B] bool);
    dense_in: (cols dict of [Nd] int32, valid [Nd]) or None;
    ddos_in:  (uniq [B, 4] int64, sums [B] float32, valid [B]) or None.

    Cached on the spec, as engine/fused.py _cached_step; the value is a
    plain function of the port's tensors and holds no state."""

    def apply(states, hh_in, dense_in, ddos_in):
        hh_states, dense_tots, ddos_states = states
        new_hh = tuple(
            hh._apply_grouped(st, u, s, v, cfg)
            for st, (u, s, v), cfg in zip(hh_states, hh_in, hh_cfgs))
        new_dense = dense_tots
        if dense_in is not None:
            dcols, dvalid = dense_in
            new_dense = tuple(dense_update(t, dcols, dvalid, config=c)
                              for t, c in zip(dense_tots, dense_cfgs))
        new_ddos = tuple(
            _accumulate_grouped(st, ddos_in[0], ddos_in[1], ddos_in[2], cfg)
            for st, cfg in zip(ddos_states, ddos_cfgs)
        ) if ddos_in is not None else ddos_states
        return new_hh, new_dense, new_ddos

    return apply


class HostGroupPipeline(FusedPipeline):
    """FusedPipeline with host (numpy / native) pre-aggregation."""

    @staticmethod
    def eligible(mode: str = "auto",
                 device: torch.device | None = None) -> bool:
        """Whether to pick this pipeline over engine/fused.py: "on"
        always, "off" never, "auto" when the models' ``device`` is the
        CPU (host memory is device memory there)."""
        if mode == "on":
            return True
        if mode == "off":
            return False
        if mode != "auto":
            raise ValueError(
                f"host_assist must be auto|on|off, got {mode!r}")
        return device is not None and torch.device(device).type == "cpu"

    def __init__(self, models: dict, shards: int = 0,
                 native_group: bool = False,
                 pool: Optional[ShardPool] = None,
                 audit: str = "off"):
        super().__init__(models)
        self.stages = StageTimer()
        # the sketch audit: a sampled exact shadow of the hh families
        # (and of the spread families), sealed at each window close by
        # the wrapped models' audit_hook
        if audit not in ("off", "sample", "full"):
            raise ValueError(
                f"audit must be off|sample|full, got {audit!r}")
        self.audit = None
        if audit != "off" and self._hh:
            self.audit = SketchAudit(
                {name: (w.config, w.k) for name, w in self._hh},
                mode=audit)
            for name, w in self._hh:
                w.audit_hook = self._audit_close_hook(self.audit, name)
        self.spread_audit = None
        if audit != "off" and self._spread:
            self.spread_audit = SpreadAudit(
                {name: w.config for name, w in self._spread}, mode=audit)
            for name, w in self._spread:
                w.audit_hook = self._audit_close_hook(self.spread_audit,
                                                      name)
        # native_group: the C hash-group kernel, built now; a build or
        # load failure raises here instead of grouping with numpy
        self._native = native_group
        if native_group:
            from .. import native

            native.library()
            mark_native_serving("group")
        # shards=1 disables the sharded path; 0 sizes it to the pool
        self._shards = shards
        self._pool = None if shards == 1 else (pool or shared_pool())
        # family plan: the widest key families group raw rows; each
        # strict-subset family (same value planes and scale) regroups its
        # smallest such parent's group table
        self._widths = {}
        cfgs = [w.config for _, w in self._hh]
        for c in cfgs:
            for name in c.key_cols:
                self._widths[name] = lane_width(name)
        order = sorted(range(len(cfgs)),
                       key=lambda i: -len(cfgs[i].key_cols))
        self._fam_plan: list[tuple] = [()] * len(cfgs)
        planned: list[int] = []
        for i in order:
            parent = None
            for j in planned:
                if (set(cfgs[i].key_cols) < set(cfgs[j].key_cols)
                        and tuple(cfgs[i].value_cols)
                        == tuple(cfgs[j].value_cols)
                        and cfgs[i].scale_col == cfgs[j].scale_col):
                    if parent is None or len(cfgs[j].key_cols) < len(
                            cfgs[parent].key_cols):
                        parent = j
            if parent is None:
                self._fam_plan[i] = ("own",)
            else:
                sel = select_lanes(cfgs[parent].key_cols, self._widths,
                                   cfgs[i].key_cols)
                self._fam_plan[i] = ("cascade", parent, tuple(sel))
            planned.append(i)
        # DDoS per-dst sums ride a family keyed on dst_addr whose value
        # planes carry the detector's value column
        self._ddos_plan = None
        if self._ddos:
            dcfg = self._ddos[0][1].config
            for j, c in enumerate(cfgs):
                if ("dst_addr" in c.key_cols
                        and dcfg.value_col in c.value_cols
                        and c.scale_col == dcfg.scale_col):
                    self._ddos_plan = (
                        "cascade", j,
                        tuple(select_lanes(c.key_cols, {
                            **self._widths, "dst_addr": 4}, ("dst_addr",))),
                        c.value_cols.index(dcfg.value_col))
                    break
            if self._ddos_plan is None:
                self._ddos_plan = ("own",)
        self._apply = _cached_apply(
            tuple(w.config for _, w in self._hh),
            tuple(w.config for _, w in self._dense),
            tuple(d.config for _, d in self._ddos))
        self.applied_chunks = 0  # chunks that ran the device step

    # ---- prepare half: host numpy only ------------------------------------

    def prepare(self, batch: FlowBatch) -> Optional[PreparedBatch]:
        """Group one batch on the host. Touches no model state, so it may
        run on another thread than apply."""
        if len(batch) == 0:
            return None
        parts, wm = self._split_parts(batch)
        out_parts = []
        with self.stages.stage("host_group"):
            for slot, sub, part in parts:
                chunks = []
                for start in range(0, len(part), self._bs):
                    chunk = part.slice(start, start + self._bs)
                    chunks.append(self._prepare_chunk(chunk.columns,
                                                      len(chunk)))
                out_parts.append((slot, sub, len(part), chunks))
        return PreparedBatch(batch, out_parts, wm)

    def _prepare_chunk(self, cols: dict, n: int) -> PreparedChunk:
        # flows_5m: an exact uint64 groupby straight into the window store
        wagg = [self._wagg_rows(m, cols, n) for _, m in self._waggs]
        spread_in = self._prep_spread(cols) if self._spread else None
        if not (self._hh or self._dense or self._ddos):
            return PreparedChunk(wagg, None, None, None, spread_in)
        fams = (self._group_families(cols)
                if (self._hh or self._ddos) else None)
        prep = PreparedChunk(wagg, *self._prep_device(cols, fams, n),
                             spread_in)
        if self.audit is not None and prep.hh_in is not None:
            # the audit samples the same tables, on the same thread
            prep = prep._replace(audit_in=[
                (name, self.audit.prepare_grouped(name, u, s, g))
                for (name, _), (u, s, g) in zip(self._hh, prep.hh_in)])
        return prep

    def _group(self, lanes, planes, exact):
        return group_by_key_sharded(lanes, planes, self._pool, self._shards,
                                    exact=exact, native=self._native)

    def _wagg_rows(self, m, cols: dict, n: int):
        lanes, planes = self._build_wagg_inputs(m.config, cols, n)
        return self._group_exact_planes(lanes, planes)

    # ---- seams: the lane layouts and the exact grouping ------------------
    #
    # The numpy bodies are the plain versions; HostSketchPipeline routes
    # them through the native lane builders and the one-pass exact
    # groupby (native/flowfused.cc).

    def _build_key_lanes(self, cols: dict, key_cols) -> np.ndarray:
        return _key_lanes_into(cols, key_cols)

    def _build_value_planes(self, cols: dict, value_cols,
                            scale_col) -> np.ndarray:
        return _value_planes_np(cols, value_cols, scale_col)

    def _build_wagg_inputs(self, cfg, cols: dict, n: int):
        return _wagg_inputs_np(cfg, cols, n)

    def _group_exact_planes(self, lanes: np.ndarray, planes: np.ndarray):
        """Exact groupby-sum of [N, P] uint64 planes (flows_5m)."""
        uniq, sums, counts = self._group(lanes, [planes], True)
        return uniq, sums[0], counts

    def _prep_spread(self, cols: dict) -> list:
        """Per spread family: the chunk's unique (key, element) pairs, the
        per-key pair counts (group order does not matter: the register
        fold is an order-free max and the table merge lex-groups) and the
        spread audit's sample of the pairs (None with the audit off)."""
        out = []
        for name, w in self._spread:
            cfg = w.config
            lanes = self._build_key_lanes(cols,
                                          (*cfg.key_cols, cfg.elem_col))
            prep = spread_prepare(lanes, spread_key_width(cfg), self._group)
            aud = (self.spread_audit.prepare_pairs(name, prep[0])
                   if self.spread_audit is not None else None)
            out.append((*prep, aud))
        return out

    def _group_families(self, cols: dict) -> list[tuple]:
        """Per hh family (uniq [G, W] u32, value sums [G, P] f64, counts
        [G]) in the family cascade, then the DDoS per-dst (uniq, sums)
        when planned."""
        out: list = [None] * len(self._hh)
        for i, (plan, (_, w)) in enumerate(zip(self._fam_plan, self._hh)):
            if plan[0] != "own":
                continue
            cfg = w.config
            lanes = self._build_key_lanes(cols, cfg.key_cols)
            vals = self._build_value_planes(cols, cfg.value_cols,
                                            cfg.scale_col)
            uniq, sums, counts = self._group(lanes, [vals], False)
            out[i] = (uniq, sums[0], counts)
        for i, plan in enumerate(self._fam_plan):
            if plan[0] != "cascade":
                continue
            _, parent, sel = plan
            p_uniq, p_vsum, p_cnt = out[parent]
            uniq, sums, _ = self._group(p_uniq[:, list(sel)],
                                        [p_vsum, p_cnt], False)
            out[i] = (uniq, sums[0], sums[1].astype(np.int64))
        if self._ddos_plan is not None:
            dcfg = self._ddos[0][1].config
            if self._ddos_plan[0] == "cascade":
                _, parent, sel, plane = self._ddos_plan
                p_uniq, p_vsum, _ = out[parent]
                uniq, sums, _ = self._group(p_uniq[:, list(sel)],
                                            [p_vsum[:, plane]], False)
            else:
                lanes = self._build_key_lanes(cols, ("dst_addr",))
                vals = self._build_value_planes(cols, (dcfg.value_col,),
                                        dcfg.scale_col)[:, 0]
                uniq, sums, _ = self._group(lanes, [vals], False)
            out.append((uniq, sums[0].astype(np.float32)))
        return out

    def _prep_device(self, cols: dict, fams, n: int):
        """Pad the group tables to power-of-two buckets (per family: a
        cascade family groups 3-4x smaller than its parent) and the dense
        columns to the chunk shape. Valid planes wait for apply."""
        hi = max(self._bs, 1024)
        hh_in = []
        for i in range(len(self._hh)):
            uniq, vsum, cnt = fams[i]
            g = uniq.shape[0]
            b = _pow2_bucket(g, hi=hi)
            p = vsum.shape[1]
            u = np.zeros((b, uniq.shape[1]), np.uint32)
            s = np.zeros((b, p + 1), np.float32)
            u[:g] = uniq
            s[:g, :p] = vsum
            s[:g, p] = cnt
            hh_in.append((u, s, g))
        ddos_in = (self._pad_ddos(*fams[-1])
                   if self._ddos_plan is not None else None)
        return hh_in, self._prep_dense(cols, n), ddos_in

    def _prep_dense(self, cols: dict, n: int):
        """The port tables' columns, padded to the chunk shape, as int32
        bit patterns (FlowBatch.device_columns' form)."""
        if not self._dense:
            return None
        need = set()
        for _, w in self._dense:
            need.add(w.config.key_col)
            need.update(w.config.value_cols)
            if w.config.scale_col:
                need.add(w.config.scale_col)
        dcols = {}
        for name in need:
            a = np.zeros(self._bs, np.uint32)
            a[:n] = _u32_lane(cols[name])
            dcols[name] = a.view(np.int32)
        dvalid = np.zeros(self._bs, bool)
        dvalid[:n] = True
        return dcols, dvalid

    def _pad_ddos(self, uniq: np.ndarray, dsum: np.ndarray):
        """A per-dst group table padded to its power-of-two bucket."""
        g = uniq.shape[0]
        b = _pow2_bucket(g, hi=max(self._bs, 1024))
        u = np.zeros((b, 4), np.uint32)
        s = np.zeros(b, np.float32)
        u[:g] = uniq
        s[:g] = dsum
        return u, s, g

    # ---- apply half: lifecycle and model state ----------------------------

    def apply(self, prep: Optional[PreparedBatch]) -> None:
        """Advance the window lifecycles and fold one prepared batch into
        the models. Runs on the thread that owns model state (the
        worker's), in batch order."""
        if prep is None:
            return
        for slot, sub, n_rows, chunks in prep.parts:
            do_hh = self._advance_hh(slot, n_rows)
            do_dd = self._advance_ddos(sub, n_rows)
            for ch in chunks:
                for (_, m), rows in zip(self._waggs, ch.wagg):
                    m.add_host_rows(*rows)
                if not (do_hh or do_dd):
                    continue  # a late part: nothing but flows_5m takes it
                if do_hh and ch.spread_in is not None:
                    self._fold_spread(ch)
                if ch.hh_in is None and ch.dense_in is None \
                        and ch.ddos_in is None and ch.fused_in is None:
                    continue
                self._timed_apply_chunk(ch, do_hh, do_dd)
                if do_hh and self.audit is not None:
                    # after the fold, gated as the sketches are: the
                    # cohort covers exactly the rows they took
                    with self.stages.stage("sketch_audit"):
                        self._audit_chunk(ch)
        for _, m in self._waggs:
            if prep.watermark > m.watermark:
                m.watermark = prep.watermark

    def update(self, batch: FlowBatch) -> None:
        self.apply(self.prepare(batch))

    def _fold_spread(self, ch: PreparedChunk) -> None:
        """Fold one chunk's pair tables into the spread models (the same
        state as SpreadModel.update over the chunk)."""
        with self.stages.stage("host_spread"):
            for (name, w), (*prep, aud) in zip(self._spread, ch.spread_in):
                w.model.state = spread_fold(w.model.state, w.config, *prep)
                if aud is not None:
                    self.spread_audit.fold_prepared(name, aud)

    # ---- the sketch audit's hooks ------------------------------------------

    def _audit_close_hook(self, audit, name: str):
        """The window-close hook handed to a wrapped model: seal the
        cohort against the closing state, timed apart from the per-chunk
        fold (a once-per-window lump: the card's planes come to the
        host)."""
        def hook(slot, model):
            with self.stages.stage("sketch_audit_close"):
                audit.on_close(name, slot, model)
        return hook

    def _audit_chunk(self, ch: PreparedChunk) -> None:
        """Fold one applied chunk's extraction (made by the prepare
        half) into the audit."""
        for name, prepared in ch.audit_in:
            self.audit.fold_prepared(name, prepared)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the models' device; uint32 lanes widen to the
        port's int64 carriers."""
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    def _timed_apply_chunk(self, ch: PreparedChunk, do_hh: bool,
                           do_dd: bool) -> None:
        """Stage attribution seam: here the whole chunk apply is the
        device step; HostSketchPipeline splits its chunk between
        host_fused / host_sketch and device_apply."""
        with self.stages.stage("device_apply"):
            self._apply_chunk(ch, do_hh, do_dd)

    def _apply_chunk(self, ch: PreparedChunk, do_hh: bool,
                     do_dd: bool) -> None:
        """The device step of one chunk: host-to-device copies of the
        padded tables, then _cached_apply (one CMS update per hh family,
        the kernel on a card)."""
        hh_in = []
        for u, s, g in ch.hh_in:
            v = np.zeros(u.shape[0], bool)
            v[:g] = do_hh
            hh_in.append((self._tensor(u), self._tensor(s), self._tensor(v)))
        dense_in = None
        if ch.dense_in is not None and do_hh:
            dcols, dvalid = ch.dense_in
            dense_in = ({k: self._tensor(a) for k, a in dcols.items()},
                        self._tensor(dvalid))
        ddos_in = None
        if ch.ddos_in is not None:
            u, s, g = ch.ddos_in
            v = np.zeros(u.shape[0], bool)
            v[:g] = do_dd
            ddos_in = (self._tensor(u), self._tensor(s), self._tensor(v))
        states = (tuple(w.model.state for _, w in self._hh),
                  tuple(w.model.totals for _, w in self._dense),
                  tuple(d.state for _, d in self._ddos))
        new_hh, new_dense, new_ddos = self._apply(
            states, tuple(hh_in), dense_in, ddos_in)
        for (_, w), st in zip(self._hh, new_hh):
            w.model.state = st
            w.model.chunk_updates += 1  # one CMS update per family
        if dense_in is not None:
            for (_, w), tot in zip(self._dense, new_dense):
                w.model.totals = tot
        for (_, d), st in zip(self._ddos, new_ddos):
            d.state = st
        self.applied_chunks += 1
