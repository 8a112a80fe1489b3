"""Fused per-chunk step: one step over every model, with shared sorts.

Counterpart of flow_pipeline_tpu/engine/fused.py (the reference's default
``processor`` path). The per-model worker updates every model in turn,
and each model groups the chunk with its own sort. The fused step groups
once where models can share:

- a heavy-hitter family whose key is a prefix of another's (src_addr
  under the 5-tuple) rides the longer family's sort: rows are sorted on
  the 4 lanes ``[h1, h2 of the prefix, h1, h2 of the full key]``, so they
  are grouped by the prefix at width 2 and by the full key at width 4;
- the dst-keyed family (top_dst_ips) and the DDoS accumulate share one
  hash sort of ``dst_addr`` and apply their own row masks to the
  gathered rows;
- every other family groups on its own; the port tables, flows_5m and
  the updates that end each family (the CMS kernel in its estimate form,
  the table merge, the dense scatter, the DDoS accumulate) run in the
  same step.

The reference compiles the step with ``jit``; here it is plain torch on
the models' state tensors, built once per model spec. Window lifecycles
(slot closes, DDoS sub-windows, late-row drops) stay on the host, in the
same transitions as the per-model wrappers: the batch is split at (slot,
sub-window) boundaries and each part advances the models' lifecycles
before its chunks run.
"""

from __future__ import annotations

import functools
import logging
from typing import Any

import numpy as np
import torch

from ..models import heavy_hitter as hh
from ..models.ddos import DDoSDetector, _accumulate_grouped
from ..models.dense_top import DenseTopKModel, dense_update
from ..models.heavy_hitter import HeavyHitterModel
from ..models.window_agg import WindowAggregator
from ..models.window_agg import _update as wagg_update
from ..ops.segment import (SENTINEL, _hash_grouped, _segment_min_keys,
                           _u64_order_key, hash_groupby_float, hash_lanes,
                           hash_sort, presorted_segments, segment_sum)
from ..schema.batch import FlowBatch, lane_width
from ..schema.keys import as_u32
from .windowed import WindowedHeavyHitter

log = logging.getLogger("flow_pipeline_tpu_torch.fused")

# the payload planes the shared sorts carry (dst-keyed B path and chains)
_HH_VALS = ("bytes", "packets")


def _hh_plan(cfg) -> tuple:
    """How a heavy-hitter family is grouped inside the step: ("B",) = the
    shared dst-keyed hash sort (masked apart from the DDoS accumulate);
    ("own",) = its own hash groupby (or a nested-family chain)."""
    if tuple(cfg.value_cols) == _HH_VALS and cfg.key_cols == ("dst_addr",):
        return ("B",)
    return ("own",)


def _chains(hh_specs) -> list[tuple[int, ...]]:
    """Nested-family chains: each "own" family whose key tuple is a
    prefix of a longer one's (with the same scale column) joins that
    family's sort. Members come shortest key first."""
    own_ix = [i for i, (plan, cfg) in enumerate(hh_specs)
              if plan[0] == "own" and tuple(cfg.value_cols) == _HH_VALS]
    own_ix.sort(key=lambda i: -len(hh_specs[i][1].key_cols))
    chains, absorbed = [], set()
    for i in own_ix:
        if i in absorbed:
            continue
        members = [i]
        pk = hh_specs[i][1].key_cols
        for j in own_ix:
            if j in absorbed or j == i:
                continue
            ck = hh_specs[j][1].key_cols
            if (len(ck) < len(pk) and pk[:len(ck)] == ck
                    and hh_specs[j][1].scale_col
                    == hh_specs[i][1].scale_col):
                members.append(j)
                absorbed.add(j)
        if len(members) > 1:
            members.sort(key=lambda m: len(hh_specs[m][1].key_cols))
            chains.append(tuple(members))
            absorbed.add(i)
    return chains


def _to_f32(col: torch.Tensor) -> torch.Tensor:
    # int32 bit patterns of uint32 counters: unsigned before the float
    # cast, so saturated values stay positive
    return as_u32(col).to(torch.float32)


def _rate_of(cols: dict, cfg):
    """The per-row sampling factor max(rate, 1), or None without a scale
    column."""
    if not getattr(cfg, "scale_col", None):
        return None
    return torch.clamp(_to_f32(cols[cfg.scale_col]), min=1.0)


def _lex_hash_perm(lanes: list[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows by ``lanes`` = [h1, h2, h1', h2', ...]
    (u32 values in int64 carriers) lexicographically and unsigned, equal
    rows in input order: stable sorts of each (h1, h2) pair's 64-bit
    order key, from the last pair to the first. The same order as the
    reference's ``lax.sort(lanes + [iota], num_keys=len(lanes))``."""
    n = lanes[0].shape[0]
    perm = torch.arange(n, device=lanes[0].device)
    for k in range(len(lanes) - 2, -1, -2):
        key = _u64_order_key(lanes[k][perm], lanes[k + 1][perm])
        _, order = torch.sort(key, stable=True)
        perm = perm[order]
    return perm


@functools.lru_cache(maxsize=None)
def _cached_step(hh_specs, dense_cfgs, ddos_cfgs, wagg_cfgs):
    """The fused step for one model spec: ``step(states, cols, valid,
    valid_hh, valid_dd) -> ((hh states, dense totals, ddos states),
    wagg partials)``. Cached on the spec (frozen config dataclasses), as
    the reference caches its compiled step; the cached value is a plain
    function and holds no state."""
    # The shared B path scales its planes by the FIRST B family's rate; a
    # second dst-keyed family with another scale column gets its own
    # groupby instead.
    b_scale = next((cfg.scale_col for plan, cfg in hh_specs
                    if plan[0] == "B"), None)
    hh_specs = tuple(
        (("own",) if plan[0] == "B" and cfg.scale_col != b_scale else plan,
         cfg)
        for plan, cfg in hh_specs)
    hh_b = any(plan[0] == "B" for plan, _ in hh_specs)
    need_b = hh_b or bool(ddos_cfgs)
    b_cfg = next((cfg for plan, cfg in hh_specs if plan[0] == "B"), None)
    chains = _chains(hh_specs)

    def run_chains(cols, valid_hh) -> dict:
        out: dict[int, tuple] = {}
        for members in chains:
            parent_cfg = hh_specs[members[-1]][1]
            full_lanes = hh._key_lanes(cols, parent_cfg.key_cols)
            lanes = []
            for m in members:
                h1, h2 = hash_lanes(hh._key_lanes(cols,
                                                  hh_specs[m][1].key_cols))
                lanes.append(torch.where(valid_hh, h1, SENTINEL))
                lanes.append(torch.where(valid_hh, h2, SENTINEL))
            perm = _lex_hash_perm(lanes)
            sh = torch.stack([lane[perm] for lane in lanes], dim=1)
            sk = torch.where(valid_hh[:, None], full_lanes, SENTINEL)[perm]
            sv = torch.stack([_to_f32(cols[c]) for c in _HH_VALS], dim=1)
            r = _rate_of(cols, parent_cfg)  # members share scale_col
            if r is not None:
                sv = sv * r[:, None]
            sv = torch.where(valid_hh[:, None], sv, 0.0)[perm]
            sc = valid_hh[perm].to(torch.int32)
            for level, m in enumerate(members):
                width = sum(lane_width(c) for c in hh_specs[m][1].key_cols)
                out[m] = _hash_grouped(sh[:, :2 * (level + 1)],
                                       sk[:, :width], sv, sc)
        return out

    def run_b(cols, valid_hh, valid_dd):
        """One dst-keyed hash sort for the B family and the DDoS
        accumulate; the masks apply to the gathered rows. Returns
        consume(plane_ix, cnt_ix, nplanes) -> (uniq, sums, counts)."""
        dst = as_u32(cols["dst_addr"])
        vb = valid_hh if hh_b else torch.zeros_like(valid_hh)
        vd = valid_dd if ddos_cfgs else torch.zeros_like(valid_hh)
        va = vb | vd
        n = dst.shape[0]
        sh_b, perm = hash_sort(dst, va)
        sk_b = torch.where(va[:, None], dst, SENTINEL)[perm]
        vbp, vdp = vb[perm], vd[perm]
        planes, cnts = [], []
        if hh_b:
            rb = _rate_of(cols, b_cfg)
            for c in _HH_VALS:
                p = _to_f32(cols[c])
                if rb is not None:
                    p = p * rb
                planes.append(torch.where(vbp, p[perm], 0.0))
            cnts.append(vbp.to(torch.int32))
        for dcfg in ddos_cfgs[:1]:  # detectors share cadence and columns
            p = _to_f32(cols[dcfg.value_col])
            rd = _rate_of(cols, dcfg)
            if rd is not None:
                p = p * rd
            planes.append(torch.where(vdp, p[perm], 0.0))
            cnts.append(vdp.to(torch.int32))
        seg = presorted_segments(sh_b)
        sums_b = segment_sum(torch.stack(planes, dim=1), seg, n)
        cnt_b = segment_sum(torch.stack(cnts, dim=1), seg, n)
        # min, not max: rows masked for NEITHER consumer keep sentinel keys
        # and share a segment with real rows only on a 64-bit hash
        # collision; min lets the real key win
        uniq_b = _segment_min_keys(sk_b, seg, n)

        def consume(plane_ix, cnt_ix, nplanes):
            counts = cnt_b[:, cnt_ix]
            real = counts > 0
            s = torch.where(real[:, None],
                            sums_b[:, plane_ix:plane_ix + nplanes], 0.0)
            u = torch.where(real[:, None], uniq_b, SENTINEL)
            return u, s, counts
        return consume

    def step(states, cols, valid, valid_hh, valid_dd):
        hh_states, dense_tots, ddos_states = states
        chain_results = run_chains(cols, valid_hh)
        consume_b = run_b(cols, valid_hh, valid_dd) if need_b else None

        new_hh = []
        for i, ((plan, cfg), st) in enumerate(zip(hh_specs, hh_states)):
            if plan[0] == "B":
                uniq, sums, counts = consume_b(0, 0, 2)
            elif i in chain_results:
                uniq, sums, counts = chain_results[i]
            else:
                lanes = hh._key_lanes(cols, cfg.key_cols)
                vals = torch.stack([_to_f32(cols[c])
                                    for c in cfg.value_cols], dim=1)
                r = _rate_of(cols, cfg)
                if r is not None:
                    vals = vals * r[:, None]
                uniq, sums, counts = hash_groupby_float(lanes, vals,
                                                        valid_hh)
            sums3 = torch.cat([sums, counts.to(torch.float32)[:, None]],
                              dim=1)
            new_hh.append(hh._apply_grouped(st, uniq, sums3, counts > 0,
                                            cfg))

        new_dense = tuple(dense_update(t, cols, valid_hh, config=c)
                          for t, c in zip(dense_tots, dense_cfgs))

        new_ddos = []
        for dcfg, dst_state in zip(ddos_cfgs, ddos_states):
            u, s, counts = consume_b(2 if hh_b else 0, 1 if hh_b else 0, 1)
            new_ddos.append(_accumulate_grouped(dst_state, u, s[:, 0],
                                                counts > 0, dcfg))

        wagg_parts = tuple(wagg_update(c, cols, valid) for c in wagg_cfgs)
        return (tuple(new_hh), new_dense, tuple(new_ddos)), wagg_parts

    return step


def _model_device(m) -> torch.device:
    return m.model.device if isinstance(m, WindowedHeavyHitter) else m.device


class FusedPipeline:
    """Drives a worker's whole model dict through one fused step per
    chunk."""

    @staticmethod
    def supported(models: dict[str, Any]) -> bool:
        """True iff every model is a kind this pipeline fuses, the
        windowed models agree on cadence and chunking, at most one DDoS
        detector is present, and every model lives on one device. (The
        port has no spread model, so a set holding one is not fusable.)"""
        whh_windows, subs, batch_sizes, devices = set(), set(), set(), set()
        for m in models.values():
            if type(m) is WindowAggregator:
                batch_sizes.add(m.config.batch_size)
            elif type(m) is WindowedHeavyHitter and type(m.model) in (
                    HeavyHitterModel, DenseTopKModel):
                whh_windows.add(m.window_seconds)
                batch_sizes.add(m.config.batch_size)
            elif type(m) is DDoSDetector:
                subs.add(m.config.sub_window_seconds)
                batch_sizes.add(m.config.batch_size)
            else:
                return False
            devices.add(_model_device(m))
        n_ddos = sum(type(m) is DDoSDetector for m in models.values())
        return (len(whh_windows) <= 1 and len(subs) <= 1 and n_ddos <= 1
                and len(batch_sizes) == 1 and len(devices) == 1)

    def __init__(self, models: dict[str, Any]):
        if not self.supported(models):
            raise ValueError("model set not fusable (see supported())")
        self._waggs: list[tuple[str, WindowAggregator]] = []
        self._hh: list[tuple[str, WindowedHeavyHitter]] = []
        self._dense: list[tuple[str, WindowedHeavyHitter]] = []
        self._ddos: list[tuple[str, DDoSDetector]] = []
        self._whh: list[WindowedHeavyHitter] = []  # hh and dense wrappers
        for name, m in models.items():
            if type(m) is WindowAggregator:
                self._waggs.append((name, m))
            elif type(m) is DDoSDetector:
                self._ddos.append((name, m))
            elif type(m.model) is HeavyHitterModel:
                self._hh.append((name, m))
                self._whh.append(m)
            else:
                self._dense.append((name, m))
                self._whh.append(m)
        first = next(iter(models.values()))
        self._bs = first.config.batch_size
        self._device = _model_device(first)
        self._window_seconds = (self._whh[0].window_seconds
                                if self._whh else None)
        self._sub_seconds = (self._ddos[0][1].config.sub_window_seconds
                             if self._ddos else None)
        self._hh_specs = tuple(
            (_hh_plan(w.config), w.config) for _, w in self._hh)
        self._cols = self._column_union()
        self._step = _cached_step(
            self._hh_specs,
            tuple(w.config for _, w in self._dense),
            tuple(d.config for _, d in self._ddos),
            tuple(m.config for _, m in self._waggs),
        )

    def _column_union(self) -> tuple[str, ...]:
        cols: list[str] = []

        def add(*names):
            for n in names:
                if n not in cols:
                    cols.append(n)

        def scale_of(cfg):
            return (cfg.scale_col,) if getattr(cfg, "scale_col", None) \
                else ()

        for _, m in self._waggs:
            add("time_received", *m.config.key_cols, *m.config.value_cols,
                *scale_of(m.config))
        for _, w in self._hh:
            add(*w.config.key_cols, *w.config.value_cols,
                *scale_of(w.config))
        for _, w in self._dense:
            add(w.config.key_col, *w.config.value_cols,
                *scale_of(w.config))
        for _, d in self._ddos:
            add("dst_addr", d.config.value_col, *scale_of(d.config))
        return tuple(cols)

    # ---- host lifecycle ---------------------------------------------------

    def _split_parts(self, batch: FlowBatch):
        """Split a batch at (window slot, DDoS sub-window) boundaries into
        homogeneous parts, in (slot, sub) order. Returns (parts, wm):
        parts = [(slot, sub, FlowBatch)], wm the batch's watermark."""
        n = len(batch)
        t = batch.columns["time_received"].astype(np.int64)
        slots = ((t // self._window_seconds) * self._window_seconds
                 if self._whh else np.zeros(n, np.int64))
        subs = ((t // self._sub_seconds) * self._sub_seconds
                if self._ddos else np.zeros(n, np.int64))
        # one (slot, sub) pair is the common case: scalar min/max passes
        # instead of a row-tuple unique
        if slots.min() == slots.max() and subs.min() == subs.max():
            groups = [(int(slots[0]), int(subs[0]), None)]
        else:
            pairs = np.stack([slots, subs], axis=1)
            uniq_pairs, inverse = np.unique(pairs, axis=0,
                                            return_inverse=True)
            inverse = inverse.reshape(-1)
            groups = [(int(slot), int(sub), np.flatnonzero(inverse == gi))
                      for gi, (slot, sub) in enumerate(uniq_pairs)]
        parts = []
        for slot, sub, idx in groups:
            part = batch if idx is None else FlowBatch(
                {k: v[idx] for k, v in batch.columns.items()},
                batch.partition)
            parts.append((slot, sub, part))
        return parts, int(t.max())

    def update(self, batch: FlowBatch) -> None:
        if len(batch) == 0:
            return
        parts, wm = self._split_parts(batch)
        for slot, sub, part in parts:
            do_hh = self._advance_hh(slot, len(part))
            do_dd = self._advance_ddos(sub, len(part))
            self._run_chunks(part, do_hh, do_dd)
        for _, m in self._waggs:
            if wm > m.watermark:
                m.watermark = wm

    def _advance_hh(self, slot: int, n_rows: int) -> bool:
        """The WindowedHeavyHitter lifecycle in lockstep (the first slot
        is adopted, a newer one closes and rolls, an older one drops its
        rows as late). False when the part is late."""
        if not self._whh:
            return False
        cur = self._whh[0].current_slot
        if cur is None:
            for w in self._whh:
                w.current_slot = slot
            return True
        if slot > cur:
            for w in self._whh:
                w._close()
                w.current_slot = slot
            return True
        if slot < cur:
            for w in self._whh:
                w.late_flows_dropped += n_rows
            return False
        return True

    def _advance_ddos(self, sub: int, n_rows: int) -> bool:
        """The DDoSDetector sub-window lifecycle in lockstep (a close
        scores the OLD sub-window before current_sub advances)."""
        if not self._ddos:
            return False
        cur = self._ddos[0][1].current_sub
        if cur is None:
            for _, d in self._ddos:
                d.current_sub = sub
            return True
        if sub > cur:
            for _, d in self._ddos:
                d.close_sub_window()
                d.current_sub = sub
            return True
        if sub < cur:
            for _, d in self._ddos:
                d.late_flows_dropped += n_rows
            return False
        return True

    def _run_chunks(self, part: FlowBatch, do_hh: bool, do_dd: bool) -> None:
        bs, dev = self._bs, self._device
        for start in range(0, len(part), bs):
            padded, mask = part.slice(start, start + bs).pad_to(bs)
            host_cols = padded.device_columns(self._cols)
            cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in host_cols.items()}
            valid = torch.from_numpy(mask).to(dev)
            zeros = torch.zeros_like(valid)
            states = (
                tuple(w.model.state for _, w in self._hh),
                tuple(w.model.totals for _, w in self._dense),
                tuple(d.state for _, d in self._ddos),
            )
            (new_hh, new_dense, new_ddos), wagg_parts = self._step(
                states, cols, valid,
                valid if do_hh else zeros,
                valid if do_dd else zeros)
            for (_, w), st in zip(self._hh, new_hh):
                w.model.state = st
                # one CMS update per family per step, late parts included
                w.model.chunk_updates += 1
            for (_, w), tot in zip(self._dense, new_dense):
                w.model.totals = tot
            for (_, d), st in zip(self._ddos, new_ddos):
                d.state = st
            for (_, m), out in zip(self._waggs, wagg_parts):
                # the exact fallback for a 64-bit hash collision closes
                # over the HOST columns (no device memory held)
                m.add_partial(out, fallback=m._exact_fallback(host_cols,
                                                              mask))
