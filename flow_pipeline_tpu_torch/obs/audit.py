"""The sketch audit (``-obs.audit``): how wrong the sketches are, measured
on the running system.

Counterpart of flow_pipeline_tpu/obs/audit.py (numpy only), copied so the
port imports nothing of the JAX package:

- **Sampled exact shadow.** Keys are hash-sampled at about 1/256 with a
  fixed protocol seed over the uint32 key lanes every backend hashes, so
  every worker samples the same cohort. For that cohort the audit keeps
  exact uint64 sums on the host and, at each window close, compares them
  with the CMS estimates (``np_cms_query_u64``) and the ranked candidate
  table: relative-error histograms
  (``sketch_estimate_error_ratio{family,path=cms|table}``), sampled
  recall and precision at k, and false drops.
- **Saturation.** CMS fill per plane, min and max row load, table
  occupancy, admission churn and the est-admitted fraction.

The addends go through the CMS update's own clamp (``_addend_u64``) and
are summed in uint64, so chunking, grouping granularity (raw rows on the
fused pass, group tables on the staged path) and thread order cannot
change the totals inside the integer envelope. The audit only reads: the
sink rows are bit-equal with it on and off.

On the card the closing state's CMS planes and table are tensors there;
``_state_arrays`` copies them to the host (``frozen_cms`` and ``_np`` of
hostsketch/state.py), about 3 MB per family at the default widths, once
per window close on the worker thread (the ``sketch_audit_close`` stage).

A mesh member sets the auditor's ``capture``: each close then ships the
cohort to the member, which sends it inside the family's payload, and
the coordinator audits the merged sketch against the merged cohort.

The metric families are the ones obs/families.py registers on every
worker (``register_audit_metrics``), bound here, never registered twice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .families import ERROR_RATIO_BUCKETS, register_audit_metrics
from .metrics import REGISTRY

# The sampling contract: a multiply-shift lane fold (sum_i lane_i * K_i
# mod 2^32, K_i odd constants minted from this seed by a splitmix round)
# finished with murmur3's fmix32; keys whose low AUDIT_SAMPLE_BITS are
# zero are sampled (about 1/256). Seed and fold are protocol constants:
# the reference samples the same keys.
AUDIT_SAMPLE_SEED = 0x5EED_A0D1
AUDIT_SAMPLE_BITS = 8

_FMIX1 = np.uint32(0x85EBCA6B)
_FMIX2 = np.uint32(0xC2B2AE35)


def _lane_mults(n: int, seed: int = AUDIT_SAMPLE_SEED) -> tuple:
    """Per-position odd uint32 multipliers, splitmix-minted from a
    protocol seed (position-dependent: permuted key tuples hash apart).
    The guard mints its admission multipliers from its own seed here, so
    its shed set stays uncorrelated with the audit cohort."""
    out = []
    x = seed & 0xFFFFFFFF
    for _ in range(n):
        x = (x + 0x9E3779B9) & 0xFFFFFFFF
        z = x
        z = ((z ^ (z >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
        z = ((z ^ (z >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
        z ^= z >> 16
        out.append(np.uint32(z | 1))  # odd: the multiply is a bijection
    return tuple(out)


_LANE_MULTS = _lane_mults(16)


def _sample_hash(lanes: np.ndarray, mults: Optional[tuple] = None
                 ) -> np.ndarray:
    """[N] uint32 sampling hash of [N, W] uint32 key lanes, in two
    buffers with every op in place (it runs per chunk per family).
    ``mults`` selects the multiplier family (default: the audit cohort's;
    the guard passes its own-seed multipliers)."""
    w = lanes.shape[1]
    if mults is None:
        mults = _LANE_MULTS
    if w > len(mults):
        mults = _lane_mults(w)
    tmp = np.empty(lanes.shape[0], np.uint32)
    with np.errstate(over="ignore"):
        h = np.multiply(lanes[:, 0], mults[0])
        for i in range(1, w):
            np.multiply(lanes[:, i], mults[i], out=tmp)
            h += tmp
        np.right_shift(h, np.uint32(16), out=tmp)
        h ^= tmp
        h *= _FMIX1
        np.right_shift(h, np.uint32(13), out=tmp)
        h ^= tmp
        h *= _FMIX2
        np.right_shift(h, np.uint32(16), out=tmp)
        h ^= tmp
    return h


# Per-family cohort cap (2^8 * cap distinct keys per window before it
# bites); an overflow is counted, because a capped cohort is no longer
# comparable across shards.
AUDIT_MAX_COHORT = 1 << 18

# The spread audit's families (registered when a SpreadAudit is built,
# as in the reference). The error can run both ways: HLL is unbiased.
SPREAD_AUDIT_METRICS = {
    "error": ("sketch_spread_error_ratio",
              "sampled-cohort spread relative error (decoded - exact "
              "distinct) / exact distinct at window close "
              "(label: family)"),
    "cohort": ("sketch_spread_audit_sampled_keys",
               "sampled exact-distinct shadow cohort size at the last "
               "window close (label: family)"),
    "windows": ("sketch_spread_audit_windows_total",
                "spread windows audited (label: family)"),
    "overflow": ("sketch_spread_audit_cohort_overflow_total",
                 "sampled spread keys dropped past AUDIT_MAX_COHORT "
                 "(label: family)"),
}


def register_spread_audit_metrics() -> dict:
    """Register (or fetch) the spread audit's families; idempotent."""
    out = {}
    for key, spec in SPREAD_AUDIT_METRICS.items():
        if key == "error":
            out[key] = REGISTRY.histogram(*spec,
                                          buckets=ERROR_RATIO_BUCKETS)
        elif key == "cohort":
            out[key] = REGISTRY.gauge(*spec)
        else:
            out[key] = REGISTRY.counter(*spec)
    return out


_SENTINEL = np.uint32(0xFFFFFFFF)


def sample_mask(lanes: np.ndarray, mode: str = "sample") -> np.ndarray:
    """[N] bool: which rows' keys are in the cohort. ``full`` audits every
    key; ``sample`` is the deterministic ~1/256 cohort."""
    if mode == "full":
        return np.ones(lanes.shape[0], bool)
    h = _sample_hash(np.asarray(lanes, dtype=np.uint32))
    return (h & np.uint32((1 << AUDIT_SAMPLE_BITS) - 1)) == np.uint32(0)


# ---- pure evaluation helpers ------------------------------------------------


def _state_arrays(state, config=None):
    """(cms u64 [P+1, D, W], table_keys u32, table_vals f32) on the host,
    from any sketch-state form: a torch HHState (on the card or the CPU),
    a HostHHState, a checkpoint field dict, or an invertible state
    (InvState, HostInvState, its field dict), whose table is decoded from
    the sketch at ``config.capacity`` (the ranking the family emits)."""
    from ..hostsketch.state import _np, frozen_cms, is_inv_state

    has_table = (("table_keys" in state) if isinstance(state, dict)
                 else hasattr(state, "table_keys"))
    if not has_table and is_inv_state(state):
        from ..hostsketch.engine import inv_extract

        if config is None:
            raise ValueError(
                "an invertible-state audit needs the family config "
                "(capacity)")
        tk, tv = inv_extract(state, config.capacity)
        return frozen_cms(state), tk, tv
    cms = frozen_cms(state)
    if isinstance(state, dict):
        tk, tv = state["table_keys"], state["table_vals"]
    else:
        tk, tv = state.table_keys, state.table_vals
    # the port carries u32 lanes as int64 on the device: the low 32 bits
    return (cms,
            np.ascontiguousarray(_np(tk).astype(np.uint32)),
            np.asarray(_np(tv), dtype=np.float32))


def _quantiles(ratios: np.ndarray) -> dict:
    if not len(ratios):
        return {"p50": 0.0, "p99": 0.0, "max": 0.0}
    s = np.sort(ratios)
    return {
        "p50": float(s[min(len(s) - 1, int(0.5 * len(s)))]),
        "p99": float(s[min(len(s) - 1, int(0.99 * len(s)))]),
        "max": float(s[-1]),
    }


def audit_report(keys: np.ndarray, vals: np.ndarray, state, config,
                 k: int, slot=None, scale: int = 1) -> dict:
    """Compare one sampled exact cohort with one sketch state.

    ``keys`` [K, W] uint32 cohort key lanes, ``vals`` [K, P+1] uint64
    exact sums (count plane last), ``state`` the family's state at the
    window close. ``scale`` is the sampling denominator (1 for the full
    cohort, 2^AUDIT_SAMPLE_BITS for the sample): recall and precision
    compare the table's top-k with the cohort's top-ceil(k/scale). Pure;
    :func:`publish_report` publishes."""
    from ..hostsketch.engine import np_cms_query_u64

    cms, tkeys, tvals = _state_arrays(state, config)
    n = keys.shape[0]
    report: dict = {"slot": None if slot is None else int(slot),
                    "sampled_keys": int(n), "k": int(k)}
    # saturation first: defined even with an empty cohort
    planes = cms.shape[0]
    fill = [float(np.count_nonzero(cms[p]) / cms[p].size)
            for p in range(planes)]
    count_rows = cms[-1]
    row_fill = np.count_nonzero(count_rows, axis=1) / count_rows.shape[1]
    t_real = (tkeys != _SENTINEL).any(axis=1)
    report.update({
        "fill_ratio": [round(f, 6) for f in fill],
        "row_load_min": round(float(row_fill.min()), 6),
        "row_load_max": round(float(row_fill.max()), 6),
        "table_occupancy": round(float(t_real.sum() / len(t_real)), 6),
    })
    if n == 0:
        empty = np.empty(0, np.float64)
        report.update({"resident": 0, "cms_err": _quantiles(empty),
                       "table_err": _quantiles(empty),
                       "recall_at_k": None, "precision_at_k": None,
                       "false_drops": 0, "est_admitted_fraction": 0.0})
        return report
    exact = vals[:, -1].astype(np.float64)  # the count plane: always >= 1
    est = np_cms_query_u64(cms, keys)[:, -1].astype(np.float64)
    cms_ratio = (est - exact) / exact
    # table path: each cohort key's row in the ranked table (row index ==
    # rank; -1 absent), by a vectorized void-row match
    t_idx = np.flatnonzero(t_real)
    tpos = np.full(n, -1, np.int64)
    if len(t_idx):
        tk = np.ascontiguousarray(tkeys[t_idx])
        kc = np.ascontiguousarray(keys)
        tv = tk.view([("", tk.dtype)] * tk.shape[1]).reshape(-1)
        kv = kc.view([("", kc.dtype)] * kc.shape[1]).reshape(-1)
        t_order = np.argsort(tv)
        pos = np.minimum(np.searchsorted(tv[t_order], kv),
                         len(t_order) - 1)
        found = tv[t_order[pos]] == kv
        tpos[found] = t_idx[t_order[pos[found]]]
    resident = tpos >= 0
    table_ratio = np.empty(0, np.float64)
    est_frac = 0.0
    if resident.any():
        tv = tvals[tpos[resident], -1].astype(np.float64)
        ex = exact[resident]
        table_ratio = (tv - ex) / ex
        est_frac = float((tv > ex).mean())
    # the sampled ground truth: the cohort ranked by the primary plane as
    # the table ranks (plane 0 descending, stable), its scaled-k head
    kk = min(n, max(1, -(-int(k) // max(int(scale), 1))))
    order = np.argsort(-vals[:, 0].astype(np.float64), kind="stable")
    truth = set(order[:kk].tolist())
    # the sampled keys the ranked table would emit at k
    predicted = set(np.flatnonzero(resident & (tpos < int(k))).tolist())
    hit = len(truth & predicted)
    top_pred = set(order[:len(predicted)].tolist())
    report.update({
        "resident": int(resident.sum()),
        "cms_err": {kq: round(v, 6)
                    for kq, v in _quantiles(cms_ratio).items()},
        "table_err": {kq: round(v, 6)
                      for kq, v in _quantiles(table_ratio).items()},
        "recall_at_k": round(hit / len(truth), 6) if truth else None,
        "precision_at_k": round(
            len(predicted & top_pred) / len(predicted), 6)
        if predicted else None,
        "false_drops": int(sum(1 for i in truth if tpos[i] < 0)),
        "est_admitted_fraction": round(est_frac, 6),
    })
    report["_cms_ratios"] = cms_ratio
    report["_table_ratios"] = table_ratio
    return report


def publish_report(family: str, report: dict,
                   metrics: Optional[dict] = None) -> dict:
    """Push one family's close report into the registry; returns the
    report without its internal arrays (JSON-safe)."""
    m = metrics if metrics is not None else register_audit_metrics()
    for r in report.pop("_cms_ratios", ()):
        m["error"].observe(float(r), family=family, path="cms")
    for r in report.pop("_table_ratios", ()):
        m["error"].observe(float(r), family=family, path="table")
    m["cohort"].set(report["sampled_keys"], family=family)
    m["windows"].inc(family=family)
    for p, f in enumerate(report["fill_ratio"]):
        m["fill"].set(f, family=family, plane=str(p))
    m["row_min"].set(report["row_load_min"], family=family)
    m["row_max"].set(report["row_load_max"], family=family)
    m["occupancy"].set(report["table_occupancy"], family=family)
    if report.get("recall_at_k") is not None:
        m["recall"].set(report["recall_at_k"], family=family)
    if report.get("precision_at_k") is not None:
        m["precision"].set(report["precision_at_k"], family=family)
    if report.get("false_drops"):
        m["false_drop"].inc(report["false_drops"], family=family)
    m["est_frac"].set(report.get("est_admitted_fraction", 0.0),
                      family=family)
    return report


# ---- the per-pipeline auditor -----------------------------------------------


class _FamilyAudit:
    __slots__ = ("config", "k", "exact", "evictions", "prev_table")

    def __init__(self, config, k: int):
        self.config = config
        self.k = k
        # key-lane bytes -> uint64 [P+1] exact sums (count plane last)
        self.exact: dict[bytes, np.ndarray] = {}
        self.evictions = 0  # table churn since the window opened
        self.prev_table: set | None = None


class SketchAudit:
    """Sampled exact shadow audit of one pipeline's heavy-hitter families.

    ``families``: {name: (HeavyHitterConfig, k)}; ``mode``: ``sample``
    (the ~1/256 cohort) or ``full`` (every key). Owned by one pipeline:
    ``fold_prepared``/``note_table`` and the closes run on the worker
    thread; ``prepare_*`` are pure and run on the group thread."""

    def __init__(self, families: dict, mode: str = "sample"):
        if mode not in ("sample", "full"):
            raise ValueError(
                f"audit mode must be sample|full, got {mode!r} "
                "(off = don't construct an auditor)")
        self.mode = mode
        self._fams = {name: _FamilyAudit(cfg, k)
                      for name, (cfg, k) in families.items()}
        # the guard's level >= 1 pauses cohort refresh (prepare_* return
        # None); the cohort already held still evaluates at window close.
        # A bool flipped on the worker thread and read on the group
        # thread: a stale read folds or skips one chunk
        self.paused = False
        # the mesh member's hook, (name, slot, partial) -> None, bound
        # before the worker loop starts: closes ship the cohort to it
        self.capture = None
        # the newest JSON-safe close report per family
        self.last_reports: dict[str, dict] = {}
        self._m = register_audit_metrics()

    # ---- accumulation -----------------------------------------------------

    def _fold(self, fam: _FamilyAudit, rows: np.ndarray,
              add: np.ndarray, family: str) -> None:
        """Fold sampled (key rows, u64 addends) into the cohort, rows
        pre-summed per key first (exact and order-free)."""
        if rows.shape[0] > 1:
            from ..ops.hostgroup import _lex_regroup

            order, starts = _lex_regroup(rows)
            add = np.add.reduceat(add[order], starts, axis=0)
            rows = np.ascontiguousarray(rows[order][starts])
        exact = fam.exact
        overflow = 0
        for i in range(rows.shape[0]):
            key = rows[i].tobytes()
            vec = exact.get(key)
            if vec is None:
                if len(exact) >= AUDIT_MAX_COHORT:
                    overflow += 1
                    continue
                exact[key] = add[i].copy()
            else:
                vec += add[i]
        if overflow:
            self._m["overflow"].inc(overflow, family=family)

    def prepare_grouped(self, name: str, uniq: np.ndarray,
                        sums: np.ndarray, n_groups: int):
        """Staged-path extraction from one group table (``uniq`` [B, W]
        u32 padded, ``sums`` [B, P+1] f32, the first ``n_groups`` real)
        -> (rows, u64 addends) or None. Pure."""
        from ..hostsketch.engine import _addend_u64

        if self.paused or name not in self._fams or n_groups <= 0:
            return None
        lanes = uniq[:n_groups]
        mask = sample_mask(lanes, self.mode)
        if not mask.any():
            return None
        return (np.ascontiguousarray(lanes[mask]),
                _addend_u64(sums[:n_groups][mask]))

    def prepare_rows(self, name: str, lanes: np.ndarray,
                     vals: np.ndarray):
        """Fused-path extraction from raw rows (``lanes`` [N, W] u32,
        ``vals`` [N, P] f32; each row counts 1 on the count plane) ->
        (rows, u64 addends) or None. Pure."""
        from ..hostsketch.engine import _addend_u64

        if self.paused or name not in self._fams or lanes.shape[0] == 0:
            return None
        mask = sample_mask(lanes, self.mode)
        if not mask.any():
            return None
        add = _addend_u64(vals[mask])
        add = np.concatenate(
            [add, np.ones((add.shape[0], 1), np.uint64)], axis=1)
        return (np.ascontiguousarray(lanes[mask]), add)

    def fold_prepared(self, name: str, prepared) -> None:
        """Fold one prepare_*() extraction into the cohort."""
        if prepared is not None:
            self._fold(self._fams[name], prepared[0], prepared[1], name)

    def note_table(self, name: str, table_keys: np.ndarray) -> None:
        """Admission churn: snapshot a host-resident candidate table's
        key set and count the keys it displaced."""
        from ..ops.hostgroup import hash_u64

        fam = self._fams.get(name)
        if fam is None:
            return
        real = (table_keys != _SENTINEL).any(axis=1)
        if real.any():
            cur = set(hash_u64(
                np.ascontiguousarray(table_keys[real])).tolist())
        else:
            cur = set()
        if fam.prev_table is not None:
            fam.evictions += len(fam.prev_table - cur)
        fam.prev_table = cur

    # ---- window close ------------------------------------------------------

    def _partial(self, fam: _FamilyAudit) -> dict:
        """The cohort, keys lex-sorted (equal cohorts serialize equally)."""
        from ..models.heavy_hitter import key_width

        w = key_width(fam.config)
        planes = len(fam.config.value_cols) + 1
        scale = 1 if self.mode == "full" else 1 << AUDIT_SAMPLE_BITS
        if not fam.exact:
            return {"keys": np.zeros((0, w), np.uint32),
                    "vals": np.zeros((0, planes), np.uint64),
                    "scale": scale}
        keys = np.frombuffer(b"".join(fam.exact.keys()),
                             dtype=np.uint32).reshape(len(fam.exact), w)
        vals = np.stack(list(fam.exact.values()))
        order = np.lexsort(keys.T[::-1])
        return {"keys": np.ascontiguousarray(keys[order]),
                "vals": np.ascontiguousarray(vals[order]),
                "scale": scale}

    def peek_partial(self, name: str) -> dict | None:
        """The open window's cohort (the mesh carry), not reset."""
        fam = self._fams.get(name)
        return None if fam is None else self._partial(fam)

    def take_partial(self, name: str) -> dict:
        """Detach the closed window's cohort and reset it (the sketch
        resets at the close; so does its shadow)."""
        fam = self._fams[name]
        part = self._partial(fam)
        part["evictions"] = int(fam.evictions)
        fam.exact = {}
        fam.evictions = 0
        fam.prev_table = None
        return part

    def on_close(self, name: str, slot, model) -> None:
        """The window-close hook (WindowedHeavyHitter.audit_hook): ship
        the cohort to the mesh member's capture, or evaluate it against
        the closing state and publish."""
        part = self.take_partial(name)
        if self.capture is not None:
            self.capture(name, int(slot), part)
            return
        self.evaluate(name, slot, part, model.state)

    def evaluate(self, name: str, slot, part: dict, state) -> dict:
        """Compare one detached cohort with one sketch state, publish the
        metrics, keep the JSON-safe report."""
        fam = self._fams[name]
        report = audit_report(part["keys"], part["vals"], state,
                              fam.config, fam.k, slot=slot,
                              scale=int(part.get("scale", 1)))
        evictions = int(part.get("evictions", 0))
        if evictions:
            self._m["evictions"].inc(evictions, family=name)
        report["evictions"] = evictions
        report = publish_report(name, report, metrics=self._m)
        self.last_reports[name] = report
        return report


# ---- the spread auditor -----------------------------------------------------


class _SpreadFamilyAudit:
    __slots__ = ("config", "kw", "elems")

    def __init__(self, config):
        from ..models.spread import spread_key_width

        self.config = config
        self.kw = spread_key_width(config)
        # key-lane bytes -> set of element-lane bytes (the exact distinct
        # shadow; a set dedupes as the registers' max does)
        self.elems: dict[bytes, set] = {}


class SpreadAudit:
    """Sampled exact-distinct shadow audit of one pipeline's spread
    families, with SketchAudit's sampling and split: ``prepare_pairs`` is
    pure (group thread), ``fold_prepared`` and the closes run on the
    worker thread. At a close the register decode (np_spread_query) of
    each sampled key is compared with its exact distinct count."""

    def __init__(self, families: dict, mode: str = "sample"):
        if mode not in ("sample", "full"):
            raise ValueError(
                f"spread audit mode must be sample|full, got {mode!r} "
                "(off = don't construct an auditor)")
        self.mode = mode
        self._fams = {name: _SpreadFamilyAudit(cfg)
                      for name, cfg in families.items()}
        # the guard's level >= 1 pauses cohort refresh, as SketchAudit's
        self.paused = False
        self.last_reports: dict[str, dict] = {}
        self._m = register_spread_audit_metrics()

    def prepare_pairs(self, name: str, pairs: np.ndarray):
        """The sampled rows of one chunk's unique (key, element) pair rows
        (``pairs`` [G, kw+ew] u32), or None. Pure."""
        fam = self._fams.get(name)
        if self.paused or fam is None or pairs.shape[0] == 0:
            return None
        mask = sample_mask(
            np.ascontiguousarray(pairs[:, :fam.kw]), self.mode)
        if not mask.any():
            return None
        return np.ascontiguousarray(pairs[mask])

    def fold_prepared(self, name: str, prepared) -> None:
        """Fold sampled pair rows into the element-set shadow."""
        if prepared is None:
            return
        fam = self._fams[name]
        kw = fam.kw
        elems = fam.elems
        overflow = 0
        for row in prepared:
            key = row[:kw].tobytes()
            s = elems.get(key)
            if s is None:
                if len(elems) >= AUDIT_MAX_COHORT:
                    overflow += 1
                    continue
                elems[key] = {row[kw:].tobytes()}
            else:
                s.add(row[kw:].tobytes())
        if overflow:
            self._m["overflow"].inc(overflow, family=name)

    def take_partial(self, name: str) -> dict:
        """Detach the closed window's cohort (keys lex-sorted) and reset
        it."""
        fam = self._fams[name]
        if not fam.elems:
            part = {"keys": np.zeros((0, fam.kw), np.uint32),
                    "distinct": np.zeros(0, np.uint64)}
        else:
            keys = np.frombuffer(
                b"".join(fam.elems.keys()),
                dtype=np.uint32).reshape(len(fam.elems), fam.kw)
            distinct = np.fromiter(
                (len(s) for s in fam.elems.values()), dtype=np.uint64,
                count=len(fam.elems))
            order = np.lexsort(keys.T[::-1])
            part = {"keys": np.ascontiguousarray(keys[order]),
                    "distinct": np.ascontiguousarray(distinct[order])}
        fam.elems = {}
        return part

    def on_close(self, name: str, slot, model) -> None:
        """The window-close hook (WindowedHeavyHitter.audit_hook)."""
        self.evaluate(name, slot, self.take_partial(name), model.state)

    def evaluate(self, name: str, slot, part: dict, state) -> dict:
        """Compare one detached cohort with one register state, publish
        the error histogram, keep the JSON-safe report."""
        from ..hostsketch.engine import np_spread_query

        regs = (np.asarray(state["regs"], np.uint8)
                if isinstance(state, dict) else state.regs)
        keys = part["keys"]
        n = keys.shape[0]
        report: dict = {"slot": None if slot is None else int(slot),
                        "sampled_keys": int(n)}
        if n:
            exact = part["distinct"].astype(np.float64)  # always >= 1
            decoded = np_spread_query(regs, keys)
            ratios = (decoded - exact) / exact
            for r in ratios:
                self._m["error"].observe(float(r), family=name)
            q = _quantiles(np.abs(ratios))
            report["spread_err"] = {
                kq: round(v, 6) for kq, v in _quantiles(ratios).items()}
            report["spread_abs_err"] = {kq: round(v, 6)
                                        for kq, v in q.items()}
        else:
            report["spread_err"] = _quantiles(np.empty(0, np.float64))
            report["spread_abs_err"] = dict(report["spread_err"])
        self._m["cohort"].set(n, family=name)
        self._m["windows"].inc(family=name)
        self.last_reports[name] = report
        return report
