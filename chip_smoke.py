#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flow_pipeline_tpu_torch) on one card.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown

Phases, each fatal on failure:

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi). No CUDA device: exit non-zero before anything else.
2. Build every kernel source (csrc/*.cu) with one nvcc call for sm_90a,
   printing the build time and ptxas's registers / shared memory.
3. Each kernel against its plain PyTorch version on the card at the main
   path's shapes (conservative: torch.equal; linear: torch.equal with
   integer addends inside 2^24, rtol 1e-6 with real ones), timed with
   CUDA events beside the plain version, one library call computing the
   same scatter, and the bound. Then the quantile bucket ids of every
   integer in [0, 2^24) on the card against the CPU's.
4. The main path: the port's mocker writes 262,144 seeded Zipf flows; the
   port's processor runs them on the card with the reference's default
   model set at CLI defaults (flows_5m, three heavy-hitter families, two
   port tables, DDoS; batch 32768, width 65536, depth 4, capacity 1024,
   top-k 100), then on the CPU. The conservative kernel's launch count
   must equal the family chunk updates the worker counted (and an
   independent replay); flows_5m must equal the exact oracle; the HH and
   port tables are held against exact per-window sums; the CPU run must
   give the same rows and the same DDoS alerts.
5. The linear path: the three heavy-hitter families built through the
   library with HeavyHitterConfig(conservative=False) on the same stream,
   card and CPU; the linear kernel's launches must equal the chunk
   updates, every window's top-10 the exact top-10.
6. A DDoS flood: a seeded steady stream with a flood after the warm-up,
   on the card and the CPU; alerts must fire and be identical.
7. Timings: flows/s end to end and ms per batch on the device path for
   the full model set.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Outputs too long for the console go to
chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
WORK = ROOT / "build" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

POOL = 1 << 22  # random keys searched for a forced bucket collision
N_FLOWS = 262_144
RATE = 500.0
SEED = 0
BATCH = 32768
WIDTH = 1 << 16
DEPTH = 4
PLANES = 3
FAMILIES = {
    "top_talkers": ("src_addr", "dst_addr", "src_port", "dst_port",
                    "proto"),
    "top_src_ips": ("src_addr",),
    "top_dst_ips": ("dst_addr",),
}
PORT_TABLES = {"top_src_ports": "src_port", "top_dst_ports": "dst_port"}
FLOWS_5M_KEYS = ("src_as", "dst_as", "etype")
PROCESSOR_FLAGS = ["-processor.fused=false"]
INT_ENVELOPE = 1 << 24  # f32 sums of integers are exact below this
# f32 sums of integers above 2^24 round (spacing 2 up to 2^25); an upper
# bound may then sit a few units below the exact uint64 sum
F32_RTOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- phase 1 ---------------------------------------------------------------

def environment(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(smi)
    return smi


# ---- phase 2 ---------------------------------------------------------------

def build_kernels():
    from flow_pipeline_tpu_torch import kernels

    info = kernels.build(force=True)
    log(f"build: {info.seconds:.2f} s -> {info.path.relative_to(ROOT)}")
    for line in info.log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("  " + line.strip())
    (OUT / "nvcc.log").write_text(info.log)
    return info


# ---- phase 3 ---------------------------------------------------------------

def time_cuda(torch, fn, iters=100, warmup=10) -> float:
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_keys(torch, gen, n, wk, width):
    """n unique random key rows on the card, with a forced collision: the
    most crowded row-0 bucket of a 2^22-key pool contributes all its keys
    (about 64 keys sharing one cell)."""
    from flow_pipeline_tpu_torch.ops.cms import cms_buckets

    pool = torch.randint(0, 2**32, (POOL, wk), generator=gen,
                         device="cuda", dtype=torch.int64)
    b0 = cms_buckets(pool, 1, width)[0]
    crowded = torch.bincount(b0, minlength=width).argmax()
    forced = pool[b0 == crowded]
    keys = torch.cat([forced, pool[: n - forced.shape[0]]])
    keys = torch.unique(keys, dim=0)
    keys = keys[torch.randperm(keys.shape[0], generator=gen,
                               device="cuda")]
    return keys.contiguous(), int(forced.shape[0])


def conservative_phase(torch):
    from flow_pipeline_tpu_torch.ops import cms as cms_ops
    from flow_pipeline_tpu_torch.ops import cms_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    n = BATCH
    shapes = {}
    for wk in (11, 4):
        # a sketch pre-filled by an earlier update (plain version)
        counts = torch.zeros((PLANES, DEPTH, WIDTH), device="cuda")
        warm_keys = torch.randint(0, 2**32, (n, wk), generator=gen,
                                  device="cuda", dtype=torch.int64)
        cms_ops.cms_add_conservative(
            counts, warm_keys, torch.rand((n, PLANES), generator=gen,
                                          device="cuda") * 1e4,
            torch.ones(n, dtype=torch.bool, device="cuda"))
        keys, n_forced = _kernel_keys(torch, gen, n, wk, WIDTH)
        m = keys.shape[0]
        valid = torch.rand(m, generator=gen, device="cuda") < 0.8
        plain = counts.clone()
        max_err = 0.0
        for call in range(3):  # repeated calls on one sketch
            # real-valued addends: exactness must not rest on 2^24
            vals = torch.rand((m, PLANES), generator=gen,
                              device="cuda") * 1e4
            before = counts.clone()
            cms_cuda.cms_add_conservative(counts, keys, vals, valid)
            cms_ops.cms_add_conservative(plain, keys, vals, valid)
            torch.cuda.synchronize()
            if not torch.equal(counts, plain):
                diff = (counts - plain).abs().max().item()
                raise AssertionError(f"kernel != plain (Wk={wk}, call "
                                     f"{call}): max abs err {diff}")
            max_err = max(max_err, (counts - plain).abs().max().item())
            if call == 0:
                changed = int((counts != before).sum().item())
        # bound: the bytes this call's data needs -- the mask, the u32 key
        # words and f32 values of the valid rows (invalid rows are never
        # read), a read of every touched cell and a write of every changed
        # one -- and its integer operations. The main path hands the kernel
        # u32 words in int64 carriers, so it reads 8 bytes per word where
        # the function needs 4 (key_bytes_read beside the bound).
        buckets = cms_ops.cms_buckets(keys, DEPTH, WIDTH)  # [D, N]
        vb = buckets[:, valid]
        cells = torch.unique(vb + torch.arange(
            DEPTH, device="cuda")[:, None] * WIDTH).numel() * PLANES
        n_valid = int(valid.sum().item())
        nbytes = (valid.numel() + n_valid * (4 * wk + 4 * PLANES)
                  + 4 * cells + 4 * changed)
        ops = n_valid * DEPTH * (9 * wk + 10) + n_valid * DEPTH * PLANES * 2
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
        # timings: the wrapper (its launches counted here are reset before
        # the main path), the plain version, one library scatter call
        kernel_ms = time_cuda(torch, lambda: cms_cuda.cms_add_conservative(
            counts, keys, vals, valid))
        plain_ms = time_cuda(torch, lambda: cms_ops.cms_add_conservative(
            plain, keys, vals, valid))
        target = torch.where(valid[:, None],
                             cms_ops.cms_query(counts, keys) + vals, 0.0)
        flat = (buckets + torch.arange(DEPTH, device="cuda")[:, None]
                * WIDTH).reshape(1, -1).expand(PLANES, -1).contiguous()
        tgt = target.T[:, None, :].expand(PLANES, DEPTH, m).reshape(
            PLANES, -1).contiguous()
        view = counts.view(PLANES, DEPTH * WIDTH)
        library_ms = time_cuda(torch, lambda: view.scatter_reduce_(
            1, flat, tgt, "amax"))
        shapes[wk] = dict(
            n=m, wk=wk, forced_collisions=n_forced, valid=n_valid,
            max_abs_err=max_err, kernel_ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bytes=nbytes, ops=ops,
            key_bytes_read=n_valid * wk * keys.element_size(),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"kernel cms_add_conservative Wk={wk} N={m} "
            f"(forced collisions {n_forced}): equal to plain over 3 calls; "
            f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"scatter_reduce_ {library_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.6f} ms ({nbytes} B / 3.35 TB/s; the "
            f"kernel reads {keys.element_size()} B per key word where the "
            f"bound counts 4)")
    return shapes


def linear_phase(torch):
    """The linear kernel against the plain cms_add at the main path's
    shapes: integer addends with every cell below 2^24 (bit-equal), then
    real-valued addends (atomic order: rtol 1e-6)."""
    from flow_pipeline_tpu_torch.ops import cms as cms_ops
    from flow_pipeline_tpu_torch.ops import cms_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    shapes = {}
    for wk in (11, 4):
        # a sketch pre-filled with integer cells, as earlier updates leave
        counts = torch.randint(0, 5000, (PLANES, DEPTH, WIDTH), generator=gen,
                               device="cuda").float()
        keys, n_forced = _kernel_keys(torch, gen, BATCH, wk, WIDTH)
        m = keys.shape[0]
        valid = torch.rand(m, generator=gen, device="cuda") < 0.8
        plain = counts.clone()
        for call in range(3):  # repeated calls, integer addends
            vals = torch.randint(0, 1500, (m, PLANES), generator=gen,
                                 device="cuda").float()
            cms_cuda.cms_add(counts, keys, vals, valid)
            cms_ops.cms_add(plain, keys, vals, valid)
            torch.cuda.synchronize()
            if counts.max().item() >= INT_ENVELOPE:
                raise AssertionError("integer case left the 2^24 envelope")
            if not torch.equal(counts, plain):
                diff = (counts - plain).abs().max().item()
                raise AssertionError(f"linear kernel != plain (Wk={wk}, "
                                     f"integer call {call}): max abs err "
                                     f"{diff}")
        max_err = 0.0
        for call in range(3):  # real-valued addends: atomic order shows
            vals = torch.rand((m, PLANES), generator=gen,
                              device="cuda") * 1e4
            cms_cuda.cms_add(counts, keys, vals, valid)
            cms_ops.cms_add(plain, keys, vals, valid)
            torch.cuda.synchronize()
            torch.testing.assert_close(counts, plain, rtol=F32_RTOL, atol=0)
            max_err = max(max_err, (counts - plain).abs().max().item())
        # bound: the mask, the u32 key words and f32 values of the valid
        # rows, a read and a write of every touched cell; the hashing and
        # the adds as operations
        buckets = cms_ops.cms_buckets(keys, DEPTH, WIDTH)  # [D, N]
        rows = torch.arange(DEPTH, device="cuda")[:, None] * WIDTH
        cells = torch.unique((buckets + rows)[:, valid]).numel() * PLANES
        n_valid = int(valid.sum().item())
        nbytes = valid.numel() + n_valid * (4 * wk + 4 * PLANES) + 8 * cells
        ops = n_valid * DEPTH * (9 * wk + 10) + n_valid * DEPTH * PLANES
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
        kernel_ms = time_cuda(torch, lambda: cms_cuda.cms_add(
            counts, keys, vals, valid))
        plain_ms = time_cuda(torch, lambda: cms_ops.cms_add(
            plain, keys, vals, valid))
        # the library call: one index_add_ on precomputed flat buckets
        flat = (buckets + rows).reshape(-1)
        src = torch.where(valid[:, None], vals, 0.0).T.repeat(1, DEPTH)
        view = counts.view(PLANES, DEPTH * WIDTH)
        library_ms = time_cuda(torch, lambda: view.index_add_(1, flat, src))
        shapes[wk] = dict(
            n=m, wk=wk, forced_collisions=n_forced, valid=n_valid,
            max_abs_err=max_err, kernel_ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bytes=nbytes, ops=ops, cells=cells,
            key_bytes_read=n_valid * wk * keys.element_size(),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"kernel cms_add Wk={wk} N={m} (forced collisions {n_forced}): "
            f"equal to plain over 3 integer calls, within rtol {F32_RTOL} "
            f"over 3 real-valued calls (max abs err {max_err:.4g}); kernel "
            f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"index_add_ {library_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.6f} ms ({nbytes} B / 3.35 TB/s)")
    return shapes


def quantile_phase(torch) -> None:
    """Quantile bucket ids of every integer in [0, 2^24) on the card
    against the CPU's (the CPU's are held against the JAX package's by
    tests/test_torch_ddos.py). Any difference is a fault."""
    from flow_pipeline_tpu_torch.ops.quantile import QuantileSketchSpec

    spec = QuantileSketchSpec(rel_err=0.01)
    step = 1 << 22
    for lo in range(0, INT_ENVELOPE, step):
        v = torch.arange(lo, lo + step, dtype=torch.float32)
        card = spec.bucket_of(v.cuda()).cpu()
        if not torch.equal(card, spec.bucket_of(v)):
            bad = torch.nonzero(card != spec.bucket_of(v))[:5].flatten()
            raise AssertionError(f"quantile bucket ids differ card/CPU at "
                                 f"{(v[bad]).tolist()}")
    log(f"quantile: bucket ids of all {INT_ENVELOPE} integers in [0, 2^24) "
        "equal on the card and the CPU")


# ---- phase 4 ---------------------------------------------------------------

class Capture:
    """A sink that keeps the raw columnar rows (estimates included)."""

    def __init__(self):
        self.tables: dict[str, list[dict]] = {}

    def write(self, table, rows):
        self.tables.setdefault(table, []).append(rows)


def generate_flows():
    """The stream the mocker writes, as one columnar batch (the mocker
    draws batches of 4096 from one generator)."""
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    gen = FlowGenerator(ZipfProfile(), seed=SEED, rate=RATE)
    return FlowBatch.concat([gen.batch(4096)
                             for _ in range(N_FLOWS // 4096)])


def accepted_windows(times, poll_max, n_parts=2, window=300):
    """Replays what the processor sees, independently of its code: frames
    round-robin over two partitions, one partition per poll in rotation,
    rows split by window slot, and rows of a closed slot dropped. Returns
    ({slot: row indices}, padded chunks per family)."""
    parts = [np.arange(p, len(times), n_parts) for p in range(n_parts)]
    pos = [0] * n_parts
    rr = 0
    current = None
    windows: dict[int, list] = {}
    chunks = 0
    while True:
        got = next((q for q in ((rr + k) % n_parts for k in range(n_parts))
                    if pos[q] < len(parts[q])), None)
        rr += 1
        if got is None:
            break
        idx = parts[got][pos[got]:pos[got] + poll_max]
        pos[got] += len(idx)
        slots = times[idx] // window * window
        for slot in np.unique(slots):
            if current is not None and slot < current:
                continue  # late: the window was closed
            current = slot
            part = idx[slots == slot]
            windows.setdefault(int(slot), []).append(part)
            chunks += math.ceil(len(part) / poll_max)
    return {s: np.concatenate(v) for s, v in windows.items()}, chunks


def _key_tuples(cols: dict, key_cols) -> list[tuple]:
    lanes = [np.asarray(cols[c], dtype=np.uint64).reshape(len(cols[c]), -1)
             for c in key_cols]
    return [tuple(r) for r in np.concatenate(lanes, axis=1).tolist()]


def _exact_window(flows, idx, key_cols, scale_col=None):
    from flow_pipeline_tpu_torch.models.oracle import exact_groupby
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    sub = FlowBatch({k: v[idx] for k, v in flows.columns.items()})
    return exact_groupby(sub, list(key_cols), ["bytes", "packets"],
                         timeslot=False, scale_col=scale_col)


def _check_top(table, slot, keys, exact, k) -> None:
    """The first k emitted keys are the exact top-k by bytes (keys whose
    sums tie with the k-th within float32 rounding may go either way)."""
    k = min(k, len(exact))
    ranked = sorted(exact.items(), key=lambda kv: -kv[1][0])
    vk = ranked[k - 1][1][0]
    must = {kk for kk, v in ranked if v[0] > vk * (1 + F32_RTOL)}
    allowed = {kk for kk, v in ranked if v[0] >= vk * (1 - F32_RTOL)}
    if not (must <= set(keys[:k]) <= allowed):
        raise AssertionError(f"{table}@{slot}: top-{k} differs from the "
                             f"exact top-{k}")


def check_oracle(flows, rows_by_table, windows, top_k=20) -> dict:
    """Every emitted heavy-hitter window against the exact numpy oracle:
    the top-``top_k`` keys match the exact ones and every value and
    estimate upper-bounds its exact sum."""
    summary = {}
    for table, key_cols in FAMILIES.items():
        emitted = rows_by_table[table]
        if sorted(int(r["timeslot"][0]) for r in emitted) != sorted(windows):
            raise AssertionError(f"{table}: windows {len(emitted)} emitted, "
                                 f"{len(windows)} expected")
        for rows in emitted:
            slot = int(rows["timeslot"][0])
            ex = _exact_window(flows, windows[slot], key_cols)
            exact = dict(zip(_key_tuples(ex, key_cols),
                             zip(ex["bytes"].tolist(), ex["packets"].tolist(),
                                 ex["count"].tolist())))
            valid = rows["valid"]
            keys = _key_tuples({c: rows[c][valid] for c in key_cols},
                               key_cols)
            for j, key in enumerate(keys):
                if key not in exact:
                    raise AssertionError(f"{table}@{slot}: emitted key "
                                         f"{key} never occurred")
                for plane, name in enumerate(("bytes", "packets", "count")):
                    truth = exact[key][plane]
                    for col in (name, f"{name}_est"):
                        got = float(rows[col][valid][j])
                        if got < truth * (1 - F32_RTOL):
                            raise AssertionError(
                                f"{table}@{slot} {col}={got} below exact "
                                f"{truth} for {key}")
            _check_top(table, slot, keys, exact, top_k)
            summary[f"{table}@{slot}"] = dict(
                rows=int(valid.sum()), exact_groups=len(exact),
                flows=int(len(windows[slot])))
    return summary


def check_port_tables(flows, rows_by_table, windows) -> dict:
    """Every emitted port-table window: each row's values EQUAL the exact
    per-window sums (dense int32 planes are exact), the keys are the
    exact top-100 and come in rank order."""
    summary = {}
    for table, col in PORT_TABLES.items():
        emitted = rows_by_table[table]
        if sorted(int(r["timeslot"][0]) for r in emitted) != sorted(windows):
            raise AssertionError(f"{table}: windows {len(emitted)} emitted, "
                                 f"{len(windows)} expected")
        for rows in emitted:
            slot = int(rows["timeslot"][0])
            ex = _exact_window(flows, windows[slot], (col,),
                               scale_col="sampling_rate")
            exact = {int(p): (int(b), int(pk), int(c)) for p, b, pk, c in zip(
                ex[col], ex["bytes_scaled"], ex["packets_scaled"],
                ex["count"])}
            valid = rows["valid"]
            keys = [int(p) for p in rows[col][valid]]
            for j, key in enumerate(keys):
                got = tuple(int(rows[c][valid][j])
                            for c in ("bytes", "packets", "count"))
                if got != exact.get(key):
                    raise AssertionError(f"{table}@{slot} port {key}: {got} "
                                         f"!= exact {exact.get(key)}")
            if np.any(np.diff(rows["bytes"][valid].astype(np.float64)) > 0):
                raise AssertionError(f"{table}@{slot}: rows not in rank "
                                     "order")
            _check_top(table, slot, [(k,) for k in keys],
                       {(k,): v for k, v in exact.items()}, 100)
            summary[f"{table}@{slot}"] = dict(rows=len(keys),
                                              exact_groups=len(exact))
    return summary


def check_flows_5m(flows, emitted) -> int:
    """flows_5m rows, merged by key as the sink's SummingMergeTree merges
    late partials, EQUAL the oracle's rollup of the whole stream."""
    from flow_pipeline_tpu_torch.models.oracle import exact_groupby, flows_5m

    got: dict = {}
    for rows in emitted:
        for i in range(len(rows["timeslot"])):
            key = (int(rows["timeslot"][i]),
                   *(int(rows[c][i]) for c in FLOWS_5M_KEYS))
            vals = [int(rows[c][i]) for c in ("bytes", "packets", "count",
                                               "bytes_scaled",
                                               "packets_scaled")]
            acc = got.setdefault(key, [0] * 5)
            for j, v in enumerate(vals):
                acc[j] += v
    want = flows_5m(flows)
    scaled = exact_groupby(flows, list(FLOWS_5M_KEYS), timeslot=True,
                           scale_col="sampling_rate")
    exact = {}
    for i in range(len(want["timeslot"])):
        key = (int(want["timeslot"][i]),
               *(int(want[c][i]) for c in FLOWS_5M_KEYS))
        exact[key] = [int(want["bytes"][i]), int(want["packets"][i]),
                      int(want["count"][i]), int(scaled["bytes_scaled"][i]),
                      int(scaled["packets_scaled"][i])]
    if got != exact:
        bad = sorted(set(got.items()) ^ set(
            (k, tuple(v)) for k, v in exact.items()))[:3]
        raise AssertionError(f"flows_5m differs from the oracle: {bad}")
    return len(exact)


def _concat_rows(emitted: list[dict]) -> dict:
    return {k: np.concatenate([r[k] for r in emitted]) for k in emitted[0]}


def compare_runs(gpu: dict, cpu: dict, full: bool = True) -> None:
    """Card run against CPU run. Heavy-hitter tables: same keys and ranks,
    values within rtol 1e-6 (group sums and linear CMS cells on the card
    are taken in atomic order). With ``full``: flows_5m and the port
    tables equal exactly, and the DDoS alerts are identical."""
    for table, key_cols in FAMILIES.items():
        if len(gpu[table]) != len(cpu[table]):
            raise AssertionError(f"{table}: window counts differ")
        for g, c in zip(gpu[table], cpu[table]):
            for col in (*key_cols, "valid", "timeslot"):
                if not np.array_equal(g[col], c[col]):
                    raise AssertionError(f"{table}: {col} differs card/CPU")
            for col in ("bytes", "packets", "count", "bytes_est",
                        "packets_est", "count_est"):
                np.testing.assert_allclose(g[col], c[col], rtol=F32_RTOL,
                                           atol=0, err_msg=f"{table} {col}")
    if not full:
        return
    for table in ("flows_5m", *PORT_TABLES):
        g, c = _concat_rows(gpu[table]), _concat_rows(cpu[table])
        for col in c:
            if not np.array_equal(g[col], c[col]):
                raise AssertionError(f"{table}: {col} differs card/CPU")
    ga = [a for rows in gpu.get("ddos_alerts", []) for a in rows]
    ca = [a for rows in cpu.get("ddos_alerts", []) for a in rows]
    if len(ga) != len(ca) or any(
            a.keys() != b.keys() or any(
                not np.array_equal(a[k], b[k]) for k in a)
            for a, b in zip(ga, ca)):
        raise AssertionError(f"ddos_alerts differ card/CPU: {len(ga)} vs "
                             f"{len(ca)} alerts")


def max_ddos_rate(flows, sub_window=10, n_buckets=1 << 14) -> float:
    """Largest per-bucket sub-window rate the stream can produce (late
    rows included, so an upper bound of what the detector summed)."""
    import torch

    from flow_pipeline_tpu_torch.ops.ewma import bucket_of

    cols = flows.columns
    b = bucket_of(torch.from_numpy(cols["dst_addr"].astype(np.int64)),
                  n_buckets).numpy()
    sub = cols["time_received"].astype(np.int64) // sub_window
    rate = cols["packets"].astype(np.float64) * np.maximum(
        cols["sampling_rate"].astype(np.float64), 1)
    _, inv = np.unique(sub * n_buckets + b, return_inverse=True)
    return float(np.bincount(inv, weights=rate).max())


class _Batches:
    """A consumer over decoded batches (the device-path timing excludes
    decode)."""

    def __init__(self, batches):
        self._it = iter(batches)

    def poll(self, max_messages):
        return next(self._it, None)

    def commit(self, partition, next_offset):
        pass


def device_state_bytes(models: dict) -> dict:
    """Bytes of device state each model holds for a window (flows_5m keeps
    its store on the host)."""
    out = {}
    for name, m in models.items():
        state = getattr(m, "state", None)  # DDoSDetector
        inner = getattr(m, "model", None)  # WindowedHeavyHitter
        if inner is not None:
            state = getattr(inner, "state", None)
            if state is None:
                state = (inner.totals,)  # DenseTopKModel
        out[name] = sum(t.numel() * t.element_size() for t in state or ())
    return out


def device_batches(torch, flows, profile: bool):
    """ms per 32768-row batch on the device path for the full model set:
    one StreamWorker step (every model's update, the per-batch flush and
    its drains) over pre-decoded batches, synchronised per batch."""
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine import StreamWorker

    batches = [flows.slice(s, s + BATCH) for s in range(0, N_FLOWS, BATCH)]

    def worker(bs):
        vals = cli._processor_flags(cli._common_flags(
            cli.FlagSet("processor"))).parse(
            ["-in", "unused", *PROCESSOR_FLAGS])
        return StreamWorker(_Batches(bs), cli._build_models(vals, "cuda"),
                            poll_max=BATCH)

    warm = worker(batches[:1])  # allocator and first launches
    state_bytes = device_state_bytes(warm.models)
    log("device state bytes by model: " + json.dumps(state_bytes)
        + f" (total {sum(state_bytes.values())})")
    warm.run()
    torch.cuda.synchronize()
    timed = worker(batches)
    times = []
    for _ in batches:
        t0 = time.perf_counter()
        timed.run_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    # the same batches model by model, each update synchronised, for the
    # split of the device path (flushes and drains excluded)
    split = worker(batches)
    per_model = {name: 0.0 for name in split.models}
    for b in batches:
        for name, model in split.models.items():
            t0 = time.perf_counter()
            model.update(b)
            torch.cuda.synchronize()
            per_model[name] += (time.perf_counter() - t0) * 1e3 / len(batches)
    breakdown = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof

        prof_worker = worker(batches[:2])
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while prof_worker.run_once():
                pass
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        avgs = prof.key_averages()
        kernels = [e for e in avgs if str(e.device_type).endswith("CUDA")]
        dev_ms = sum(getattr(e, "self_device_time_total", 0) or
                     getattr(e, "self_cuda_time_total", 0)
                     for e in kernels) / 1e3
        log(f"profile (2 batches): {sum(e.count for e in kernels)} kernel "
            f"launches, {dev_ms:.3f} ms of device time in {wall_ms:.3f} ms "
            f"wall: the card idle {100 * (1 - dev_ms / wall_ms):.1f} % "
            "(under the profiler)")
        key = ("device_time_total" if avgs and hasattr(avgs[0],
                                                       "device_time_total")
               else "cuda_time_total")
        table = avgs.table(sort_by=key, row_limit=25)
        (OUT / "profile.txt").write_text(table)
        prof.export_chrome_trace(str(OUT / "trace.json"))
        breakdown = table
    return times, per_model, state_bytes, breakdown


def run_main_path(torch, frames) -> list[dict]:
    """The processor at CLI defaults with every default model, on the
    card then on the CPU; each run's launch counts are zeroed just before
    it and read just after."""
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.ops import cms_cuda

    runs = []
    for device in ("cuda", "cpu"):
        capture = Capture()
        for name in cms_cuda.LAUNCHES:
            cms_cuda.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        worker = cli.run_processor(
            ["-device", device, "-in", str(frames), "-sink",
             f"sqlite:{WORK / (device + '.db')}", "-loglevel", "warning",
             "-processor.batch", str(BATCH), "-sketch.width", str(WIDTH),
             *PROCESSOR_FLAGS], sinks=[capture])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cms_cuda.LAUNCHES)
        runs.append(dict(device=device, worker=worker, rows=capture.tables,
                         wall=wall, launches=launches))
        log(f"processor -device {device} (full model set): "
            f"{worker.flows_seen} flows, {worker.batches_seen} batches, "
            f"{wall:.2f} s wall ({worker.flows_seen / wall:.0f} flows/s "
            f"incl. pure-Python decode), update calls "
            f"{worker.update_seconds:.2f} s, launches {launches}, family "
            f"chunk updates {worker.chunk_updates}")
    return runs


def run_linear_path(torch, frames) -> list[dict]:
    """The three heavy-hitter families with the linear update, built
    through the library (WindowedHeavyHitter, StreamWorker, bus,
    consumer) on the card and the CPU."""
    from flow_pipeline_tpu_torch.engine import StreamWorker, WindowedHeavyHitter
    from flow_pipeline_tpu_torch.models import HeavyHitterConfig
    from flow_pipeline_tpu_torch.ops import cms_cuda
    from flow_pipeline_tpu_torch.schema import wire
    from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus

    runs = []
    for device in ("cuda", "cpu"):
        bus = InProcessBus()
        bus.create_topic("flows", 2)
        bus.produce_many("flows", wire.iter_raw_frames(frames.read_bytes()))
        models = {name: WindowedHeavyHitter(
            HeavyHitterConfig(key_cols=keys, batch_size=BATCH, width=WIDTH,
                              conservative=False), k=100, device=device)
            for name, keys in FAMILIES.items()}
        capture = Capture()
        worker = StreamWorker(Consumer(bus, "flows"), models, [capture],
                              poll_max=BATCH)
        for name in cms_cuda.LAUNCHES:
            cms_cuda.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        worker.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cms_cuda.LAUNCHES)
        runs.append(dict(device=device, worker=worker, rows=capture.tables,
                         wall=wall, launches=launches))
        log(f"linear families -device {device}: {worker.flows_seen} flows, "
            f"{wall:.2f} s wall, launches {launches}, chunk updates "
            f"{worker.chunk_updates}")
    return runs


def _check_launches(what, run, kernel, chunks) -> None:
    """The worker's chunk updates equal the replay; on the card the
    path's kernel launched once per chunk update and no other kernel ran;
    on the CPU no kernel launched."""
    w = run["worker"]
    if w.chunk_updates != len(FAMILIES) * chunks:
        raise AssertionError(f"{what}: chunk updates {w.chunk_updates} != "
                             f"replayed {len(FAMILIES) * chunks}")
    want = {k: 0 for k in run["launches"]}
    if run["device"] == "cuda":
        want[kernel] = w.chunk_updates
    if run["launches"] != want:
        raise AssertionError(f"{what}: launches {run['launches']}, want "
                             f"{want}")


VICTIM = 7


def flood_stream(seed=SEED, n_dst=500, subs=30, per_sub=20000,
                 flood_from=12, flood_flows=3000):
    """A seeded steady stream of 10-s sub-windows over ``n_dst`` IPv4
    destinations, with one destination flooded from sub-window
    ``flood_from`` on (after the warm-up), as 32768-row FlowBatches."""
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000
    times, dsts, pkts = [], [], []
    for s in range(subs):
        n = per_sub + (flood_flows if s >= flood_from else 0)
        times.append(t0 + s * 10 + rng.integers(0, 10, n))
        d = rng.integers(0, n_dst, n)
        p = rng.integers(1, 20, n)
        if s >= flood_from:
            d[per_sub:] = VICTIM
            p[per_sub:] = rng.integers(40, 60, flood_flows)
        dsts.append(d)
        pkts.append(p)
    times, dsts, pkts = map(np.concatenate, (times, dsts, pkts))
    order = np.argsort(times, kind="stable")
    n = len(order)
    batch = FlowBatch.empty(n)
    batch.columns["time_received"][:] = times[order]
    batch.columns["packets"][:] = pkts[order]
    batch.columns["bytes"][:] = pkts[order] * 100
    batch.columns["sampling_rate"][:] = 1
    batch.columns["dst_addr"][:, 3] = 0x0A000000 + dsts[order]
    return [batch.slice(s, s + BATCH) for s in range(0, n, BATCH)]


def ddos_flood(torch) -> dict:
    """The DDoS detector on the flood stream, card and CPU: alerts fire
    after the warm-up and are identical."""
    from flow_pipeline_tpu_torch.models import DDoSConfig, DDoSDetector

    batches = flood_stream()
    alerts = {}
    for device in ("cuda", "cpu"):
        det = DDoSDetector(DDoSConfig(batch_size=BATCH), device=device)
        for b in batches:
            det.update(b)
        det.close_sub_window()
        alerts[device] = det.alerts
    card, cpu = alerts["cuda"], alerts["cpu"]
    if not card or int(card[0]["dst_addr"][3]) - 0x0A000000 != VICTIM:
        raise AssertionError("DDoS flood: no alert on the victim fired "
                             "first on the card")
    if len(card) != len(cpu) or any(
            any(not np.array_equal(a[k], b[k]) for k in a)
            for a, b in zip(card, cpu)):
        raise AssertionError(f"DDoS flood: card alerts {len(card)} != CPU "
                             f"alerts {len(cpu)}")
    victims = sorted({int(a["dst_addr"][3]) - 0x0A000000 for a in card})
    log(f"ddos flood: {sum(len(b) for b in batches)} flows, {len(card)} "
        f"alerts on the card = CPU (victims {victims}, first at sub-window "
        f"{card[0]['sub_window']}, max rate {max(a['rate'] for a in card)})")
    return dict(flows=sum(len(b) for b in batches), alerts=len(card),
                victims=victims)


def main_path(torch, profile: bool) -> dict:
    from flow_pipeline_tpu_torch import cli

    frames = WORK / "frames.bin"
    t0 = time.perf_counter()
    assert cli.main(["mocker", "-out", str(frames), "-produce.profile",
                     "zipf", "-produce.count", str(N_FLOWS),
                     "-produce.rate", str(RATE), "-produce.seed",
                     str(SEED)]) == 0
    log(f"mocker: {N_FLOWS} flows in {time.perf_counter() - t0:.1f} s")
    flows = generate_flows()
    windows, chunks = accepted_windows(
        flows.columns["time_received"].astype(np.int64), BATCH)

    gpu, cpu = runs = run_main_path(torch, frames)
    for run in runs:
        _check_launches(f"main path ({run['device']})", run,
                        "cms_add_conservative", chunks)
    summary = check_oracle(flows, gpu["rows"], windows)
    log(f"oracle: {len(summary)} heavy-hitter windows hold top-20 and upper "
        "bounds: " + json.dumps(summary))
    groups = check_flows_5m(flows, gpu["rows"]["flows_5m"])
    log(f"flows_5m: {groups} (timeslot, key) rows equal the oracle exactly")
    ports = check_port_tables(flows, gpu["rows"], windows)
    log(f"port tables: {len(ports)} windows equal exact per-window sums "
        "and the exact top-100: " + json.dumps(ports))
    compare_runs(gpu["rows"], cpu["rows"])
    n_alerts = sum(len(a) for a in gpu["rows"].get("ddos_alerts", []))
    max_rate = max_ddos_rate(flows)
    if max_rate >= INT_ENVELOPE:
        raise AssertionError(f"DDoS rates left the 2^24 envelope: "
                             f"{max_rate}")
    log(f"card run equals CPU run: flows_5m, port tables and {n_alerts} "
        "DDoS alerts identical; heavy-hitter keys and ranks equal, values "
        f"within rtol 1e-6; largest DDoS bucket rate {max_rate:.0f} < 2^24")

    lin_gpu, lin_cpu = lin = run_linear_path(torch, frames)
    for run in lin:
        _check_launches(f"linear path ({run['device']})", run, "cms_add",
                        chunks)
    lin_summary = check_oracle(flows, lin_gpu["rows"], windows, top_k=10)
    compare_runs(lin_gpu["rows"], lin_cpu["rows"], full=False)
    log(f"linear path: {len(lin_summary)} windows hold the exact top-10 "
        "and upper bounds; card rows equal CPU rows (keys and ranks equal, "
        "values within rtol 1e-6)")

    flood = ddos_flood(torch)
    times, per_model, state_bytes, breakdown = device_batches(
        torch, flows, profile)
    log(f"device path (full model set): {np.mean(times):.3f} ms per "
        f"{BATCH}-row batch (7 models, synchronised; min {min(times):.3f}, "
        f"max {max(times):.3f}) = {BATCH / np.mean(times) * 1e3:.0f} "
        "flows/s excluding decode; update ms per batch by model: "
        + json.dumps({k: round(v, 3) for k, v in per_model.items()}))
    if breakdown:
        log(breakdown)
    return dict(
        launches=gpu["launches"], chunk_updates=gpu["worker"].chunk_updates,
        linear_launches=lin_gpu["launches"],
        linear_chunk_updates=lin_gpu["worker"].chunk_updates,
        windows=len(windows), flows_5m_rows=groups, ddos_alerts=n_alerts,
        max_ddos_rate=max_rate, flood=flood,
        late_dropped={n: getattr(m, "late_flows_dropped", None)
                      for n, m in gpu["worker"].models.items()},
        wall_s={r["device"]: r["wall"] for r in runs},
        linear_wall_s={r["device"]: r["wall"] for r in lin},
        flows_per_s_e2e=N_FLOWS / gpu["wall"],
        update_s={r["device"]: r["worker"].update_seconds for r in runs},
        batch_ms=times, batch_ms_mean=float(np.mean(times)),
        update_ms_by_model=per_model, state_bytes_by_model=state_bytes)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace two batches with torch.profiler")
    args = ap.parse_args()
    import torch

    smi = environment(torch)
    # import only after the CUDA check: a copy of this script alone fails
    # here, as it must
    import flow_pipeline_tpu_torch  # noqa: F401

    OUT.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        build = build_kernels()
        shapes = {"cms_add_conservative": conservative_phase(torch),
                  "cms_add": linear_phase(torch)}
        quantile_phase(torch)
        path = main_path(torch, args.profile)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    launches = {"cms_add_conservative": path["launches"],
                "cms_add": path["linear_launches"]}
    kernels = []
    for name, source, line, tpu in (
            ("cms_add", "cms_linear.cu", 39,
             "cms_add_pallas (_add_kernel)"),
            ("cms_add_conservative", "cms_conservative.cu", 86,
             "cms_add_conservative_pallas (_max_kernel)")):
        by_wk = shapes[name]
        main_shape = by_wk[11]  # the widest family's shape
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"flow_pipeline_tpu_torch/csrc/{source}",
            "replaces": f"flow_pipeline_tpu/ops/cms_pallas.py:{line}",
            "jax": f"flow_pipeline_tpu/ops/cms_pallas.py:{tpu}",
            # counted in the run of the path that uses the kernel
            "launches": launches[name][name],
            "max_abs_err": max(s["max_abs_err"] for s in by_wk.values()),
            "ms": main_shape["kernel_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shapes": {f"wk{k}": v for k, v in by_wk.items()},
        })
    record = dict(card=smi, build_s=build.seconds, kernels=kernels,
                  main_path=path)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"card: {smi}; end to end {path['flows_per_s_e2e']:.0f} flows/s, "
        f"device path {path['batch_ms_mean']:.3f} ms per {BATCH}-row batch "
        "(full model set)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
