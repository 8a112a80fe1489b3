#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flow_pipeline_tpu_torch) on one card.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown

Phases, each fatal on failure:

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi). No CUDA device: exit non-zero before anything else.
2. Build every kernel source (csrc/*.cu) with nvcc for sm_90a, printing
   the build time and ptxas's registers / shared memory per kernel.
3. Each kernel against its plain PyTorch version on the card at the main
   path's shapes (torch.equal), timed with CUDA events beside the plain
   version, one library call computing the same scatter, and the bound.
4. The main path: the port's mocker writes 262,144 seeded Zipf flows; the
   port's processor runs them on the card with the heavy-hitter families
   (CLI defaults: batch 32768, width 65536, depth 4, capacity 1024). The
   kernel's launch count must equal the family chunk updates the worker
   counted; every window is held against the exact numpy oracle; the
   same stream on the CPU must give the same keys and ranks.

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
PROCESSOR_FLAGS = ["-processor.fused=false", "-model.flows5m=false",
                   "-model.ports=false", "-model.ddos=false"]
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


def kernel_phase(torch):
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


def check_oracle(flows, rows_by_table, windows) -> dict:
    """Every emitted window against the exact numpy oracle: top-20 keys
    match the exact top-20 (ties at the 20th value allowed either way) and
    every value and estimate upper-bounds its exact sum."""
    from flow_pipeline_tpu_torch.models.oracle import exact_groupby
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    summary = {}
    for table, key_cols in FAMILIES.items():
        emitted = rows_by_table[table]
        if sorted(int(r["timeslot"][0]) for r in emitted) != sorted(windows):
            raise AssertionError(f"{table}: windows {len(emitted)} emitted, "
                                 f"{len(windows)} expected")
        for rows in emitted:
            slot = int(rows["timeslot"][0])
            idx = windows[slot]
            sub = FlowBatch({k: v[idx] for k, v in flows.columns.items()})
            ex = exact_groupby(sub, list(key_cols), ["bytes", "packets"],
                               timeslot=False)
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
            k = min(20, len(exact))
            ranked = sorted(exact.items(), key=lambda kv: -kv[1][0])
            v20 = ranked[k - 1][1][0]
            must = {kk for kk, v in ranked if v[0] > v20 * (1 + F32_RTOL)}
            allowed = {kk for kk, v in ranked if v[0] >= v20 * (1 - F32_RTOL)}
            top = set(keys[:k])
            if not (must <= top <= allowed):
                raise AssertionError(f"{table}@{slot}: top-{k} differs from "
                                     f"the exact top-{k}")
            summary[f"{table}@{slot}"] = dict(rows=int(valid.sum()),
                                              exact_groups=len(exact),
                                              flows=int(len(idx)))
    return summary


def compare_runs(gpu: dict, cpu: dict) -> None:
    """Card run against CPU run: same keys and ranks; values within
    rtol 1e-6 (group sums on the card are taken in atomic order)."""
    for table, key_cols in FAMILIES.items():
        if len(gpu[table]) != len(cpu[table]):
            raise AssertionError(f"{table}: window counts differ")
        for g, c in zip(gpu[table], cpu[table]):
            for col in (*key_cols, "valid", "timeslot"):
                if not np.array_equal(g[col], c[col]):
                    raise AssertionError(f"{table}: {col} differs card/CPU")
            for col in ("bytes", "packets", "count", "bytes_est",
                        "packets_est", "count_est"):
                np.testing.assert_allclose(g[col], c[col], rtol=1e-6,
                                           atol=0, err_msg=f"{table} {col}")


def device_batches(torch, flows, profile: bool):
    """ms per 32768-row batch of the three families' updates on the card,
    synchronised per batch (decode excluded)."""
    from flow_pipeline_tpu_torch.models.heavy_hitter import (
        HeavyHitterConfig, HeavyHitterModel)

    models = [HeavyHitterModel(HeavyHitterConfig(
        key_cols=k, batch_size=BATCH, width=WIDTH), device="cuda")
        for k in FAMILIES.values()]
    batches = [flows.slice(s, s + BATCH) for s in range(0, N_FLOWS, BATCH)]
    for m in models:  # warm-up: allocator and the first launches
        m.update(batches[0])
    torch.cuda.synchronize()
    times = []
    for b in batches:
        t0 = time.perf_counter()
        for m in models:
            m.update(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    breakdown = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof

        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for b in batches[:2]:
                for m in models:
                    m.update(b)
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        key = ("device_time_total" if avgs and hasattr(avgs[0],
                                                       "device_time_total")
               else "cuda_time_total")
        table = avgs.table(sort_by=key, row_limit=25)
        (OUT / "profile.txt").write_text(table)
        prof.export_chrome_trace(str(OUT / "trace.json"))
        breakdown = table
    return times, breakdown


def main_path(torch, profile: bool) -> dict:
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.ops import cms_cuda

    frames = WORK / "frames.bin"
    t0 = time.perf_counter()
    assert cli.main(["mocker", "-out", str(frames), "-produce.profile",
                     "zipf", "-produce.count", str(N_FLOWS),
                     "-produce.rate", str(RATE), "-produce.seed",
                     str(SEED)]) == 0
    log(f"mocker: {N_FLOWS} flows in {time.perf_counter() - t0:.1f} s")

    runs = []
    for device in ("cuda", "cpu"):
        capture = Capture()
        cms_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        worker = cli.run_processor(
            ["-device", device, "-in", str(frames), "-sink",
             f"sqlite:{WORK / (device + '.db')}", "-loglevel", "warning",
             "-processor.batch", str(BATCH), "-sketch.width", str(WIDTH),
             *PROCESSOR_FLAGS], sinks=[capture])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(device=device, worker=worker, rows=capture.tables,
                         wall=wall, launches=cms_cuda.LAUNCHES))
        log(f"processor -device {device}: {worker.flows_seen} flows, "
            f"{worker.batches_seen} batches, {wall:.2f} s wall "
            f"({worker.flows_seen / wall:.0f} flows/s incl. pure-Python "
            f"decode), update calls {worker.update_seconds:.2f} s, "
            f"kernel launches {cms_cuda.LAUNCHES}, chunk updates "
            f"{worker.chunk_updates}")

    gpu, cpu = runs
    flows = generate_flows()
    windows, chunks = accepted_windows(
        flows.columns["time_received"].astype(np.int64), BATCH)
    if gpu["worker"].chunk_updates != len(FAMILIES) * chunks:
        raise AssertionError(
            f"chunk updates {gpu['worker'].chunk_updates} != replayed "
            f"{len(FAMILIES) * chunks}")
    if gpu["launches"] != gpu["worker"].chunk_updates or cpu["launches"] != 0:
        raise AssertionError(
            f"kernel launches {gpu['launches']} on the card run (want "
            f"{gpu['worker'].chunk_updates}), {cpu['launches']} on "
            "the CPU run (want 0)")
    summary = check_oracle(flows, gpu["rows"], windows)
    log(f"oracle: {len(summary)} emitted windows hold top-20 and upper "
        f"bounds: " + json.dumps(summary))
    compare_runs(gpu["rows"], cpu["rows"])
    log("card run equals CPU run: keys, ranks, values within rtol 1e-6")
    times, breakdown = device_batches(torch, flows, profile)
    log(f"device path: {np.mean(times):.3f} ms per {BATCH}-row batch "
        f"(3 families, synchronised; min {min(times):.3f}, max "
        f"{max(times):.3f}) = {BATCH / np.mean(times) * 1e3:.0f} flows/s "
        f"excluding decode")
    if breakdown:
        log(breakdown)
    return dict(
        launches=gpu["launches"], chunk_updates=gpu["worker"].chunk_updates,
        windows=len(windows),
        late_dropped={n: m.late_flows_dropped
                      for n, m in gpu["worker"].models.items()},
        wall_s={r["device"]: r["wall"] for r in runs},
        flows_per_s_e2e=N_FLOWS / gpu["wall"],
        update_s={r["device"]: r["worker"].update_seconds for r in runs},
        batch_ms=times, batch_ms_mean=float(np.mean(times)))


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
        shapes = kernel_phase(torch)
        path = main_path(torch, args.profile)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    main_shape = shapes[11]
    kernel = {
        "name": "cms_add_conservative",
        "route": "cuda",
        "source": "flow_pipeline_tpu_torch/csrc/cms_conservative.cu",
        "replaces": "flow_pipeline_tpu/ops/cms_pallas.py:86",
        "jax": "flow_pipeline_tpu/ops/cms_pallas.py:"
               "cms_add_conservative_pallas (_max_kernel)",
        "launches": path["launches"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
        # one time under the two names the line's readers look for
        "ms": main_shape["kernel_ms"],
        "kernel_ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shapes": {f"wk{k}": v for k, v in shapes.items()},
    }
    record = dict(card=smi, build_s=build.seconds, kernels=[kernel],
                  main_path=path)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"card: {smi}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
