#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flow_pipeline_tpu_torch) on one card.

    python3 chip_smoke.py            # the whole run, one card

Phases, each fatal on failure:

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi). No CUDA device: exit non-zero before anything else.
2. Build every kernel source (csrc/*.cu) with one nvcc call for sm_90a,
   printing the build time and ptxas's registers, stack frame and spills
   of the main path's instantiations (Wk = 4 and 11, D = 4, P = 3), which
   must show a 0-byte stack frame and no spills.
3. Each kernel against its plain PyTorch version on the card at the main
   path's shapes (conservative: torch.equal; linear: torch.equal with
   integer addends inside 2^24, rtol 1e-6 with real ones), and its
   estimate form against the plain update followed by cms_query, at
   N = 32,768 and at an N above the resident-thread count (the scratch
   route). At Wk = 11 and 4, the time split of the update alone
   (tools/cms_split.py): device us per launch (torch.profiler, and CUDA
   events behind a sleeping kernel), device launches per call, host us
   per call, the back-to-back figure; beside it the plain version, one
   library call computing the same scatter, and the bound; and the
   estimate form against the sequence it replaces (the update, then
   cms_query), in turns. Then the quantile bucket ids of every integer in
   [0, 2^24) on the card against the CPU's.
4. Decode: the port's mocker writes 262,144 seeded Zipf flows; the native
   frame decoder (built with g++) must equal the pure-Python decode of
   the whole file, column for column; us per flow of each.
5. The main path: the port's processor at CLI defaults (native decode,
   prefetch 2, one fused step per chunk; flows_5m, three heavy-hitter
   families, two port tables, DDoS; batch 32768, width 65536, depth 4,
   capacity 1024, top-k 100) on the card, then on the CPU. The
   conservative kernel's launches must equal the family chunk updates
   the worker counted and an independent replay of the fused steps, each
   in its estimate form, so no cms_query follows an update; flows_5m must
   equal the exact oracle; the HH and port tables are held against exact
   per-window sums; the CPU run must give the same rows and alerts. The
   card run's /metrics and /debug/trace (its metrics server on a free
   port) are scraped over HTTP before the server stops: flows, batches
   and rows written equal the worker's, the DDoS detector's late rows
   equal its gauge, and the trace holds one decode and one apply span per
   batch and one flush span per sink write.
6. The per-model path (-processor.fused=false), card and CPU, with the
   same gates; its flows_5m, port tables and DDoS alerts must equal the
   fused run's. Its heavy-hitter chunks differ from the fused run's
   wherever a batch crosses a DDoS sub-window, so the heavy-hitter
   tables are held row for row on a pair without DDoS (-model.ddos=false,
   fused and per-model on the card), where both chunk alike.
7. The linear path: the three heavy-hitter families built through the
   library with HeavyHitterConfig(conservative=False), run through the
   fused step on the same stream, card and CPU; the linear kernel's
   launches must equal the chunk updates, every window's top-10 the
   exact top-10.
8. A DDoS flood: a seeded steady stream with a flood after the warm-up,
   on the card and the CPU; alerts must fire and be identical.
9. Timings: flows/s end to end (the first run of each path in the
   process, then both paths again in turns, warm); ms per batch on the
   device path, fused and per-model in turns; kernel launches per batch
   and the card's idle share of each path under torch.profiler.
10. The host wiring: the default run against -metrics.addr "" -sink.retries
   1 -obs.trace off, end to end in turns (on, off, off, on, on, off);
   the default run under the fault plan sink.write:p=0.3@seed=7 at
   -sink.retries 4 (rows equal the fault-free run's, retries counted, no
   failures); and a checkpoint: a card run stopped after half its polls with
   -checkpoint.path, restored into a fresh card processor and into a CPU
   processor that finish the stream (rows equal the uninterrupted card
   run's), with the save and restore ms and the bytes on disk.
11. The host-grouped path (-processor.hostassist on: host grouping with
   the native kernel, the pipelined ingest runtime, the device step over
   power-of-two group tables), first on the card, then on the CPU. The
   conservative kernel's estimate form against the plain update and
   cms_query at the group-table shapes (N = 1,024, 4,096 and 32,768; Wk
   = 11 and 4; torch.equal), with its device us per launch at 1,024 and
   32,768. Gates: flows_5m equal to the oracle; port tables and alerts
   equal to the fused card run's, heavy-hitter keys and ranks equal
   (values within rtol 1e-6); card rows equal CPU rows; conservative
   launches equal the chunk updates, each in the estimate form;
   /metrics shows native_path_degraded{feature="group"} 0; the group
   thread prepared every batch and the flusher ran. Times: end to end
   with the host-grouped, fused and per-model paths in turns, and the
   host-grouped device path per batch (prepare and apply apart) with
   launches and idle share under torch.profiler.
12. The spread detectors (-spread.enabled) on a stream with spreader
   legs (-zipf.spread 0.05), fused and host-grouped, card and CPU: the
   superspreader and portscan rows (and the sqlite journal) equal in all
   four runs; each window holds the generator's spreaders whose exact
   fan-out is at least 8x the largest other source's, on top, each
   decoded spread within 3 x 1.04/sqrt(64) of its exact distinct count;
   every other table equals the run without -spread.enabled. Times: end
   to end with spread on and off, in turns.

Each phase prints its seconds. The line before the last is the kernels'
JSON; the last line is
{"ok": true, "device": {...}}. Outputs too long for the console go to
chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
WORK = ROOT / "build" / "chip_smoke"

cms_split = None  # tools/cms_split.py, imported after the CUDA check

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

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
SUB_WINDOW = 10  # the DDoS detector's default cadence, seconds
# the device-sorted fused step (the card's default; on the CPU auto would
# pick host grouping) and the per-model path
PATHS = {"fused": ["-processor.hostassist", "off"],
         "per-model": ["-processor.fused=false"]}
# every path the processor runs here, with the pipeline each must select
RUN_PATHS = {**PATHS, "hostassist": ["-processor.hostassist", "on"]}
PIPELINE = {"fused": "FusedPipeline", "per-model": None,
            "hostassist": "HostGroupPipeline"}
BUCKETS = (1024, 4096, 32768)  # the host-grouped step's table shapes
SPREAD_FRACTION = 0.05
SPREAD_REGS = 64
SPREAD_TABLES = {"superspreaders": "dst_addr", "portscan": "dst_port"}
INT_ENVELOPE = 1 << 24  # f32 sums of integers are exact below this
# f32 sums of integers above 2^24 round (spacing 2 up to 2^25); an upper
# bound may then sit a few units below the exact uint64 sum
F32_RTOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_SECONDS: dict[str, float] = {}


@contextlib.contextmanager
def phase(name: str):
    """Log and keep the seconds a phase took."""
    t0 = time.perf_counter()
    yield
    PHASE_SECONDS[name] = secs = time.perf_counter() - t0
    log(f"phase {name}: {secs:.1f} s")


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

# ptxas's mangled name of a CMS kernel instantiation:
# fpt_cms_<kind>_kernel<WK, D, P, EST, REG>
PTXAS_KERNEL = re.compile(r"fpt_cms_(conservative|linear)_kernel"
                          r"ILi(\d+)ELi(\d+)ELi(\d+)ELb([01])ELb([01])E")


def ptxas_report(log: str) -> dict:
    """{(kind, wk, d, p, est, reg): {registers, stack, spill_stores,
    spill_loads}} from nvcc's -Xptxas -v log."""
    out: dict = {}
    current = None
    for line in log.splitlines():
        m = PTXAS_KERNEL.search(line)
        if m and "Function properties" in line:
            kind, wk, d, p, est, reg = m.groups()
            current = (kind, int(wk), int(d), int(p), est == "1", reg == "1")
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[current].update(stack=int(m[1]), spill_stores=int(m[2]),
                                spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m[1])
            current = None
    return out


def build_kernels():
    """One nvcc call over csrc/*.cu. The main path's instantiations
    (Wk = 4 and 11, D = 4, P = 3, every form and route) must keep their
    per-key state in registers: a 0-byte stack frame and no spills."""
    from flow_pipeline_tpu_torch import kernels

    info = kernels.build(force=True)
    log(f"build: {info.seconds:.2f} s -> {info.path.relative_to(ROOT)}")
    (OUT / "nvcc.log").write_text(info.log)
    report = ptxas_report(info.log)
    log(f"ptxas (-Xptxas -v): {len(report)} kernel instantiations; the main "
        "path's (full log: chiprun_out/chip_smoke/nvcc.log):")
    main = {k: v for k, v in sorted(report.items())
            if k[1] in (4, 11) and k[2:4] == (DEPTH, PLANES)}
    for (kind, wk, d, p, est, reg), v in main.items():
        log(f"  ptxas {kind} Wk={wk} D={d} P={p} "
            f"{'estimate' if est else 'update'} "
            f"{'registers' if reg else 'scratch'}: {v}")
    # 2 kinds x Wk 4, 11 x (conservative: 4 forms; linear: 3)
    if len(main) != 14 or any(v.get("stack") != 0 or v.get("spill_stores")
                              or v.get("spill_loads")
                              for v in main.values()):
        raise AssertionError("ptxas: a main-path instantiation is missing "
                             "or uses a stack frame or spills")
    return info, {f"{k[0]}/wk{k[1]}/d{k[2]}p{k[3]}/"
                  f"{'est' if k[4] else 'upd'}/{'reg' if k[5] else 'scr'}": v
                  for k, v in main.items()}


# ---- phase 3 ---------------------------------------------------------------

def _bound(nbytes, ops) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timing(torch, name, counts, keys, vals, valid, library_fn) -> dict:
    """The split of the update alone (device, host, back-to-back), the
    library call's back-to-back figure and device time, and the estimate
    form against the update followed by cms_query, in turns."""
    from flow_pipeline_tpu_torch.ops import cms as cms_ops
    from flow_pipeline_tpu_torch.ops import cms_cuda

    fn = getattr(cms_cuda, name)
    upd = cms_split.split(torch, lambda: fn(counts, keys, vals, valid))
    lib_prof = cms_split.profile_kernels(torch, library_fn)

    def est_form():
        fn(counts, keys, vals, valid, with_estimate=True)

    def replaced():
        fn(counts, keys, vals, valid)
        cms_ops.cms_query(counts, keys)

    turns = {"est": [], "replaced": []}
    for which in ("est", "replaced", "replaced", "est"):
        turns[which].append(cms_split.time_cuda(
            torch, est_form if which == "est" else replaced))
    est_prof = cms_split.profile_kernels(torch, est_form, match="fpt_")
    rep_prof = cms_split.profile_kernels(torch, replaced, calls=10)
    return dict(
        device_ms=upd["device_us"] / 1e3,
        device_ms_events=upd["device_us_events"] / 1e3,
        launches_per_call=upd["launches_per_call"],
        host_ms=upd["host_us"] / 1e3, kernel_ms=upd["b2b_ms"],
        library_ms=cms_split.time_cuda(torch, library_fn),
        library_device_ms=lib_prof["device_us"] / 1e3,
        library_launches=lib_prof["launches_per_call"],
        est_ms=float(np.mean(turns["est"])),
        est_replaced_ms=float(np.mean(turns["replaced"])),
        est_turns_ms=turns,
        est_device_ms=est_prof["device_us"] / 1e3,
        est_launches_per_call=est_prof["launches_per_call"],
        est_replaced_device_ms=rep_prof["device_us"] / 1e3,
        est_replaced_launches=rep_prof["launches_per_call"])


def _log_timing(name, wk, t, bound_ms, est_bound_ms) -> None:
    log(f"  {name} Wk={wk} update: device {t['device_ms'] * 1e3:.2f} us "
        f"per launch (events {t['device_ms_events'] * 1e3:.2f} us, "
        f"{t['launches_per_call']:.2f} launches/call), host "
        f"{t['host_ms'] * 1e3:.2f} us per call, back-to-back "
        f"{t['kernel_ms'] * 1e3:.2f} us; plain {t['plain_ms']:.4f} ms; "
        f"library {t['library_ms'] * 1e3:.2f} us back-to-back "
        f"({t['library_device_ms'] * 1e3:.2f} us device, "
        f"{t['library_launches']:.0f} launches); bound "
        f"{bound_ms * 1e3:.3f} us")
    log(f"  {name} Wk={wk} estimate form: {t['est_ms'] * 1e3:.2f} us "
        f"back-to-back, {t['est_device_ms'] * 1e3:.2f} us device "
        f"({t['est_launches_per_call']:.0f} launch); the update + cms_query "
        f"it replaces {t['est_replaced_ms'] * 1e3:.2f} us back-to-back, "
        f"{t['est_replaced_device_ms'] * 1e3:.2f} us device "
        f"({t['est_replaced_launches']:.0f} launches); bound "
        f"{est_bound_ms * 1e3:.3f} us")


def check_estimate_form(torch, name, wk, real: bool) -> dict:
    """The estimate form against the plain update then cms_query over
    three calls on one sketch, at N = 32,768 (register route) and at
    N = 2^19, above the resident threads (scratch route). Conservative:
    torch.equal. Linear: torch.equal with integer addends inside 2^24,
    rtol 1e-6 with real-valued ones (``real``)."""
    from flow_pipeline_tpu_torch import kernels
    from flow_pipeline_tpu_torch.ops import cms as cms_ops
    from flow_pipeline_tpu_torch.ops import cms_cuda

    plain_fn = (cms_ops.cms_add_conservative
                if name == "cms_add_conservative" else cms_ops.cms_add)
    resident = cms_cuda._resident_rows(kernels.library(), name, 0, wk, DEPTH,
                                       PLANES)
    out = {"resident_rows": resident}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    for n in (BATCH, 1 << 19):
        counts = torch.randint(0, 5000, (PLANES, DEPTH, WIDTH), generator=gen,
                               device="cuda").float()
        keys = torch.unique(torch.randint(0, 2**32, (n, wk), generator=gen,
                                          device="cuda", dtype=torch.int64),
                            dim=0)
        keys = keys[torch.randperm(keys.shape[0], generator=gen,
                                   device="cuda")].contiguous()
        m = keys.shape[0]
        if (m > resident) != (n > BATCH):
            raise AssertionError(f"{name} Wk={wk} N={m}: route is not the "
                                 f"one meant (resident rows {resident})")
        valid = torch.rand(m, generator=gen, device="cuda") < 0.8
        plain = counts.clone()
        max_err = 0.0
        for _ in range(3):
            vals = (torch.rand((m, PLANES), generator=gen, device="cuda")
                    * 1e4 if real else
                    torch.randint(0, 1500, (m, PLANES), generator=gen,
                                  device="cuda").float())
            _, est = getattr(cms_cuda, name)(counts, keys, vals, valid,
                                             with_estimate=True)
            plain_fn(plain, keys, vals, valid)
            want = cms_ops.cms_query(plain, keys)
            torch.cuda.synchronize()
            if real:
                torch.testing.assert_close(counts, plain, rtol=F32_RTOL,
                                           atol=0)
                torch.testing.assert_close(est, want, rtol=F32_RTOL, atol=0)
            elif not (torch.equal(counts, plain) and torch.equal(est, want)):
                raise AssertionError(f"{name} estimate form != plain update "
                                     f"+ cms_query (Wk={wk}, N={m})")
            max_err = max(max_err, (counts - plain).abs().max().item(),
                          (est - want).abs().max().item())
        route = "scratch" if m > resident else "registers"
        out[route] = dict(n=m, max_abs_err=max_err)
    log(f"  {name} Wk={wk} estimate form == plain update + cms_query over 3 "
        f"calls at N={out['registers']['n']} (registers) and "
        f"N={out['scratch']['n']} (scratch; resident rows {resident})"
        + (f", within rtol {F32_RTOL}" if real else ", torch.equal"))
    return out


def conservative_phase(torch):
    from flow_pipeline_tpu_torch.ops import cms as cms_ops
    from flow_pipeline_tpu_torch.ops import cms_cuda

    shapes = {}
    for wk in (11, 4):
        counts, keys, vals, valid, n_forced = cms_split.inputs(torch, wk)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + wk)
        m = keys.shape[0]
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
        log(f"kernel cms_add_conservative Wk={wk} N={m} (forced collisions "
            f"{n_forced}): equal to plain over 3 calls")
        est_check = check_estimate_form(torch, "cms_add_conservative", wk,
                                        real=True)
        # bound: the bytes this call's data needs -- the mask, the u32 key
        # words and f32 values of the valid rows (invalid rows are never
        # read), a read of every touched cell and a write of every changed
        # one -- and its integer operations. The main path hands the kernel
        # u32 words in int64 carriers, so it reads 8 bytes per word where
        # the function needs 4 (key_bytes_read beside the bound). The
        # estimate form also writes N x P f32 estimates.
        buckets = cms_ops.cms_buckets(keys, DEPTH, WIDTH)  # [D, N]
        vb = buckets[:, valid]
        cells = torch.unique(vb + torch.arange(
            DEPTH, device="cuda")[:, None] * WIDTH).numel() * PLANES
        n_valid = int(valid.sum().item())
        nbytes = (valid.numel() + n_valid * (4 * wk + 4 * PLANES)
                  + 4 * cells + 4 * changed)
        ops = n_valid * DEPTH * (9 * wk + 10) + n_valid * DEPTH * PLANES * 2
        bound_ms, bound_by = _bound(nbytes, ops)
        est_bound_ms, _ = _bound(nbytes + 4 * m * PLANES, ops)
        # the library call: one scatter_reduce_ amax on precomputed flat
        # cells and targets
        target = torch.where(valid[:, None],
                             cms_ops.cms_query(counts, keys) + vals, 0.0)
        flat = (buckets + torch.arange(DEPTH, device="cuda")[:, None]
                * WIDTH).reshape(1, -1).expand(PLANES, -1).contiguous()
        tgt = target.T[:, None, :].expand(PLANES, DEPTH, m).reshape(
            PLANES, -1).contiguous()
        view = counts.view(PLANES, DEPTH * WIDTH)
        t = timing(torch, "cms_add_conservative", counts, keys, vals, valid,
                   lambda: view.scatter_reduce_(1, flat, tgt, "amax"))
        t["plain_ms"] = cms_split.time_cuda(
            torch, lambda: cms_ops.cms_add_conservative(plain, keys, vals,
                                                        valid))
        shapes[wk] = dict(
            n=m, wk=wk, forced_collisions=n_forced, valid=n_valid,
            max_abs_err=max(max_err, est_check["registers"]["max_abs_err"],
                            est_check["scratch"]["max_abs_err"]),
            bytes=nbytes, ops=ops,
            key_bytes_read=n_valid * wk * keys.element_size(),
            bound_ms=bound_ms, bound_by=bound_by, est_bound_ms=est_bound_ms,
            estimate_check=est_check, **t)
        _log_timing("cms_add_conservative", wk, t, bound_ms, est_bound_ms)
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
        counts, keys, vals, valid, n_forced = cms_split.inputs(torch, wk)
        m = keys.shape[0]
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
        log(f"kernel cms_add Wk={wk} N={m} (forced collisions {n_forced}): "
            f"equal to plain over 3 integer calls, within rtol {F32_RTOL} "
            f"over 3 real-valued calls (max abs err {max_err:.4g})")
        checks = [check_estimate_form(torch, "cms_add", wk, real=r)
                  for r in (False, True)]
        # bound: the mask, the u32 key words and f32 values of the valid
        # rows, a read and a write of every touched cell; the hashing and
        # the adds as operations. The estimate form also writes N x P f32.
        buckets = cms_ops.cms_buckets(keys, DEPTH, WIDTH)  # [D, N]
        rows = torch.arange(DEPTH, device="cuda")[:, None] * WIDTH
        cells = torch.unique((buckets + rows)[:, valid]).numel() * PLANES
        n_valid = int(valid.sum().item())
        nbytes = valid.numel() + n_valid * (4 * wk + 4 * PLANES) + 8 * cells
        ops = n_valid * DEPTH * (9 * wk + 10) + n_valid * DEPTH * PLANES
        bound_ms, bound_by = _bound(nbytes, ops)
        est_bound_ms, _ = _bound(nbytes + 4 * m * PLANES, ops)
        # the library call: one index_add_ on precomputed flat buckets
        flat = (buckets + rows).reshape(-1)
        src = torch.where(valid[:, None], vals, 0.0).T.repeat(1, DEPTH)
        view = counts.view(PLANES, DEPTH * WIDTH)
        t = timing(torch, "cms_add", counts, keys, vals, valid,
                   lambda: view.index_add_(1, flat, src))
        t["plain_ms"] = cms_split.time_cuda(
            torch, lambda: cms_ops.cms_add(plain, keys, vals, valid))
        shapes[wk] = dict(
            n=m, wk=wk, forced_collisions=n_forced, valid=n_valid,
            max_abs_err=max([max_err] + [c[r]["max_abs_err"] for c in checks
                                         for r in ("registers", "scratch")]),
            bytes=nbytes, ops=ops, cells=cells,
            key_bytes_read=n_valid * wk * keys.element_size(),
            bound_ms=bound_ms, bound_by=bound_by, est_bound_ms=est_bound_ms,
            estimate_check=checks, **t)
        _log_timing("cms_add", wk, t, bound_ms, est_bound_ms)
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


def generate_flows(spread_fraction: float = 0.0):
    """The stream the mocker writes, as one columnar batch (the mocker
    draws batches of 4096 from one generator)."""
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    gen = FlowGenerator(ZipfProfile(spread_fraction=spread_fraction),
                        seed=SEED, rate=RATE)
    return FlowBatch.concat([gen.batch(4096)
                             for _ in range(N_FLOWS // 4096)])


def accepted_windows(times, poll_max, n_parts=2, window=300,
                     sub=SUB_WINDOW):
    """Replays what the processor sees, independently of its code: frames
    round-robin over two partitions, one partition per poll in rotation,
    rows split by window slot, and rows of a closed slot dropped. Returns
    ({slot: row indices}, padded chunks per family on the per-model path,
    fused steps). The fused pipeline splits each poll at (slot, DDoS
    sub-window) boundaries and runs one step per part, late parts
    included (a poll holds at most poll_max rows, so a part is one
    chunk); ``sub=None`` replays a model set without DDoS, which splits
    by slot alone."""
    parts = [np.arange(p, len(times), n_parts) for p in range(n_parts)]
    pos = [0] * n_parts
    rr = 0
    current = None
    windows: dict[int, list] = {}
    chunks = steps = 0
    while True:
        got = next((q for q in ((rr + k) % n_parts for k in range(n_parts))
                    if pos[q] < len(parts[q])), None)
        rr += 1
        if got is None:
            break
        idx = parts[got][pos[got]:pos[got] + poll_max]
        pos[got] += len(idx)
        slots = times[idx] // window * window
        # sub-windows nest in slots (300 % 10 == 0): one part per sub
        steps += len(np.unique(times[idx] // sub if sub else slots))
        for slot in np.unique(slots):
            if current is not None and slot < current:
                continue  # late: the window was closed
            current = slot
            part = idx[slots == slot]
            windows.setdefault(int(slot), []).append(part)
            chunks += math.ceil(len(part) / poll_max)
    return ({s: np.concatenate(v) for s, v in windows.items()}, chunks,
            steps)


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


def compare_hh(a: dict, b: dict, what: str) -> None:
    """Heavy-hitter tables of two runs: same windows, keys, ranks and
    validity; values within rtol 1e-6 (group sums and linear CMS cells on
    the card are taken in atomic order)."""
    for table, key_cols in FAMILIES.items():
        if len(a[table]) != len(b[table]):
            raise AssertionError(f"{table}: window counts differ ({what})")
        for g, c in zip(a[table], b[table]):
            for col in (*key_cols, "valid", "timeslot"):
                if not np.array_equal(g[col], c[col]):
                    raise AssertionError(f"{table}: {col} differs ({what})")
            for col in ("bytes", "packets", "count", "bytes_est",
                        "packets_est", "count_est"):
                np.testing.assert_allclose(g[col], c[col], rtol=F32_RTOL,
                                           atol=0,
                                           err_msg=f"{table} {col} ({what})")


def compare_exact(a: dict, b: dict, what: str) -> None:
    """flows_5m and the port tables equal exactly, and the DDoS alerts
    are identical."""
    for table in ("flows_5m", *PORT_TABLES):
        g, c = _concat_rows(a[table]), _concat_rows(b[table])
        for col in c:
            if not np.array_equal(g[col], c[col]):
                raise AssertionError(f"{table}: {col} differs ({what})")
    ga = [x for rows in a.get("ddos_alerts", []) for x in rows]
    ca = [x for rows in b.get("ddos_alerts", []) for x in rows]
    if len(ga) != len(ca) or any(
            x.keys() != y.keys() or any(
                not np.array_equal(x[k], y[k]) for k in x)
            for x, y in zip(ga, ca)):
        raise AssertionError(f"ddos_alerts differ ({what}): {len(ga)} vs "
                             f"{len(ca)} alerts")


def compare_runs(gpu: dict, cpu: dict, full: bool = True) -> None:
    """Card run against CPU run: the heavy-hitter tables, and with
    ``full`` the exact tables and the alerts."""
    compare_hh(gpu, cpu, "card/CPU")
    if full:
        compare_exact(gpu, cpu, "card/CPU")


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


def _path_worker(batches, path: str, extra=()):
    """A StreamWorker for ``path`` (fused or per-model) over pre-decoded
    batches on the card, polled inline (no prefetch thread)."""
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine import StreamWorker

    vals = cli._processor_flags(cli._common_flags(
        cli.FlagSet("processor"))).parse(["-in", "unused", *RUN_PATHS[path],
                                          *extra])
    worker = StreamWorker(_Batches(batches), cli._build_models(vals, "cuda"),
                          poll_max=BATCH, prefetch=0,
                          fused=vals["processor.fused"],
                          **cli._ingest_kwargs(vals))
    if type(worker.fused).__name__ != (PIPELINE[path] or "NoneType"):
        raise AssertionError(f"{path} worker built the wrong path")
    return worker


def _profile_path(torch, worker, n_batches: int, tag: str) -> dict:
    """Kernel launches, device time and the card's idle share over
    ``n_batches`` worker steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as tprof

    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_batches):
            worker.run_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kernels = [e for e in avgs if str(e.device_type).endswith("CUDA")]
    dev_ms = sum(getattr(e, "self_device_time_total", 0) or
                 getattr(e, "self_cuda_time_total", 0)
                 for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    key = ("device_time_total" if avgs and hasattr(avgs[0],
                                                   "device_time_total")
           else "cuda_time_total")
    (OUT / f"profile_{tag}.txt").write_text(
        avgs.table(sort_by=key, row_limit=30))
    return dict(launches_per_batch=n_launch / n_batches,
                device_ms=dev_ms, wall_ms=wall_ms,
                idle=1 - dev_ms / wall_ms)


def device_batches(torch, flows, smi: str) -> dict:
    """ms per 32768-row batch on the device path for the full model set,
    fused and per-model: one StreamWorker step per pre-decoded batch (the
    models' updates, the per-batch flush and its drains), synchronised
    per batch, the two paths in turns (fused, per-model, per-model,
    fused) after a warm-up of each. Then the per-model updates split by
    model, and two batches of each path under torch.profiler."""
    batches = [flows.slice(s, s + BATCH) for s in range(0, N_FLOWS, BATCH)]
    for path in PATHS:  # allocator and first launches
        _path_worker(batches[:1], path).run()
    torch.cuda.synchronize()
    state_bytes = device_state_bytes(_path_worker(batches[:1],
                                                  "fused").models)
    log("device state bytes by model: " + json.dumps(state_bytes)
        + f" (total {sum(state_bytes.values())})")
    times = {path: [] for path in PATHS}
    for path in ("fused", "per-model", "per-model", "fused"):
        worker = _path_worker(batches, path)
        for _ in batches:
            t0 = time.perf_counter()
            worker.run_once()
            torch.cuda.synchronize()
            times[path].append((time.perf_counter() - t0) * 1e3)
    # the per-model updates model by model, each synchronised, for the
    # split of that path (flushes and drains excluded)
    split = _path_worker(batches, "per-model")
    per_model = {name: 0.0 for name in split.models}
    for b in batches:
        for name, model in split.models.items():
            t0 = time.perf_counter()
            model.update(b)
            torch.cuda.synchronize()
            per_model[name] += (time.perf_counter() - t0) * 1e3 / len(batches)
    prof = {path: _profile_path(torch, _path_worker(batches[:2], path), 2,
                                path.replace("-", "_"))
            for path in PATHS}
    for path in PATHS:
        t, p = times[path], prof[path]
        log(f"device path {path}: {np.mean(t):.3f} ms per {BATCH}-row batch "
            f"(7 models, synchronised; min {min(t):.3f}, max {max(t):.3f}, "
            f"{len(t)} batches) = {BATCH / np.mean(t) * 1e3:.0f} flows/s "
            f"excluding decode; profile (2 batches): "
            f"{p['launches_per_batch']:.0f} kernel launches per batch, "
            f"{p['device_ms']:.3f} ms of device time in {p['wall_ms']:.3f} "
            f"ms wall: the card idle {100 * p['idle']:.1f} % (under the "
            f"profiler) [{smi}]")
    log("per-model update ms per batch by model: "
        + json.dumps({k: round(v, 3) for k, v in per_model.items()}))
    return dict(batch_ms=times,
                batch_ms_mean={k: float(np.mean(v)) for k, v in times.items()},
                update_ms_by_model=per_model, state_bytes_by_model=state_bytes,
                profile=prof)


def _samples(text: str) -> dict:
    """{series (name + labels): float} of a /metrics exposition text."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, _, value = line.rpartition(" ")
            out[series] = float(value)
    return out


def _scrape(server) -> dict:
    """/metrics, /debug/trace and /healthz of a running MetricsServer, over
    HTTP on the port it was given."""
    import urllib.request

    base = f"http://127.0.0.1:{server.port}"
    return {p: urllib.request.urlopen(base + p, timeout=60).read().decode()
            for p in ("/metrics", "/debug/trace", "/healthz")}


def run_main_path(torch, frames, path: str, devices=("cuda", "cpu"),
                  extra=(), scrape: bool = False,
                  tag: str = "") -> list[dict]:
    """The processor at CLI defaults (``path`` adds RUN_PATHS[path]: the
    fused step with -processor.hostassist off, -processor.fused=false, or
    -processor.hostassist on; ``extra`` flags after it) with every default
    model, on each of ``devices``; each run's launch counts are zeroed
    just before it and read just after. The metrics server listens on a
    free port (-metrics.addr 127.0.0.1:0); with ``scrape`` its /metrics
    and /debug/trace are read over HTTP before it stops, and the
    registry's samples just before the run are kept (counters are
    process totals: a run's count is the difference)."""
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.obs import REGISTRY
    from flow_pipeline_tpu_torch.ops import cms as cms_ops
    from flow_pipeline_tpu_torch.ops import cms_cuda

    query = cms_ops.cms_query
    runs = []
    for device in devices:
        capture = Capture()
        queries = []  # cms_query calls: on the card, window extractions only

        def counted(counts, keys):
            queries.append(keys.shape[0])
            return query(counts, keys)

        scraped: dict = {}
        before = _samples(REGISTRY.render()) if scrape else None
        db = WORK / f"{tag}{path}{''.join(extra)}-{device}.db"
        for name in cms_cuda.LAUNCHES:
            cms_cuda.LAUNCHES[name] = 0
        cms_ops.cms_query = counted
        t0 = time.perf_counter()
        try:
            worker = cli.run_processor(
                ["-device", device, "-in", str(frames), "-sink",
                 f"sqlite:{db}", "-loglevel", "warning",
                 "-processor.batch", str(BATCH), "-sketch.width", str(WIDTH),
                 "-metrics.addr", "127.0.0.1:0", *RUN_PATHS[path], *extra],
                sinks=[capture],
                on_finish=(lambda w, srv: scraped.update(_scrape(srv)))
                if scrape else None)
            torch.cuda.synchronize()
        finally:
            cms_ops.cms_query = query
        wall = time.perf_counter() - t0
        launches = dict(cms_cuda.LAUNCHES)
        if type(worker.fused).__name__ != (PIPELINE[path] or "NoneType"):
            raise AssertionError(f"{path} run took another path: "
                                 f"{type(worker.fused).__name__}")
        runs.append(dict(device=device, worker=worker, rows=capture.tables,
                         wall=wall, launches=launches,
                         cms_queries=len(queries), scrape=scraped,
                         before=before, db=db))
        log(f"processor {path} {' '.join(extra)} -device {device}: "
            f"{worker.flows_seen} flows, {worker.batches_seen} batches, "
            f"{wall:.2f} s wall ({worker.flows_seen / wall:.0f} flows/s "
            f"incl. native decode), update calls "
            f"{worker.update_seconds:.2f} s, launches {launches}, family "
            f"chunk updates {worker.chunk_updates}, cms_query calls "
            f"{len(queries)}")
    return runs


def run_linear_path(torch, frames) -> list[dict]:
    """The three heavy-hitter families with the linear update, built
    through the library (WindowedHeavyHitter, StreamWorker with its
    default fused step and prefetch feed, bus, consumer) on the card and
    the CPU."""
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
                              poll_max=BATCH, host_assist="off")
        if worker.fused is None:
            raise AssertionError("the linear families did not fuse")
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


def decode_phase(frames, smi: str) -> dict:
    """The native decoder against the pure-Python codec on the whole
    frames file, column for column, and us per flow of each (native: the
    best of three)."""
    from flow_pipeline_tpu_torch import native
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    data = frames.read_bytes()
    t0 = time.perf_counter()
    lib_path = native.build()
    build_s = time.perf_counter() - t0
    native.library()
    native_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = FlowBatch.from_wire(data)
        native_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = FlowBatch.from_python_wire(data)
    python_s = time.perf_counter() - t0
    if len(got) != N_FLOWS or len(want) != N_FLOWS:
        raise AssertionError(f"decode: {len(got)} native, {len(want)} "
                             f"Python rows; want {N_FLOWS}")
    for name, col in want.columns.items():
        if got.columns[name].dtype != col.dtype or not np.array_equal(
                got.columns[name], col):
            raise AssertionError(f"decode: native {name} != Python")
    out = dict(build_s=build_s, native_us_per_flow=min(native_s) / N_FLOWS
               * 1e6, python_us_per_flow=python_s / N_FLOWS * 1e6,
               bytes=len(data))
    log(f"decode: native ({lib_path.name}, g++ build {build_s:.2f} s) == "
        f"pure-Python on all {N_FLOWS} flows, column for column; native "
        f"{out['native_us_per_flow']:.4f} us per flow, Python "
        f"{out['python_us_per_flow']:.3f} us per flow [{smi}]")
    return out


def _check_main_run(run, flows, windows, steps_or_chunks, what) -> dict:
    """The gates of one main-path card run: conservative launches equal
    the chunk updates and the replay, cms_query once per emitted window,
    heavy-hitter windows against the oracle, flows_5m equal to the
    oracle, the port tables equal to exact sums."""
    _check_launches(what, run, "cms_add_conservative", steps_or_chunks)
    # the estimates come out of the update: on the card cms_query runs
    # once per emitted heavy-hitter window (the table's estimates at
    # extraction) and never after an update
    extractions = sum(len(run["rows"][t]) for t in FAMILIES)
    if run["cms_queries"] != extractions:
        raise AssertionError(f"{what}: {run['cms_queries']} cms_query "
                             f"calls, want {extractions} (one per emitted "
                             "window)")
    summary = check_oracle(flows, run["rows"], windows)
    groups = check_flows_5m(flows, run["rows"]["flows_5m"])
    ports = check_port_tables(flows, run["rows"], windows)
    log(f"{what}: {len(summary)} heavy-hitter windows hold top-20 and "
        f"upper bounds; flows_5m {groups} (timeslot, key) rows equal the "
        f"oracle exactly; {len(ports)} port-table windows equal exact "
        "per-window sums and the exact top-100")
    return dict(hh=summary, flows_5m_rows=groups, ports=ports)


def _rows_written(table: str, rows) -> int:
    """Rows one sink write carried, as the worker counts them."""
    if table == "ddos_alerts":
        return len(rows)
    if table == "flows_5m":
        return len(rows["timeslot"])
    return int(rows["valid"].sum())


def check_scrape(run) -> dict:
    """The default run's /metrics and /debug/trace, scraped over HTTP
    before its server stopped, against the worker: the flows, batches
    and rows of this run (differences of the process totals), the DDoS
    detector's late rows, and one decode and apply span per batch and a
    flush span per sink write."""
    from collections import Counter

    w, got = run["worker"], run["scrape"]
    after, before = _samples(got["/metrics"]), run["before"]

    def delta(series):
        return after.get(series, 0.0) - before.get(series, 0.0)

    written = sum(_rows_written(t, r) for t, rs in run["rows"].items()
                  for r in rs)
    writes = sum(len(rs) for rs in run["rows"].values())
    late = w.models["ddos_alerts"].late_flows_dropped
    spans = Counter(ev["name"] for ev in
                    json.loads(got["/debug/trace"])["traceEvents"])
    checks = {
        "flows_processed_total": (delta("flows_processed_total"), N_FLOWS),
        "batches_processed_total": (delta("batches_processed_total"),
                                    w.batches_seen),
        "insert_count": (delta("insert_count"), written),
        "late_flows_dropped{ddos_alerts}": (
            after.get('late_flows_dropped{model="ddos_alerts"}'), late),
        "decode spans": (spans["decode"], w.batches_seen),
        "apply spans": (spans["apply"], w.batches_seen),
        "flush spans": (spans["flush"], writes),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad or w.flows_seen != N_FLOWS or json.loads(got["/healthz"]) != {
            "ok": True}:
        raise AssertionError(f"scrape: {bad} (scraped, want)")
    log(f"scrape (/metrics, /debug/trace over HTTP): "
        + ", ".join(f"{k} {v[0]:.0f}" for k, v in checks.items())
        + f"; {len(_samples(got['/metrics']))} series")
    return {k: v[0] for k, v in checks.items()}


WIRING_OFF = ("-metrics.addr", "", "-sink.retries", "1", "-obs.trace", "off")
FAULT_PLAN = "sink.write:p=0.3@seed=7"


def wiring_phase(torch, frames, clean, steps, smi: str) -> dict:
    """The paired cost of the host wiring (the defaults: metrics server,
    retried sinks, trace ring; against -metrics.addr "" -sink.retries 1
    -obs.trace off) end to end on the card, in turns (on, off, off, on,
    on, off);
    then the default run under the fault plan sink.write:p=0.3@seed=7 at
    -sink.retries 4, whose rows must equal the fault-free card run's,
    with retries and no failures."""
    runs = {"on": [], "off": []}
    for tag in ("on", "off", "off", "on", "on", "off"):
        (run,) = run_main_path(torch, frames, "fused", devices=("cuda",),
                               extra=WIRING_OFF if tag == "off" else ())
        _check_launches(f"wiring {tag}", run, "cms_add_conservative", steps)
        runs[tag].append(run)
    out = {tag: dict(flows_per_s=[N_FLOWS / r["wall"] for r in rs],
                     ms_per_batch=[r["wall"] * 1e3 / r["worker"].batches_seen
                                   for r in rs])
           for tag, rs in runs.items()}
    cost = float(np.mean(out["on"]["ms_per_batch"])
                 - np.mean(out["off"]["ms_per_batch"]))
    log("wiring, end to end in turns (on = defaults; off = "
        f"{' '.join(repr(a) if not a else a for a in WIRING_OFF)}): "
        + "; ".join(f"{t} {', '.join(f'{x:.0f}' for x in v['flows_per_s'])}"
                    f" flows/s" for t, v in out.items())
        + f"; on - off = {cost:.3f} ms per {BATCH}-row batch [{smi}]")
    (fr,) = run_main_path(torch, frames, "fused", devices=("cuda",),
                          extra=("-faults", FAULT_PLAN, "-sink.retries", "4"),
                          scrape=True)
    _check_launches("fault plan", fr, "cms_add_conservative", steps)
    compare_runs(fr["rows"], clean)
    after, before = _samples(fr["scrape"]["/metrics"]), fr["before"]
    sink = {fam: sum(v - before.get(k, 0.0) for k, v in after.items()
                     if k.startswith(fam))
            for fam in ("sink_write_retries_total",
                        "sink_write_failures_total")}
    if sink["sink_write_retries_total"] <= 0 or \
            sink["sink_write_failures_total"] != 0:
        raise AssertionError(f"fault plan: sink counters {sink}")
    log(f"fault plan {FAULT_PLAN} at -sink.retries 4: rows equal the "
        f"fault-free card run's; {sink['sink_write_retries_total']:.0f} "
        f"retries, {sink['sink_write_failures_total']:.0f} failures, "
        f"{fr['wall']:.2f} s wall")
    return dict(out, on_minus_off_ms_per_batch=cost, fault_plan=FAULT_PLAN,
                fault_sink_counters=sink, fault_wall_s=fr["wall"])


def checkpoint_phase(torch, frames, clean, smi: str) -> dict:
    """A card run stopped after half the polls with -checkpoint.path (a
    snapshot, then the stop), restored into a fresh card processor and
    into a CPU processor, each running the stream to its end: the rows
    of the first half and the resumed run together must equal the
    uninterrupted card run's (flows_5m, port tables and alerts exactly;
    heavy-hitter keys and ranks equal, values within rtol 1e-6). Times
    the save (the snapshot with its device-to-host copies) and a restore
    onto each device, and reports the checkpoint's bytes on disk."""
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine import StreamWorker
    from flow_pipeline_tpu_torch.engine.checkpoint import checkpoint_bytes
    from flow_pipeline_tpu_torch.ops import cms_cuda
    from flow_pipeline_tpu_torch.transport import Consumer

    ckpt = WORK / "ckpt"
    base = ["-in", str(frames), "-loglevel", "warning", "-processor.batch",
            str(BATCH), "-sketch.width", str(WIDTH), *PATHS["fused"]]
    vals = cli._processor_flags(cli._common_flags(cli.FlagSet(
        "processor"))).parse([*base, "-sink", f"sqlite:{WORK / 'half.db'}",
                              "-checkpoint.path", str(ckpt)])
    first = Capture()
    bus = cli._load_frames_bus(vals["in"], vals["kafka.topic"])
    for name in cms_cuda.LAUNCHES:
        cms_cuda.LAUNCHES[name] = 0
    worker = StreamWorker(
        Consumer(bus, vals["kafka.topic"]), cli._build_models(vals, "cuda"),
        cli._make_sinks(vals["sink"], retries=vals["sink.retries"],
                        extra=[first]),
        poll_max=BATCH, prefetch=vals["feed.prefetch"],
        snapshot_every=vals["flush.count"], checkpoint_path=str(ckpt),
        host_assist="off")
    half = N_FLOWS // BATCH // 2  # even: the partition rotation lines up
    try:
        for _ in range(half):
            if not worker.run_once():
                raise AssertionError("checkpoint: the stream ended early")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        worker.snapshot_and_commit()
        save_ms = (time.perf_counter() - t0) * 1e3
    finally:
        worker.consumer.stop()
    if cms_cuda.LAUNCHES["cms_add_conservative"] != worker.chunk_updates:
        raise AssertionError("checkpoint: first half launches "
                             f"{cms_cuda.LAUNCHES} != chunk updates "
                             f"{worker.chunk_updates}")
    nbytes = checkpoint_bytes(str(ckpt))
    shutil.copytree(ckpt, WORK / "ckpt-cpu")  # the card run rewrites ckpt
    restore_ms = {}
    for device in ("cuda", "cpu"):
        fresh = StreamWorker(None, cli._build_models(vals, device),
                             prefetch=0, host_assist="off")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not fresh.restore(str(ckpt)):
            raise AssertionError("checkpoint: nothing to restore")
        torch.cuda.synchronize()
        restore_ms[device] = (time.perf_counter() - t0) * 1e3
    resumed = {}
    for device, path in (("cuda", ckpt), ("cpu", WORK / "ckpt-cpu")):
        cap = Capture()
        for name in cms_cuda.LAUNCHES:
            cms_cuda.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        w = cli.run_processor(
            ["-device", device, *base, "-sink",
             f"sqlite:{WORK / f'resumed-{device}.db'}", "-metrics.addr",
             "127.0.0.1:0", "-checkpoint.path", str(path)], sinks=[cap])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = w.chunk_updates if device == "cuda" else 0
        if w.flows_seen != N_FLOWS or w.batches_seen <= half or \
                cms_cuda.LAUNCHES["cms_add_conservative"] != want:
            raise AssertionError(
                f"checkpoint resume ({device}): {w.flows_seen} flows, "
                f"{w.batches_seen} batches, launches {cms_cuda.LAUNCHES}, "
                f"want {want}")
        rows = {t: first.tables.get(t, []) + cap.tables.get(t, [])
                for t in set(first.tables) | set(cap.tables)}
        compare_runs(rows, clean)
        resumed[device] = dict(wall_s=wall, batches=w.batches_seen - half,
                               launches=cms_cuda.LAUNCHES[
                                   "cms_add_conservative"])
    log(f"checkpoint: card run stopped after {half} of {2 * half} polls; "
        f"save {save_ms:.1f} ms, {nbytes} bytes on disk "
        f"(arrays.npz + meta.json); restore {restore_ms['cuda']:.1f} ms "
        f"onto the card, {restore_ms['cpu']:.1f} ms onto the CPU; resumed "
        "on the card and on the CPU, each with the first half's rows equal "
        "to the uninterrupted card run's (exact tables and alerts; "
        f"heavy-hitter values within rtol 1e-6) [{smi}]")
    return dict(save_ms=save_ms, restore_ms=restore_ms, bytes=nbytes,
                cut_after_polls=half, resumed=resumed)


# ---- phase 11 ---------------------------------------------------------------

def bucket_kernel_check(torch) -> dict:
    """The conservative kernel's estimate form (what the host-grouped step
    launches) against the plain update followed by cms_query at the
    group-table shapes: N in BUCKETS, Wk 11 and 4, the real groups first
    and the padding rows zero and invalid, three calls on one sketch,
    torch.equal. Device us per launch (torch.profiler) at N = 1,024 and
    32,768."""
    from flow_pipeline_tpu_torch import kernels
    from flow_pipeline_tpu_torch.ops import cms as cms_ops
    from flow_pipeline_tpu_torch.ops import cms_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    out = {}
    for wk in (11, 4):
        resident = cms_cuda._resident_rows(
            kernels.library(), "cms_add_conservative", 0, wk, DEPTH, PLANES)
        for n in BUCKETS:
            g = n * 3 // 4 + 1  # groups in a table padded to n rows
            counts = torch.randint(0, 5000, (PLANES, DEPTH, WIDTH),
                                   generator=gen, device="cuda").float()
            plain = counts.clone()
            keys = torch.zeros((n, wk), dtype=torch.int64, device="cuda")
            keys[:g] = torch.unique(torch.randint(
                0, 2**32, (g, wk), generator=gen, device="cuda",
                dtype=torch.int64), dim=0)[:g]
            valid = torch.arange(n, device="cuda") < g
            max_err = 0.0
            for _ in range(3):
                vals = torch.randint(1, 1500, (n, PLANES), generator=gen,
                                     device="cuda").float()
                vals[g:] = 0.0
                _, est = cms_cuda.cms_add_conservative(
                    counts, keys, vals, valid, with_estimate=True)
                cms_ops.cms_add_conservative(plain, keys, vals, valid)
                want = cms_ops.cms_query(plain, keys)
                torch.cuda.synchronize()
                if not (torch.equal(counts, plain) and torch.equal(est, want)):
                    raise AssertionError(
                        f"conservative estimate form != plain update + "
                        f"cms_query at the bucket shape N={n} Wk={wk}")
                max_err = max(max_err, (counts - plain).abs().max().item(),
                              (est - want).abs().max().item())
            rec = dict(n=n, wk=wk, groups=g, max_abs_err=max_err,
                       route="scratch" if n > resident else "registers")
            if n in (BUCKETS[0], BUCKETS[-1]):
                prof = cms_split.profile_kernels(
                    torch, lambda: cms_cuda.cms_add_conservative(
                        counts, keys, vals, valid, with_estimate=True),
                    match="fpt_")
                # per launch: the profiler may drop some of a run's
                # events, so divide by the launches it kept
                rec["device_ms"] = (prof["device_us"] / 1e3
                                    / prof["launches_per_call"])
                rec["launches_per_call"] = prof["launches_per_call"]
            out[f"wk{wk}/n{n}"] = rec
    log("kernel cms_add_conservative at the host-grouped step's shapes "
        "(estimate form == plain update + cms_query, torch.equal, 3 calls "
        "each): " + "; ".join(
            f"{k} {v['route']}" + (f" {v['device_ms'] * 1e3:.2f} us/launch"
                                   if "device_ms" in v else "")
            for k, v in out.items()))
    return out


def _check_hostgroup_run(run) -> None:
    """One host-grouped run: the pipeline, the pipelined runtime (the
    group thread prepared every batch, the flusher ran), and one
    conservative launch per family per applied chunk on the card (none on
    the CPU)."""
    w = run["worker"]
    if w.executor is None or w.executor.prepared != w.batches_seen or \
            w.flusher is None or not w.flusher.jobs_run:
        raise AssertionError(f"host-grouped ({run['device']}): the "
                             "pipelined runtime did not run")
    if w.chunk_updates != len(FAMILIES) * w.fused.applied_chunks:
        raise AssertionError(f"host-grouped ({run['device']}): chunk "
                             f"updates {w.chunk_updates} != 3 x "
                             f"{w.fused.applied_chunks} applied chunks")
    want = {k: 0 for k in run["launches"]}
    if run["device"] == "cuda":
        want["cms_add_conservative"] = w.chunk_updates
    if run["launches"] != want:
        raise AssertionError(f"host-grouped ({run['device']}): launches "
                             f"{run['launches']}, want {want}")


def hostgroup_device_path(torch, flows, smi: str) -> dict:
    """The host-grouped step over pre-decoded 32768-row batches on the
    card, serial: per batch the host prepare (grouping) and the apply
    (lifecycle, host-to-device copies, the device step) timed apart,
    synchronised; then two applies under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as tprof

    batches = [flows.slice(s, s + BATCH) for s in range(0, N_FLOWS, BATCH)]
    _path_worker(batches[:1], "hostassist").run()  # warm-up
    pipe = _path_worker(batches, "hostassist").fused
    prep_ms, apply_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        prep = pipe.prepare(b)
        t1 = time.perf_counter()
        pipe.apply(prep)
        torch.cuda.synchronize()
        prep_ms.append((t1 - t0) * 1e3)
        apply_ms.append((time.perf_counter() - t1) * 1e3)
    pipe = _path_worker(batches[:2], "hostassist").fused
    preps = [pipe.prepare(b) for b in batches[:2]]
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in preps:
            pipe.apply(p)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kern = [e for e in avgs if str(e.device_type).endswith("CUDA")]
    dev_ms = sum(getattr(e, "self_device_time_total", 0) or
                 getattr(e, "self_cuda_time_total", 0) for e in kern) / 1e3
    launches = sum(e.count for e in kern) / 2
    key = ("device_time_total" if avgs and hasattr(avgs[0],
                                                   "device_time_total")
           else "cuda_time_total")
    (OUT / "profile_hostassist.txt").write_text(
        avgs.table(sort_by=key, row_limit=30))
    out = dict(prepare_ms=prep_ms, apply_ms=apply_ms,
               prepare_ms_mean=float(np.mean(prep_ms)),
               apply_ms_mean=float(np.mean(apply_ms)),
               launches_per_batch=launches, device_ms=dev_ms,
               wall_ms=wall_ms, idle=1 - dev_ms / wall_ms)
    log(f"device path hostassist: prepare (host grouping) "
        f"{out['prepare_ms_mean']:.3f} ms + apply {out['apply_ms_mean']:.3f}"
        f" ms per {BATCH}-row batch (synchronised, {len(batches)} "
        f"batches); profile (2 applies): {launches:.0f} kernel launches "
        f"per batch, {dev_ms:.3f} ms of device time in {wall_ms:.3f} ms "
        f"wall: the card idle {100 * out['idle']:.1f} % [{smi}]")
    return out


def hostgroup_phase(torch, frames, flows, fused_card, smi: str) -> dict:
    """Phase 11: the host-grouped path on the card and the CPU."""
    buckets = bucket_kernel_check(torch)
    card, cpu = run_main_path(torch, frames, "hostassist", scrape=True)
    for run in (card, cpu):
        _check_hostgroup_run(run)
    extractions = sum(len(card["rows"][t]) for t in FAMILIES)
    if card["cms_queries"] != extractions:
        raise AssertionError(f"host-grouped: {card['cms_queries']} cms_query "
                             f"calls, want {extractions} (one per emitted "
                             "window: every update is in the estimate form)")
    groups = check_flows_5m(flows, card["rows"]["flows_5m"])
    compare_exact(card["rows"], fused_card["rows"], "host-grouped/fused")
    compare_hh(card["rows"], fused_card["rows"], "host-grouped/fused")
    compare_runs(card["rows"], cpu["rows"])
    gauge = 'native_path_degraded{feature="group"} 0'
    if gauge not in card["scrape"]["/metrics"].splitlines():
        raise AssertionError(f"host-grouped: /metrics lacks {gauge!r}")
    log(f"host-grouped (-processor.hostassist on): card and CPU runs, "
        f"{card['worker'].fused.applied_chunks} applied chunks, "
        f"{card['launches']['cms_add_conservative']} conservative launches "
        f"= chunk updates, each in the estimate form; flows_5m {groups} "
        "rows equal the oracle; port tables and alerts equal the fused "
        "card run's, heavy-hitter keys and ranks equal (values within "
        "rtol 1e-6); card rows equal CPU rows; /metrics shows "
        f"{gauge}; {card['worker'].executor.prepared} batches prepared on "
        f"the group thread, {card['worker'].flusher.jobs_run} flush jobs")
    e2e = {p: [] for p in RUN_PATHS}
    for p in ("hostassist", "fused", "per-model", "per-model", "fused",
              "hostassist"):
        (run,) = run_main_path(torch, frames, p, devices=("cuda",))
        e2e[p].append(N_FLOWS / run["wall"])
    log("end to end, warm, in turns: " + "; ".join(
        f"{p} {', '.join(f'{r:.0f}' for r in v)} flows/s"
        for p, v in e2e.items()) + f" [{smi}]")
    dev = hostgroup_device_path(torch, flows, smi)
    return dict(buckets=buckets, launches=card["launches"],
                chunk_updates=card["worker"].chunk_updates,
                applied_chunks=card["worker"].fused.applied_chunks,
                wall_s={r["device"]: r["wall"] for r in (card, cpu)},
                flows_per_s_e2e_turns=e2e, device_path=dev)


# ---- phase 12 ---------------------------------------------------------------

def _spread_rows(db) -> list:
    import sqlite3

    conn = sqlite3.connect(db)
    try:
        return sorted(conn.execute("SELECT * FROM journal").fetchall())
    finally:
        conn.close()


def check_spreaders(flows, rows_by_table, windows) -> dict:
    """Every emitted spread window holds the generator's spreader sources
    whose exact distinct count is at least 8x the largest other source's,
    with no other source ranked above any of them (spreader legs below
    the cut may interleave). Each one's decoded spread past the
    linear-counting range (exact count > 2.5 m, where the estimator
    claims its 1.04/sqrt(m) standard error) lies within 3 x 1.04/sqrt(m)
    of its exact distinct count; below it the errors are reported (there
    a bucket's other keys add their elements to the count: 41 % on one
    row of this stream, the same in the reference, whose registers and
    decode the port reproduces bit for bit)."""
    from flow_pipeline_tpu_torch.gen import ZipfProfile

    prof = ZipfProfile(spread_fraction=SPREAD_FRACTION)
    prefix = np.frombuffer(prof.prefix + b"\x00", dtype=">u4").astype(
        np.uint32)
    tol = 3 * 1.04 / math.sqrt(SPREAD_REGS)
    src = flows.columns["src_addr"]
    summary = {}
    for table, elem in SPREAD_TABLES.items():
        emitted = {int(r["timeslot"][0]): r for r in rows_by_table[table]}
        if sorted(emitted) != sorted(windows):
            raise AssertionError(f"{table}: windows {sorted(emitted)} "
                                 f"emitted, {sorted(windows)} expected")
        for slot, idx in windows.items():
            e = flows.columns[elem][idx].astype(np.uint32).reshape(
                len(idx), -1)
            pairs = np.unique(np.concatenate([src[idx], e], axis=1), axis=0)
            keys, exact = np.unique(pairs[:, :4], axis=0, return_counts=True)
            leg = ((keys[:, :3] == prefix[:3]).all(axis=1)
                   & ((keys[:, 3] & 0xFFFF0000) == (prefix[3] & 0xFFFF0000))
                   & ((keys[:, 3] & 0xF000) == 0xF000))
            floor = 8 * int(exact[~leg].max())
            strong = {tuple(k): int(c) for k, c in zip(keys[leg & (
                exact >= floor)], exact[leg & (exact >= floor)])}
            legs = {tuple(k) for k in keys[leg]}
            rows = emitted[slot]
            got = [tuple(k) for k in rows["src_addr"][rows["valid"]]]
            if not strong or not set(strong) <= set(got):
                raise AssertionError(
                    f"{table}@{slot}: not all {len(strong)} spreaders with "
                    f"fan-out >= {floor} were emitted")
            last = max(got.index(k) for k in strong)
            if not set(got[:last + 1]) <= legs:
                raise AssertionError(f"{table}@{slot}: another source ranks "
                                     "above a spreader")
            errs = {"hll": [0.0], "lc": [0.0]}
            for j, key in enumerate(got[:last + 1]):
                if key in strong:
                    rel = abs(float(rows["spread"][j]) - strong[key]) \
                        / strong[key]
                    errs["hll" if strong[key] > 2.5 * SPREAD_REGS
                         else "lc"].append(rel)
            if max(errs["hll"]) > tol:
                raise AssertionError(f"{table}@{slot}: decoded spread off "
                                     f"by {max(errs['hll']):.3f} > {tol:.3f}")
            summary[f"{table}@{slot}"] = dict(
                spreaders=len(strong), floor=floor,
                hll_rows=len(errs["hll"]) - 1,
                max_rel_err=max(errs["hll"]),
                max_rel_err_lc=max(errs["lc"]),
                top_exact=max(strong.values()))
    return summary


def _same_spread_rows(a: dict, b: dict, what: str) -> None:
    for table in SPREAD_TABLES:
        if len(a[table]) != len(b[table]):
            raise AssertionError(f"{table}: window counts differ ({what})")
        for x, y in zip(a[table], b[table]):
            if x.keys() != y.keys() or any(
                    x[c].dtype != y[c].dtype or not np.array_equal(x[c], y[c])
                    for c in x):
                raise AssertionError(f"{table}: rows differ ({what})")


def spread_phase(torch, smi: str) -> dict:
    """Phase 12: -spread.enabled, fused and host-grouped, card and CPU."""
    from flow_pipeline_tpu_torch import cli

    frames = WORK / "spread.bin"
    assert cli.main(["mocker", "-out", str(frames), "-produce.profile",
                     "zipf", "-zipf.spread", str(SPREAD_FRACTION),
                     "-produce.count", str(N_FLOWS), "-produce.rate",
                     str(RATE), "-produce.seed", str(SEED)]) == 0
    flows = generate_flows(SPREAD_FRACTION)
    windows, _, _ = accepted_windows(
        flows.columns["time_received"].astype(np.int64), BATCH)
    on = ("-spread.enabled",)
    runs = {}
    for path in ("fused", "hostassist"):
        for run in run_main_path(torch, frames, path, extra=on,
                                 tag="spread-"):
            runs[f"{path}/{run['device']}"] = run
    ref = runs["fused/cuda"]
    summary = check_spreaders(flows, ref["rows"], windows)
    journal = _spread_rows(ref["db"])
    for name, run in runs.items():
        _same_spread_rows(run["rows"], ref["rows"], f"{name}/fused card")
        if _spread_rows(run["db"]) != journal:
            raise AssertionError(f"spread journal rows differ ({name})")
        if run["device"] == "cuda":
            w = run["worker"]
            if run["launches"]["cms_add_conservative"] != w.chunk_updates:
                raise AssertionError(f"spread {name}: launches "
                                     f"{run['launches']} != chunk updates "
                                     f"{w.chunk_updates}")
    # with spread on and off, in turns; the first "on" is the gate run
    rates = {"on": [N_FLOWS / ref["wall"]], "off": []}
    off_rows = None
    for tag in ("off", "off", "on"):
        (run,) = run_main_path(torch, frames, "fused", devices=("cuda",),
                               extra=on if tag == "on" else (),
                               tag=f"spread-{tag}{len(rates[tag])}-")
        rates[tag].append(N_FLOWS / run["wall"])
        if tag == "off" and off_rows is None:
            off_rows = run["rows"]
    compare_exact(ref["rows"], off_rows, "spread on/off")
    compare_hh(ref["rows"], off_rows, "spread on/off")
    log(f"spread (-spread.enabled, -zipf.spread {SPREAD_FRACTION}): "
        f"superspreader and portscan rows and the sqlite journal "
        f"({len(journal)} rows) equal in the fused and host-grouped runs "
        f"on the card and the CPU; " + "; ".join(
            f"{k}: {v['spreaders']} spreaders (fan-out >= {v['floor']}) on "
            f"top, max rel err {v['max_rel_err']:.3f} over the "
            f"{v['hll_rows']} past linear counting, "
            f"{v['max_rel_err_lc']:.3f} below"
            for k, v in summary.items())
        + f" (bound {3 * 1.04 / math.sqrt(SPREAD_REGS):.3f}); every other "
        "table equals the run without -spread.enabled. End to end, in "
        "turns: " + "; ".join(f"spread {t} {', '.join(f'{r:.0f}' for r in v)}"
                              f" flows/s" for t, v in rates.items())
        + f" [{smi}]")
    return dict(windows=summary, journal_rows=len(journal),
                wall_s={k: r["wall"] for k, r in runs.items()},
                flows_per_s_e2e_turns=rates)


def main_path(torch, smi: str) -> dict:
    from flow_pipeline_tpu_torch import cli

    frames = WORK / "frames.bin"
    t0 = time.perf_counter()
    assert cli.main(["mocker", "-out", str(frames), "-produce.profile",
                     "zipf", "-produce.count", str(N_FLOWS),
                     "-produce.rate", str(RATE), "-produce.seed",
                     str(SEED)]) == 0
    log(f"mocker: {N_FLOWS} flows in {time.perf_counter() - t0:.1f} s")
    with phase("4 decode"):
        decode = decode_phase(frames, smi)
    flows = generate_flows()
    times = flows.columns["time_received"].astype(np.int64)
    windows, chunks, steps = accepted_windows(times, BATCH)
    log(f"replay: {len(windows)} windows, {chunks} padded chunks per "
        f"family on the per-model path, {steps} fused steps")

    # the main path: the processor at CLI defaults (fused), its /metrics
    # and /debug/trace scraped before the server stops
    with phase("5 fused"):
        gpu, cpu = runs = run_main_path(torch, frames, "fused", scrape=True)
        _check_launches("fused path (cpu)", cpu, "cms_add_conservative",
                        steps)
        checks = _check_main_run(gpu, flows, windows, steps,
                                 "fused path (card)")
        scrape = check_scrape(gpu)
        compare_runs(gpu["rows"], cpu["rows"])
    n_alerts = sum(len(a) for a in gpu["rows"].get("ddos_alerts", []))
    max_rate = max_ddos_rate(flows)
    if max_rate >= INT_ENVELOPE:
        raise AssertionError(f"DDoS rates left the 2^24 envelope: "
                             f"{max_rate}")
    log(f"fused: card run equals CPU run: flows_5m, port tables and "
        f"{n_alerts} DDoS alerts identical; heavy-hitter keys and ranks "
        "equal, values within rtol 1e-6; largest DDoS bucket rate "
        f"{max_rate:.0f} < 2^24")

    # the second path: per-model, card and CPU, its own gates, and its
    # exact tables equal to the fused run's
    t6 = time.perf_counter()
    pm_gpu, pm_cpu = pm = run_main_path(torch, frames, "per-model")
    _check_launches("per-model path (cpu)", pm_cpu, "cms_add_conservative",
                    chunks)
    _check_main_run(pm_gpu, flows, windows, chunks, "per-model path (card)")
    compare_runs(pm_gpu["rows"], pm_cpu["rows"])
    compare_exact(gpu["rows"], pm_gpu["rows"], "fused/per-model")
    # without DDoS both paths chunk the heavy hitters alike: their tables
    # must agree row for row (the fused chain sums the src groups in
    # another order: values within rtol 1e-6)
    _, chunks_hh, steps_hh = accepted_windows(times, BATCH, sub=None)
    hh_pair = [run_main_path(torch, frames, path, devices=("cuda",),
                             extra=("-model.ddos=false",))[0]
               for path in PATHS]
    for run, path in zip(hh_pair, PATHS):
        _check_launches(f"{path} path without DDoS (card)", run,
                        "cms_add_conservative",
                        steps_hh if path == "fused" else chunks_hh)
    compare_hh(*(r["rows"] for r in hh_pair), "fused/per-model, no DDoS")
    compare_exact(*(r["rows"] for r in hh_pair), "fused/per-model, no DDoS")
    log("fused card rows equal per-model card rows: flows_5m, port tables "
        f"and {n_alerts} DDoS alerts identical; without DDoS ({steps_hh} "
        f"fused steps, {chunks_hh} per-model chunks per family) the "
        "heavy-hitter keys and ranks equal, values within rtol 1e-6")
    PHASE_SECONDS["6 per-model"] = time.perf_counter() - t6
    log(f"phase 6 per-model: {PHASE_SECONDS['6 per-model']:.1f} s")

    with phase("7 linear"):
        lin_gpu, lin_cpu = lin = run_linear_path(torch, frames)
        for run in lin:
            _check_launches(f"linear path ({run['device']})", run,
                            "cms_add", steps_hh)
        lin_summary = check_oracle(flows, lin_gpu["rows"], windows,
                                   top_k=10)
        compare_runs(lin_gpu["rows"], lin_cpu["rows"], full=False)
    log(f"linear path (fused step): {len(lin_summary)} windows hold the "
        "exact top-10 and upper bounds; card rows equal CPU rows (keys and "
        "ranks equal, values within rtol 1e-6)")

    with phase("8 flood"):
        flood = ddos_flood(torch)
    t9 = time.perf_counter()
    dev = device_batches(torch, flows, smi)
    e2e = N_FLOWS / gpu["wall"]
    log(f"end to end, first run in the process (fused, native decode, "
        f"prefetch 2): {e2e:.0f} flows/s on the card ({gpu['wall']:.2f} s); "
        f"per-model {N_FLOWS / pm_gpu['wall']:.0f} flows/s "
        f"({pm_gpu['wall']:.2f} s) [{smi}]")
    # the same runs again, every kernel loaded and the allocator warm, in
    # turns: the steady end-to-end rate of each path
    warm = {path: [] for path in PATHS}
    for path in ("fused", "per-model", "per-model", "fused"):
        (run,) = run_main_path(torch, frames, path, devices=("cuda",))
        warm[path].append(N_FLOWS / run["wall"])
    log("end to end, warm, in turns: " + "; ".join(
        f"{p} {', '.join(f'{r:.0f}' for r in v)} flows/s"
        for p, v in warm.items()) + f" [{smi}]")
    PHASE_SECONDS["9 timings"] = time.perf_counter() - t9
    log(f"phase 9 timings: {PHASE_SECONDS['9 timings']:.1f} s")
    with phase("10 wiring, faults, checkpoint"):
        wiring = wiring_phase(torch, frames, gpu["rows"], steps, smi)
        ckpt = checkpoint_phase(torch, frames, gpu["rows"], smi)
    with phase("11 host-grouped"):
        hostgroup = hostgroup_phase(torch, frames, flows, gpu, smi)
    with phase("12 spread"):
        spread = spread_phase(torch, smi)
    return dict(
        hostgroup=hostgroup, spread=spread,
        scrape=scrape, wiring=wiring, checkpoint=ckpt,
        launches=gpu["launches"], chunk_updates=gpu["worker"].chunk_updates,
        fused_steps=steps, per_model_chunks=chunks,
        per_model_launches=pm_gpu["launches"],
        cms_query_calls={f"{p}/{r['device']}": r["cms_queries"]
                         for p, rs in (("fused", runs), ("per-model", pm))
                         for r in rs},
        linear_launches=lin_gpu["launches"],
        linear_chunk_updates=lin_gpu["worker"].chunk_updates,
        windows=len(windows), flows_5m_rows=checks["flows_5m_rows"],
        ddos_alerts=n_alerts, max_ddos_rate=max_rate, flood=flood,
        decode=decode,
        late_dropped={n: getattr(m, "late_flows_dropped", None)
                      for n, m in gpu["worker"].models.items()},
        wall_s={f"{p}/{r['device']}": r["wall"]
                for p, rs in (("fused", runs), ("per-model", pm))
                for r in rs},
        linear_wall_s={r["device"]: r["wall"] for r in lin},
        flows_per_s_e2e=e2e, flows_per_s_e2e_per_model=N_FLOWS
        / pm_gpu["wall"], flows_per_s_e2e_warm=warm,
        update_s={f"{p}/{r['device']}": r["worker"].update_seconds
                  for p, rs in (("fused", runs), ("per-model", pm))
                  for r in rs},
        **dev)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import torch

    smi = environment(torch)
    # import only after the CUDA check: a copy of this script alone fails
    # here, as it must
    import flow_pipeline_tpu_torch  # noqa: F401
    global cms_split
    from tools import cms_split

    OUT.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        with phase("2 build"):
            build, ptxas = build_kernels()
        with phase("3 kernels"):
            shapes = {"cms_add_conservative": conservative_phase(torch),
                      "cms_add": linear_phase(torch)}
            quantile_phase(torch)
        path = main_path(torch, smi)
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
            # the back-to-back figure of PRs 1-2; the device and host
            # times per call split it
            "ms": main_shape["kernel_ms"],
            "device_ms": main_shape["device_ms"],
            "device_ms_events": main_shape["device_ms_events"],
            "host_ms": main_shape["host_ms"],
            "launches_per_call": main_shape["launches_per_call"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "library_device_ms": main_shape["library_device_ms"],
            "est_ms": main_shape["est_ms"],
            "est_device_ms": main_shape["est_device_ms"],
            "est_replaced_ms": main_shape["est_replaced_ms"],
            "est_replaced_device_ms": main_shape["est_replaced_device_ms"],
            "est_bound_ms": main_shape["est_bound_ms"],
            "ptxas": {k: v for k, v in ptxas.items()
                      if k.startswith(source[4:-3])},
            "shapes": {f"wk{k}": v for k, v in by_wk.items()},
        })
    # the host-grouped path launches only the conservative kernel, at the
    # group-table shapes
    hg = path["hostgroup"]
    cons = next(k for k in kernels if k["name"] == "cms_add_conservative")
    cons["hostgroup_launches"] = hg["launches"]["cms_add_conservative"]
    cons["hostgroup_device_ms"] = {
        str(n): hg["buckets"][f"wk11/n{n}"]["device_ms"]
        for n in (BUCKETS[0], BUCKETS[-1])}
    record = dict(card=smi, build_s=build.seconds, kernels=kernels,
                  main_path=path, phase_seconds=PHASE_SECONDS)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    ms = path["batch_ms_mean"]
    log(f"card: {smi}; end to end {path['flows_per_s_e2e']:.0f} flows/s "
        f"(fused); device path {ms['fused']:.3f} ms per {BATCH}-row batch "
        f"fused, {ms['per-model']:.3f} per-model (full model set)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
