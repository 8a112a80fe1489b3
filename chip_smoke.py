#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flow_pipeline_tpu_torch) on one card.

    python3 chip_smoke.py            # the whole run, one card

Phases, each fatal on failure:

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi). No CUDA device: exit non-zero before anything else.
2. Build every kernel source (csrc/*.cu) for sm_90a, one nvcc per source
   started together and one link, printing the build time and ptxas's registers, stack frame and spills
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
   library call computing the same scatter (its device time the median
   of 25 warm calls, each read from its own kernel events), and the
   bound; and the
   estimate form against the sequence it replaces (the update, then
   cms_query), in turns. Then the quantile bucket ids of every integer in
   [0, 2^24) on the card against the CPU's.
4. Decode: the port's mocker writes 262,144 seeded Zipf flows; the native
   frame decoder (built with g++) must equal the pure-Python decode of
   the whole file, column for column; us per flow of each.
5. The main path: the port's processor at CLI defaults (native decode,
   prefetch 2, one fused step per chunk; flows_5m, three heavy-hitter
   families, two port tables, DDoS; batch 32768, width 65536, depth 4,
   capacity 1024, top-k 100) on the card, then over the stream's first
   quarter on the card and on the CPU (the CPU's fused step took 45-65 s
   over the whole stream). The
   conservative kernel's launches must equal the family chunk updates
   the worker counted and an independent replay of the fused steps, each
   in its estimate form, so no cms_query follows an update; flows_5m must
   equal the exact oracle; the HH and port tables are held against exact
   per-window sums; the CPU run must give the card's rows and alerts over
   the same quarter. The
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
   process, then both paths once more, warm); ms per batch on the
   device path, fused and per-model, one run each; kernel launches per
   batch and the card's idle share of each path over one batch under
   torch.profiler.
10. The host wiring: the default run against -metrics.addr "" -sink.retries
   1 -obs.trace off, end to end, one run each (on, off);
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
   with the host-grouped and per-model paths, one warm run each, and the
   host-grouped device path per batch (prepare and apply apart) with
   launches and idle share under torch.profiler.
12. The spread detectors (-spread.enabled) on a stream with spreader
   legs (-zipf.spread 0.05), fused and host-grouped, on the card over the
   whole stream and on the CPU over its first quarter (against a fused
   card run of that quarter): the superspreader and portscan rows (and
   the sqlite journal) equal in every pair; each window holds the generator's spreaders whose exact
   fan-out is at least 8x the largest other source's, on top, each
   decoded spread within 3 x 1.04/sqrt(64) of its exact distinct count;
   every other table equals the run without -spread.enabled. Times: end
   to end with spread on (the gate run) and off.
13. The host sketch backend (-sketch.backend host -processor.hostassist
   on; -hh.sketch auto puts top_src_ips and top_dst_ips on the invertible
   sketch), with the fused native pass (-ingest.fused auto) and the
   staged engine (off), each on the card and the CPU. Gates: no CMS
   launch; flows_5m equal to the oracle; port tables and alerts equal to
   the fused card run's; top_talkers (table family, u64 host engine)
   holds the exact top-20 and upper bounds; every invertible row's
   values equal the exact per-window sums, in the exact ranking of the
   decoded keys; all seven tables bit-equal between the fused pass and
   the staged engine and between the card and the CPU; /metrics shows
   native_path_degraded 0 for group, sketch, lanes, fused and invsketch;
   the host_fused phase counters are non-zero. Times: end to end with
   the host-sketch (fused and staged) and host-grouped paths, one warm
   run each;
   the host sketch device path per batch (host prepare, host
   sketch and device rest-step apart) for the fused pass, the staged
   engine and the fused pass on one thread (-ingest.threads 1) in
   turns; launches per batch and idle share under torch.profiler; the
   host_fused phase split.
   Phases 11-13 run with -obs.audit off, so their figures compare with
   the runs from before the sketch audit was ported; phase 14 runs it.
14. The sketch audit (-obs.audit sample, the default; off; full): the
   host-grouped path and the host sketch backend (fused pass and staged
   engine) with the audit at sample and off, one pair each (sample,
   off), on the card. Gates: all seven tables bit-equal on and off;
   sketch_audit_windows_total grows by the closes on every heavy-hitter
   family (0 off); the close reports on the card equal a -device cpu
   run's (host-grouped, host sketch), the fused pass's equal the staged
   engine's; once at full on the host-grouped path, whose top_talkers
   cohort is every key and whose recall at 100 equals the exact
   oracle's in every window. Times: flows/s end to end on and off, the
   sketch_audit and sketch_audit_close stage seconds, prepare and apply
   ms per batch on and off in turns.
15. The pipeline entry (cli.run_pipeline, ``pipeline``) at CLI defaults
   on the card (the fused step; full default widths): 524,288 Zipf
   flows at 2,000 flows/s, generated and encoded with the native frame
   encoder into a two-partition in-process bus, with the live query API
   (-query.addr) and the serving tier (-serve.addr, -serve.refresh 2),
   both on free ports; while it runs, serve/loadgen.py samples the
   snapshot's age and its 8 closed-loop reader threads (in a reader
   process) query /query/* for 3 s. Gates:
   flows_5m equal to the oracle over the generated flows; all seven
   tables equal a processor -in run on the card over the frames the
   mocker writes with the same -produce.* flags (heavy-hitter values
   within rtol 1e-6); conservative launches equal the chunk updates;
   with the worker held between two steps and a snapshot published
   there, /healthz, /topk, /windows and /alerts answer 200, /topk (off
   the fresh snapshot, lock-free) and /query/topk equal the model's own
   top(), and /query/estimate of each top key equals np_cms_query_u64
   over a host copy of the card's CMS planes; at the end /query/range
   equals the rows the sinks were given and a /sub/snapshot?since=0
   full frame rebuilds the served snapshot (state_to_snapshot); every
   reader request answers 200 (the load starts once a window closed, so
   /query/range has rows) and the server answers no 500.
   Figures: publishes and ms per publish (the card-to-host capture
   apart), reader p50/p99 ms, snapshot age p50/p99, the generation
   seconds (draw and native encode apart), flows/s end to end beside
   the processor -in run's, and pipeline with and without -serve.addr,
   one run each (serve, plain; tools/serve_cost.py times the pairs).
16. processor -listen.feed on the card, fed the phase-4 frames by
   FeedClient in 8 publishes: rows equal the phase-5 -in run's. Then
   collector -out F on loopback, sent NetFlow v9, IPFIX and sFlow v5
   datagrams (templates first; built here): the collected records equal
   the datagrams' records, and processor -in F on the card gives
   flows_5m equal to the oracle; datagrams decoded per second (host).
17. The gateway, the history tier and the guard. pipeline at CLI
   defaults on the card as in phase 15, with -serve.addr (port 0), a
   -serve.feed_bytes budget that holds about one delta, and -guard.lag
   armed and held at level 0; a port gateway (cli.run_gateway, with
   -history.dir) and a port history tier (cli.run_history) subscribed to
   its serving tier, in process. Gates: the tables equal phase 15's
   unguarded run's; conservative launches equal the chunk updates; with
   the worker held between two steps and a snapshot published there, the
   /query/{topk,estimate,range,audit} bodies (and an error answer) are
   byte-equal on the worker, the gateway and the history tier, and again
   at the final version; ArchiveReader.reconstruct(v) of each archive
   equals the snapshot the worker published at v, for every archived
   version; /query/topk?at= and ?version= of the held version, long
   superseded at the worker, answer the body served then (whether the
   worker's delta chain, at a budget of a few deltas, still reaches that
   version is recorded).
   Then the guard held at level 3 (-guard.lag 1, the ladder stepped with
   explicit clocks and fed a fixed lag): processor -in over the phase-4
   frames on the host-grouped path (admission on the group thread) on
   the card and the CPU give equal tables and shed the same rows,
   conservative launches equal the chunk updates; pipeline (the fused
   step, admission on the worker thread) held at
   level 3 against unguarded, one run each (guarded, plain),
   the first guarded run's /metrics showing flow_guard_level 3 and its
   guard_shed_total. Figures: gateway mirror age p50/p99, archive bytes
   per version, reconstruct ms, flows/s guarded against unguarded, the
   share of rows shed.
18. The in-process mesh: pipeline -mesh.workers N at CLI defaults on the
   card over phase 15's stream (the flows key-hash sharded over
   max(2, N) partitions; every member's fused step launches the
   conservative kernel from its own thread, on the device's one default
   stream), for N = 2, then N = 2 with the merged serving tier
   (-serve.addr), N = 4 over the first quarter of the stream, a churn
   run of 3 members with one killed (no final submission) and fenced
   mid-stream over its first half, then N = 1. Gates on each run: the
   merged flows_5m equal
   the oracle and, over the whole stream, phase 15's single-worker rows;
   top_talkers keys and values equal the single worker's where the
   stream's distinct keys fit the capacity, else every merged row's
   estimates bound its values (est >= value); the conservative launches
   equal the members' CMS updates summed (the process tally, counted
   under a lock); every model set a member built holds its state on the
   card, and every member launched on the default stream; in the churn
   run the killed member's model state is freed while the mesh runs on
   and the card's allocated memory returns to its level before the run.
   The serving run has phase 15's 8 loadgen readers (in a subprocess,
   once a window merged), a /query/version poller and a port gateway
   mirroring the merged store: no reader answer but 200 and no 500,
   versions never go back; a publish taken with the members idle answers
   /query/topk equal to coordinator.query_topk; the final publish's
   /query/range equals the merged flows_5m sink rows and its full frame
   rebuilds it; the gateway lands the final version and answers its
   queries byte-equal. Figures: flows/s for N = 1, 2 and 4 (one
   interpreter lock and one card shared: no claim) and N = 2 with the
   serving tier; publishes and ms per publish (the members' captures
   apart), reader p50/p99 ms, snapshot age p50/p99; peak card memory per
   run, and the card's idle share under torch.profiler over a 2-member
   run of 65,536 flows.
19. The mesh over HTTP, one process per member. The coordinator is a
   subprocess, python -m flow_pipeline_tpu_torch.cli processor
   -mesh.role coordinator (-mesh.listen, -bus.partitions K = max(2, N),
   -mesh.heartbeat 2, -mesh.journal, -obs.trace ring, -metrics.addr,
   -sink sqlite:DB, phase 15's widths; it touches no device). Each
   member is this script re-invoked as one member (--mesh-member): the
   body of the reference's member role (RemoteCoordinator with its state
   and trace URLs, MeshMember with submit_every 64 and a 1-s sync, a
   MemberStateServer, a metrics server for /debug/trace) over its own
   in-process bus, loaded with phase 15's stream key-hash sharded over K
   partitions as every process shards it. Members load the kernels phase
   2 built; all join before any consumes; the parent waits on counts
   (the coordinator's frontier at the stream's end offsets). Runs: N = 2
   over the whole stream, then 3 over the whole stream with member 1
   SIGKILLed once it has stepped two batches (fenced by the heartbeat
   expiry, its partitions rebalanced). Gates: the merged flows_5m sqlite
   rows equal the oracle and, over the whole stream, phase 15's
   single-worker rows; every merged top_talkers row (the sqlite sink
   keeps no estimates) is a key of its window whose values bound the
   exact sums; on N = 2 the conservative launches summed over the member
   processes equal their CMS updates summed, and with the members idle
   the coordinator's /topk equals a host fold of their /meshstate
   payloads; /debug/trace holds a coordinator lane and one per live
   member, each thread's spans in order; the lineage entry prints a
   merged line per window and its -lineage.raw equals /debug/lineage;
   /healthz counts the members; the coordinator exits 0 on SIGINT.
   Figures: flows/s of N = 2 against phase 18's in-process N = 2, per
   member flows/s and peak card memory, merges and their seconds, the
   fence delay, the /topk ms.

20. Device sharding: processor -processor.mesh N at CLI defaults (every
   default model sharded over N shard slots on the one card, the per-model
   path, -processor.batch 32768 per shard) over the first half of
   phase 15's stream (262,144 flows, the mocker's frames), N = 4, then 1
   and 2, beside the single-worker per-model run of the same frames.
   Gates on each: flows_5m equal to the oracle and to the single worker's
   rows; conservative launches equal the CMS updates counted per shard
   (3 families x N shards x the replayed chunks); every shard's state on
   cuda:0 and every launch on the default stream. N = 4 also on the CPU:
   the tables and alerts equal, heavy-hitter values within rtol 1e-6,
   every estimate bounding its value. Then two processes over
   torch.distributed (gloo; this script re-invoked with --shard-rank),
   each holding two of four shards of a MultihostPipeline on the card
   and feeding its half of every global batch: the ranks' merged
   flows_5m equal the oracle, the top-K rows identical on both ranks and
   equal to one process's ShardedHeavyHitter at N = 4. Figures: flows/s
   for each N and the single worker's, launches per global batch, the
   merges (count and ms, synchronised), peak card memory, the ranks'
   update and flush seconds.

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
# the sketch audit (on by default on the host-grouped pipelines) off:
# phases 11-13 measure what they measured before it was ported; phase 14
# turns it on with a later -obs.audit
AUDIT_OFF = ["-obs.audit", "off"]
# every path the processor runs here, with the pipeline each must select
RUN_PATHS = {**PATHS,
             # CLI defaults, for -processor.mesh N (sharded models take the
             # per-model path)
             "mesh": [],
             "hostassist": ["-processor.hostassist", "on",
                                     *AUDIT_OFF],
             # the host sketch backend: the fused native pass (the
             # default, -ingest.fused auto) and the staged engine
             "hostsketch": ["-processor.hostassist", "on",
                            "-sketch.backend", "host", *AUDIT_OFF],
             "hostsketch-staged": ["-processor.hostassist", "on",
                                   "-sketch.backend", "host",
                                   "-ingest.fused", "off", *AUDIT_OFF],
             # the fused pass with its kernels on one thread
             "hostsketch-t1": ["-processor.hostassist", "on",
                               "-sketch.backend", "host",
                               "-ingest.threads", "1", *AUDIT_OFF]}
PIPELINE = {"fused": "FusedPipeline", "per-model": None, "mesh": None,
            "hostassist": "HostGroupPipeline",
            "hostsketch": "HostSketchPipeline",
            "hostsketch-staged": "HostSketchPipeline",
            "hostsketch-t1": "HostSketchPipeline"}
# -hh.sketch auto on the host backend: the cascade families invertible
INVERTIBLE = ("top_src_ips", "top_dst_ips")
BUCKETS = (1024, 4096, 32768)  # the host-grouped step's table shapes
SPREAD_FRACTION = 0.05
SPREAD_REGS = 64
SPREAD_TABLES = {"superspreaders": "dst_addr", "portscan": "dst_port"}
INT_ENVELOPE = 1 << 24  # f32 sums of integers are exact below this
# the CPU legs of the fused path (phases 5 and 12) run over the stream's
# first HEAD_FLOWS flows, against a card run of the same frames: the CPU's
# fused step takes 45-65 s over the whole stream
HEAD_FLOWS = N_FLOWS // 4
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
    """An nvcc per csrc/*.cu, all at once, then one link. The main path's
    instantiations (Wk = 4 and 11, D = 4, P = 3, every form and route)
    must keep their per-key state in registers: a 0-byte stack frame and
    no spills."""
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
    # the library's device time: the median over 25 warm calls of each
    # call's own kernel events (a single profile once read 4.05 us at
    # Wk = 11 where other calls read 13.68: the profiler drops events)
    lib_med = cms_split.device_us_median(torch, library_fn, calls=25)

    def est_form():
        fn(counts, keys, vals, valid, with_estimate=True)

    def replaced():
        fn(counts, keys, vals, valid)
        cms_ops.cms_query(counts, keys)

    turns = {"est": [], "replaced": []}
    for which in ("est", "replaced"):
        turns[which].append(cms_split.time_cuda(
            torch, est_form if which == "est" else replaced, iters=20))
    est_prof = cms_split.profile_kernels(torch, est_form, match="fpt_")
    rep_prof = cms_split.profile_kernels(torch, replaced, calls=3)
    return dict(
        device_ms=upd["device_us"] / 1e3,
        device_ms_events=upd["device_us_events"] / 1e3,
        launches_per_call=upd["launches_per_call"],
        host_ms=upd["host_us"] / 1e3, kernel_ms=upd["b2b_ms"],
        library_ms=cms_split.time_cuda(torch, library_fn),
        library_device_ms=lib_med["median_us"] / 1e3,
        library_device_ms_quartiles=(lib_med["q1_us"] / 1e3,
                                     lib_med["q3_us"] / 1e3),
        library_device_readings_us=lib_med["readings_us"],
        library_device_ms_profile100=lib_prof["device_us"] / 1e3,
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
        f"({t['library_device_ms'] * 1e3:.2f} us device, the median of "
        f"{len(t['library_device_readings_us'])} warm calls' kernel events, "
        f"quartiles {t['library_device_ms_quartiles'][0] * 1e3:.2f}-"
        f"{t['library_device_ms_quartiles'][1] * 1e3:.2f}; "
        f"{t['library_device_ms_profile100'] * 1e3:.2f} us over one "
        f"profile of 100 calls; {t['library_launches']:.0f} launches); bound "
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
        keys = cms_split.unique_rows(torch, torch.randint(
            0, 2**32, (n, wk), generator=gen, device="cuda",
            dtype=torch.int64), gen)
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
                                                        valid), iters=20)
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
            torch, lambda: cms_ops.cms_add(plain, keys, vals, valid),
            iters=20)
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


def head_frames(frames: Path, n: int) -> Path:
    """A frames file of the first ``n`` frames of ``frames``."""
    from flow_pipeline_tpu_torch.schema import wire

    head = frames.with_name(f"head-{frames.name}")
    it = wire.iter_raw_frames(frames.read_bytes())
    head.write_bytes(b"".join(bytes(next(it)) for _ in range(n)))
    return head


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


def check_oracle(flows, rows_by_table, windows, top_k=20,
                 tables=tuple(FAMILIES)) -> dict:
    """Every emitted heavy-hitter window of ``tables`` against the exact
    numpy oracle: the top-``top_k`` keys match the exact ones and every
    value and estimate upper-bounds its exact sum."""
    summary = {}
    for table in tables:
        key_cols = FAMILIES[table]
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


_ORACLES: dict = {}  # check_flows_5m's exact rollups, by stream


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
    # the mesh phases hold several runs against one stream: its oracle
    # is computed once (a stream is known by its length and column sums)
    cols = flows.columns
    stream = (len(flows), *(int(cols[k].sum()) for k in (
        "time_received", "bytes", "packets", "src_as")))
    exact = _ORACLES.get(stream)
    if exact is None:
        want = flows_5m(flows)
        scaled = exact_groupby(flows, list(FLOWS_5M_KEYS), timeslot=True,
                               scale_col="sampling_rate")
        exact = _ORACLES[stream] = {}
        for i in range(len(want["timeslot"])):
            key = (int(want["timeslot"][i]),
                   *(int(want[c][i]) for c in FLOWS_5M_KEYS))
            exact[key] = [int(want["bytes"][i]), int(want["packets"][i]),
                          int(want["count"][i]),
                          int(scaled["bytes_scaled"][i]),
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
    per batch, one run of each path (fused, then per-model) after a
    warm-up of each. Then the per-model updates split by model, and one
    batch of each path under torch.profiler."""
    batches = [flows.slice(s, s + BATCH) for s in range(0, N_FLOWS, BATCH)]
    for path in PATHS:  # allocator and first launches
        _path_worker(batches[:1], path).run()
    torch.cuda.synchronize()
    state_bytes = device_state_bytes(_path_worker(batches[:1],
                                                  "fused").models)
    log("device state bytes by model: " + json.dumps(state_bytes)
        + f" (total {sum(state_bytes.values())})")
    times = {path: [] for path in PATHS}
    for path in ("fused", "per-model"):
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
    prof = {path: _profile_path(torch, _path_worker(batches[:1], path), 1,
                                path.replace("-", "_"))
            for path in PATHS}
    for path in PATHS:
        t, p = times[path], prof[path]
        log(f"device path {path}: {np.mean(t):.3f} ms per {BATCH}-row batch "
            f"(7 models, synchronised; min {min(t):.3f}, max {max(t):.3f}, "
            f"{len(t)} batches) = {BATCH / np.mean(t) * 1e3:.0f} flows/s "
            f"excluding decode; profile (1 batch): "
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
                  tag: str = "", on_start=None) -> list[dict]:
    """The processor at CLI defaults (``path`` adds RUN_PATHS[path]: the
    fused step with -processor.hostassist off, -processor.fused=false, or
    -processor.hostassist on; ``extra`` flags after it) with every default
    model, on each of ``devices``; each run's launch counts are zeroed
    just before it and read just after. The metrics server listens on a
    free port (-metrics.addr 127.0.0.1:0); with ``scrape`` its /metrics
    and /debug/trace are read over HTTP before it stops, and the
    registry's samples just before the run are kept (counters are
    process totals: a run's count is the difference). ``on_start`` is
    run_processor's."""
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
                sinks=[capture], on_start=on_start,
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
    -obs.trace off) end to end on the card, one run each (on, off);
    then the default run under the fault plan sink.write:p=0.3@seed=7 at
    -sink.retries 4, whose rows must equal the fault-free card run's,
    with retries and no failures."""
    runs = {"on": [], "off": []}
    for tag in ("on", "off"):
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
            keys[:g] = cms_split.unique_rows(torch, torch.randint(
                0, 2**32, (g, wk), generator=gen, device="cuda",
                dtype=torch.int64), gen, shuffle=False)[:g]
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
    # the fused path's turns are phase 9's
    e2e = {p: [] for p in ("hostassist", "per-model")}
    for p in e2e:
        (run,) = run_main_path(torch, frames, p, devices=("cuda",))
        e2e[p].append(N_FLOWS / run["wall"])
    log("end to end, warm: " + "; ".join(
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
        (runs[f"{path}/cuda"],) = run_main_path(
            torch, frames, path, devices=("cuda",), extra=on, tag="spread-")
    # the CPU legs over the first HEAD_FLOWS flows, against a card run of
    # the same frames
    head = head_frames(frames, HEAD_FLOWS)
    (head_ref,) = run_main_path(torch, head, "fused", devices=("cuda",),
                                extra=on, tag="spread-head-")
    for path in ("fused", "hostassist"):
        (runs[f"{path}/cpu"],) = run_main_path(
            torch, head, path, devices=("cpu",), extra=on,
            tag="spread-head-")
    ref = runs["fused/cuda"]
    summary = check_spreaders(flows, ref["rows"], windows)
    journal = _spread_rows(ref["db"])
    # the card runs against the fused card run, the CPU runs against the
    # fused card run over the same first HEAD_FLOWS flows
    want = {"cuda": (ref["rows"], journal),
            "cpu": (head_ref["rows"], _spread_rows(head_ref["db"]))}
    for name, run in runs.items():
        rows, want_journal = want[run["device"]]
        _same_spread_rows(run["rows"], rows, f"{name}/fused card")
        if _spread_rows(run["db"]) != want_journal:
            raise AssertionError(f"spread journal rows differ ({name})")
    for name, run in (*runs.items(), ("fused/cuda, head", head_ref)):
        w = run["worker"]
        if run["device"] == "cuda" and \
                run["launches"]["cms_add_conservative"] != w.chunk_updates:
            raise AssertionError(f"spread {name}: launches "
                                 f"{run['launches']} != chunk updates "
                                 f"{w.chunk_updates}")
    # with spread on (the gate run) and off
    rates = {"on": [N_FLOWS / ref["wall"]], "off": []}
    off_rows = None
    for tag in ("off",):
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
        f"on the card, and over the first {HEAD_FLOWS} flows in both on "
        f"the CPU and the fused run on the card; " + "; ".join(
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


# ---- phase 13 ---------------------------------------------------------------

def check_invertible(flows, rows_by_table, windows) -> dict:
    """The invertible families (top_src_ips, top_dst_ips under -hh.sketch
    auto on the host backend): every emitted row's bytes, packets and
    count equal its key's exact per-window sums (the float32 of the exact
    uint64 sum: the decode recovers exact sums), and the rows come in the
    exact ranking of the recovered keys (bytes descending, the key's
    lexicographic order on ties). Reports how many of the exact top-20
    keys were recovered."""
    summary = {}
    for table in INVERTIBLE:
        key_cols = FAMILIES[table]
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
                    raise AssertionError(f"{table}@{slot}: decoded key "
                                         f"{key} never occurred")
                for plane, name in enumerate(("bytes", "packets", "count")):
                    got = rows[name][valid][j]
                    if got != np.float32(exact[key][plane]):
                        raise AssertionError(
                            f"{table}@{slot} {name}={got} != exact "
                            f"{exact[key][plane]} for {key}")
            order = sorted(keys, key=lambda k: (-exact[k][0], k))
            if keys != order:
                raise AssertionError(f"{table}@{slot}: rows are not in the "
                                     "exact ranking of the decoded keys")
            ranked = sorted(exact, key=lambda k: (-exact[k][0], k))[:20]
            summary[f"{table}@{slot}"] = dict(
                rows=len(keys), exact_groups=len(exact),
                top20_recovered=len(set(ranked) & set(keys)))
    return summary


def _same_tables(a: dict, b: dict, what: str) -> None:
    """All seven tables bit-equal (every column, dtype included) and the
    DDoS alerts identical."""
    for table in ("flows_5m", *FAMILIES, *PORT_TABLES):
        if len(a[table]) != len(b[table]):
            raise AssertionError(f"{table}: window counts differ ({what})")
        for x, y in zip(a[table], b[table]):
            if x.keys() != y.keys() or any(
                    x[c].dtype != y[c].dtype or not np.array_equal(x[c], y[c])
                    for c in x):
                raise AssertionError(f"{table}: rows differ ({what})")
    compare_exact(a, b, what)


def _phase_ns(run, stage="host_fused") -> dict:
    """{phase: ns} of a scraped run's <stage>_phase_ns_total counters
    (this run's difference of the process totals)."""
    after, before = _samples(run["scrape"]["/metrics"]), run["before"]
    prefix = f"{stage}_phase_ns_total{{phase=\""
    return {k[len(prefix):-2]: v - before.get(k, 0.0)
            for k, v in after.items() if k.startswith(prefix)}


def hostsketch_device_path(torch, flows, smi: str) -> dict:
    """The host sketch step over pre-decoded 32768-row batches on the
    card, serial, for the fused pass, the staged engine and the fused
    pass on one thread (-ingest.threads 1), one run each: per batch the host
    prepare (lane building, flows_5m grouping; the staged engine's hh
    grouping too), the host sketch (the fused pass, or the staged
    engine's folds) and the device rest-step (dense scatters and the DDoS
    accumulate, synchronised) apart; then two applies of the fused pass
    under torch.profiler (launches per batch, idle share)."""
    from torch.profiler import ProfilerActivity, profile as tprof

    batches = [flows.slice(s, s + BATCH) for s in range(0, N_FLOWS, BATCH)]
    paths = ("hostsketch", "hostsketch-staged", "hostsketch-t1")
    for path in paths:
        _path_worker(batches[:1], path).run()  # warm-up
    out = {}
    for path in paths:
        pipe = _path_worker(batches, path).fused
        acc = {"host_sketch": 0.0, "rest_step": 0.0}

        def timed(fn, key, sync):
            def call(*a, **kw):
                t0 = time.perf_counter()
                res = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                acc[key] += (time.perf_counter() - t0) * 1e3
                return res
            return call

        if pipe._fused:
            pipe._run_fused = timed(pipe._run_fused, "host_sketch", False)
        else:
            pipe._engine.update = timed(pipe._engine.update, "host_sketch",
                                        False)
        pipe._apply_rest = timed(pipe._apply_rest, "rest_step", True)
        prep_ms, apply_ms = [], []
        for b in batches:
            t0 = time.perf_counter()
            prep = pipe.prepare(b)
            t1 = time.perf_counter()
            pipe.apply(prep)
            torch.cuda.synchronize()
            prep_ms.append((t1 - t0) * 1e3)
            apply_ms.append((time.perf_counter() - t1) * 1e3)
        rec = out.setdefault(path, dict(prepare_ms=[], apply_ms=[],
                                        host_sketch_ms=[], rest_step_ms=[],
                                        rest_steps=[]))
        rec["prepare_ms"].append(float(np.mean(prep_ms)))
        rec["apply_ms"].append(float(np.mean(apply_ms)))
        rec["host_sketch_ms"].append(acc["host_sketch"] / len(batches))
        rec["rest_step_ms"].append(acc["rest_step"] / len(batches))
        rec["rest_steps"].append(pipe.rest_steps)
    pipe = _path_worker(batches[:2], "hostsketch").fused
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
    (OUT / "profile_hostsketch.txt").write_text(
        avgs.table(sort_by=key, row_limit=30))
    out["profile"] = dict(launches_per_batch=launches, device_ms=dev_ms,
                          wall_ms=wall_ms, idle=1 - dev_ms / wall_ms,
                          rest_steps=pipe.rest_steps)
    for path in paths:
        r = out[path]
        log(f"device path {path}: per {BATCH}-row batch (synchronised, "
            f"{len(batches)} batches, one run): host prepare "
            + ", ".join(f"{v:.3f}" for v in r["prepare_ms"])
            + " ms; host sketch " + ", ".join(
                f"{v:.3f}" for v in r["host_sketch_ms"])
            + " ms; device rest-step " + ", ".join(
                f"{v:.3f}" for v in r["rest_step_ms"])
            + " ms; whole apply " + ", ".join(
                f"{v:.3f}" for v in r["apply_ms"]) + f" ms [{smi}]")
    p = out["profile"]
    log(f"device path hostsketch profile (2 applies): "
        f"{p['launches_per_batch']:.0f} kernel launches per batch "
        f"({p['rest_steps']} rest-steps), {dev_ms:.3f} ms of device time "
        f"in {wall_ms:.3f} ms wall: the card idle {100 * p['idle']:.1f} % "
        f"[{smi}]")
    return out


def hostsketch_phase(torch, frames, flows, windows, fused_card,
                     smi: str) -> dict:
    """Phase 13: -sketch.backend host, the fused pass and the staged
    engine, each on the card and the CPU."""
    runs = {}
    for path in ("hostsketch", "hostsketch-staged"):
        card, cpu = run_main_path(torch, frames, path, scrape=True,
                                  tag="hs-")
        runs[path] = {"cuda": card, "cpu": cpu}
    card = runs["hostsketch"]["cuda"]
    for path, by_dev in runs.items():
        for dev, run in by_dev.items():
            w = run["worker"]
            if any(run["launches"].values()) or w.chunk_updates:
                raise AssertionError(f"{path} ({dev}): CMS launches "
                                     f"{run['launches']}, chunk updates "
                                     f"{w.chunk_updates}; want none")
            if w.fused._fused != (path == "hostsketch"):
                raise AssertionError(f"{path} ({dev}): wrong ingest.fused")
            modes = {n: w.models[n].config.hh_sketch for n in FAMILIES}
            if modes != {n: "invertible" if n in INVERTIBLE else "table"
                         for n in FAMILIES}:
                raise AssertionError(f"{path} ({dev}): families {modes}")
            lines = run["scrape"]["/metrics"].splitlines()
            for feature in ("group", "sketch", "lanes", "fused",
                            "invsketch"):
                gauge = f'native_path_degraded{{feature="{feature}"}} 0'
                if gauge not in lines:
                    raise AssertionError(f"{path} ({dev}): /metrics lacks "
                                         f"{gauge!r}")
    groups = check_flows_5m(flows, card["rows"]["flows_5m"])
    compare_exact(card["rows"], fused_card["rows"], "host sketch/fused")
    talkers = check_oracle(flows, card["rows"], windows,
                           tables=("top_talkers",))
    inv = check_invertible(flows, card["rows"], windows)
    for path, by_dev in runs.items():
        _same_tables(by_dev["cuda"]["rows"], by_dev["cpu"]["rows"],
                     f"{path} card/CPU")
        _same_tables(by_dev["cuda"]["rows"], card["rows"],
                     f"{path}/hostsketch card")
    split = _phase_ns(card)
    if not split or not all(split.get(k, 0) > 0 for k in (
            "radix", "refine", "regroup", "fold", "cms", "topk", "inv")):
        raise AssertionError(f"host_fused phase counters: {split}")
    log(f"host sketch (-sketch.backend host; -hh.sketch auto: "
        f"{', '.join(INVERTIBLE)} invertible): fused pass and staged "
        f"engine, card and CPU: 0 CMS launches; flows_5m {groups} rows "
        f"equal the oracle; port tables and alerts equal the fused card "
        f"run's; top_talkers holds the exact top-20 and upper bounds in "
        f"{len(talkers)} windows; the invertible families report exact "
        f"sums in the exact ranking ("
        + ", ".join(f"{k} {v['rows']} rows, {v['top20_recovered']}/20 of "
                    f"the exact top-20" for k, v in inv.items())
        + "); all seven tables bit-equal between the fused pass and the "
        "staged engine and between the card and the CPU; "
        "native_path_degraded 0 for group, sketch, lanes, fused and "
        "invsketch")
    log("host_fused phase split (card run, ms): " + json.dumps(
        {k: round(v / 1e6, 3) for k, v in sorted(split.items())})
        + f" [{smi}]")
    # the fused path's turns are phase 9's
    e2e = {p: [] for p in ("hostsketch", "hostsketch-staged", "hostassist")}
    order = list(e2e)
    for p in order:
        (run,) = run_main_path(torch, frames, p, devices=("cuda",),
                               tag="hs-turns-")
        e2e[p].append(N_FLOWS / run["wall"])
    log("end to end, warm, in turns: " + "; ".join(
        f"{p} {', '.join(f'{r:.0f}' for r in v)} flows/s"
        for p, v in e2e.items()) + f" [{smi}]")
    dev = hostsketch_device_path(torch, flows, smi)
    return dict(wall_s={f"{p}/{d}": r["wall"] for p, by in runs.items()
                        for d, r in by.items()},
                launches=card["launches"], invertible=inv,
                top_talkers=talkers, flows_5m_rows=groups,
                phase_ns=split, flows_per_s_e2e_turns=e2e, device_path=dev)


# ---- phase 14 ---------------------------------------------------------------

# the host-grouped paths the sketch audit rides
AUDIT_PATHS = ("hostassist", "hostsketch", "hostsketch-staged")


@contextlib.contextmanager
def audit_reports():
    """Every close report the sketch audit evaluates while the block
    runs, as (family, report), in order."""
    from flow_pipeline_tpu_torch.obs import audit

    seen: list = []
    evaluate = audit.SketchAudit.evaluate

    def recording(self, name, slot, part, state):
        report = evaluate(self, name, slot, part, state)
        seen.append((name, report))
        return report

    audit.SketchAudit.evaluate = recording
    try:
        yield seen
    finally:
        audit.SketchAudit.evaluate = evaluate


def _delta(run, series: str) -> float:
    """This run's part of a process-total series (scraped runs)."""
    after = _samples(run["scrape"]["/metrics"])
    return after.get(series, 0.0) - run["before"].get(series, 0.0)


def _audit_run(torch, frames, path: str, mode: str, device: str = "cuda",
               tag: str = "") -> dict:
    """One processor run of ``path`` at -obs.audit ``mode``, with its
    close reports, its audit windows per family (from /metrics) and the
    sketch_audit and sketch_audit_close stage seconds."""
    with audit_reports() as seen:
        (run,) = run_main_path(torch, frames, path, devices=(device,),
                               extra=("-obs.audit", mode), scrape=True,
                               tag=f"audit-{mode}{tag}-")
    w = run["worker"]
    what = f"{path} -obs.audit {mode} ({device})"
    if (w.fused.audit is None) != (mode == "off"):
        raise AssertionError(f"{what}: audit {w.fused.audit!r}")
    closes = len(run["rows"]["top_talkers"])
    for fam in FAMILIES:
        got = _delta(run, f'sketch_audit_windows_total{{family="{fam}"}}')
        if got != (0 if mode == "off" else closes):
            raise AssertionError(f"{what}: sketch_audit_windows_total "
                                 f"{{family={fam}}} {got}, want "
                                 f"{closes} closes or 0 off")
    if len(seen) != (0 if mode == "off" else closes * len(FAMILIES)):
        raise AssertionError(f"{what}: {len(seen)} close reports")
    if path == "hostassist":
        _check_hostgroup_run(run)
    elif any(run["launches"].values()):
        raise AssertionError(f"{what}: CMS launches {run['launches']}")
    run.update(reports=seen, closes=closes, stage_s={
        st: _delta(run, f"flow_summary_{st}_time_us_sum") / 1e6
        for st in ("sketch_audit", "sketch_audit_close")})
    return run


def _audit_recall_oracle(flows, windows, run, k: int) -> dict:
    """At -obs.audit full: each window's top_talkers report against the
    exact oracle: the cohort is every key of the window, and recall at k
    is the share of the exact top-k (bytes descending, ties in key order,
    the audit's ranking) among the k emitted rows."""
    key_cols = FAMILIES["top_talkers"]
    reports = [r for n, r in run["reports"] if n == "top_talkers"]
    emitted = {int(rows["timeslot"][0]): rows
               for rows in run["rows"]["top_talkers"]}
    out = {}
    for report in reports:
        slot = report["slot"]
        ex = _exact_window(flows, windows[slot], key_cols)
        keys = _key_tuples(ex, key_cols)
        ranked = sorted(zip(keys, ex["bytes"].tolist()),
                        key=lambda kv: (-kv[1], kv[0]))
        truth = {kk for kk, _ in ranked[:min(k, len(ranked))]}
        rows = emitted[slot]
        valid = rows["valid"]
        got = set(_key_tuples({c: rows[c][valid] for c in key_cols},
                              key_cols)[:k])
        want = round(len(truth & got) / len(truth), 6)
        if report["sampled_keys"] != len(keys) or \
                report["recall_at_k"] != want:
            raise AssertionError(
                f"top_talkers@{slot} at -obs.audit full: cohort "
                f"{report['sampled_keys']} keys, recall "
                f"{report['recall_at_k']}; the oracle: {len(keys)} keys, "
                f"recall {want}")
        out[slot] = dict(keys=len(keys), recall_at_k=want,
                         false_drops=report["false_drops"])
    if sorted(out) != sorted(windows):
        raise AssertionError(f"full audit windows {sorted(out)}")
    return out


def audit_device_path(torch, flows, smi: str) -> dict:
    """Prepare and apply ms per 32768-row batch of the host-grouped and
    host sketch (fused pass) steps with the audit at sample and off, in
    turns (sample, off), serial and synchronised."""
    batches = [flows.slice(s, s + BATCH) for s in range(0, N_FLOWS, BATCH)]
    out = {}
    for path in ("hostassist", "hostsketch"):
        _path_worker(batches[:1], path).run()  # warm-up
        for mode in ("sample", "off"):
            pipe = _path_worker(batches, path,
                                extra=("-obs.audit", mode)).fused
            prep_ms, apply_ms = [], []
            for b in batches:
                t0 = time.perf_counter()
                prep = pipe.prepare(b)
                t1 = time.perf_counter()
                pipe.apply(prep)
                torch.cuda.synchronize()
                prep_ms.append((t1 - t0) * 1e3)
                apply_ms.append((time.perf_counter() - t1) * 1e3)
            rec = out.setdefault(f"{path}/{mode}",
                                 dict(prepare_ms=[], apply_ms=[]))
            rec["prepare_ms"].append(float(np.mean(prep_ms)))
            rec["apply_ms"].append(float(np.mean(apply_ms)))
    for key, r in out.items():
        log(f"device path {key}: prepare "
            + ", ".join(f"{v:.3f}" for v in r["prepare_ms"])
            + " ms + apply " + ", ".join(f"{v:.3f}" for v in r["apply_ms"])
            + f" ms per {BATCH}-row batch (in turns) [{smi}]")
    return out


def audit_phase(torch, frames, flows, windows, smi: str) -> dict:
    """Phase 14: the sketch audit at its default (-obs.audit sample) and
    off, in turns, on the host-grouped path and the host sketch backend
    (fused pass and staged engine); once at full."""
    runs: dict = {}
    rates = {f"{p}/{m}": [] for p in AUDIT_PATHS for m in ("sample", "off")}
    stages = {p: [] for p in AUDIT_PATHS}
    for path in AUDIT_PATHS:
        for mode in ("sample", "off"):
            key = f"{path}/{mode}"
            run = _audit_run(torch, frames, path, mode,
                             tag=str(len(rates[key])))
            rates[key].append(N_FLOWS / run["wall"])
            if mode == "sample":
                stages[path].append(run["stage_s"])
            runs.setdefault(key, run)
        on, off = runs[f"{path}/sample"], runs[f"{path}/off"]
        _same_tables(on["rows"], off["rows"], f"{path} audit on/off")
    # the reports: card == CPU (every number of a report comes from the
    # count plane, exact in the envelope, or from the exact cohort); the
    # fused pass's == the staged engine's (equal engine states)
    cpu = {p: _audit_run(torch, frames, p, "sample", device="cpu")
           for p in ("hostassist", "hostsketch")}
    for path, run in cpu.items():
        if run["reports"] != runs[f"{path}/sample"]["reports"]:
            raise AssertionError(f"{path}: audit reports card != CPU")
    if runs["hostsketch-staged/sample"]["reports"] != \
            runs["hostsketch/sample"]["reports"]:
        raise AssertionError("audit reports: staged engine != fused pass")
    full = _audit_run(torch, frames, "hostassist", "full")
    _same_tables(full["rows"], runs["hostassist/off"]["rows"],
                 "hostassist audit full/off")
    recall = _audit_recall_oracle(flows, windows, full, k=100)
    dev = audit_device_path(torch, flows, smi)
    sample = runs["hostassist/sample"]["reports"]
    log(f"sketch audit (-obs.audit sample, the default): on the "
        f"host-grouped path, the host sketch fused pass and the staged "
        f"engine, all seven tables bit-equal with the audit on, off and "
        f"(host-grouped) full; sketch_audit_windows_total = "
        f"{runs['hostassist/sample']['closes']} closes x "
        f"{len(FAMILIES)} families per run; the card's "
        f"{len(sample)} close reports equal the CPU's (host-grouped, host "
        f"sketch), the fused pass's equal the staged engine's; at full "
        f"the top_talkers recall at 100 equals the exact oracle's in "
        f"{len(recall)} windows "
        + json.dumps({str(s): v["recall_at_k"] for s, v in recall.items()})
        + "; sampled cohorts per close: "
        + ", ".join(f"{n} {r['sampled_keys']}" for n, r in sample[:3]))
    log("end to end, warm, in turns (audit sample / off): " + "; ".join(
        f"{k} {', '.join(f'{r:.0f}' for r in v)} flows/s"
        for k, v in rates.items()) + f" [{smi}]")
    log("audit stage seconds per run (sketch_audit, sketch_audit_close): "
        + "; ".join(f"{p} " + ", ".join(
            f"{s['sketch_audit']:.4f}/{s['sketch_audit_close']:.4f}"
            for s in v) for p, v in stages.items()) + f" [{smi}]")
    return dict(flows_per_s_e2e_turns=rates, stage_s=stages,
                closes=runs["hostassist/sample"]["closes"],
                full_recall=recall, device_path=dev,
                reports={n: r for n, r in sample})


# ---- phase 15 ---------------------------------------------------------------

PIPE_FLOWS = 1 << 19
PIPE_RATE = 2000.0
PIPE_GEN = ["-produce.count", str(PIPE_FLOWS), "-produce.profile", "zipf",
            "-produce.rate", str(PIPE_RATE), "-produce.seed", str(SEED)]


def _get_json(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _query_live(worker, services, gate, paused, out: dict) -> None:
    """While the run is live, the worker held between two steps (``gate``
    cleared; ``paused`` set by the worker's loop once it waits there), so
    every read below sees one state: a snapshot is published at the held
    point; the query API's /healthz, /topk, /windows and /alerts answer
    200 and its /topk (now off that fresh snapshot, without the lock) and
    the serving tier's /query/topk equal the model's own top(); every
    /query/estimate of the top keys equals np_cms_query_u64 over a host
    copy of the card's CMS planes."""
    from flow_pipeline_tpu_torch.hostsketch.engine import np_cms_query_u64
    from flow_pipeline_tpu_torch.hostsketch.state import frozen_cms
    from flow_pipeline_tpu_torch.sink.base import rows_to_records

    port, sport = services["query"].port, services["serve"].port
    try:
        deadline = time.monotonic() + 600
        while worker.flows_seen == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.clear()
        if not paused.wait(120):
            raise AssertionError("the run ended before the worker paused")
        model = worker.models["top_talkers"]
        with worker.lock:
            snap = services["publisher"].publish(worker)
            top = model.model.top(10)
            direct = {"model": "top_talkers",
                      "window_start": model.current_slot,
                      "rows": rows_to_records(top)}
            planes = frozen_cms(model.model.state.cms)  # card -> host
            seen = worker.flows_seen
        out["statuses"] = {}
        answers = {}
        for path in ("/healthz", "/topk?model=top_talkers&k=10",
                     "/windows", "/alerts"):
            out["statuses"][path], answers[path] = _get_json(port, path)
        topk = answers["/topk?model=top_talkers&k=10"]
        direct = json.loads(json.dumps(direct, default=str))
        if answers["/healthz"]["flows_seen"] != seen or topk != direct:
            raise AssertionError(f"/topk differs from the model's top() "
                                 f"at {seen} flows")
        if not topk["rows"] or not answers["/windows"]["open_windows"]:
            raise AssertionError(f"no open window at {seen} flows")
        code, served = _get_json(sport, "/query/topk?model=top_talkers&k=10")
        out["statuses"]["/query/topk"] = code
        if snap.flows_seen != seen or served["rows"] != direct["rows"] or \
                served["window_start"] != direct["window_start"]:
            raise AssertionError(f"/query/topk differs from the model's "
                                 f"top() at {seen} flows")
        lanes = np.concatenate([np.asarray(top[c]).reshape(len(top["valid"]),
                                                           -1)
                                for c in FAMILIES["top_talkers"]], axis=1)
        lanes = lanes[top["valid"]].astype(np.uint32)
        want = np_cms_query_u64(planes, lanes)
        for i, key in enumerate(lanes):
            path = ("/query/estimate?model=top_talkers&key="
                    + ",".join(str(int(x)) for x in key))
            code, est = _get_json(sport, path)
            out["statuses"]["/query/estimate"] = code
            if list(est["estimates"].values()) != [int(x) for x in want[i]]:
                raise AssertionError(f"/query/estimate of row {i} differs "
                                     f"from the card's planes: {est}")
        out.update(topk_equal=True, at_flows=seen, rows=len(topk["rows"]),
                   open_windows=len(answers["/windows"]["open_windows"]),
                   estimates_equal=len(lanes), snapshot_version=snap.version)
    except BaseException as e:  # noqa: BLE001 -- reported by the phase
        out["error"] = repr(e)
    finally:
        gate.set()


READ_LOAD_S = 3.0  # seconds of closed-loop reader load during the run


def _readers(services, stop, out: dict) -> None:
    """serve/loadgen.py against the live serving tier: once the first
    snapshot is up, the snapshot-age sampler runs until ``stop``, and
    run_load's 8 closed-loop reader threads run for READ_LOAD_S seconds
    in a reader process of their own (run_load_procs), so the clients
    do not share the worker's interpreter lock."""
    from flow_pipeline_tpu_torch.serve import loadgen

    port = services["serve"].port
    try:
        if not loadgen.wait_ready("127.0.0.1", port, timeout=600):
            raise AssertionError("no snapshot within 600 s")
        sampler, ages = loadgen.sample_ages("127.0.0.1", port, stop)
        # the load starts once a window closed, so /query/range has rows
        # to serve (it answers 400 before)
        while not stop.is_set() and not _get_json(
                port, "/query/version")[1]["ranges"].get("flows_5m"):
            stop.wait(0.05)
        out["load"] = loadgen.run_load_procs("127.0.0.1", port, procs=1,
                                             threads=8, duration=READ_LOAD_S)
        stop.wait()
        sampler.join(timeout=30)
        out["ages"] = ages
    except BaseException as e:  # noqa: BLE001 -- reported by the phase
        out["error"] = repr(e)


def _serve_after_run(publisher, port: int, capture) -> dict:
    """At the end of the run, before the servers stop: /query/range
    equals the rows the sinks were given, slot for slot, and a
    /sub/snapshot?since=0 full frame rebuilds (state_to_snapshot) the
    served snapshot's rows and planes."""
    import urllib.request

    from flow_pipeline_tpu_torch.gateway import delta
    from flow_pipeline_tpu_torch.sink.base import rows_to_records

    _, doc = _get_json(port, "/query/range?model=flows_5m")
    given: dict = {}
    for rows in capture.tables["flows_5m"]:
        for slot in np.unique(rows["timeslot"]):
            idx = np.flatnonzero(rows["timeslot"] == slot)
            given.setdefault(int(slot), []).append(
                {k: v[idx] for k, v in rows.items()})
    want = [r for slot in doc["slots"] for chunk in given[slot]
            for r in rows_to_records(chunk)]
    if doc["slots"] != sorted(given) or \
            doc["rows"] != json.loads(json.dumps(want, default=str)):
        raise AssertionError("/query/range differs from the sinks' "
                             "flows_5m rows")
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/sub/snapshot?since=0",
            timeout=120) as resp:
        frame = resp.read()
    (tree,) = list(delta.decode_frames(frame))
    rebuilt = delta.state_to_snapshot(tree["state"])
    snap = publisher.store.current
    if tree["t"] != "full" or rebuilt.version != snap.version:
        raise AssertionError(f"/sub/snapshot: {tree['t']} frame at "
                             f"v{rebuilt.version}, serving v{snap.version}")
    for name, fam in snap.families.items():
        got = rebuilt.families[name]
        same = all(np.array_equal(got.rows[c], v) for c, v in
                   fam.rows.items()) and (fam.cms is None or np.array_equal(
                       got.cms.get(), fam.cms.get()))
        if not same:
            raise AssertionError(f"/sub/snapshot: {name} does not rebuild")
    return dict(range_slots=len(doc["slots"]), range_rows=len(doc["rows"]),
                feed_frame_bytes=len(frame))


def _pipeline_run(torch, flags, sinks=(), on_start=None, on_finish=None):
    """One ``pipeline`` at CLI defaults on the card; the CMS launch
    counts are zeroed just before it and read just after. Returns the
    worker, the launches and the generation and run seconds."""
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.ops import cms_cuda

    started: dict = {}

    def start(worker, services):
        started["t"] = time.perf_counter()
        if on_start is not None:
            on_start(worker, services)

    for name in cms_cuda.LAUNCHES:
        cms_cuda.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    worker = cli.run_pipeline(
        ["-device", "cuda", *PIPE_GEN, "-bus.partitions", "2",
         "-processor.batch", str(BATCH), "-sketch.width", str(WIDTH),
         "-loglevel", "warning", *flags], sinks=sinks, on_start=start,
        on_finish=on_finish)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    return worker, dict(cms_cuda.LAUNCHES), started["t"] - t0, \
        t1 - started["t"]


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if len(values) else float("nan")


def pipeline_phase(torch, smi: str) -> dict:
    """Phase 15: the pipeline entry at CLI defaults on the card (the
    fused step) with the serving tier and the live query API, readers
    on both while it runs; against processor -in over the frames the
    mocker writes with the same -produce.* flags; then pipeline with
    and without -serve.addr, in turns."""
    import threading

    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine import FusedPipeline
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    capture = Capture()
    live: dict = {}
    load: dict = {}
    after: dict = {}
    threads: dict = {}
    held: dict = {}
    gate, paused, stop = threading.Event(), threading.Event(), \
        threading.Event()
    gate.set()

    def on_start(worker, services):
        step = worker.run_once

        def gated_step():
            # the query thread holds the worker here, between two steps
            if not gate.is_set():
                paused.set()
                gate.wait()
            return step()

        worker.run_once = gated_step
        held["services"] = services
        threads["query"] = threading.Thread(
            target=_query_live, args=(worker, services, gate, paused, live),
            name="smoke-query", daemon=True)
        threads["load"] = threading.Thread(
            target=_readers, args=(services, stop, load),
            name="smoke-readers", daemon=True)
        for t in threads.values():
            t.start()

    def on_finish(worker, metrics):
        stop.set()
        threads["load"].join(timeout=300)
        services = held["services"]
        try:
            after.update(_serve_after_run(services["publisher"],
                                          services["serve"].port, capture))
        except BaseException as e:  # noqa: BLE001 -- reported below
            after["error"] = repr(e)
        after["responses"] = {
            code: services["publisher"].store.m_responses.value(code=code)
            for code in ("200", "304", "400", "404", "500", "503")}

    worker, launches, gen_s, run_s = _pipeline_run(
        torch, ["-sink", f"sqlite:{WORK / 'pipeline.db'}", "-query.addr",
                "127.0.0.1:0", "-serve.addr", "127.0.0.1:0",
                "-metrics.addr", "127.0.0.1:0"],
        sinks=[capture], on_start=on_start, on_finish=on_finish)
    threads["query"].join(timeout=120)
    if live.get("error") or not live.get("topk_equal"):
        raise AssertionError(f"pipeline -query.addr -serve.addr: {live}")
    if any(code != 200 for code in live["statuses"].values()):
        raise AssertionError(f"pipeline queries: {live['statuses']}")
    for what in (load, after):
        if what.get("error"):
            raise AssertionError(f"pipeline -serve.addr: {what['error']}")
    codes = load["load"]["codes"]
    # the server's only 503s may be the readiness polls before the first
    # publish (no snapshot yet); the readers start after it
    if any(c != "200" for c in codes) or after["responses"]["500"] or \
            load["load"]["errors"] or not load["load"]["requests"]:
        raise AssertionError(f"serving tier under load: codes {codes}, "
                             f"responses {after['responses']}, transport "
                             f"errors {load['load']['errors']}")
    if type(worker.fused) is not FusedPipeline or \
            worker.flows_seen != PIPE_FLOWS:
        raise AssertionError(f"pipeline: {type(worker.fused).__name__}, "
                             f"{worker.flows_seen} flows")
    want = {k: 0 for k in launches}
    want["cms_add_conservative"] = worker.chunk_updates
    if launches != want or not worker.chunk_updates:
        raise AssertionError(f"pipeline: launches {launches}, chunk "
                             f"updates {worker.chunk_updates}")
    pub = worker.serve
    if pub.store.current.flows_seen != PIPE_FLOWS:
        raise AssertionError("the end-of-stream snapshot does not cover "
                             "the run")
    gen = FlowGenerator(ZipfProfile(), seed=SEED, rate=PIPE_RATE)
    tg = time.perf_counter()
    batches = [gen.batch(8192) for _ in range(PIPE_FLOWS // 8192)]
    draw_s = time.perf_counter() - tg
    te = time.perf_counter()
    encoded = sum(len(b.to_wire()) for b in batches)
    encode_s = time.perf_counter() - te
    flows = FlowBatch.concat(batches)
    groups = check_flows_5m(flows, capture.tables["flows_5m"])
    frames = WORK / "pipeline-frames.bin"
    tm = time.perf_counter()
    # the pipeline draws the generator in batches of 8192
    assert cli.main(["mocker", "-out", str(frames), *PIPE_GEN,
                     "-produce.batch", "8192"]) == 0
    mocker_s = time.perf_counter() - tm
    (proc,) = run_main_path(torch, frames, "fused", devices=("cuda",),
                            tag="pipe-")
    compare_exact(capture.tables, proc["rows"], "pipeline/processor -in")
    compare_hh(capture.tables, proc["rows"], "pipeline/processor -in")
    # -serve.addr's cost: the same pipeline with it and without it, no
    # readers (the publisher's work on the worker thread); the pairs
    # that resolve it are tools/serve_cost.py's
    turns = {"serve": [], "plain": []}
    turn_launches = {}
    turn_publishes = []
    for tag in ("serve", "plain"):
        flags = ["-sink", f"sqlite:{WORK / f'pipe-{tag}.db'}",
                 "-metrics.addr", ""]
        if tag == "serve":
            flags += ["-serve.addr", "127.0.0.1:0"]
        w, n, _, secs = _pipeline_run(torch, flags)
        turns[tag].append(PIPE_FLOWS / secs)
        turn_launches[tag] = n["cms_add_conservative"]
        if n["cms_add_conservative"] != w.chunk_updates:
            raise AssertionError(f"pipeline ({tag}): launches {n}, chunk "
                                 f"updates {w.chunk_updates}")
        if tag == "serve":
            turn_publishes.append(w.serve.publishes)
    ages = load["ages"]
    per_publish_ms = 1e3 * pub.publish_seconds / pub.publishes
    capture_ms = 1e3 * pub.capture_seconds / pub.publishes
    serve = dict(
        publishes=pub.publishes, publish_ms=per_publish_ms,
        capture_ms=capture_ms, rest_ms=per_publish_ms - capture_ms,
        readers=load["load"], age_p50_s=_pct(ages, 50),
        age_p99_s=_pct(ages, 99), age_samples=len(ages),
        final_version=pub.store.current.version, **after)
    out = dict(flows=PIPE_FLOWS, generation_s=gen_s, run_s=run_s,
               flows_per_s=PIPE_FLOWS / run_s,
               flows_per_s_with_generation=PIPE_FLOWS / (gen_s + run_s),
               draw_s=draw_s, encode_s=encode_s, encoded_bytes=encoded,
               processor_in_flows_per_s=PIPE_FLOWS / proc["wall"],
               launches=launches["cms_add_conservative"],
               serve_launches=launches["cms_add_conservative"],
               plain_launches=turn_launches["plain"],
               chunk_updates=worker.chunk_updates, flows_5m_rows=groups,
               windows=len(capture.tables["top_talkers"]),
               query={k: v for k, v in live.items() if k != "statuses"},
               serve=serve, flows_per_s_turns=turns,
               turn_publishes=turn_publishes, mocker_s=mocker_s,
               tables=capture.tables)
    log(f"pipeline (CLI defaults on the card: {PIPE_FLOWS} zipf flows at "
        f"{PIPE_RATE:.0f} flows/s, 2 partitions, the fused step, "
        f"-query.addr and -serve.addr): {out['windows']} windows; "
        f"flows_5m {groups} rows equal the oracle; all seven tables equal "
        f"processor -in over the mocker's frames (heavy-hitter values "
        f"within rtol 1e-6); {launches['cms_add_conservative']} "
        f"conservative launches = chunk updates; with the worker held at "
        f"{live['at_flows']} flows a snapshot published there: /topk (off "
        f"the snapshot) and /query/topk equal the model's top() "
        f"({live['rows']} rows), {live['estimates_equal']} "
        f"/query/estimate answers equal np_cms_query_u64 over a host copy "
        f"of the card's planes; /query/range equals the sinks' flows_5m "
        f"rows ({after['range_slots']} slots, {after['range_rows']} rows); "
        f"the /sub/snapshot full frame ({after['feed_frame_bytes']} B) "
        f"rebuilds the served snapshot; {load['load']['requests']} reader "
        f"requests all answered 200, no 500 [{smi}]")
    log(f"serving tier: {pub.publishes} publishes, {per_publish_ms:.3f} ms "
        f"per publish ({capture_ms:.3f} ms card-to-host capture, "
        f"{per_publish_ms - capture_ms:.3f} ms the rest); 8 readers for "
        f"{load['load']['duration_s']:.1f} s "
        f"{load['load']['qps']:.0f} queries/s, p50 "
        f"{load['load']['p50_ms']:.3f} ms, p99 {load['load']['p99_ms']:.3f} "
        f"ms; snapshot age p50 {serve['age_p50_s']:.3f} s, p99 "
        f"{serve['age_p99_s']:.3f} s ({len(ages)} samples) [{smi}]")
    log(f"pipeline end to end {out['flows_per_s']:.0f} flows/s after "
        f"generation with the readers "
        f"({out['flows_per_s_with_generation']:.0f} with it; generation "
        f"{gen_s:.2f} s: draw {draw_s:.2f} s, "
        f"native encode {encode_s:.2f} s); processor -in "
        f"{out['processor_in_flows_per_s']:.0f} flows/s; in turns without "
        f"readers: " + "; ".join(f"{t} {', '.join(f'{r:.0f}' for r in v)}"
                                 for t, v in turns.items())
        + f" flows/s [{smi}]")
    return out


# ---- phase 16 ---------------------------------------------------------------

def feed_phase(torch, frames, fused_card, smi: str) -> dict:
    """processor -listen.feed on the card, fed the phase-4 frames by
    FeedClient in 8 publishes before its first poll: the -in run's
    rows."""
    import threading

    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.ops import cms_cuda
    from flow_pipeline_tpu_torch.schema import wire
    from flow_pipeline_tpu_torch.transport.feed import FeedClient

    raw = list(wire.iter_raw_frames(frames.read_bytes()))
    per = -(-len(raw) // 8)
    pub: dict = {"accepted": 0, "bytes": []}

    def on_start(worker, services):
        client = FeedClient(f"127.0.0.1:{services['feed'].port}")
        try:
            t0 = time.perf_counter()
            for i in range(8):
                blob = b"".join(raw[i * per:(i + 1) * per])
                pub["bytes"].append(len(blob))
                pub["accepted"] += client.publish_frames(blob)
            pub["publish_s"] = time.perf_counter() - t0
        finally:
            client.close()

        def stop_when_done():
            deadline = time.monotonic() + 600
            while worker.flows_seen < len(raw) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            worker.request_stop()

        threading.Thread(target=stop_when_done, name="smoke-feed-stop",
                         daemon=True).start()

    capture = Capture()
    for name in cms_cuda.LAUNCHES:
        cms_cuda.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    worker = cli.run_processor(
        ["-device", "cuda", "-listen.feed", "127.0.0.1:0", "-sink",
         f"sqlite:{WORK / 'feed.db'}", "-loglevel", "warning",
         "-processor.batch", str(BATCH), "-sketch.width", str(WIDTH),
         "-metrics.addr", "127.0.0.1:0", *PATHS["fused"]],
        sinks=[capture], on_start=on_start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cms_cuda.LAUNCHES)
    if pub["accepted"] != len(raw) or worker.flows_seen != len(raw):
        raise AssertionError(f"feed: {pub['accepted']} accepted, "
                             f"{worker.flows_seen} processed, want "
                             f"{len(raw)}")
    if launches["cms_add_conservative"] != worker.chunk_updates:
        raise AssertionError(f"feed: launches {launches} != chunk updates "
                             f"{worker.chunk_updates}")
    compare_exact(capture.tables, fused_card["rows"], "-listen.feed/-in")
    compare_hh(capture.tables, fused_card["rows"], "-listen.feed/-in")
    log(f"processor -listen.feed (card): {len(raw)} frames in 8 "
        f"publishes ({max(pub['bytes'])} B at most, "
        f"{pub['publish_s']:.2f} s); rows equal the -in run's (flows_5m, "
        f"port tables, alerts identical; heavy-hitter values within rtol "
        f"1e-6); {launches['cms_add_conservative']} conservative launches "
        f"= chunk updates; {len(raw) / wall:.0f} flows/s with the "
        f"publishes [{smi}]")
    return dict(frames=len(raw), publish_bytes=pub["bytes"],
                publish_s=pub["publish_s"], wall_s=wall,
                launches=launches["cms_add_conservative"])


COLLECT_DATAGRAMS = 3000  # a third each of NetFlow v9, IPFIX and sFlow


def _datagrams(rng) -> list[tuple[str, bytes]]:
    """Seeded NetFlow v9 and IPFIX datagrams (each template first, then
    data sets of 24 records) and sFlow v5 datagrams (8 flow samples of
    Ethernet/IPv4/TCP-or-UDP headers), interleaved."""
    import struct

    now = int(time.time())
    v9_fields = [(8, 4), (12, 4), (1, 4), (2, 4), (4, 1), (7, 2), (11, 2),
                 (16, 2), (17, 2)]
    ipfix_fields = [(8, 4), (12, 4), (1, 4), (2, 4), (4, 1), (7, 2),
                    (11, 2), (150, 4), (151, 4)]

    def tmpl(tid, fields, set_id):
        body = struct.pack(">HH", tid, len(fields)) + b"".join(
            struct.pack(">HH", t, n) for t, n in fields)
        return struct.pack(">HH", set_id, 4 + len(body)) + body

    def addrs(n):
        return rng.integers(0, 1 << 32, size=(n, 2), dtype=np.uint64)

    def v9(seq, with_template):
        a = addrs(24)
        recs = b"".join(
            struct.pack(">IIIIBHHHH", int(a[i, 0]), int(a[i, 1]),
                        int(rng.integers(40, 1 << 20)),
                        int(rng.integers(1, 1000)),
                        int(rng.choice([6, 17])),
                        int(rng.integers(1, 65536)),
                        int(rng.integers(1, 1024)),
                        int(rng.integers(64512, 64520)),
                        int(rng.integers(64512, 64520)))
            for i in range(24))
        sets = (tmpl(256, v9_fields, 0) if with_template else b"") + \
            struct.pack(">HH", 256, 4 + len(recs)) + recs
        count = 24 + (1 if with_template else 0)
        return struct.pack(">HHIIII", 9, count, 3_600_000, now, seq, 1) + \
            sets

    def ipfix(seq, with_template):
        a = addrs(24)
        recs = b"".join(
            struct.pack(">IIIIBHHII", int(a[i, 0]), int(a[i, 1]),
                        int(rng.integers(40, 1 << 20)),
                        int(rng.integers(1, 1000)),
                        int(rng.choice([6, 17])),
                        int(rng.integers(1, 65536)),
                        int(rng.integers(1, 1024)), now - 10, now - 1)
            for i in range(24))
        sets = (tmpl(300, ipfix_fields, 2) if with_template else b"") + \
            struct.pack(">HH", 300, 4 + len(recs)) + recs
        return struct.pack(">HHIII", 10, 16 + len(sets), now, seq, 5) + sets

    def sflow(seq):
        samples = b""
        for i in range(8):
            a = addrs(1)[0]
            proto = int(rng.choice([6, 17]))
            eth = bytes(12) + struct.pack(">H", 0x0800)
            ip = bytes([0x45, 0]) + struct.pack(
                ">H", int(rng.integers(64, 1500))) + bytes(4) + \
                bytes([64, proto]) + bytes(2) + \
                struct.pack(">II", int(a[0]), int(a[1]))
            l4 = struct.pack(">HH", int(rng.integers(1, 65536)),
                             int(rng.integers(1, 1024))) + bytes(16)
            pkt = eth + ip + l4
            raw = struct.pack(">IIII", 1, len(pkt) + 4, 4, len(pkt)) + pkt
            rec = struct.pack(">II", 1, len(raw)) + raw
            body = struct.pack(">IIIIIIII", seq * 8 + i, 1, 512, 1000, 0, 5,
                               6, 1) + rec
            samples += struct.pack(">II", 1, len(body)) + body
        return struct.pack(">II", 5, 1) + bytes([192, 0, 2, 1]) + \
            struct.pack(">IIII", 0, seq, 123456, 8) + samples

    out = []
    for j in range(COLLECT_DATAGRAMS // 3):
        out.append(("netflow", v9(j + 1, j == 0)))
        out.append(("netflow", ipfix(j + 1, j == 0)))
        out.append(("sflow", sflow(j + 1)))
    return out


def collector_phase(torch, smi: str) -> dict:
    """collector -out F on loopback, sent NetFlow v9, IPFIX and sFlow v5
    datagrams (templates first), then processor -in F on the card:
    flows_5m equals the oracle over the collected records, which equal
    the datagrams' records as the port's decoders read them."""
    import socket

    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.collector import (TemplateCache,
                                                   decode_netflow,
                                                   decode_sflow)
    from flow_pipeline_tpu_torch.obs import REGISTRY
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    datagrams = _datagrams(np.random.default_rng(SEED))
    cache = TemplateCache()
    sent = []
    for kind, data in datagrams:
        sent += (decode_netflow(data, cache, "127.0.0.1:1", now=0)
                 if kind == "netflow" else decode_sflow(data))
    out = WORK / "collected.bin"
    stats: dict = {}
    packets = REGISTRY.counter("udp_traffic_packets")

    def on_start(collector):
        base = packets.value()
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        t0 = time.perf_counter()
        try:
            for i, (kind, data) in enumerate(datagrams):
                sock.sendto(data, ("127.0.0.1", collector.ports[kind]))
                # keep within the receive buffers: loopback drops nothing
                # a listener keeps up with
                while i - (packets.value() - base) > 128:
                    time.sleep(0.0005)
            deadline = time.monotonic() + 60
            while packets.value() - base < len(datagrams) and \
                    time.monotonic() < deadline:
                time.sleep(0.001)
            stats["seconds"] = time.perf_counter() - t0
        finally:
            sock.close()
        stats["received"] = int(packets.value() - base)

    rc = cli.run_collector(["-out", str(out), "-listen.netflow",
                            "127.0.0.1:0", "-listen.sflow", "127.0.0.1:0",
                            "-metrics.addr", "", "-loglevel", "warning"],
                           on_start=on_start)
    if rc != 0 or stats["received"] != len(datagrams):
        raise AssertionError(f"collector: rc {rc}, {stats['received']} of "
                             f"{len(datagrams)} datagrams received")
    batch = FlowBatch.from_wire(out.read_bytes())

    def records(cols, n):
        return sorted(zip(*(np.asarray(cols[c]).reshape(n, -1).tolist()
                            for c in ("src_addr", "dst_addr", "src_port",
                                      "dst_port", "proto", "bytes",
                                      "packets", "src_as", "dst_as",
                                      "sampling_rate"))))

    want = FlowBatch.from_messages(sent)
    if len(batch) != len(sent) or \
            records(batch.columns, len(batch)) != records(want.columns,
                                                          len(want)):
        raise AssertionError(f"collector: {len(batch)} records written, "
                             f"want the {len(sent)} sent")
    capture = Capture()
    worker = cli.run_processor(
        ["-device", "cuda", "-in", str(out), "-sink",
         f"sqlite:{WORK / 'collected.db'}", "-metrics.addr", "",
         "-processor.batch", str(BATCH), "-loglevel", "warning"],
        sinks=[capture])
    if worker.flows_seen != len(sent):
        raise AssertionError(f"collector frames: {worker.flows_seen} "
                             "flows processed")
    groups = check_flows_5m(batch, capture.tables["flows_5m"])
    rate = len(datagrams) / stats["seconds"]
    log(f"collector -out (loopback): {len(datagrams)} datagrams (NetFlow "
        f"v9, IPFIX, sFlow v5; templates first) -> {len(sent)} records, "
        f"equal to the datagrams' records; {rate:.0f} datagrams decoded "
        f"per second (host); processor -in on the card: flows_5m {groups} "
        f"rows equal the oracle [{smi}]")
    return dict(datagrams=len(datagrams), records=len(sent),
                datagrams_per_s=rate, flows_5m_rows=groups)


# ---- phase 17 ---------------------------------------------------------------

GUARD_BUDGET = 1.0  # -guard.lag seconds: the hysteresis band is [0.5, 1.0]
GUARD_LEVEL = 3  # the forced level: admission at keep rate 1/4
MIRROR_POLL = 0.05  # the gateway's and the history tier's poll, seconds
# a -serve.feed_bytes budget of a few deltas (a delta of three [3, 4,
# 65,536] CMS families is a few MB when about a tenth of each row's
# columns changed), so an archived version falls out of the worker's
# delta chain while the run goes on; whether it did is recorded
FEED_BYTES = 4 << 20
TIER_QUERIES = ("/query/topk", "/query/topk?model=top_src_ips&k=20",
                "/query/topk?model=top_dst_ports&k=7", "/query/range",
                "/query/audit", "/query/topk?model=ghost")


def force_level(guard, level: int) -> None:
    """Step a guard's ladder to ``level`` with explicit clocks, then hold
    it: every later observe is fed a lag inside the hysteresis band, so
    wall time and the stream's real lag never move it."""
    for i in range(level):
        if guard.observe(10.0, now=10.0 * (i + 1)) != i + 1:
            raise AssertionError(f"guard did not step to level {i + 1}")
    observe = guard.observe
    guard.observe = lambda lag, now=None: observe(0.75 * GUARD_BUDGET, now)


def _http(port: int, path: str) -> tuple[int, bytes]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _wait_version(store, version: int, what: str, timeout=120.0) -> None:
    deadline = time.monotonic() + timeout
    while store.current is None or store.current.version < version:
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} did not reach v{version}")
        time.sleep(0.01)


def _tier_queries(snap) -> list[str]:
    """TIER_QUERIES and an estimate of the top talker of ``snap``."""
    fam = snap.families["top_talkers"]
    out = list(TIER_QUERIES)
    if fam.rows["valid"].any():
        lanes = [int(x) for col in FAMILIES["top_talkers"]
                 for x in np.atleast_1d(fam.rows[col][0])]
        out.append("/query/estimate?key=" + ",".join(map(str, lanes)))
    return out


def _same_bodies(ports: dict, queries, version: int) -> dict:
    """Each query's (status, body) from every tier ("worker" first),
    byte-equal. A tier with an archive extends the live /query/range with
    archived slots (``archived_slots``): there the live answer must equal
    the worker's but that key, which must be empty (the worker's snapshot
    still holds every slot), and the same query at ``?version=`` (the
    unchanged handler over the archived snapshot) byte-equal."""
    bodies = {}
    for q in queries:
        answers = {name: _http(port, q) for name, port in ports.items()}
        want = answers.pop("worker")
        if q.startswith("/query/range"):
            sep = "&" if "?" in q else "?"
            extra = {name: _http(port, f"{q}{sep}version={version}")
                     for name, port in ports.items() if name != "worker"}
            for name, (code, body) in answers.items():
                doc = json.loads(body)
                if code != want[0] or doc.pop("archived_slots", []) or \
                        doc != json.loads(want[1]):
                    extra[name + " (live)"] = (code, body)
            answers = {k: v for k, v in extra.items() if v != want}
        if any(a != want for a in answers.values()):
            OUT.mkdir(parents=True, exist_ok=True)
            for name, (_, body) in {"worker": want, **answers}.items():
                (OUT / f"tiers-{name}.json").write_bytes(body)
            raise AssertionError(
                f"{q}: the tiers answer differently: worker "
                f"{(want[0], len(want[1]))}, "
                f"{ {k: (a[0], len(a[1])) for k, a in answers.items()} } "
                f"(bodies in {OUT})")
        bodies[q] = want
    return bodies


def _states_equal(a: dict, b: dict, what: str) -> None:
    """Two canonical snapshot states (gateway.delta.snapshot_state) hold
    equal metadata and arrays of equal dtype, shape and words."""
    def meta(x):
        return {k: v for k, v in x.items() if k not in ("families", "ranges")}

    if meta(a) != meta(b) or list(a["families"]) != list(b["families"]) \
            or list(a["ranges"]) != list(b["ranges"]):
        raise AssertionError(f"{what}: metadata differs")
    arrays = []
    for name, fa in a["families"].items():
        fb = b["families"][name]
        if list(fa["rows"]) != list(fb["rows"]):
            raise AssertionError(f"{what}: {name} columns differ")
        arrays += [(fa["rows"][c], fb["rows"][c], f"{name}.{c}")
                   for c in fa["rows"]]
        arrays += [(fa[p], fb[p], f"{name}.{p}") for p in ("cms", "regs")]
    for table, slots in a["ranges"].items():
        other = b["ranges"][table]
        if [int(s) for s, _ in slots] != [int(s) for s, _ in other]:
            raise AssertionError(f"{what}: {table} slots differ")
        for (_, ra), (_, rb) in zip(slots, other):
            arrays += [(ra[c], rb[c], f"{table}.{c}") for c in ra]
    for x, y, name in arrays:
        if (x is None) != (y is None) or (x is not None and not (
                np.asarray(x).dtype == np.asarray(y).dtype
                and np.array_equal(x, y))):
            raise AssertionError(f"{what}: {name} differs")


def _check_archive(path, recorded: dict, what: str) -> dict:
    """Every version the archive at ``path`` holds rebuilds (a fresh
    reader, from its keyframe) into the snapshot the worker served at
    that version. Returns versions, bytes and reconstruct ms."""
    from flow_pipeline_tpu_torch.gateway import delta
    from flow_pipeline_tpu_torch.history import ArchiveReader

    reader = ArchiveReader(str(path))
    versions = reader.versions()
    if len(versions) < 3:
        raise AssertionError(f"{what}: {len(versions)} archived versions")
    ms = []
    for v in versions:
        cold = ArchiveReader(str(path))
        t0 = time.perf_counter()
        state = cold.reconstruct(v)
        ms.append(1e3 * (time.perf_counter() - t0))
        if v not in recorded:
            raise AssertionError(f"{what}: v{v} was never published")
        _states_equal(state, delta.snapshot_state(recorded[v]),
                      f"{what} v{v}")
    stats = reader.stats()
    return dict(versions=len(versions), bytes=stats["bytes"],
                bytes_per_version=stats["bytes"] / len(versions),
                segments=stats["segments"],
                reconstruct_ms_mean=float(np.mean(ms)),
                reconstruct_ms_max=float(np.max(ms)))


def tiers_phase(torch, smi: str, unguarded: dict) -> dict:
    """Phase 17, gateway and history: ``pipeline`` at CLI defaults on the
    card with -serve.addr and the guard armed (held at level 0), a port
    gateway (-history.dir) and a port history tier on its serving tier,
    in process. ``unguarded``: phase 15's capture of the same pipeline
    without the guard."""
    import tempfile
    import threading

    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine import FusedPipeline

    root = Path(tempfile.mkdtemp(prefix="tiers-", dir=WORK))
    capture = Capture()
    recorded: dict = {}
    tiers: dict = {}
    live: dict = {}
    ages: dict = {}
    done, stop, gate, paused = (threading.Event() for _ in range(4))
    gate.set()
    threads = []

    def tier(name, entry, argv):
        def hold(obj, server):
            tiers[name] = (obj, server)
            done.wait()

        def run():
            try:
                if entry(argv, on_start=hold) != 0:
                    tiers[name + "-error"] = "exit code"
            except BaseException as e:  # noqa: BLE001 -- checked below
                tiers[name + "-error"] = repr(e)
        t = threading.Thread(target=run, name=f"smoke-{name}", daemon=True)
        threads.append(t)
        t.start()

    def sample_ages():
        # mirror age: when a version lands in the gateway's store, minus
        # the worker's publish time (the snapshot's created)
        while "gateway" not in tiers and not stop.is_set():
            time.sleep(0.005)
        store = tiers["gateway"][1].store if "gateway" in tiers else None
        seen = 0
        while store is not None and not stop.is_set():
            snap = store.current
            if snap is not None and snap.version != seen:
                seen = snap.version
                ages[seen] = time.time() - snap.created
            time.sleep(0.002)

    def held_point(worker, services):
        # the worker held between two steps once a window closed; a
        # snapshot published there; every tier answers it alike
        try:
            pub, sport = services["publisher"], services["serve"].port
            deadline = time.monotonic() + 600
            while worker.flows_seen < 3 * PIPE_FLOWS // 4 or \
                    "gateway" not in tiers or "history" not in tiers:
                if time.monotonic() > deadline:
                    raise AssertionError("the run ended before the hold")
                time.sleep(0.01)
            gate.clear()
            if not paused.wait(120):
                raise AssertionError("the worker did not pause")
            with worker.lock:
                snap = pub.publish(worker)
            for name in ("gateway", "history"):
                _wait_version(tiers[name][1].store, snap.version, name)
            live["bodies"] = _same_bodies(
                {"worker": sport, "gateway": tiers["gateway"][1].port,
                 "history": tiers["history"][1].port}, _tier_queries(snap),
                snap.version)
            live.update(version=snap.version, created=snap.created,
                        flows=worker.flows_seen)
        except BaseException as e:  # noqa: BLE001 -- reported below
            live["error"] = repr(e)
        finally:
            gate.set()

    def on_start(worker, services):
        force_level(worker.guard, 0)
        store = services["publisher"].store
        publish = store.publish

        def recording(**kw):
            snap = publish(**kw)
            recorded[snap.version] = snap
            return snap

        store.publish = recording
        step = worker.run_once

        def gated_step():
            if not gate.is_set():
                paused.set()
                gate.wait()
            return step()

        worker.run_once = gated_step
        upstream = f"127.0.0.1:{services['serve'].port}"
        tier("gateway", cli.run_gateway, [
            "-gateway.upstream", upstream, "-gateway.listen", "127.0.0.1:0",
            "-gateway.poll", str(MIRROR_POLL), "-history.dir",
            str(root / "gateway"), "-loglevel", "warning"])
        tier("history", cli.run_history, [
            "-history.upstream", upstream, "-history.listen", "127.0.0.1:0",
            "-history.poll", str(MIRROR_POLL), "-history.dir",
            str(root / "history"), "-loglevel", "warning"])
        for target, args in ((sample_ages, ()),
                             (held_point, (worker, services))):
            t = threading.Thread(target=target, args=args, daemon=True,
                                 name="smoke-tiers")
            threads.append(t)
            t.start()

    after: dict = {}
    serve_port: dict = {}

    def on_finish(worker, metrics):
        try:
            final = worker.serve.store.current
            for name in ("gateway", "history"):
                _wait_version(tiers[name][1].store, final.version, name)
            ports = {"worker": serve_port["port"],
                     "gateway": tiers["gateway"][1].port,
                     "history": tiers["history"][1].port}
            after["bodies"] = _same_bodies(ports, _tier_queries(final),
                                           final.version)
            after["version"] = final.version
            # the held version, long superseded at the worker (and, when
            # its delta chain no longer reaches it, out of its feed
            # history), is answered by the history tier as served then
            v_old = live["version"]
            feed = serve_port["server"]._feed
            kind = feed.frame_since(v_old)[0]
            after["feed"] = feed.stats()
            hport = tiers["history"][1].port
            for q in (f"/query/topk?at={live['created']!r}",
                      f"/query/topk?version={v_old}"):
                got = _http(hport, q)
                if got != live["bodies"]["/query/topk"]:
                    raise AssertionError(f"history {q}: not the body "
                                         f"served at v{v_old}")
            after["time_travel"] = kind
        except BaseException as e:  # noqa: BLE001 -- reported below
            after["error"] = repr(e)
        finally:
            stop.set()
            done.set()

    def start(worker, services):
        serve_port.update(port=services["serve"].port,
                          server=services["serve"])
        on_start(worker, services)

    worker, launches, gen_s, run_s = _pipeline_run(
        torch, ["-sink", f"sqlite:{WORK / 'tiers.db'}", "-serve.addr",
                "127.0.0.1:0", "-serve.feed_bytes", str(FEED_BYTES),
                "-guard.lag", str(GUARD_BUDGET), "-metrics.addr", ""],
        sinks=[capture], on_start=start, on_finish=on_finish)
    for t in threads:
        t.join(timeout=120)
    errors = {k: v for k, v in tiers.items() if k.endswith("-error")}
    for what, got in (("tiers", errors), ("held point", live.get("error")),
                      ("end", after.get("error"))):
        if got:
            raise AssertionError(f"phase 17 {what}: {got}")
    if any(t.is_alive() for t in threads):
        raise AssertionError("a tier thread did not stop")
    if type(worker.fused) is not FusedPipeline or \
            worker.flows_seen != PIPE_FLOWS or worker.guard.level != 0 or \
            not worker.guard.armed:
        raise AssertionError(f"guarded pipeline: {worker.guard.meta()}, "
                             f"{worker.flows_seen} flows")
    if launches["cms_add_conservative"] != worker.chunk_updates:
        raise AssertionError(f"guarded pipeline: launches {launches}, "
                             f"chunk updates {worker.chunk_updates}")
    # level 0: the guarded run's tables are the unguarded run's
    compare_exact(capture.tables, unguarded, "guard level 0/unguarded")
    compare_hh(capture.tables, unguarded, "guard level 0/unguarded")
    history = _check_archive(root / "history", recorded, "history tier")
    gw_archive = _check_archive(root / "gateway", recorded,
                                "gateway -history.dir")
    age = [ages[v] for v in sorted(ages)]
    out = dict(
        flows=PIPE_FLOWS, run_s=run_s, generation_s=gen_s,
        launches=launches["cms_add_conservative"],
        chunk_updates=worker.chunk_updates, publishes=len(recorded),
        held_version=live["version"], final_version=after["version"],
        held_queries=len(live["bodies"]), end_queries=len(after["bodies"]),
        held_in_worker_feed=after["time_travel"] == "delta",
        worker_feed=after["feed"],
        mirror_age_p50_s=_pct(age, 50), mirror_age_p99_s=_pct(age, 99),
        mirror_versions=len(age), history=history,
        gateway_archive=gw_archive)
    log(f"gateway and history (pipeline at CLI defaults on the card, "
        f"-serve.addr, -guard.lag {GUARD_BUDGET} held at level 0; a gateway "
        f"with -history.dir and a history tier polling every "
        f"{MIRROR_POLL} s): rows equal phase 15's unguarded run (flows_5m, "
        f"port tables, alerts identical; heavy-hitter values within rtol "
        f"1e-6); {out['launches']} conservative launches = chunk updates; "
        f"{len(live['bodies'])} /query/* bodies byte-equal on worker, "
        f"gateway and history at the held v{live['version']} and "
        f"{len(after['bodies'])} at the final v{after['version']}; "
        f"/query/topk?at= and ?version= of v{live['version']} answer the "
        f"body served then (the worker's feed chain "
        f"{'still reaches' if out['held_in_worker_feed'] else 'no longer reaches'}"
        f" it: {after['feed']}); "
        f"{history['versions']} archived versions (history tier) and "
        f"{gw_archive['versions']} (gateway) rebuild into the published "
        f"snapshots [{smi}]")
    log(f"gateway mirror age p50 {out['mirror_age_p50_s']:.3f} s, p99 "
        f"{out['mirror_age_p99_s']:.3f} s over {len(age)} versions; archive "
        f"{history['bytes_per_version']:.0f} B per version "
        f"({history['segments']} segments), reconstruct "
        f"{history['reconstruct_ms_mean']:.1f} ms mean, "
        f"{history['reconstruct_ms_max']:.1f} ms max (a fresh reader, "
        f"keyframe every 64 versions) [{smi}]")
    return out


def guard_phase(torch, frames, smi: str) -> dict:
    """Phase 17, the guard: processor -in (phase-4 frames, the host-grouped
    path: admission on the group thread) held at level GUARD_LEVEL on the
    card and the CPU (equal tables), and pipeline at CLI defaults (the
    fused step: admission on the worker thread) held there against
    unguarded, one run each, the guarded run's /metrics scraped."""
    from flow_pipeline_tpu_torch.obs import REGISTRY

    gpu, cpu = run_main_path(
        torch, frames, "hostassist",
        extra=("-guard.lag", str(GUARD_BUDGET)),
        on_start=lambda w, services: force_level(w.guard, GUARD_LEVEL),
        tag="guard-")
    compare_runs(gpu["rows"], cpu["rows"])
    for run in (gpu, cpu):
        meta = run["worker"].guard.meta()
        if meta["level"] != GUARD_LEVEL or not meta["shed_total"]:
            raise AssertionError(f"guard ({run['device']}): {meta}")
    if gpu["worker"].guard.meta() != cpu["worker"].guard.meta():
        raise AssertionError("guard: card and CPU shed differently")
    for run in (gpu, cpu):
        want = {k: 0 for k in run["launches"]}
        if run["device"] == "cuda":
            want["cms_add_conservative"] = run["worker"].chunk_updates
        if run["launches"] != want or not run["worker"].chunk_updates:
            raise AssertionError(f"guarded host-grouped path "
                                 f"({run['device']}): "
                                 f"launches {run['launches']}, want {want}")
    shed = gpu["worker"].guard.meta()["shed_total"]
    # pipeline at CLI defaults, guarded at the level and unguarded, in
    # turns; the first guarded run's /metrics scraped before it stops
    turns = {"guarded": [], "plain": []}
    scraped: dict = {}
    first = {}
    for tag in ("guarded", "plain"):
        flags = ["-sink", f"sqlite:{WORK / f'guard-{tag}.db'}"]
        kw = {}
        if tag == "guarded":
            flags += ["-guard.lag", str(GUARD_BUDGET)]
            kw["on_start"] = lambda w, s: force_level(w.guard, GUARD_LEVEL)
            if not scraped:
                flags += ["-metrics.addr", "127.0.0.1:0"]
                scraped["before"] = _samples(REGISTRY.render())
                kw["on_finish"] = lambda w, srv: scraped.update(
                    _scrape(srv))
            else:
                flags += ["-metrics.addr", ""]
        else:
            flags += ["-metrics.addr", ""]
        w, n, _, secs = _pipeline_run(torch, flags, **kw)
        turns[tag].append(PIPE_FLOWS / secs)
        if n["cms_add_conservative"] != w.chunk_updates:
            raise AssertionError(f"pipeline ({tag}): launches {n}, chunk "
                                 f"updates {w.chunk_updates}")
        first.setdefault(tag, (w.guard.meta(), n["cms_add_conservative"],
                               w.flows_seen))
    metrics = _samples(scraped["/metrics"])
    series = 'guard_shed_total{reason="admission",stage="ingest"}'
    pipe_shed = metrics.get(series, 0) - scraped["before"].get(series, 0)
    meta, lk_launches, lk_flows = first["guarded"]
    if metrics.get("flow_guard_level") != GUARD_LEVEL or \
            pipe_shed != meta["shed_total"] or not pipe_shed or \
            lk_flows != PIPE_FLOWS - pipe_shed:
        raise AssertionError(f"guard /metrics: level "
                             f"{metrics.get('flow_guard_level')}, shed "
                             f"{pipe_shed}, {meta}")
    health = json.loads(scraped["/healthz"])
    out = dict(level=GUARD_LEVEL, processor_shed=shed,
               processor_shed_share=shed / N_FLOWS,
               processor_launches=gpu["launches"]["cms_add_conservative"],
               processor_chunk_updates=gpu["worker"].chunk_updates,
               pipeline_shed=pipe_shed,
               pipeline_shed_share=pipe_shed / PIPE_FLOWS,
               pipeline_launches=lk_launches,
               plain_launches=first["plain"][1],
               flows_per_s_turns=turns, healthz=health)
    log(f"guard held at level {GUARD_LEVEL} (keep rate 1/"
        f"{1 << (GUARD_LEVEL - 1)}): processor -in (host-grouped) card rows "
        f"equal CPU rows "
        f"(flows_5m, port tables, alerts identical; heavy-hitter values "
        f"within rtol 1e-6), {shed} of {N_FLOWS} rows shed "
        f"({100 * shed / N_FLOWS:.2f} %) on both, "
        f"{out['processor_launches']} conservative launches = chunk "
        f"updates; pipeline: /metrics flow_guard_level "
        f"{metrics.get('flow_guard_level'):.0f}, guard_shed_total "
        f"{pipe_shed:.0f} ({100 * pipe_shed / PIPE_FLOWS:.2f} % of "
        f"{PIPE_FLOWS}), {lk_launches} launches (unguarded "
        f"{first['plain'][1]}) [{smi}]")
    log("pipeline end to end in turns (offered flows over wall): "
        + "; ".join(f"{t} {', '.join(f'{r:.0f}' for r in v)}"
                    for t, v in turns.items()) + f" flows/s [{smi}]")
    return out


# ---- phase 18 ---------------------------------------------------------------

MESH_CHURN_VICTIM = 1  # of 3 members
MESH_PROFILE_FLOWS = 1 << 16
# card memory a finished mesh run may leave allocated: far below one
# member's model state (about 13.6 MB at the default widths)
MESH_MEMORY_SLACK = 4 << 20


def _mesh_run(torch, n: int, capture, churn: bool = False,
              flows: int = 0, profile: bool = False,
              serve=None) -> dict:
    """One ``pipeline -mesh.workers n`` on the card over phase 15's
    stream (its first ``flows`` flows where given). The launch counts
    and the CMS update tally are zeroed just before it and read just
    after; every model set a member builds is checked for card state and
    for the stream its thread launches on. With ``churn`` a watcher kills
    member MESH_CHURN_VICTIM once it has stepped two batches and fences
    it (InProcessMesh.kill_member). ``serve``: the (on_start, on_finish)
    hooks of a run with ``-serve.addr`` (_mesh_serve_hooks)."""
    import gc
    import threading
    import weakref

    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine.fused import state_device
    from flow_pipeline_tpu_torch.models import heavy_hitter as thh
    from flow_pipeline_tpu_torch.ops import cms_cuda

    built = {"devices": set(), "streams": set(), "sets": 0}
    lock = threading.Lock()
    started: dict = {}
    ended: dict = {}
    churned: dict = {}

    def on_start(mesh, services):
        for m in mesh.members:
            def factory(make=m.model_factory):
                models = make()
                with lock:
                    built["devices"].add(state_device(models).type)
                    built["streams"].add(
                        torch.cuda.current_stream().cuda_stream)
                    built["sets"] += 1
                return models
            m.model_factory = factory
        if churn:
            threading.Thread(target=kill, args=(mesh,), name="smoke-churn",
                             daemon=True).start()
        if serve is not None:
            serve[0](mesh, services)
        started["t"] = time.perf_counter()

    def on_finish(mesh, metrics):
        # the run's clock stops here, before the serving tier's checks
        torch.cuda.synchronize()
        ended["t"] = time.perf_counter()
        serve[1](mesh, metrics)

    def kill(mesh):
        victim = mesh.members[MESH_CHURN_VICTIM]
        try:
            while True:
                w = victim.worker
                if w is not None and w.flows_seen >= 2 * BATCH:
                    break
                if mesh._stop.is_set():
                    raise RuntimeError("the run ended before the victim "
                                       f"stepped {2 * BATCH} flows")
                time.sleep(0.005)
            state = weakref.ref(w.models["top_talkers"].model.state.cms)
            churned["victim_flows"] = w.flows_seen
            del w
            churned["allocated_before_kill"] = torch.cuda.memory_allocated()
            mesh.kill_member(MESH_CHURN_VICTIM)
            mesh._threads[MESH_CHURN_VICTIM].join(timeout=600)
            gc.collect()
            churned["state_freed"] = state() is None
            churned["allocated_after_kill"] = torch.cuda.memory_allocated()
        except BaseException as e:  # noqa: BLE001 -- reported below
            churned["error"] = repr(e)

    for name in cms_cuda.LAUNCHES:
        cms_cuda.LAUNCHES[name] = 0
        thh.CHUNK_UPDATES[name] = 0
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    merged0 = _merge_totals()
    flows = flows or PIPE_FLOWS
    gen = list(PIPE_GEN)
    gen[gen.index("-produce.count") + 1] = str(flows)
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof

        prof = tprof(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        mesh = cli.run_pipeline(
            ["-device", "cuda", *gen, "-bus.partitions", "2",
             "-processor.batch", str(BATCH), "-sketch.width", str(WIDTH),
             "-loglevel", "warning", "-metrics.addr", "",
             "-mesh.workers", str(n), "-mesh.heartbeat", "3600",
             *(("-serve.addr", "127.0.0.1:0") if serve else ()),
             "-sink", f"sqlite:{WORK / f'mesh-{n}-{int(churn)}.db'}"],
            sinks=[capture] if capture is not None else (),
            on_start=on_start, on_finish=on_finish if serve else None)
        torch.cuda.synchronize()
        t1 = ended.get("t", time.perf_counter())
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    launches = dict(cms_cuda.LAUNCHES)
    updates = dict(thh.CHUNK_UPDATES)
    peak = torch.cuda.max_memory_allocated()
    merges, merge_s = (a - b for a, b in zip(_merge_totals(), merged0))
    submits = sum(m._sub_seq for m in mesh.members)
    del mesh
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if churned.get("error") or (churn and not churned):
        raise AssertionError(f"mesh churn: {churned}")
    if launches != updates or not launches["cms_add_conservative"] or \
            launches["cms_add"]:
        raise AssertionError(f"mesh N={n}: launches {launches} != CMS "
                             f"updates {updates}")
    if built["devices"] != {"cuda"} or len(built["streams"]) != 1 or \
            built["streams"] != {torch.cuda.default_stream().cuda_stream}:
        raise AssertionError(f"mesh N={n}: model sets {built}")
    if after > base + MESH_MEMORY_SLACK:
        raise AssertionError(f"mesh N={n}: {after - base} B of card memory "
                             f"still allocated after the run")
    out = dict(n=n, flows=flows, launches=launches["cms_add_conservative"],
               chunk_updates=updates["cms_add_conservative"],
               model_sets=built["sets"], run_s=t1 - started["t"],
               with_generation_s=t1 - t0,
               flows_per_s=flows / (t1 - started["t"]),
               peak_bytes=peak, base_bytes=base, after_bytes=after,
               submissions=submits, merges=merges, merge_s=merge_s)
    if churn:
        if not churned["state_freed"]:
            raise AssertionError("mesh churn: the killed member's card "
                                 "state is still held")
        out.update(churned)
    if prof is not None:
        avgs = prof.key_averages()
        kernels = [e for e in avgs if str(e.device_type).endswith("CUDA")]
        dev_ms = sum(getattr(e, "self_device_time_total", 0) or
                     getattr(e, "self_cuda_time_total", 0)
                     for e in kernels) / 1e3
        wall_ms = (t1 - started["t"]) * 1e3
        key = ("device_time_total" if avgs and hasattr(avgs[0],
                                                       "device_time_total")
               else "cuda_time_total")
        (OUT / f"profile_mesh{n}.txt").write_text(
            avgs.table(sort_by=key, row_limit=30))
        out.update(device_ms=dev_ms, wall_ms=wall_ms,
                   launches_profiled=sum(e.count for e in kernels),
                   idle=1 - dev_ms / wall_ms)
    return out


def _mesh_serve_hooks(capture, out: dict) -> tuple:
    """The (on_start, on_finish) hooks of ``pipeline -mesh.workers 2
    -serve.addr``: while the mesh runs, phase 15's readers (loadgen's 8
    reader threads in a subprocess for READ_LOAD_S once a window merged,
    and the snapshot-age sampler), a /query/version poller and a port
    gateway mirroring the merged store over HTTP. Once the members are
    idle (just before the mesh finalizes) a publish there answers
    /query/topk equal to coordinator.query_topk. After the run the
    publisher thread stops and one more publish covers every merged
    window: /query/range equals the sinks' merged flows_5m rows and a
    /sub/snapshot full frame rebuilds it (_serve_after_run), and the
    gateway lands that version and answers every query byte-equal.
    Failures land in ``out["error"]``."""
    import threading

    from flow_pipeline_tpu_torch.gateway.subscriber import SnapshotGateway
    from flow_pipeline_tpu_torch.serve import ServeServer

    stop = threading.Event()
    held: dict = {}
    load: dict = {}
    versions: list = []
    threads: list = []

    def poll_versions(port):
        while not stop.is_set():
            try:
                versions.append(
                    _get_json(port, "/query/version")[1]["version"])
            except OSError:
                pass
            stop.wait(0.05)

    def idle_check():
        services, mesh = held["services"], held["mesh"]
        snap = services["publisher"].publish_now()
        direct = json.loads(json.dumps(
            mesh.coordinator.query_topk("top_talkers", 10), default=str))
        code, served = _get_json(services["serve"].port,
                                 "/query/topk?model=top_talkers&k=10")
        if code != 200 or not direct["rows"] or \
                served["rows"] != direct["rows"] or \
                served["window_start"] != direct["window_start"]:
            raise AssertionError("/query/topk of the idle mesh's publish "
                                 "differs from coordinator.query_topk")
        out["idle"] = dict(version=snap.version, rows=len(direct["rows"]),
                           window_start=direct["window_start"])

    def on_start(mesh, services):
        held.update(services=services, mesh=mesh)
        port = services["serve"].port
        gw = SnapshotGateway([f"127.0.0.1:{port}"], poll=MIRROR_POLL)
        gws = ServeServer(gw.store, port=0).start()
        gw.serve_on(gws)
        gw.start()
        held.update(gateway=gw, gateway_server=gws)
        threads.extend(threading.Thread(target=f, args=a, daemon=True,
                                        name=f"smoke-{tag}")
                       for tag, f, a in (
                           ("readers", _readers, (services, stop, load)),
                           ("versions", poll_versions, (port,))))
        for t in threads:
            t.start()
        finalize = mesh.finalize

        def checked_finalize():
            try:
                idle_check()
            except BaseException as e:  # noqa: BLE001 -- reported below
                out["error"] = repr(e)
            finalize()

        mesh.finalize = checked_finalize

    def on_finish(mesh, metrics):
        stop.set()
        for t in threads:
            t.join(timeout=300)
        services = held["services"]
        pub, port = services["publisher"], services["serve"].port
        gw, gws = held["gateway"], held["gateway_server"]
        try:
            if load.get("error"):
                raise AssertionError(f"readers: {load['error']}")
            pub.stop()  # the last publish below stays the served one
            snap = pub.publish_now()
            out["after"] = _serve_after_run(pub, port, capture)
            _wait_version(gw.store, snap.version, "the mesh's gateway")
            if gw.store.current.version != snap.version:
                raise AssertionError("the gateway passed the upstream")
            queries = [*_tier_queries(snap), "/query/range?model=flows_5m"]
            for q in queries:
                if _http(port, q) != _http(gws.port, q):
                    raise AssertionError(f"{q}: the gateway answers "
                                         "differently from the mesh")
            docs = [_get_json(p, "/query/version")[1]
                    for p in (port, gws.port)]
            for doc in docs:
                doc.pop("age_seconds")
            if docs[0] != docs[1]:
                raise AssertionError("/query/version: the gateway differs")
            out.update(final_version=snap.version, gateway_queries=len(
                queries), publishes=pub.publishes,
                publish_seconds=pub.publish_seconds,
                capture_seconds=pub.capture_seconds, readers=load["load"],
                ages=load["ages"], versions=versions,
                responses={code: pub.store.m_responses.value(code=code)
                           for code in ("200", "304", "400", "404", "500",
                                        "503")})
        except BaseException as e:  # noqa: BLE001 -- reported below
            out.setdefault("error", repr(e))
        finally:
            gw.stop()
            gws.stop()

    return on_start, on_finish


def _merge_totals() -> tuple:
    """(window merges, their seconds) the process's coordinators have
    recorded so far (mesh_merge_seconds)."""
    from flow_pipeline_tpu_torch.obs.metrics import REGISTRY

    hist = REGISTRY._metrics.get("mesh_merge_seconds")
    return hist.value() if hist is not None else (0, 0.0)


def _folded_flows_5m(emitted) -> dict:
    """flows_5m rows summed by key (late partials merged, as the sink's
    SummingMergeTree merges them)."""
    got: dict = {}
    for rows in emitted:
        for i in range(len(rows["timeslot"])):
            key = (int(rows["timeslot"][i]),
                   *(int(rows[c][i]) for c in FLOWS_5M_KEYS))
            acc = got.setdefault(key, [0] * 5)
            for j, c in enumerate(("bytes", "packets", "count",
                                   "bytes_scaled", "packets_scaled")):
                acc[j] += int(rows[c][i])
    return got


def _check_mesh_talkers(merged: list, single, capacity: int,
                        distinct: int, what: str) -> str:
    """top_talkers of a mesh run against the single worker's: equal keys
    and values while the distinct keys fit the capacity, else every
    merged row's estimates bound its values. A run over part of the
    stream (``single`` None) holds the bound alone."""
    if single is None:
        for m in merged:
            v = m["valid"]
            for col in ("bytes", "packets", "count"):
                if not v.any() or (m[f"{col}_est"][v].astype(np.float64)
                                   < m[col][v].astype(np.float64)).any():
                    raise AssertionError(f"{what}: top_talkers {col}_est "
                                         f"< {col}, or an empty window")
        return "est >= value"
    if len(merged) != len(single):
        raise AssertionError(f"{what}: {len(merged)} top_talkers windows, "
                             f"single worker {len(single)}")
    for m, s in zip(merged, single):
        v = m["valid"]
        if not v.any() or not np.array_equal(m["timeslot"], s["timeslot"]):
            raise AssertionError(f"{what}: top_talkers windows differ")
        if distinct <= capacity:
            for col in (*FAMILIES["top_talkers"], "bytes", "packets",
                        "count", "valid"):
                if not np.array_equal(m[col], s[col]):
                    raise AssertionError(f"{what}: top_talkers {col} "
                                         "differs from the single worker")
        for col in ("bytes", "packets", "count"):
            if (m[f"{col}_est"][v].astype(np.float64)
                    < m[col][v].astype(np.float64)).any():
                raise AssertionError(f"{what}: top_talkers {col}_est < "
                                     f"{col}")
    return "equal" if distinct <= capacity else "est >= value"


def _mesh_serve_report(run: dict, served: dict, plain: dict,
                       smi: str) -> dict:
    """The gates and figures of the merged serving tier's run."""
    if served.get("error"):
        raise AssertionError(f"mesh -serve.addr: {served['error']}")
    codes, versions = served["readers"]["codes"], served["versions"]
    if any(c != "200" for c in codes) or served["responses"]["500"] or \
            served["readers"]["errors"] or not served["readers"]["requests"]:
        raise AssertionError(f"mesh serving tier under load: codes {codes},"
                             f" responses {served['responses']}")
    if not versions or versions != sorted(versions):
        raise AssertionError("mesh serving tier: versions went back")
    n = served["publishes"]
    ms = 1e3 * served["publish_seconds"] / n
    cap = 1e3 * served["capture_seconds"] / n
    ages = served["ages"]
    out = dict(publishes=n, publish_ms=ms, capture_ms=cap,
               rest_ms=ms - cap, readers=served["readers"],
               age_p50_s=_pct(ages, 50), age_p99_s=_pct(ages, 99),
               age_samples=len(ages), versions_sampled=len(versions),
               final_version=served["final_version"], idle=served["idle"],
               gateway_queries=served["gateway_queries"],
               responses=served["responses"], **served["after"])
    log(f"mesh -serve.addr (pipeline -mesh.workers 2 -serve.addr): "
        f"{n} merged publishes, {ms:.3f} ms per publish ({cap:.3f} ms the "
        f"2 members' captures, {ms - cap:.3f} ms merge, extraction and "
        f"swap); 8 readers {served['readers']['qps']:.0f} queries/s, p50 "
        f"{served['readers']['p50_ms']:.3f} ms, p99 "
        f"{served['readers']['p99_ms']:.3f} ms, all 200, no 500; snapshot "
        f"age p50 {out['age_p50_s']:.3f} s, p99 {out['age_p99_s']:.3f} s "
        f"({len(ages)} samples); {len(versions)} /query/version polls "
        f"monotone to v{served['final_version']}; the idle mesh's publish "
        f"v{served['idle']['version']}: /query/topk == "
        f"coordinator.query_topk ({served['idle']['rows']} rows); the "
        f"final publish's /query/range == the merged flows_5m sink rows "
        f"({out['range_rows']} rows, {out['range_slots']} slots) and its "
        f"full frame rebuilds it; the gateway landed "
        f"v{served['final_version']} and answered "
        f"{served['gateway_queries']} queries and /query/version "
        f"byte-equal; {run['flows_per_s']:.0f} flows/s against "
        f"{plain['flows_per_s']:.0f} without -serve.addr (recorded, not "
        f"claimed); peak card memory {run['peak_bytes']} B [{smi}]")
    return out


def mesh_phase(torch, smi: str, single: dict) -> dict:
    """Phase 18: pipeline -mesh.workers N on the card (N = 2, N = 2 with
    the merged serving tier, N = 4 over the first quarter of the stream,
    a churn run of 3 with one member killed over its first half, then
    1)
    against phase 15's single-worker tables and the oracle."""
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    gen = FlowGenerator(ZipfProfile(), seed=SEED, rate=PIPE_RATE)
    batches = [gen.batch(8192) for _ in range(PIPE_FLOWS // 8192)]
    flows = FlowBatch.concat(batches)
    half = FlowBatch.concat(batches[:len(batches) // 2])
    quarter = FlowBatch.concat(batches[:len(batches) // 4])
    del batches
    from flow_pipeline_tpu_torch.engine.hostfused import _key_lanes_into

    lanes = _key_lanes_into(flows.columns, FAMILIES["top_talkers"])
    distinct = len(np.unique(lanes, axis=0))
    del lanes
    want = _folded_flows_5m(single["flows_5m"])
    runs = {}
    served: dict = {}
    # N = 4 over the first quarter of the stream (131,072 flows) and the
    # churn run over its first half (the victim must step two batches):
    # whole-stream runs took two to four times as long of the script's
    # time limit
    for tag, n, churn, part in (("2", 2, False, None),
                                ("2-serve", 2, False, None),
                                ("4", 4, False, quarter),
                                ("churn", 3, True, half),
                                ("1", 1, False, None)):
        capture = Capture()
        run = _mesh_run(
            torch, n, capture, churn=churn,
            flows=len(part) if part is not None else 0,
            serve=_mesh_serve_hooks(capture, served)
            if tag == "2-serve" else None)
        groups = check_flows_5m(flows if part is None else part,
                                capture.tables["flows_5m"])
        if part is None and \
                _folded_flows_5m(capture.tables["flows_5m"]) != want:
            raise AssertionError(f"mesh {tag}: flows_5m differs from the "
                                 "single worker's")
        run["top_talkers"] = _check_mesh_talkers(
            capture.tables["top_talkers"],
            single["top_talkers"] if part is None else None, 1024,
            distinct, f"mesh {tag}")
        run["flows_5m_rows"] = groups
        runs[tag] = run
        if tag == "2-serve":
            run["serve"] = _mesh_serve_report(run, served, runs["2"], smi)
        twin = " and the single worker's" if part is None else ""
        extra = ""
        if churn:
            extra = (f"; member {MESH_CHURN_VICTIM} killed after "
                     f"{run['victim_flows']} flows and fenced, its model "
                     f"state freed (allocated {run['allocated_before_kill']}"
                     f" B before the kill, {run['allocated_after_kill']} B "
                     "after)")
        log(f"mesh {tag} (pipeline -mesh.workers {n}"
            f"{' -serve.addr' if tag == '2-serve' else ''}, "
            f"{run['flows']} flows): flows_5m {groups} rows equal the "
            f"oracle{twin}; top_talkers "
            f"{run['top_talkers']} ({distinct} distinct 5-tuples, capacity "
            f"1024); {run['launches']} conservative launches = "
            f"{run['chunk_updates']} CMS updates over {run['model_sets']} "
            f"model sets, all on cuda, one stream; {run['flows_per_s']:.0f}"
            f" flows/s ({run['run_s']:.2f} s; {run['submissions']:.0f} "
            f"submissions, {run['merges']} window merges in "
            f"{run['merge_s']:.3f} s); peak card memory "
            f"{run['peak_bytes']} B, {run['after_bytes']} B allocated "
            f"after (before {run['base_bytes']}){extra} [{smi}]")
    prof = _mesh_run(torch, 2, None, flows=MESH_PROFILE_FLOWS, profile=True)
    log(f"mesh idle share (2 members, {MESH_PROFILE_FLOWS} flows under "
        f"torch.profiler): card busy {prof['device_ms']:.1f} of "
        f"{prof['wall_ms']:.1f} ms, idle {100 * prof['idle']:.1f} %, "
        f"{prof['launches_profiled']} kernel launches [{smi}]")
    log("mesh flows/s by members (one interpreter lock, one card; no "
        "claim; N = 4 over a quarter of the stream): " + ", ".join(
            f"N={runs[t]['n']} {runs[t]['flows_per_s']:.0f}"
            for t in ("1", "2", "4")) + f" [{smi}]")
    return dict(runs=runs, profile=prof, distinct_talkers=distinct)


# ---- phase 19 ---------------------------------------------------------------

HTTP_HEARTBEAT = 2.0  # -mesh.heartbeat of the coordinator service, seconds
HTTP_CHURN_VICTIM = 1  # of 3 member processes
HTTP_DEADLINE = 600.0  # the longest any wait of the phase may take, seconds


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for(what: str, cond, poll: float = 0.05):
    """Poll ``cond()`` until it returns a true value; HTTP_DEADLINE is a
    guard against a hang, never the condition."""
    deadline = time.monotonic() + HTTP_DEADLINE
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"mesh over HTTP: {what} never happened")
        time.sleep(poll)


def _sharded_stream(flows: int, partitions: int, bus=None):
    """Phase 15's seeded stream (its first ``flows`` flows), key-hash
    sharded over ``partitions`` as ``pipeline -mesh.workers`` shards it:
    the messages per partition, loaded onto ``bus`` when one is given."""
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.mesh import produce_sharded, shard_ids

    gen = FlowGenerator(ZipfProfile(), seed=SEED, rate=PIPE_RATE)
    ends = np.zeros(partitions, np.int64)
    done = 0
    while done < flows:
        batch = gen.batch(min(8192, flows - done))
        ends += np.bincount(shard_ids(batch, partitions),
                            minlength=partitions)
        if bus is not None:
            produce_sharded(bus, "flows", batch, partitions)
        done += len(batch)
    return ends.tolist()


def http_member(spec: dict) -> int:
    """One mesh member in a process of its own (``chip_smoke.py
    --mesh-member SPEC``): the body of the reference's member role
    (RemoteCoordinator with its state and trace URLs, MeshMember with
    submit_every 64 and a 1-s sync, a MemberStateServer and a metrics
    server for /debug/trace), except that its consumers read this
    process's own in-process bus, loaded with phase 15's stream sharded
    as every process shards it. It prints one JSON line when it is ready
    to join, joins when the parent writes a line to its stdin, steps
    until SIGINT (or, as the churn victim, holds once it has stepped
    ``hold_after`` flows, for the parent to SIGKILL), finalizes and
    prints its tallies."""
    import signal
    import threading

    import torch

    device = torch.device(spec["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("chip_smoke member: no CUDA device")
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.mesh import (MemberStateServer, MeshMember,
                                              RemoteCoordinator)
    from flow_pipeline_tpu_torch.models import heavy_hitter as thh
    from flow_pipeline_tpu_torch.obs.metrics import REGISTRY
    from flow_pipeline_tpu_torch.ops import cms_cuda
    from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus

    t_start = time.perf_counter()
    if device.type == "cuda":
        from flow_pipeline_tpu_torch import kernels

        # phase 2 built the library; a member only loads it
        if kernels.build().seconds:
            raise AssertionError("a member process built the kernels")
        kernels.library()
        # the context before the join: its seconds must not cost a beat
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats()
    bus = InProcessBus()
    bus.create_topic("flows", spec["partitions"])
    ends = _sharded_stream(spec["flows"], spec["partitions"], bus)
    vals = cli._parse_processor(
        ["-device", spec["device"], "-processor.batch", str(spec["batch"]),
         "-sketch.width", str(spec["width"]), "-loglevel", "warning",
         "-metrics.addr", "127.0.0.1:0", "-sink", f"sqlite:{spec['db']}"])
    cli._begin(vals)
    mid = spec["id"]
    metrics = cli._start_metrics(vals["metrics.addr"])
    trace_url = f"http://127.0.0.1:{metrics.port}/debug/trace"
    remote = RemoteCoordinator(spec["coordinator"], trace_url=trace_url)
    member = MeshMember(
        mid, remote,
        lambda parts: Consumer(bus, "flows", group=f"mesh-{mid}",
                               partitions=list(parts)),
        model_factory=lambda: cli._build_models(vals, device),
        config=cli._worker_config(vals),
        sinks=cli._make_sinks(vals["sink"], retries=vals["sink.retries"],
                              deadletter=vals["sink.deadletter"]),
        submit_every=64, sync_interval=1.0, trace_url=trace_url)
    state = MemberStateServer(member, 0, "127.0.0.1").start()
    remote.state_url = state.url
    # one batch through a throwaway model set first: a process's first
    # fused step loads its kernels and warms the allocator, and must not
    # outlast a heartbeat once the member has joined
    _warm_member(cli, vals, device, spec["batch"])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    for name in cms_cuda.LAUNCHES:
        cms_cuda.LAUNCHES[name] = 0
        thh.CHUNK_UPDATES[name] = 0
    counter = REGISTRY._metrics["flows_processed_total"]
    warm_flows = counter.value()
    print(json.dumps({"ready": mid, "state_port": state.port,
                      "trace_url": trace_url, "ends": ends,
                      "setup_s": time.perf_counter() - t_start}),
          flush=True)
    sys.stdin.readline()  # the parent's go: every member is ready
    remote.join(mid)
    member._joined = True
    # every member joins before any consumes: the first assignment covers
    # the whole membership
    _wait_for("every member joining", lambda: json.loads(_http(
        spec["coordinator_port"], "/healthz")[1])["members"] >=
        spec["members"], poll=0.01)
    first = last = None
    held = False
    while not stop.is_set():
        w = member.worker
        if spec["hold_after"] and w is not None and \
                w.flows_seen >= spec["hold_after"]:
            # the churn victim: stop mid-stream, heartbeats and all, and
            # wait for the parent's SIGKILL
            held = True
            Path(spec["hold_file"]).write_text(str(w.flows_seen))
            stop.wait()
            break
        if member.step():
            last = time.perf_counter()
            first = first or last
        else:
            stop.wait(0.01)
    if not held:
        member.finalize()
    flows = counter.value() - warm_flows
    out = {"final": mid, "flows": flows,
           "launches": dict(cms_cuda.LAUNCHES),
           "chunk_updates": dict(thh.CHUNK_UPDATES),
           "step_s": (last - first) if first else 0.0,
           "submissions": member._sub_seq}
    if device.type == "cuda":
        torch.cuda.synchronize()
        out.update(peak_bytes=torch.cuda.max_memory_allocated(),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved())
    state.stop()
    metrics.stop()
    print(json.dumps(out), flush=True)
    return 0


def _warm_member(cli, vals, device, rows: int) -> None:
    """Run ``rows`` flows of another seed through a worker over the
    member's flags and a model set it then drops."""
    from flow_pipeline_tpu_torch.engine import StreamWorker
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.mesh import produce_sharded
    from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus

    bus = InProcessBus()
    bus.create_topic("warm", 1)
    gen = FlowGenerator(ZipfProfile(), seed=SEED + 1, rate=PIPE_RATE)
    produce_sharded(bus, "warm", gen.batch(rows), 1)
    worker = StreamWorker(Consumer(bus, "warm"),
                          cli._build_models(vals, device), [],
                          **cli._worker_config(vals).kwargs())
    worker.run(stop_when_idle=True)


def _lanes_monotone(doc: dict, t_lo: float, t_hi: float) -> dict:
    """{lane: spans} of an aggregated trace, after checking that every
    span lies inside the run (``t_lo``..``t_hi``, wall seconds) on the
    coordinator's clock, and that the spans a thread records one after
    another (a member's ``apply`` per batch, the coordinator's
    ``mesh_merge`` per window) keep their order in each lane."""
    names = {lane["pid"]: lane["name"] for lane in doc["otherData"]["lanes"]}
    counts = {name: 0 for name in names.values()}
    last: dict = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        lane = names[ev["pid"]]
        counts[lane] += 1
        t0, t1 = ev["ts"] / 1e6, (ev["ts"] + ev["dur"]) / 1e6
        if ev["dur"] < 0 or t0 < t_lo or t1 > t_hi:
            raise AssertionError(f"/debug/trace: {lane} span {ev['name']} "
                                 f"at {t0:.3f}..{t1:.3f} outside the run "
                                 f"{t_lo:.3f}..{t_hi:.3f}")
        if ev["name"] in ("apply", "mesh_merge"):
            key = (lane, ev["tid"], ev["name"])
            if t0 < last.get(key, -math.inf) - 1e-6:
                raise AssertionError(f"/debug/trace: lane {lane} thread "
                                     f"{ev['tid']} {ev['name']} goes back "
                                     "in time")
            last[key] = t0
    return counts


def _http_topk_fold(port: int, members: list, spec) -> dict:
    """The coordinator's /topk against a host fold of the members'
    /meshstate payloads fetched directly (members drained and idle).
    The coordinator also folds the promoted carry of a member it fenced
    while that window is pending; /state names such windows, and then
    the members' state alone is not the answer: the check is recorded
    as skipped, with the reason."""
    from flow_pipeline_tpu_torch.families import registry
    from flow_pipeline_tpu_torch.mesh import codec
    from flow_pipeline_tpu_torch.sink.base import rows_to_records

    t0 = time.perf_counter()
    status, body = _http(port, "/topk?model=top_talkers&k=100")
    topk_ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"/topk: {status} {body[:200]!r}")
    states = []
    for m in members:
        status, raw = _http(m["state_port"], "/meshstate?model=top_talkers")
        if status == 200:
            states.append(codec.decode(raw))
    slot = max(s["slot"] for s in states)
    fam = registry.family(spec.kind)
    merged = registry.hook(fam, "merge")(
        [s["payload"] for s in states if s["slot"] == slot], spec.config)
    rows = registry.hook(fam, "top_rows")(merged, spec.config, 100, slot)
    fold = json.loads(json.dumps(
        {"model": "top_talkers", "window_start": slot,
         "rows": rows_to_records(rows)}, default=str))
    got = json.loads(body)
    pending = json.loads(_http(port, "/state")[1])["pending_windows"]
    if f"top_talkers:{slot}" in pending:
        return dict(topk_ms=topk_ms, rows=len(got["rows"]), slot=slot,
                    members_folded=len(states),
                    skipped="a fenced member's promoted carry is pending "
                            "for the window")
    if got != fold or not got["rows"]:
        (OUT / "http-topk.json").write_text(json.dumps(
            {"topk": got, "fold": fold, "slots": [s["slot"] for s in states]},
            indent=1, default=str))
        diff = [(i, a, b) for i, (a, b) in enumerate(zip(got["rows"],
                                                          fold["rows"]))
                if a != b][:2]
        raise AssertionError(
            f"/topk differs from the host fold of the members' /meshstate "
            f"payloads: window {got['window_start']} / {fold['window_start']}"
            f", {len(got['rows'])} / {len(fold['rows'])} rows, first "
            f"differences {diff} ({OUT / 'http-topk.json'})")
    return dict(topk_ms=topk_ms, rows=len(got["rows"]), slot=slot,
                members_folded=len(states))


def _sqlite_tables(db) -> dict:
    """flows_5m as one columnar batch, and top_talkers rows by window."""
    import sqlite3

    conn = sqlite3.connect(str(db))
    try:
        cols = ("timeslot", *FLOWS_5M_KEYS, "bytes", "packets", "count",
                "bytes_scaled", "packets_scaled")
        rows = conn.execute(
            f"SELECT {','.join(cols)} FROM flows_5m").fetchall()
        flows_5m = {c: np.array([r[i] for r in rows], np.int64)
                    for i, c in enumerate(cols)}
        talkers: dict = {}
        for r in conn.execute(
                "SELECT timeslot, rank, src_addr, dst_addr, src_port, "
                "dst_port, proto, bytes, packets, count FROM top_talkers "
                "ORDER BY timeslot, rank"):
            talkers.setdefault(int(r[0]), []).append(r[1:])
    finally:
        conn.close()
    return {"flows_5m": flows_5m, "top_talkers": talkers}


def _check_http_talkers(flows, talkers: dict, windows: list) -> str:
    """The merged top_talkers rows the coordinator's sqlite sink holds
    (they carry no estimate columns): one window per expected window,
    rows in rank order, every key one that occurred in its window, and
    every value bounding the key's exact window sum (check_oracle's
    bound)."""
    from flow_pipeline_tpu_torch.sink.base import _addr_str

    if sorted(talkers) != sorted(windows):
        raise AssertionError(f"mesh over HTTP: top_talkers windows "
                             f"{sorted(talkers)} != {sorted(windows)}")
    times = flows.columns["time_received"].astype(np.int64)
    key_cols = FAMILIES["top_talkers"]
    emissions = 0
    for slot, rows in talkers.items():
        idx = np.flatnonzero(times - times % 300 == slot)
        ex = _exact_window(flows, idx, key_cols)
        exact = {}
        for i in range(len(ex["bytes"])):
            key = tuple(_addr_str(ex[c][i]) if c.endswith("addr")
                        else int(ex[c][i]) for c in key_cols)
            exact[key] = (int(ex["bytes"][i]), int(ex["packets"][i]),
                          int(ex["count"][i]))
        # one batch of ranks 0..k-1 per emission of the window (a late
        # re-merge emits the window again)
        ranks = [r[0] for r in rows]
        emitted = ranks.count(0)
        if not rows or sorted(ranks) != sorted(
                list(range(len(rows) // max(emitted, 1))) * emitted):
            raise AssertionError(f"top_talkers@{slot}: ranks {ranks[:5]}")
        emissions = max(emissions, emitted)
        for r in rows:
            key, got = tuple(r[1:6]), r[6:9]
            if key not in exact:
                raise AssertionError(f"top_talkers@{slot}: {key} never "
                                     "occurred")
            if any(g < t * (1 - F32_RTOL) for g, t in zip(got, exact[key])):
                raise AssertionError(f"top_talkers@{slot} {key}: {got} "
                                     f"below the exact {exact[key]}")
    return f"values >= exact sums, at most {emissions} emission(s) a window"


def _http_run(tag: str, n: int, flows_n: int, churn: bool, device: str,
              check, launches_gate: bool = True) -> dict:
    """One coordinator service and ``n`` member processes over the first
    ``flows_n`` flows of phase 15's stream; see http_mesh_phase.
    ``check(tables)`` holds the merged sqlite tables once every window
    merged, while the lineage entry runs; its dict joins the result."""
    import signal

    import torch

    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.mesh import spec_from_models

    partitions = max(2, n)
    db = WORK / f"http-{tag}.db"
    port, mport = _free_port(), _free_port()
    url = f"http://127.0.0.1:{port}"
    logs = {}
    procs = {}

    def spawn(name, argv, **kw):
        logs[name] = open(OUT / f"http-{tag}-{name}.log", "w")
        procs[name] = subprocess.Popen(argv, cwd=ROOT, stderr=logs[name],
                                       **kw)
        return procs[name]

    flags = ["-device", device, "-processor.batch", str(BATCH),
             "-sketch.width", str(WIDTH), "-loglevel", "warning"]
    t0 = time.perf_counter()
    t_spawn = time.time()
    try:
        coord = spawn("coordinator", [
            sys.executable, "-m", "flow_pipeline_tpu_torch.cli",
            "processor", "-mesh.role", "coordinator",
            "-mesh.listen", f"127.0.0.1:{port}",
            "-bus.partitions", str(partitions),
            "-mesh.heartbeat", str(HTTP_HEARTBEAT),
            "-mesh.journal", str(WORK / f"http-{tag}-wal"),
            "-obs.trace", "ring", "-metrics.addr", f"127.0.0.1:{mport}",
            "-sink", f"sqlite:{db}", *flags], stdout=subprocess.DEVNULL)
        # the members start beside it: they reach the coordinator only
        # once the parent lets them join
        for i in range(n):
            victim = churn and i == HTTP_CHURN_VICTIM
            spec = dict(coordinator=url, coordinator_port=port,
                        id=f"m{i}", flows=flows_n,
                        partitions=partitions, members=n, device=device,
                        batch=BATCH, width=WIDTH,
                        db=str(WORK / f"http-{tag}-m{i}.db"),
                        hold_after=2 * BATCH if victim else 0,
                        hold_file=str(WORK / f"http-{tag}-m{i}.held"))
            spawn(f"m{i}", [sys.executable, str(ROOT / "chip_smoke.py"),
                            "--mesh-member", json.dumps(spec)],
                  stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        members = []
        for i in range(n):
            line = procs[f"m{i}"].stdout.readline()
            if not line:
                raise AssertionError(
                    f"member m{i} died before it was ready "
                    f"({OUT / f'http-{tag}-m{i}.log'})")
            members.append(json.loads(line))
        marks = {"members ready": time.perf_counter()}
        _wait_for("the coordinator answering", lambda: coord.poll() is None
                  and _http_ok(port))
        marks["coordinator answering"] = time.perf_counter()
        ends = members[0]["ends"]
        if any(m["ends"] != ends for m in members) or sum(ends) != flows_n:
            raise AssertionError("member processes built different buses")
        t_go = time.perf_counter()
        for i in range(n):
            procs[f"m{i}"].stdin.write("go\n")
            procs[f"m{i}"].stdin.flush()
        health = _wait_for("every member joining", lambda: (
            lambda h: h if h["members"] == n else None)(
                json.loads(_http(port, "/healthz")[1])))
        churned = {}
        if churn:
            held = WORK / f"http-{tag}-m{HTTP_CHURN_VICTIM}.held"
            _wait_for("the victim holding mid-stream", held.exists,
                      poll=0.01)
            victim = procs[f"m{HTTP_CHURN_VICTIM}"]
            victim.send_signal(signal.SIGKILL)
            victim.wait(timeout=60)
            t_kill = time.perf_counter()
            churned["victim_flows"] = int(held.read_text())

            def fenced():
                st = json.loads(_http(port, "/state")[1])
                return not st["members"][f"m{HTTP_CHURN_VICTIM}"]["alive"]

            _wait_for("the heartbeat expiry fencing the victim", fenced)
            churned["fence_s"] = time.perf_counter() - t_kill
        live = [i for i in range(n)
                if not (churn and i == HTTP_CHURN_VICTIM)]

        def drained():
            st = json.loads(_http(port, "/state")[1])
            owned = sum(len(m["owned"]) for m in st["members"].values()
                        if m["alive"])
            return st if st["covered"] == ends and owned == partitions \
                else None

        state = _wait_for("the frontier reaching the stream's end",
                          drained)
        t_drained = time.perf_counter()
        # the members drained and idle, before they finalize
        vals = cli._parse_processor(["-device", "cpu", *flags[2:]])
        spec = next(s for s in spec_from_models(cli._build_models(
            vals, torch.device("cpu"))) if s.name == "top_talkers")
        topk = _http_topk_fold(port, [members[i] for i in live], spec)
        trace = json.loads(_http(port, "/debug/trace")[1])
        lanes = _lanes_monotone(trace, t_spawn - 1.0, time.time() + 1.0)
        want_lanes = {"coordinator", *(f"m{i}" for i in live)}
        if set(lanes) != want_lanes or not all(lanes.values()):
            raise AssertionError(f"/debug/trace lanes {lanes}, want "
                                 f"{sorted(want_lanes)}")
        offsets = {lane["name"]: lane["clock_offset_ms"]
                   for lane in trace["otherData"]["lanes"]}
        for i in live:
            procs[f"m{i}"].send_signal(signal.SIGINT)
        finals = []
        for i in live:
            out, _ = procs[f"m{i}"].communicate(timeout=HTTP_DEADLINE)
            if procs[f"m{i}"].returncode != 0:
                raise AssertionError(f"member m{i} exited "
                                     f"{procs[f'm{i}'].returncode}")
            finals.append(json.loads(out.strip().splitlines()[-1]))
        marks["members finalized"] = time.perf_counter()

        def merged():
            st = json.loads(_http(port, "/state")[1])
            return st if all(st["final"]) and not st["pending_windows"] \
                else None

        _wait_for("every window merging", merged)
        t_merged = time.perf_counter()
        metrics = _samples(_http(mport, "/metrics")[1].decode())
        merges = sum(v for k, v in metrics.items()
                     if k.startswith("mesh_merge_seconds_count"))
        merge_s = sum(v for k, v in metrics.items()
                      if k.startswith("mesh_merge_seconds_sum"))
        deaths = sum(v for k, v in metrics.items()
                     if k.startswith("mesh_rebalance_total")
                     and 'reason="death"' in k)
        # the lineage entry twice at once (its summary, its raw records)
        # while the merged tables are checked
        queries = {extra: subprocess.Popen(
            [sys.executable, "-m", "flow_pipeline_tpu_torch.cli", "lineage",
             "-mesh.coordinator", url, *extra], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for extra in ((), ("-lineage.raw",))}
        t_checks = time.perf_counter()
        checked = check(_sqlite_tables(db))
        checked["checks_s"] = time.perf_counter() - t_checks
        lineage = {}
        for extra, proc in queries.items():
            out, err = proc.communicate(timeout=120)
            if proc.returncode != 0:
                raise AssertionError(f"lineage: {err[-2000:]}")
            lineage[extra] = out
        marks["lineage"] = time.perf_counter()
        records = json.loads(_http(port, "/debug/lineage")[1])
        heads = [line for line in lineage[()].splitlines()
                 if " @ " in line and not line.startswith(" ")]
        if json.loads(lineage[("-lineage.raw",)]) != records or \
                len(heads) != len(records) or \
                any(r["status"] != "merged" for r in records) or \
                not all("[merged]" in h for h in heads):
            raise AssertionError("lineage: the summary lines or the raw "
                                 "records differ from /debug/lineage")
        coord.send_signal(signal.SIGINT)
        if coord.wait(timeout=120) != 0:
            raise AssertionError(f"coordinator exited {coord.returncode} "
                                 "on SIGINT")
        marks["coordinator exited"] = time.perf_counter()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
    # every fence the coordinator logged, with its reason: the churn
    # victim's heartbeat expiry, and any member that missed a beat
    fenced = re.findall(r"mesh member (\S+) fenced \((\w+)\)", (
        OUT / f"http-{tag}-coordinator.log").read_text())
    launches = sum(f["launches"]["cms_add_conservative"] for f in finals)
    updates = sum(f["chunk_updates"]["cms_add_conservative"]
                  for f in finals)
    if launches_gate and not churn and (
            launches != updates or not launches or
            any(f["launches"]["cms_add"] for f in finals)):
        raise AssertionError(f"mesh over HTTP N={n}: {launches} "
                             f"conservative launches != {updates} CMS "
                             "updates")
    run_s = t_drained - t_go
    marks.update({"go": t_go, "drained": t_drained, "merged": t_merged})
    timeline = {k: round(v - t0, 3) for k, v in sorted(
        marks.items(), key=lambda kv: kv[1])}
    out = dict(n=n, flows=flows_n, partitions=partitions, run_s=run_s,
               flows_per_s=flows_n / run_s, merge_tail_s=t_merged -
               t_drained, with_setup_s=t_merged - t0,
               launches=launches, chunk_updates=updates,
               members=[dict(id=m["ready"], setup_s=m["setup_s"]) for m in
                        members],
               finals=finals, merges=merges, merge_s=merge_s,
               deaths=deaths, fenced=fenced, healthz=health,
               epoch=state.get("epoch"),
               trace_lanes=lanes, clock_offsets_ms=offsets,
               lineage_windows=len(records), topk=topk, timeline=timeline,
               **checked,
               **churned)
    for f in finals:
        f["flows_per_s"] = f["flows"] / f["step_s"] if f["step_s"] else 0.0
    return out


def _http_ok(port: int) -> bool:
    try:
        return _http(port, "/healthz")[0] == 200
    except OSError:
        return False


def http_mesh_phase(torch, smi: str, single: dict, inproc: dict,
                    device: str = "cuda") -> dict:
    """Phase 19: the mesh over HTTP, one process per member. ``single``:
    phase 15's single-worker tables; ``inproc``: phase 18's in-process
    N = 2 run, the same stream in the same call."""
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    gen = FlowGenerator(ZipfProfile(), seed=SEED, rate=PIPE_RATE)
    whole = FlowBatch.concat([gen.batch(8192)
                              for _ in range(PIPE_FLOWS // 8192)])
    want = _folded_flows_5m(single["flows_5m"])
    single_windows = sorted(int(t["timeslot"][0])
                            for t in single["top_talkers"])
    runs = {}

    def checks(tag, part):
        def check(tables):
            groups = check_flows_5m(part, [tables["flows_5m"]])
            if part is whole and \
                    _folded_flows_5m([tables["flows_5m"]]) != want:
                raise AssertionError(f"mesh over HTTP {tag}: flows_5m "
                                     "differs from the single worker's")
            times = part.columns["time_received"].astype(np.int64)
            windows = sorted(set((times - times % 300).tolist()))
            if part is whole and windows != single_windows:
                raise AssertionError("mesh over HTTP: the single worker's "
                                     "top_talkers windows differ")
            return dict(flows_5m_rows=groups,
                        top_talkers=_check_http_talkers(
                            part, tables["top_talkers"], windows))
        return check

    for tag, n, churn, part in (("2", 2, False, whole),
                                ("churn", 3, True, whole)):
        run = _http_run(tag, n, len(part), churn, device, checks(tag, part),
                        launches_gate=device == "cuda")
        groups = run["flows_5m_rows"]
        runs[tag] = run
        per = ", ".join(f"{f['final']} {f['flows']:.0f} flows "
                        f"{f['flows_per_s']:.0f}/s peak "
                        f"{f.get('peak_bytes', 0)} B"
                        for f in run["finals"])
        extra = ""
        if churn:
            extra = (f"; member m{HTTP_CHURN_VICTIM} SIGKILLed after "
                     f"{run['victim_flows']} flows, fenced by the heartbeat "
                     f"expiry {run['fence_s']:.2f} s later, its partitions "
                     "rebalanced")
        else:
            extra = (f"; {run['launches']} conservative launches = "
                     f"{run['chunk_updates']} CMS updates summed over the "
                     "member processes")
        topk = run["topk"]
        extra += (f"; /topk ({topk['topk_ms']:.1f} ms, {topk['rows']} rows)"
                  + (f" not compared: {topk['skipped']}"
                     if topk.get("skipped") else
                     f" == the host fold of {topk['members_folded']} "
                     "members' /meshstate"))
        log(f"mesh over HTTP {tag} (processor -mesh.role coordinator, {n} "
            f"member processes, {run['flows']} flows over "
            f"{run['partitions']} partitions): flows_5m {groups} rows equal "
            f"the oracle{' and the single worker' if part is whole else ''}"
            f"; top_talkers {run['top_talkers']}; /healthz "
            f"{run['healthz']['members']} members; /debug/trace lanes "
            f"{run['trace_lanes']} (offsets ms {run['clock_offsets_ms']}), "
            f"monotone; lineage {run['lineage_windows']} merged windows == "
            f"/debug/lineage; coordinator exit 0 on SIGINT; "
            f"{run['flows_per_s']:.0f} flows/s ({run['run_s']:.2f} s; "
            f"{run['merges']:.0f} merges in {run['merge_s']:.3f} s, "
            f"{run['deaths']:.0f} death rebalances, fenced "
            f"{run['fenced']}); members: {per}; seconds since the "
            f"coordinator's spawn {run['timeline']}, the checks "
            f"{run['checks_s']:.1f}"
            f"{extra} [{smi}]")
    log(f"mesh over HTTP N=2 {runs['2']['flows_per_s']:.0f} flows/s against "
        f"phase 18's in-process N=2 {inproc['flows_per_s']:.0f} in this call "
        f"(no claim) [{smi}]")
    return dict(runs=runs, inproc_n2_flows_per_s=inproc["flows_per_s"])


# ---- phase 20 ---------------------------------------------------------------

SHARD_COUNTS = (4, 1, 2)  # the gate run first, then the others in turn
SHARD_FLOWS = PIPE_FLOWS // 2  # the first half of phase 15's stream
SHARD_GEN = ["-produce.count", str(SHARD_FLOWS), "-produce.profile", "zipf",
             "-produce.rate", str(PIPE_RATE), "-produce.seed", str(SEED)]
SHARD_RANKS = 2  # processes of the torch.distributed run
SHARD_RANK_N = 4  # its shards: two in each process
SHARD_COLS = ("time_received", "src_as", "dst_as", "etype", "bytes",
              "packets", "sampling_rate", "src_addr", "dst_addr",
              "src_port", "dst_port", "proto")


def _shard_stream():
    """The first SHARD_FLOWS flows of phase 15's stream, drawn as the
    pipeline and the mocker draw it (batches of 8192)."""
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    gen = FlowGenerator(ZipfProfile(), seed=SEED, rate=PIPE_RATE)
    return FlowBatch.concat([gen.batch(8192)
                             for _ in range(SHARD_FLOWS // 8192)])


def _rank_configs():
    """The MultihostPipeline of a rank: flows_5m and the three
    heavy-hitter families at the processor's defaults."""
    from flow_pipeline_tpu_torch.models import (HeavyHitterConfig,
                                                WindowAggConfig)

    return WindowAggConfig(batch_size=BATCH), {
        name: HeavyHitterConfig(key_cols=keys, batch_size=BATCH,
                                width=WIDTH)
        for name, keys in FAMILIES.items()}


def shard_rank(spec: dict) -> int:
    """One process of the torch.distributed run (``chip_smoke.py
    --shard-rank SPEC``): joins the gloo process group on the card, holds
    its two of the four shards of a MultihostPipeline, feeds its half of
    every global batch of the stream (its partitions), force-flushes (the
    merge's collectives) and writes its rows as JSON."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke rank: no CUDA device")
    from flow_pipeline_tpu_torch import kernels
    from flow_pipeline_tpu_torch.ops import cms_cuda
    from flow_pipeline_tpu_torch.parallel import make_mesh
    from flow_pipeline_tpu_torch.parallel import multihost

    if kernels.build().seconds:  # phase 2 built the library
        raise AssertionError("a rank process built the kernels")
    rank, world = spec["rank"], spec["world"]
    multihost.init_distributed(f"127.0.0.1:{spec['port']}", world, rank,
                               backend="gloo", device="cuda:0",
                               timeout=300)
    mesh = make_mesh(spec["n"])
    wagg, hh = _rank_configs()
    pipe = multihost.MultihostPipeline(mesh, wagg, hh, k=100)
    flows = _shard_stream()
    gb = BATCH * spec["n"]
    half = gb // world
    for name in cms_cuda.LAUNCHES:
        cms_cuda.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, len(flows), gb):
        padded, mask = flows.slice(start, start + gb).pad_to(gb)
        cols = padded.device_columns(SHARD_COLS)
        mine = slice(rank * half, (rank + 1) * half)
        wm = int(flows.columns["time_received"][start:start + gb].max())
        pipe.update({k: v[mine] for k, v in cols.items()}, mask[mine], wm)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows = pipe.flush(force=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    devices = sorted({str(t.device) for m in pipe.hh.values()
                      for s in m.states for t in s})
    out = dict(rank=rank, backend=multihost.backend(),
               launches=dict(cms_cuda.LAUNCHES),
               chunk_updates=sum(m.chunk_updates for m in pipe.hh.values()),
               local_shards=len(mesh.devices), state_devices=devices,
               update_s=t1 - t0, flush_s=t2 - t1,
               rows={t: {k: np.asarray(v).tolist() for k, v in r.items()}
                     for t, r in rows.items()})
    Path(spec["out"]).write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    print("SHARD_RANK_OK", rank, flush=True)
    return 0


def _rank_run(torch, flows) -> dict:
    """SHARD_RANKS processes of shard_rank on the card; their rows against
    the oracle, each other and one process's sharded models."""
    from flow_pipeline_tpu_torch.parallel import ShardedHeavyHitter, make_mesh

    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(SHARD_RANKS):
        spec = dict(rank=rank, world=SHARD_RANKS, port=port, n=SHARD_RANK_N,
                    out=str(WORK / f"shard-rank{rank}.json"))
        logs.append(open(OUT / f"shard-rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--shard-rank",
             json.dumps(spec)], cwd=ROOT, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    try:
        for rank, p in enumerate(procs):
            if p.wait(timeout=300) != 0:
                raise AssertionError(f"rank {rank} exited {p.returncode}; "
                                     f"see {OUT / f'shard-rank{rank}.log'}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    outs = [json.loads((WORK / f"shard-rank{r}.json").read_text())
            for r in range(SHARD_RANKS)]
    backends = {o["backend"] for o in outs}
    if backends != {"gloo"}:
        raise AssertionError(f"ranks ran {backends}")
    for o in outs:
        if o["state_devices"] != ["cuda:0"] or o["local_shards"] != \
                SHARD_RANK_N // SHARD_RANKS:
            raise AssertionError(f"rank {o['rank']}: shards "
                                 f"{o['local_shards']} on "
                                 f"{o['state_devices']}")
        if o["launches"] != {"cms_add": 0,
                             "cms_add_conservative": o["chunk_updates"]}:
            raise AssertionError(f"rank {o['rank']}: launches "
                                 f"{o['launches']}, chunk updates "
                                 f"{o['chunk_updates']}")
    f5 = [{k: np.asarray(v) for k, v in o["rows"]["flows_5m"].items()}
          for o in outs]
    groups = check_flows_5m(flows, f5)
    for name in FAMILIES:
        if any(o["rows"][name] != outs[0]["rows"][name] for o in outs):
            raise AssertionError(f"{name}: the ranks' merged rows differ")
    # one process's sharded models at the same N over the same batches
    wagg_cfg, hh_cfgs = _rank_configs()
    mesh = make_mesh(SHARD_RANK_N, devices="cuda")
    one = {name: ShardedHeavyHitter(cfg, mesh)
           for name, cfg in hh_cfgs.items()}
    for m in one.values():
        m.update(flows)
    for name, m in one.items():
        want = m.top(100)
        got = {k: np.asarray(v) for k, v in outs[0]["rows"][name].items()}
        for col in (*FAMILIES[name], "valid"):
            if not np.array_equal(got[col], want[col]):
                raise AssertionError(f"{name}: {col} of the ranks differs "
                                     "from one process's sharded model")
        for col in ("bytes", "packets", "count", "bytes_est",
                    "packets_est", "count_est"):
            np.testing.assert_allclose(got[col], want[col], rtol=F32_RTOL,
                                       atol=0, err_msg=f"{name} {col}")
    return dict(wall_s=wall, flows_5m_rows=groups,
                backend=outs[0]["backend"],
                launches=sum(o["launches"]["cms_add_conservative"]
                             for o in outs),
                update_s=[o["update_s"] for o in outs],
                flush_s=[o["flush_s"] for o in outs])


class _MergeClock:
    """Synchronised ms of every shard merge while installed: the
    heavy-hitter families' merged_state, the port tables'
    _merged_totals, the DDoS detector's merged_state."""

    def __init__(self, torch):
        from flow_pipeline_tpu_torch.parallel import sharded

        self.torch = torch
        self.ms = {"hh": [], "dense": [], "ddos": []}
        self._orig = []
        for kind, cls, attr in (
                ("hh", sharded.ShardedHeavyHitter, "merged_state"),
                ("dense", sharded.ShardedDenseTopK, "_merged_totals"),
                ("ddos", sharded.ShardedDDoSDetector, "merged_state")):
            fn = getattr(cls, attr)
            self._orig.append((cls, attr, fn))
            setattr(cls, attr, self._timed(kind, fn))

    def _timed(self, kind, fn):
        def call(model, *args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(model, *args, **kw)
            self.torch.cuda.synchronize()
            self.ms[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def mark(self) -> dict:
        return {k: len(v) for k, v in self.ms.items()}

    def since(self, mark: dict) -> dict:
        return {k: self.ms[k][mark[k]:] for k in self.ms}

    def close(self) -> None:
        for cls, attr, fn in self._orig:
            setattr(cls, attr, fn)


def _launch_streams(torch):
    """(set of (device, stream) every CMS launch went to, restore)."""
    from flow_pipeline_tpu_torch.ops import cms_cuda

    launch = cms_cuda._launch
    seen: set = set()

    def recorded(name, counts, *args):
        seen.add((str(counts.device),
                  torch.cuda.current_stream(counts.device).cuda_stream))
        return launch(name, counts, *args)

    cms_cuda._launch = recorded
    return seen, lambda: setattr(cms_cuda, "_launch", launch)


def _shard_state_devices(worker) -> set:
    """The device of every shard tensor of the worker's sharded models."""
    devs = set()
    for m in worker.models.values():
        inner = getattr(m, "model", m)
        for state in (getattr(inner, "states", None) or
                      getattr(inner, "shard_totals", None) or []):
            tensors = state if isinstance(state, tuple) else (state,)
            devs.update(str(t.device) for t in tensors)
    return devs


def sharding_phase(torch, smi: str) -> dict:
    """Phase 20: processor -processor.mesh N at defaults over the first
    half of phase 15's stream: N = 4 (the gates, and a CPU run of the
    same flags), then 1 and 2, beside the single-worker per-model run;
    then two torch.distributed processes (gloo) on the card."""
    import gc

    from flow_pipeline_tpu_torch import cli

    frames = WORK / "sharded.bin"
    assert cli.main(["mocker", "-out", str(frames), *SHARD_GEN,
                     "-produce.batch", "8192"]) == 0
    flows = _shard_stream()
    times = flows.columns["time_received"].astype(np.int64)
    _, chunks, _ = accepted_windows(times, BATCH)
    (single,) = run_main_path(torch, frames, "per-model", devices=("cuda",),
                              tag="shard-")
    want = _folded_flows_5m(single["rows"]["flows_5m"])
    check_flows_5m(flows, single["rows"]["flows_5m"])
    runs = {}
    clock = _MergeClock(torch)
    streams, restore = _launch_streams(torch)
    try:
        for n in SHARD_COUNTS:
            mesh = ("-processor.mesh", str(n))
            run = w = None  # the previous run's models, freed first
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            mark = clock.mark()
            streams.clear()
            (run,) = run_main_path(torch, frames, "mesh", devices=("cuda",),
                                   extra=mesh, tag="shard-")
            w = run["worker"]
            merges = clock.since(mark)
            peak = torch.cuda.max_memory_allocated() - base
            groups = check_flows_5m(flows, run["rows"]["flows_5m"])
            if _folded_flows_5m(run["rows"]["flows_5m"]) != want:
                raise AssertionError(f"mesh {n}: flows_5m differs from the "
                                     "single worker's")
            if w.chunk_updates != len(FAMILIES) * n * chunks or \
                    run["launches"] != {"cms_add": 0,
                                        "cms_add_conservative":
                                        w.chunk_updates}:
                raise AssertionError(
                    f"mesh {n}: launches {run['launches']}, CMS updates "
                    f"{w.chunk_updates}, replayed {len(FAMILIES) * n} x "
                    f"{chunks} chunks")
            if _shard_state_devices(w) != {"cuda:0"} or streams != {
                    ("cuda:0", torch.cuda.default_stream(0).cuda_stream)}:
                raise AssertionError(f"mesh {n}: shard state on "
                                     f"{_shard_state_devices(w)}, launches "
                                     f"on {streams}")
            runs[str(n)] = dict(
                n=n, flows_per_s=SHARD_FLOWS / run["wall"], wall_s=run["wall"],
                launches=run["launches"]["cms_add_conservative"],
                chunk_updates=w.chunk_updates, batches=w.batches_seen,
                launches_per_batch=run["launches"]["cms_add_conservative"]
                / w.batches_seen,
                merge_ms={k: float(np.sum(v)) for k, v in merges.items()},
                merges={k: len(v) for k, v in merges.items()},
                hh_merge_ms_mean=float(np.mean(merges["hh"]))
                if merges["hh"] else float("nan"),
                peak_bytes=peak, base_bytes=base, flows_5m_rows=groups,
                rows=run["rows"])
            log(f"processor -processor.mesh {n} (defaults, {SHARD_FLOWS} "
                f"flows): flows_5m {groups} rows equal the oracle and the "
                f"single worker's; {run['launches']['cms_add_conservative']}"
                f" conservative launches = {w.chunk_updates} CMS updates "
                f"({len(FAMILIES)} families x {n} shards x {chunks} chunks),"
                f" {runs[str(n)]['launches_per_batch']:.1f} per global batch"
                f"; every shard's state on cuda:0, launched on the default "
                f"stream; {runs[str(n)]['flows_per_s']:.0f} flows/s "
                f"({run['wall']:.2f} s); merges: "
                + ", ".join(f"{k} {len(v)} in {np.sum(v):.1f} ms"
                            for k, v in merges.items())
                + f"; peak card memory {peak} B above the {base} B "
                f"allocated before the run [{smi}]")
    finally:
        restore()
        clock.close()
    gate = runs["4"]["rows"]
    (cpu,) = run_main_path(torch, frames, "mesh", devices=("cpu",),
                           extra=("-processor.mesh", "4"), tag="shard-")
    compare_runs(gate, cpu["rows"])
    for name in FAMILIES:
        for rows in gate[name]:
            v = rows["valid"]
            for col in ("bytes", "packets", "count"):
                if (rows[f"{col}_est"][v].astype(np.float64) <
                        rows[col][v].astype(np.float64) * (1 - F32_RTOL)
                        ).any():
                    raise AssertionError(f"mesh 4 {name}: {col}_est < "
                                         f"{col}")
    log(f"processor -processor.mesh 4: card rows equal the CPU run's "
        f"(flows_5m, port tables, "
        f"{sum(len(a) for a in gate.get('ddos_alerts', []))}"
        f" DDoS alerts identical; heavy-hitter keys and ranks equal, values "
        f"within rtol {F32_RTOL}); every heavy-hitter row's estimates bound "
        f"its values (within rtol {F32_RTOL})")
    ranks = _rank_run(torch, flows)
    log(f"two processes over torch.distributed (backend "
        f"{ranks['backend']}, {SHARD_RANK_N} shards, two in each, all on "
        f"cuda:0): merged flows_5m {ranks['flows_5m_rows']} rows equal the "
        f"oracle; the top-K rows of every family identical on both ranks "
        f"and equal to one process's ShardedHeavyHitter at N = "
        f"{SHARD_RANK_N} (keys and ranks; values within rtol {F32_RTOL}); "
        f"{ranks['launches']} conservative launches = CMS updates over the "
        f"ranks; update s {', '.join(f'{x:.2f}' for x in ranks['update_s'])}"
        f", flush (the merge's collectives) s "
        f"{', '.join(f'{x:.2f}' for x in ranks['flush_s'])}; "
        f"{ranks['wall_s']:.1f} s with the processes' start [{smi}]")
    log("flows/s by shards (-processor.mesh N, one card, defaults): "
        + ", ".join(f"N={n} {runs[str(n)]['flows_per_s']:.0f}"
                    for n in sorted(SHARD_COUNTS))
        + f"; the single worker per-model "
        f"{SHARD_FLOWS / single['wall']:.0f} [{smi}]")
    for r in runs.values():
        r.pop("rows")
    return dict(runs=runs, single_flows_per_s=SHARD_FLOWS / single["wall"],
                cpu_wall_s=cpu["wall"], ranks=ranks, chunks=chunks)


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
        (gpu,) = run_main_path(torch, frames, "fused", devices=("cuda",),
                               scrape=True)
        checks = _check_main_run(gpu, flows, windows, steps,
                                 "fused path (card)")
        scrape = check_scrape(gpu)
        # the CPU leg over the first HEAD_FLOWS flows, against the card
        _, _, head_steps = accepted_windows(times[:HEAD_FLOWS], BATCH)
        head = head_frames(frames, HEAD_FLOWS)
        gpu_head, cpu = run_main_path(torch, head, "fused", tag="head-")
        for run in (gpu_head, cpu):
            _check_launches(f"fused path, first {HEAD_FLOWS} flows "
                            f"({run['device']})", run,
                            "cms_add_conservative", head_steps)
        compare_runs(gpu_head["rows"], cpu["rows"])
        runs = (gpu, cpu)
    n_alerts = sum(len(a) for a in gpu["rows"].get("ddos_alerts", []))
    max_rate = max_ddos_rate(flows)
    if max_rate >= INT_ENVELOPE:
        raise AssertionError(f"DDoS rates left the 2^24 envelope: "
                             f"{max_rate}")
    n_head = sum(len(a) for a in gpu_head["rows"].get("ddos_alerts", []))
    log(f"fused: over the first {HEAD_FLOWS} flows the card run equals the "
        f"CPU run: flows_5m, port tables and {n_head} DDoS alerts "
        "identical; heavy-hitter keys and ranks equal, values within rtol "
        f"1e-6; largest DDoS bucket rate {max_rate:.0f} < 2^24")

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
    for path in ("per-model", "fused"):
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
    with phase("13 host sketch"):
        hostsketch = hostsketch_phase(torch, frames, flows, windows, gpu,
                                      smi)
    with phase("14 audit"):
        audit = audit_phase(torch, frames, flows, windows, smi)
    with phase("15 pipeline and query"):
        pipeline = pipeline_phase(torch, smi)
    with phase("16 feed and collector"):
        feed = feed_phase(torch, frames, gpu, smi)
        collector = collector_phase(torch, smi)
    single = pipeline.pop("tables")
    with phase("17 gateway, history and guard"):
        tiers = tiers_phase(torch, smi, single)
        guard = guard_phase(torch, frames, smi)
    with phase("18 mesh"):
        mesh = mesh_phase(torch, smi, single)
    with phase("19 mesh over HTTP"):
        http_mesh = http_mesh_phase(torch, smi, single, mesh["runs"]["2"])
    with phase("20 device sharding"):
        sharding = sharding_phase(torch, smi)
    return dict(sharding=sharding,
        hostgroup=hostgroup, spread=spread, hostsketch=hostsketch,
        audit=audit, pipeline=pipeline, feed=feed, collector=collector,
        tiers=tiers, guard=guard, mesh=mesh, http_mesh=http_mesh,
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # internal: phase 19 re-invokes this script as one mesh member
    parser.add_argument("--mesh-member", metavar="SPEC",
                        help=argparse.SUPPRESS)
    # internal: phase 20 re-invokes this script as one rank
    parser.add_argument("--shard-rank", metavar="SPEC",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.mesh_member:
        return http_member(json.loads(args.mesh_member))
    if args.shard_rank:
        return shard_rank(json.loads(args.shard_rank))
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
    # the host sketch backend folds the heavy hitters on the host: neither
    # kernel launches there
    hs = path["hostsketch"]["launches"]
    for k in kernels:
        k["hostsketch_launches"] = hs[k["name"]]
    # the pipeline entry at CLI defaults (without and with the serving
    # tier) and the -listen.feed processor run the fused step: the
    # conservative kernel, launched per chunk
    cons["pipeline_launches"] = path["pipeline"]["plain_launches"]
    cons["serve_launches"] = path["pipeline"]["serve_launches"]
    cons["feed_launches"] = path["feed"]["launches"]
    # phase 17: the guarded pipeline held at level 0 (with the gateway and
    # the history tier on its serving tier) and at GUARD_LEVEL
    cons["guard_l0_launches"] = path["tiers"]["launches"]
    cons["guard_lk_launches"] = path["guard"]["pipeline_launches"]
    # phase 18: pipeline -mesh.workers N, every member's fused step
    cons["mesh_launches"] = {tag: run["launches"]
                             for tag, run in path["mesh"]["runs"].items()}
    # phase 19: the mesh over HTTP, summed over the member processes
    cons["http_mesh_launches"] = {
        tag: run["launches"]
        for tag, run in path["http_mesh"]["runs"].items()}
    # phase 20: processor -processor.mesh N, one launch per shard per
    # chunk; the two-process run summed over its ranks
    cons["sharded_launches"] = {
        tag: run["launches"]
        for tag, run in path["sharding"]["runs"].items()}
    cons["multiprocess_launches"] = path["sharding"]["ranks"]["launches"]
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
