#!/usr/bin/env python3
"""Split the port's CMS kernel wrappers' time on one card: device time per
launch, host time per call, and the back-to-back figure.

    python3 tools/cms_split.py [--root DIR] [--tag NAME] [--device-path]

Imports ``flow_pipeline_tpu_torch`` from DIR (default: this checkout),
builds its kernels (printing ptxas's register, stack and spill lines),
and times the update-only form of each wrapper (``cms_add_conservative``,
``cms_add``) at the main path's shapes (N = 32,768 unique keys with a
forced row-0 collision, 80 % valid, P = 3, D = 4, W = 65,536) at
Wk = 11 and Wk = 4:

- ``device_us``: device time per wrapper call, from ``torch.profiler``
  ``key_averages()`` over the kernels the calls launched, and
  ``launches_per_call``: device kernels per wrapper call;
- ``device_us_events``: the same from CUDA events around calls queued
  behind ``torch.cuda._sleep``, so the host stays ahead of the card;
- ``host_us``: ``time.perf_counter`` over 1,000 calls, before one
  synchronise (the host's enqueue cost per call);
- ``b2b_ms``: the mean of 100 back-to-back calls between two CUDA events
  (the figure PRs 1-2 reported; whichever of host and card is slower
  sets it).

With ``--device-path`` it also times the processor's device path per
32,768-row batch (the full default model set over pre-decoded batches).
The inputs come from a seeded generator, so two trees timed in one call
on one card see the same data (run parent, change, change, parent).
Prints one JSON line; chip_smoke.py phase 3 reuses these functions.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

SEED = 0
BATCH = 32768
WIDTH = 1 << 16
DEPTH = 4
PLANES = 3
POOL = 1 << 22  # random keys searched for a forced bucket collision


def kernel_keys(torch, gen, n, wk, width=WIDTH):
    """n unique random key rows on the card, with a forced collision: the
    most crowded row-0 bucket of a 2^22-key pool contributes all its keys
    (about 64 keys sharing one cell)."""
    from flow_pipeline_tpu_torch.ops.cms import cms_buckets

    pool = torch.randint(0, 2**32, (max(POOL, n), wk), generator=gen,
                         device="cuda", dtype=torch.int64)
    b0 = cms_buckets(pool, 1, width)[0]
    crowded = torch.bincount(b0, minlength=width).argmax()
    forced = pool[b0 == crowded]
    keys = torch.cat([forced, pool[: n - forced.shape[0]]])
    return unique_rows(torch, keys, gen), int(forced.shape[0])


def unique_rows(torch, rows, gen, shuffle=True):
    """The distinct rows of a [N, Wk] key tensor on the card, in a seeded
    random order (or sorted, without ``shuffle``). The deduplication and
    the permutation run on the host, over a few MB, so the card's part of
    input generation is elementwise hashing, a histogram and a mask. The
    card's ``torch.unique(dim=0)`` (torch 2.11: a cub merge sort with a
    row comparator, then a gather by the sorted indices) faulted once in
    an H100 run of chip_smoke.py, with that gather's index-out-of-bounds
    assert and an illegal address, and did not recur in 240 later calls;
    the port itself never calls it."""
    host = torch.unique(rows.cpu(), dim=0)
    if shuffle:
        seed = int(torch.randint(0, 2**62, (1,), generator=gen,
                                 device=gen.device).item())
        host = host[torch.randperm(host.shape[0],
                                   generator=torch.Generator().manual_seed(
                                       seed))]
    return host.to(rows.device).contiguous()


def inputs(torch, wk, n=BATCH, seed=SEED):
    """A sketch pre-filled by an earlier update, unique keys with a forced
    collision, 80 % valid rows and real-valued addends."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    counts = torch.randint(0, 5000, (PLANES, DEPTH, WIDTH), generator=gen,
                           device="cuda").float()
    keys, n_forced = kernel_keys(torch, gen, n, wk)
    m = keys.shape[0]
    valid = torch.rand(m, generator=gen, device="cuda") < 0.8
    vals = torch.rand((m, PLANES), generator=gen, device="cuda") * 1e4
    return counts, keys, vals, valid, n_forced


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


def host_us(torch, fn, calls=1000) -> float:
    """Host µs per call: the loop's wall time before the synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def device_us_events(torch, fn, calls=200) -> float:
    """Device µs per call: the calls are queued behind a sleeping kernel,
    so the events time the card's work alone, not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clocks
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def profile_kernels(torch, fn, calls=100, match=None) -> dict:
    """Device kernels launched by ``calls`` calls, from torch.profiler:
    device µs per call (over the kernels whose name contains ``match``,
    or all) and device launches per call (all kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")]

    def dev_time(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    sel = [e for e in dev if match is None or match in e.key]
    return dict(
        device_us=sum(dev_time(e) for e in sel) / calls,
        launches_per_call=sum(e.count for e in dev) / calls,
        kernels={e.key[:120]: e.count / calls for e in dev})


def split(torch, fn) -> dict:
    """The four figures of one wrapper call form."""
    prof = profile_kernels(torch, fn, match="fpt_")
    return dict(device_us=prof["device_us"],
                device_us_events=device_us_events(torch, fn),
                launches_per_call=prof["launches_per_call"],
                kernels=prof["kernels"],
                host_us=host_us(torch, fn),
                b2b_ms=time_cuda(torch, fn))


class _Batches:
    """A consumer over decoded batches (the device path excludes decode)."""

    def __init__(self, batches):
        self._it = iter(batches)

    def poll(self, max_messages):
        return next(self._it, None)

    def commit(self, partition, next_offset):
        pass


def device_path(torch, n_flows=262_144, rounds=3, device="cuda") -> dict:
    """ms per 32,768-row batch of the device path: the processor's full
    default model set at CLI defaults (-processor.fused=false), one
    StreamWorker step per pre-decoded batch of the seeded Zipf stream
    chip_smoke.py drives, synchronised per batch. Each round is a fresh
    worker over every batch; the first round warms up and is dropped."""
    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine import StreamWorker
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    gen = FlowGenerator(ZipfProfile(), seed=SEED, rate=500.0)
    flows = FlowBatch.concat([gen.batch(4096)
                              for _ in range(n_flows // 4096)])
    batches = [flows.slice(s, s + BATCH) for s in range(0, n_flows, BATCH)]
    vals = cli._processor_flags(cli._common_flags(
        cli.FlagSet("processor"))).parse(
        ["-in", "unused", "-processor.fused=false"])
    # the per-model path, polled inline; trees from before the fused
    # engine take neither keyword and have only that path
    extra = ({"fused": False, "prefetch": 0}
             if "fused" in inspect.signature(StreamWorker).parameters
             else {})
    times = []
    for _ in range(rounds):
        worker = StreamWorker(_Batches(batches),
                              cli._build_models(vals, device),
                              poll_max=BATCH, **extra)
        got = []
        for _ in batches:
            t0 = time.perf_counter()
            worker.run_once()
            if device == "cuda":
                torch.cuda.synchronize()
            got.append((time.perf_counter() - t0) * 1e3)
        times.append(got)
    steady = [t for r in times[1:] for t in r]
    return dict(batch_ms_mean=sum(steady) / len(steady), batch_ms=steady)


def ptxas_lines(log: str) -> list[str]:
    """ptxas's per-kernel lines: the function, then registers, stack frame
    and spills."""
    keep = ("Compiling entry", "Function properties", "bytes stack frame",
            "Used")
    return [ln.strip() for ln in log.splitlines()
            if "ptxas info" in ln and any(k in ln for k in keep)
            or "spill" in ln]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="tree whose flow_pipeline_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="label for the JSON line")
    ap.add_argument("--device-path", action="store_true",
                    help="also time the processor's device path per batch")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cms_split: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from flow_pipeline_tpu_torch import kernels
    from flow_pipeline_tpu_torch.ops import cms_cuda

    info = kernels.build(force=True)
    for line in ptxas_lines(info.log):
        print("  " + line, flush=True)
    out = dict(tag=args.tag, root=args.root, build_s=info.seconds,
               device=torch.cuda.get_device_name(0), kernels={})
    for name in ("cms_add_conservative", "cms_add"):
        wrapper = getattr(cms_cuda, name)
        for wk in (11, 4):
            counts, keys, vals, valid, _ = inputs(torch, wk)
            res = split(torch, lambda: wrapper(counts, keys, vals, valid))
            out["kernels"][f"{name}/wk{wk}"] = res
            print(f"{args.tag} {name} Wk={wk}: device "
                  f"{res['device_us']:.2f} us (events "
                  f"{res['device_us_events']:.2f}), "
                  f"{res['launches_per_call']:.2f} launches/call, host "
                  f"{res['host_us']:.2f} us, back-to-back "
                  f"{res['b2b_ms'] * 1e3:.2f} us", flush=True)
    if args.device_path:
        out["device_path"] = device_path(torch)
        print(f"{args.tag} device path: "
              f"{out['device_path']['batch_ms_mean']:.3f} ms per {BATCH}-row "
              "batch (full default model set)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
