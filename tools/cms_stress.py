#!/usr/bin/env python3
"""Stress the port's CMS kernels on one card, and the card's row-wise
``torch.unique`` that chip_smoke.py's test inputs once used.

    python3 tools/cms_stress.py [--checked 300] [--blasted 5000] [--unique 80]

- ``unique``: the device kernels of one ``torch.unique(dim=0)`` at phase
  3's shape (torch.profiler), then ``--unique`` rounds of the former
  card-side input generation (``torch.unique(dim=0)`` and ``randperm`` on
  the card at N = 32,768, Wk = 11 and 4, and N = 2^19, Wk = 11), each
  synchronised;
- ``kernels``: each wrapper (``cms_add_conservative``, ``cms_add``) at
  Wk = 11 and 4, at N = 32,768 (register route) and 2^19 (scratch
  route, a tenth of the calls): ``--checked`` calls, alternating the
  update and estimate forms, each held against the plain version with
  ``torch.equal`` (integer addends, the sketch reset every 50 calls so
  every cell stays inside 2^24), then ``--blasted`` unchecked calls,
  after which the keys, values and mask must be unchanged.

A fault kills the process; a mismatch exits 1. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools import cms_split  # noqa: E402

PLANES = cms_split.PLANES


def unique_kernels(torch) -> list[str]:
    """Device kernels of one card ``torch.unique(dim=0)`` at N = 32,768."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randint(0, 2**32, (cms_split.BATCH, 11), generator=gen,
                      device="cuda", dtype=torch.int64)
    torch.unique(x, dim=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.unique(x, dim=0)
        torch.cuda.synchronize()
    return [e.key[:100] for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]


def unique_rounds(torch, rounds: int) -> int:
    """The former card-side dedupe and shuffle; returns the calls made."""
    calls = 0
    for r in range(rounds):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(r)
        for n, wk in ((cms_split.BATCH, 11), (cms_split.BATCH, 4),
                      (1 << 19, 11)):
            keys = torch.unique(torch.randint(
                0, 2**32, (n, wk), generator=gen, device="cuda",
                dtype=torch.int64), dim=0)
            keys = keys[torch.randperm(keys.shape[0], generator=gen,
                                       device="cuda")]
            torch.cuda.synchronize()
            calls += 1
    return calls


def kernel_stress(torch, checked: int, blasted: int) -> dict:
    from flow_pipeline_tpu_torch.ops import cms as cms_ops
    from flow_pipeline_tpu_torch.ops import cms_cuda

    out = {}
    for name in ("cms_add_conservative", "cms_add"):
        fn = getattr(cms_cuda, name)
        plain_fn = getattr(cms_ops, name)
        for wk in (11, 4):
            for n, div in ((cms_split.BATCH, 1), (1 << 19, 10)):
                counts, keys, _, valid, _ = cms_split.inputs(
                    torch, wk, n=n, seed=wk + n)
                m = keys.shape[0]
                gen = torch.Generator(device="cuda")
                gen.manual_seed(wk + n)
                plain = counts.clone()
                for i in range(checked // div):
                    if i % 50 == 0:
                        plain.copy_(torch.randint(
                            0, 5000, counts.shape, generator=gen,
                            device="cuda").float())
                        counts.copy_(plain)
                    vals = torch.randint(0, 1500, (m, PLANES), generator=gen,
                                         device="cuda").float()
                    est_form = i % 2 == 1
                    got = fn(counts, keys, vals, valid,
                             with_estimate=est_form)
                    plain_fn(plain, keys, vals, valid)
                    ok = torch.equal(counts, plain)
                    if est_form:
                        ok = ok and torch.equal(
                            got[1], cms_ops.cms_query(plain, keys))
                    if not ok:
                        raise SystemExit(f"cms_stress: {name} Wk={wk} N={m} "
                                         f"call {i}: kernel != plain")
                before = (keys.clone(), vals.clone(), valid.clone())
                for i in range(blasted // div):
                    fn(counts, keys, vals, valid, with_estimate=i % 2 == 1)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b)
                           for a, b in zip(before, (keys, vals, valid))):
                    raise SystemExit(f"cms_stress: {name} Wk={wk} N={m}: an "
                                     "input changed")
                key = f"{name}/wk{wk}/n{m}"
                out[key] = dict(checked=checked // div,
                                blasted=blasted // div)
                print(f"{key}: {checked // div} calls equal to plain, "
                      f"{blasted // div} more, inputs intact", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checked", type=int, default=300)
    ap.add_argument("--blasted", type=int, default=5000)
    ap.add_argument("--unique", type=int, default=80)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cms_stress: needs a CUDA card")
    from flow_pipeline_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(force=True)
    out = dict(torch=torch.__version__,
               device=torch.cuda.get_device_name(0),
               build_s=time.perf_counter() - t0,
               unique_kernels=unique_kernels(torch))
    print("torch.unique(dim=0) on the card launches: "
          + "; ".join(out["unique_kernels"]), flush=True)
    out["unique_calls"] = unique_rounds(torch, args.unique)
    print(f"{out['unique_calls']} card unique+randperm calls ran", flush=True)
    out["kernels"] = kernel_stress(torch, args.checked, args.blasted)
    out["launches"] = sum(v["checked"] + v["blasted"]
                          for v in out["kernels"].values())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
