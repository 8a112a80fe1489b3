#!/usr/bin/env python3
"""What ``-serve.addr`` costs ``pipeline`` on the card: pairs in turns.

    python3 tools/serve_cost.py [--pairs 8]

Runs chip_smoke.py's phase-15 ``pipeline`` (1,048,576 Zipf flows at
2,000 flows/s, CLI defaults, the fused step, a sqlite sink) with and
without ``-serve.addr 127.0.0.1:0`` (refresh 2.0 s, no readers), the
order alternating from pair to pair (serve first, then plain first),
after one uncounted run that builds the kernels and warms the process.
Prints the card's name and power limit, each run's flows/s after
generation, its conservative launches (held equal to the chunk updates)
and, for the serve runs, the publishes and ms per publish with the
card-to-host capture apart; then the medians and the spread (max - min)
of each side. Needs one card: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "serve_cost"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=8)
    args = ap.parse_args()
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = chip_smoke.environment(torch)  # exits without a card
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    rates = {"serve": [], "plain": []}
    publish = []
    try:
        # the first run in the process builds the kernels (nvcc): uncounted
        chip_smoke._pipeline_run(torch, ["-sink", "", "-metrics.addr", ""])
        for i in range(args.pairs):
            order = ("serve", "plain") if i % 2 == 0 else ("plain", "serve")
            for tag in order:
                flags = ["-sink", f"sqlite:{WORK / f'{tag}{i}.db'}",
                         "-metrics.addr", ""]
                if tag == "serve":
                    flags += ["-serve.addr", "127.0.0.1:0"]
                worker, launches, gen_s, run_s = chip_smoke._pipeline_run(
                    torch, flags)
                if launches["cms_add_conservative"] != worker.chunk_updates:
                    raise AssertionError(f"{tag}: launches {launches}, "
                                         f"chunk updates "
                                         f"{worker.chunk_updates}")
                rate = chip_smoke.PIPE_FLOWS / run_s
                rates[tag].append(rate)
                line = (f"pair {i} {tag}: {rate:.0f} flows/s after "
                        f"generation ({gen_s:.2f} s generation), "
                        f"{launches['cms_add_conservative']} launches")
                if tag == "serve":
                    pub = worker.serve
                    ms = 1e3 * pub.publish_seconds / pub.publishes
                    cap = 1e3 * pub.capture_seconds / pub.publishes
                    publish.append((pub.publishes, ms, cap))
                    line += (f"; {pub.publishes} publishes, {ms:.3f} ms "
                             f"each ({cap:.3f} ms capture)")
                print(line, flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    summary = {tag: {"median": float(np.median(v)),
                     "spread": float(max(v) - min(v)), "runs": v}
               for tag, v in rates.items()}
    summary["cost_of_median"] = 1 - (summary["serve"]["median"]
                                     / summary["plain"]["median"])
    summary["publishes"] = publish
    print(f"-serve.addr: median {summary['serve']['median']:.0f} against "
          f"{summary['plain']['median']:.0f} flows/s without "
          f"({100 * summary['cost_of_median']:.1f} % less); spread "
          f"{summary['serve']['spread']:.0f} and "
          f"{summary['plain']['spread']:.0f} [{smi}]")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
