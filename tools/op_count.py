#!/usr/bin/env python3
"""Count the torch ops one device step of the processor runs, on the CPU.

    python3 tools/op_count.py [--batch 8192]

Builds the processor's default model set (CLI defaults, width 65,536)
on the CPU and counts the non-view aten ops of one fused step and of
each model's per-model update over one batch that lies in a single
(slot, sub-window), through a TorchDispatchMode. A CMS update wrapper
call (ops/cms_cuda.py) counts as ONE op, as it is one kernel launch on
the card, whatever its plain version runs here. On the card nearly every
other such op is one kernel launch too, so the count predicts launches
per step before a card is asked; it is a count, not a time. The count
does not depend on the batch size up to 32,768 rows (control flow is
static), so a small batch keeps the run light. Also counts the ops of
the host sketch pipeline's apply (``-sketch.backend host``: only the
device rest-step, the port scatters and the DDoS accumulate, runs torch
ops) over one 32,768-row batch of chip_smoke.py's stream, per chunk.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from torch.utils._python_dispatch import TorchDispatchMode

    from flow_pipeline_tpu_torch import cli
    from flow_pipeline_tpu_torch.engine import FusedPipeline
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu_torch.ops import cms_cuda

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0
            self.paused = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            schema = func._schema
            if not self.paused and (schema.is_mutable or not any(
                    r.alias_info for r in schema.returns)):
                self.ops += 1
            return func(*args, **(kwargs or {}))

    counter = None
    run = cms_cuda._run

    def one_launch(*a, **kw):
        if counter is None:  # outside a counted call
            return run(*a, **kw)
        counter.paused = True
        try:
            return run(*a, **kw)
        finally:
            counter.paused = False
            counter.ops += 1

    cms_cuda._run = one_launch

    vals = cli._processor_flags(cli._common_flags(
        cli.FlagSet("processor"))).parse(
        ["-in", "unused", "-processor.batch", str(args.batch)])
    batch = FlowGenerator(ZipfProfile(), seed=0).batch(args.batch)
    batch.columns["time_received"][:] = batch.columns["time_received"][0]
    out = {"batch": args.batch}
    pipe = FusedPipeline(cli._build_models(vals, "cpu"))
    pipe.update(batch)  # adopts the slot and sub-window
    with Count() as counter:
        pipe.update(batch)
    out["fused_step"] = counter.ops
    counter = None
    models = cli._build_models(vals, "cpu")
    per_model = {}
    for name, model in models.items():
        model.update(batch)
        with Count() as counter:
            model.update(batch)
        per_model[name] = counter.ops
        counter = None
    out["per_model"] = per_model
    out["per_model_sum"] = sum(per_model.values())
    # the host sketch apply over one batch of chip_smoke.py's stream (its
    # first 32,768 rows: several DDoS sub-windows, so several chunks)
    from flow_pipeline_tpu_torch.engine import StreamWorker

    vals = cli._processor_flags(cli._common_flags(
        cli.FlagSet("processor"))).parse(
        ["-in", "unused", "-processor.hostassist", "on",
         "-sketch.backend", "host"])
    pipe = StreamWorker(None, cli._build_models(vals, "cpu"), prefetch=0,
                        **cli._ingest_kwargs(vals)).fused
    prep = pipe.prepare(FlowGenerator(ZipfProfile(), seed=0,
                                      rate=500.0).batch(32768))
    chunks = sum(len(c) for _, _, _, c in prep.parts)
    with Count() as counter:
        pipe.apply(prep)
    out["hostsketch_apply"] = {"rows": 32768, "chunks": chunks,
                               "ops": counter.ops}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
