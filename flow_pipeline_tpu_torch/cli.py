"""Command-line entry points of the port, with the reference's dotted flags.

    python -m flow_pipeline_tpu_torch.cli mocker -out frames.bin [-flags]
    python -m flow_pipeline_tpu_torch.cli processor -in frames.bin \\
        -sink sqlite:out.db [-device cuda|cpu]

- ``mocker`` writes a seeded synthetic stream (mocker or Zipf profile) as
  length-prefixed frames; the same seed gives the same frames as the JAX
  package's mocker.
- ``processor`` loads a frames file onto an in-process bus and runs the
  reference's default model set: flows_5m, the heavy-hitter families
  (top_talkers, top_src_ips, top_dst_ips), the port tables
  (top_src_ports, top_dst_ports) and the DDoS detector (ddos_alerts).
  The default path is the reference's: native frame decode, a prefetch
  feed (``-feed.prefetch``, default 2) and one fused step per chunk
  (``-processor.fused``, default true; false runs every model's own
  update). ``-device`` (default cuda) replaces the reference's
  ``-processor.backend``; asking for cuda without a card is an error.
  Flags of parts that are not ported yet (the host-grouped pipeline, the
  host sketch backend, the invertible family, Kafka) are either refused
  at their non-default value or not declared; an unknown flag is an
  error.
"""

from __future__ import annotations

import logging
import sys
import time

from .utils.flags import FlagSet

log = logging.getLogger("flow_pipeline_tpu_torch.cli")


def _common_flags(fs: FlagSet) -> FlagSet:
    fs.string("loglevel", "info", "Log level")
    fs.string("kafka.topic", "flows", "Bus topic to use")
    return fs


def _set_level(level: str) -> None:
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s %(message)s")
    logging.getLogger("flow_pipeline_tpu_torch").setLevel(level.upper())


def _gen_flags(fs: FlagSet) -> FlagSet:
    fs.integer("produce.count", 100_000, "Flows to generate")
    fs.number("produce.rate", 100_000.0, "Modeled flows/sec for timestamps")
    fs.integer("produce.seed", 0, "Generator seed")
    fs.string("produce.profile", "mocker", "mocker | zipf")
    fs.integer("zipf.keys", 10_000, "Distinct keys in zipf mode")
    fs.number("zipf.alpha", 1.2, "Zipf exponent")
    fs.number("zipf.spread", 0.0,
              "Fraction of zipf-mode flows emitted by skewed-fan-out "
              "spreader/scanner legs (0 disables)")
    return fs


def _make_generator(vals):
    from .gen import FlowGenerator, MockerProfile, ZipfProfile

    if vals["produce.profile"] not in ("mocker", "zipf"):
        raise ValueError(f"produce.profile must be mocker|zipf, got "
                         f"{vals['produce.profile']!r}")
    profile = (
        ZipfProfile(n_keys=vals["zipf.keys"], alpha=vals["zipf.alpha"],
                    spread_fraction=vals["zipf.spread"])
        if vals["produce.profile"] == "zipf" else MockerProfile())
    return FlowGenerator(profile, seed=vals["produce.seed"],
                         rate=vals["produce.rate"])


def mocker_main(argv=None) -> int:
    fs = _common_flags(FlagSet("mocker"))
    _gen_flags(fs)
    fs.string("out", "", "Write length-prefixed frames to this file")
    fs.integer("produce.batch", 4096, "Frames per write")
    vals = fs.parse(argv if argv is not None else sys.argv[2:])
    _set_level(vals["loglevel"])
    if not vals["out"]:
        raise ValueError("-out FILE is required (Kafka is not ported)")
    total = vals["produce.count"]
    if total <= 0:
        raise ValueError("-produce.count must be > 0")
    gen = _make_generator(vals)
    written = 0
    with open(vals["out"], "wb") as f:
        while written < total:
            n = min(vals["produce.batch"], total - written)
            f.write(gen.batch(n).to_wire())
            written += n
    log.info("wrote %d frames to %s", written, vals["out"])
    return 0


def _processor_flags(fs: FlagSet) -> FlagSet:
    fs.string("device", "cuda", "cuda | cpu (cuda raises when no card is "
                                "available)")
    fs.string("in", "", "Read frames from this file (required)")
    fs.string("sink", "stdout", "stdout | sqlite:PATH (comma separated)")
    fs.integer("processor.batch", 32768, "Device batch rows")
    fs.boolean("processor.fused", True, "One fused device step per chunk "
                                        "with shared pre-aggregation")
    fs.string("processor.hostassist", "auto",
              "Host-grouped pre-aggregation: auto | off (both run the "
              "device-sorted fused step, as the reference's auto does on "
              "an accelerator; on is not ported)")
    fs.boolean("model.flows5m", True, "Exact 5m rollup model")
    fs.boolean("model.talkers", True, "5-tuple top-K talkers model")
    fs.boolean("model.ips", True, "Top src/dst IP models")
    fs.boolean("model.ports", True, "Top src/dst port models")
    fs.boolean("model.ddos", True, "DDoS spike detector")
    fs.integer("sketch.width", 1 << 16, "Count-min width")
    fs.string("sketch.backend", "device", "Sketch step executor: device "
                                          "(host is not ported)")
    fs.string("hh.sketch", "auto", "Heavy-hitter sketch family: auto | "
                                   "table (invertible is not ported)")
    fs.string("sketch.admission", "est",
              "Top-K table admission: est (space-saving, CMS-seeded) | "
              "plain (batch-sum merge)")
    fs.boolean("sketch.prefilter", True, "Pre-truncate table-merge "
                                         "candidates to 2 * capacity")
    fs.integer("sketch.capacity", 1024, "Top-K table capacity")
    fs.integer("sketch.topk", 100, "Rows emitted per window")
    fs.integer("window.lateness", 0, "Allowed lateness seconds")
    fs.integer("feed.prefetch", 2, "Decoded batches fetched ahead of the "
                                   "device step (0 disables)")
    return fs


def _check_ported(vals) -> None:
    mode = vals["processor.hostassist"]
    if mode == "on":
        raise ValueError("-processor.hostassist=on (the host-grouped "
                         "pipeline, engine/hostfused.py) is not ported; "
                         "auto and off run the fused device step")
    if mode not in ("auto", "off"):
        raise ValueError(f"-processor.hostassist must be auto|on|off, got "
                         f"{mode!r}")
    if vals["feed.prefetch"] < 0:
        raise ValueError("-feed.prefetch must be >= 0")
    if vals["sketch.backend"] != "device":
        raise ValueError(f"-sketch.backend={vals['sketch.backend']} is not "
                         "ported; only device is")
    if not vals["in"]:
        raise ValueError("-in FILE is required (Kafka is not ported)")


def _build_models(vals, device) -> dict:
    """The reference's _build_models without a mesh, in its order:
    flows_5m, the heavy-hitter families, the port tables, the DDoS
    detector. With the device sketch backend, -hh.sketch=auto resolves to
    table for every family, as in the reference."""
    from .engine import WindowedHeavyHitter
    from .models import (DDoSConfig, DDoSDetector, DenseTopConfig,
                         DenseTopKModel, HeavyHitterConfig, WindowAggConfig,
                         WindowAggregator)

    batch = vals["processor.batch"]
    models = {}
    if vals["model.flows5m"]:
        models["flows_5m"] = WindowAggregator(
            WindowAggConfig(batch_size=batch,
                            allowed_lateness=vals["window.lateness"]),
            device=device)
    families = []
    if vals["model.talkers"]:
        families.append(("top_talkers", ("src_addr", "dst_addr", "src_port",
                                         "dst_port", "proto")))
    if vals["model.ips"]:
        families.append(("top_src_ips", ("src_addr",)))
        families.append(("top_dst_ips", ("dst_addr",)))
    sketch = vals["hh.sketch"]
    for name, key_cols in families:
        cfg = HeavyHitterConfig(
            key_cols=key_cols,
            batch_size=batch,
            width=vals["sketch.width"],
            capacity=vals["sketch.capacity"],
            table_prefilter=vals["sketch.prefilter"],
            table_admission=vals["sketch.admission"],
            hh_sketch="table" if sketch == "auto" else sketch,
        )
        models[name] = WindowedHeavyHitter(cfg, k=vals["sketch.topk"],
                                           device=device)
    if vals["model.ports"]:
        # exact dense accumulators over the 2^16 port space
        for col, name in (("src_port", "top_src_ports"),
                          ("dst_port", "top_dst_ports")):
            models[name] = WindowedHeavyHitter(
                DenseTopConfig(key_col=col, batch_size=batch),
                k=vals["sketch.topk"], model_cls=DenseTopKModel,
                device=device)
    if vals["model.ddos"]:
        models["ddos_alerts"] = DDoSDetector(DDoSConfig(batch_size=batch),
                                             device=device)
    return models


def _make_sinks(spec: str):
    from .sink import SQLiteSink, StdoutSink

    sinks = []
    for part in filter(None, spec.split(",")):
        kind, _, arg = part.partition(":")
        if kind == "stdout":
            sinks.append(StdoutSink())
        elif kind == "sqlite":
            sinks.append(SQLiteSink(arg or ":memory:"))
        else:
            raise ValueError(f"unknown or unported sink {part!r}")
    return sinks


def _load_frames_bus(path: str, topic: str, partitions: int = 2):
    """Preload a frames file onto an in-process bus, round-robin over the
    partitions (the reference's -in path). Frames are split by their
    length prefixes; decoding happens in the consumer."""
    from .schema import wire
    from .transport import InProcessBus

    bus = InProcessBus()
    bus.create_topic(topic, partitions)
    with open(path, "rb") as f:
        data = f.read()
    bus.produce_many(topic, wire.iter_raw_frames(data))
    return bus


def run_processor(argv, sinks=()):
    """Parse processor flags, run the stream to its end and return the
    finished StreamWorker. ``sinks`` are written besides the ``-sink``
    ones (an embedding caller can capture rows in memory)."""
    from .device import resolve_device
    from .engine import StreamWorker
    from .transport import Consumer

    fs = _processor_flags(_common_flags(FlagSet("processor")))
    vals = fs.parse(argv)
    _set_level(vals["loglevel"])
    _check_ported(vals)
    device = resolve_device(vals["device"])
    t0 = time.perf_counter()
    bus = _load_frames_bus(vals["in"], vals["kafka.topic"])
    worker = StreamWorker(
        Consumer(bus, vals["kafka.topic"]),
        _build_models(vals, device),
        [*_make_sinks(vals["sink"]), *sinks],
        poll_max=vals["processor.batch"], prefetch=vals["feed.prefetch"],
        fused=vals["processor.fused"])
    worker.run()
    log.info("processed %d flows in %d batches on %s (%s) in %.3f s",
             worker.flows_seen, worker.batches_seen, device,
             "fused" if worker.fused is not None else "per-model",
             time.perf_counter() - t0)
    return worker


def processor_main(argv=None) -> int:
    run_processor(argv if argv is not None else sys.argv[2:])
    return 0


_COMMANDS = {
    "mocker": mocker_main,
    "processor": processor_main,
}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "-help", "--help"):
        print("usage: flow_pipeline_tpu_torch.cli <mocker|processor> "
              "[-flags]\nRun '<cmd> -help' for flags.")
        return 0 if argv else 2
    cmd = _COMMANDS.get(argv[0])
    if cmd is None:
        print(f"unknown command {argv[0]!r}", file=sys.stderr)
        return 2
    try:
        return cmd(argv[1:]) or 0
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
