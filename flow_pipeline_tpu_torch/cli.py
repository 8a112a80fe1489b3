"""Command-line entry points of the port, with the reference's dotted flags.

    python -m flow_pipeline_tpu_torch.cli mocker -out frames.bin [-flags]
    python -m flow_pipeline_tpu_torch.cli processor -in frames.bin \\
        -sink sqlite:out.db [-device cuda|cpu]
    python -m flow_pipeline_tpu_torch.cli processor -mesh.role coordinator \\
        -mesh.listen HOST:PORT -bus.partitions K -sink sqlite:out.db
    python -m flow_pipeline_tpu_torch.cli lineage -mesh.coordinator URL
    python -m flow_pipeline_tpu_torch.cli pipeline -produce.count N \\
        -sink sqlite:out.db
    python -m flow_pipeline_tpu_torch.cli collector -out frames.bin
    python -m flow_pipeline_tpu_torch.cli inserter -in frames.bin -sqlite DB
    python -m flow_pipeline_tpu_torch.cli replay -replay.dir DIR -sink SPEC
    python -m flow_pipeline_tpu_torch.cli gateway \\
        -gateway.upstream HOST:PORT [-history.dir DIR]
    python -m flow_pipeline_tpu_torch.cli history \\
        -history.upstream HOST:PORT -history.dir DIR

- ``mocker`` writes a seeded synthetic stream (mocker or Zipf profile) as
  length-prefixed frames; the same seed gives the same frames as the JAX
  package's mocker.
- ``processor`` loads a frames file onto an in-process bus (``-in``), or
  serves the gRPC feed (``-listen.feed HOST:PORT``, transport/feed.py:
  producers publish frames into an in-process bus; the run lasts until
  interrupted), and runs the reference's default model set: flows_5m,
  the heavy-hitter families (top_talkers, top_src_ips, top_dst_ips), the
  port tables (top_src_ports, top_dst_ports) and the DDoS detector
  (ddos_alerts), with ``-spread.enabled`` also the spread detectors
  (superspreaders, portscan). The default path is the reference's: native
  frame decode, a prefetch feed (``-feed.prefetch``, default 2) and one
  fused step per chunk (``-processor.fused``, default true; false runs
  every model's own update). ``-processor.hostassist`` picks the
  host-grouped form of that step (on; auto does on ``-device cpu``, as
  the reference's does on a CPU backend), which runs the pipelined
  ingest runtime (``-ingest.*``), groups with the native kernel and, at
  the default ``-obs.audit sample``, keeps the sketch audit
  (obs/audit.py; ``full`` audits every key, ``off`` disables); with
  ``-sketch.backend host`` its heavy-hitter families run on the host
  sketch engine (native uint64 C++), by default in one fused native pass
  per chunk (``-ingest.fused auto``; ``off`` runs the staged engine), and
  ``-hh.sketch auto`` puts the cascade families (top_src_ips,
  top_dst_ips) on the invertible sketch there. ``-device`` (default
  cuda) replaces the reference's ``-processor.backend``; asking for cuda
  without a card is an error.
  As the reference does at its defaults, it wraps every sink in a
  ResilientSink (``-sink.retries 4``, ``-sink.deadletter``), serves
  ``/metrics``, ``/healthz`` and ``/debug/trace`` on ``-metrics.addr``
  (127.0.0.1:8081; empty disables, port 0 picks a free port), records
  the trace ring (``-obs.trace ring``), honours a ``-faults`` plan, and
  snapshots and commits after every emit and every ``-flush.count``
  batches; with ``-checkpoint.path`` the snapshot saves the open
  windows' state, restored before the run. ``-query.addr`` serves the
  live query API (engine/query_api.py: ``/healthz``, ``/topk``,
  ``/windows``, ``/alerts``) off the running worker. ``-serve.addr``
  serves the serving tier (serve/: lock-free ``/query/*`` over immutable
  snapshots the worker publishes at every window close and every
  ``-serve.refresh`` seconds, and the ``/sub/snapshot`` subscription
  feed), with read-side admission (``-guard.serve_queue``,
  ``-guard.serve_deadline``); the query API's ``/topk`` then answers
  from a fresh snapshot without the worker's lock. ``-archive.raw``
  hands every batch to the sinks' raw archive (ClickHouse flows_raw).
  ``-guard.lag SECONDS`` arms the guard (guard/controller.py): past that
  watermark lag its ladder pauses the audit and the trace ring (level
  1), then admits a deterministic hash sample of the rows at keep rate
  1/2^(level-1) (up to ``-guard.max_level``); ``/healthz`` of the
  serving tier reports the level.
- ``pipeline`` generates ``-produce.count`` flows (the mocker's
  ``-produce.*`` and ``-zipf.*`` flags) into an in-process bus of
  ``-bus.partitions`` partitions, then runs the processor's worker over
  it (every processor flag applies). ``-mesh.workers N`` runs the
  in-process mesh instead (mesh/): the flows are sharded by key hash
  over max(``-bus.partitions``, N) partitions and N coordinator-driven
  workers consume them, their window state merged at every close into
  the sinks' rows (``-mesh.heartbeat`` fences a silent member,
  ``-mesh.journal DIR`` keeps the coordinator's write-ahead journal);
  ``-query.addr`` then answers ``/topk`` from the merged open windows,
  and ``-serve.addr`` serves the merged view: a publisher thread next to
  the coordinator publishes a merged snapshot at every merge and at the
  ``-serve.refresh`` cadence.
- ``processor -mesh.role coordinator`` runs the mesh's coordinator as a
  service of its own (mesh/server.py): the mesh protocol over HTTP on
  ``-mesh.listen`` (default :8090) for members in other processes, over
  ``-bus.partitions`` partitions, with ``-mesh.heartbeat`` and
  ``-mesh.journal``; ``/topk``, ``/debug/lineage``, ``/debug/trace`` (one
  clock-aligned trace of the coordinator and every member), ``/healthz``
  and ``/state`` there, ``-query.addr`` and ``-serve.addr`` over the
  merged view. It consumes nothing and touches no device; the merged
  rows go to ``-sink``. ``-mesh.role member`` needs a Kafka client, as in
  the reference, which is not ported: it exits with code 2.
- ``lineage`` asks a coordinator's ``/debug/lineage``
  (``-mesh.coordinator URL``) which members built each merged window,
  from which offset ranges and by which path, and prints one summary
  line per window and per contribution (``-lineage.raw``: the JSON).
- ``collector`` listens for sFlow and NetFlow v5/v9/IPFIX datagrams
  (collector/) and appends the decoded flows as frames to ``-out``.
- ``inserter`` writes every flow of a frames file unaggregated to the
  ``flows`` table (``-sqlite PATH``, or ``-postgres.dsn``).
- ``replay`` re-ingests a dead-letter spill (``-sink.deadletter``) into
  ``-sink``.
- ``gateway`` mirrors the serving tier of ``-gateway.upstream`` (a
  worker's ``-serve.addr``) into a local snapshot store and serves
  ``/query/*`` on ``-gateway.listen`` (gateway/); with ``-history.dir`` it
  also archives the mirrored stream and answers time travel there.
- ``history`` archives the snapshot stream of ``-history.upstream`` into
  ``-history.dir`` as keyframe segments and serves ``/query/*`` with
  ``?at=`` and ``?version=``, ``/query/range`` past the upstream's
  retention and ``/history/index`` on ``-history.listen`` (history/).
  Both read host snapshots only and never touch the card.

``-processor.mesh N`` (``processor`` and ``pipeline``) shards every model
over N shard slots (parallel/): each global batch of N x
``-processor.batch`` rows is cut into N row blocks, every shard runs its
model's update on its block, and the shards merge at window close. Shard
i lives on ``devices[i % len(devices)]``, the devices being every visible
card (``-device cuda``) or the CPU, so N shards may share one card; the
sharded models take the per-model path. ``-hh.sketch auto`` resolves to
table under a mesh; ``-hh.sketch invertible``, ``-spread.enabled`` and
``pipeline -mesh.workers`` refuse it, as in the reference.

Sinks: ``stdout``, ``sqlite:PATH``, ``clickhouse:URL`` (HTTP) and
``postgres:DSN`` (needs psycopg2). Flags of parts that are not ported
yet (Kafka) are not declared; an unknown flag is an error. Without
``-in``, ``-listen.feed`` or ``-out`` an entry needs a Kafka client, which
is not ported: it exits with code 2.
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
    fs.string("in", "", "Read frames from this file")
    fs.string("listen.feed", "", "gRPC feed address (host:port): accept "
                                 "batches from colocated producers "
                                 "instead of -in")
    fs.string("query.addr", "", "Live query API host:port (top-K, open "
                                "windows, alerts; empty disables)")
    fs.string("serve.addr", "", "flowserve query host:port (/query/topk, "
                                "/query/estimate, /query/range off "
                                "versioned immutable snapshots — readers "
                                "never touch the dataplane locks; empty "
                                "disables)")
    fs.number("serve.refresh", 2.0, "flowserve open-window snapshot "
                                    "refresh cadence in seconds "
                                    "(snapshots always publish at window "
                                    "close; 0 = window-close only)")
    fs.integer("serve.feed_bytes", 0,
               "flowserve subscription-feed delta-chain byte budget; "
               "subscribers further behind than the retained chain "
               "take a full resync (0 = library default, 128 MiB)")
    fs.number("guard.lag", 0.0,
              "flowguard watermark-lag budget in seconds before the "
              "degradation ladder engages: level 1 drops optional work "
              "(audit cohort refresh, trace ring), levels >=2 are "
              "deterministic hash-sampled admission at keep rate "
              "1/2^(level-1) with unbiased scaled estimates; recovery "
              "steps back up with hysteresis (0 = disarmed, the exact "
              "default)")
    fs.integer("guard.max_level", 6,
               "flowguard ladder ceiling (6 = keep rate 1/32 at full "
               "degradation)")
    fs.integer("guard.serve_queue", 0,
               "flowserve read-side admission: max concurrently "
               "computing queries; past it + the deadline, 503 with "
               "Retry-After (0 = unbounded, the default)")
    fs.number("guard.serve_deadline", 0.1,
              "flowserve admission deadline seconds a query may wait "
              "for a compute slot before it is shed with 503")
    fs.string("sink", "stdout", "stdout | sqlite:PATH | postgres:DSN | "
                                "clickhouse:URL (comma separated)")
    fs.integer("processor.batch", 32768, "Device batch rows (per chip)")
    fs.integer("processor.mesh", 0, "Shard models over this many devices "
                                    "(0 = single chip)")
    fs.boolean("processor.fused", True, "One fused device step per chunk "
                                        "with shared pre-aggregation")
    fs.string("processor.hostassist", "auto",
              "Host-grouped pre-aggregation: auto (-device cpu only) "
              "| on | off")
    fs.boolean("model.flows5m", True, "Exact 5m rollup model")
    fs.boolean("model.talkers", True, "5-tuple top-K talkers model")
    fs.boolean("model.ips", True, "Top src/dst IP models")
    fs.boolean("model.ports", True, "Top src/dst port models")
    fs.boolean("model.ddos", True, "DDoS spike detector")
    fs.integer("sketch.width", 1 << 16, "Count-min width")
    fs.string("sketch.backend", "device",
              "Sketch step executor: device (the CMS kernels and top-K "
              "merge on -device) | host (native threaded uint64 engine; "
              "needs the host-grouped pipeline)")
    fs.string("hh.sketch", "auto",
              "Heavy-hitter sketch family: auto (cascade families, whose "
              "key sets are strict subsets of another hh family's, run "
              "invertible when the host sketch pipeline serves them; "
              "every other family and deployment keeps table) | table "
              "(CMS + top-K admission table) | invertible (key-recovery "
              "sketch decoded at window close; ignores -sketch.prefilter "
              "and -sketch.admission, forces the plain CMS update; wants "
              "-sketch.backend host)")
    fs.boolean("spread.enabled", False,
               "flowspread distinct-count detectors: superspreaders "
               "(src -> distinct dst addrs) + portscan (src -> distinct "
               "dst ports); host-resident register planes")
    fs.integer("spread.depth", 2, "Spread sketch rows (min over rows at "
                                  "decode)")
    fs.integer("spread.width", 1 << 12, "Spread sketch buckets per row")
    fs.integer("spread.regs", 64, "u8 registers per spread bucket "
                                  "(~1.04/sqrt(m) rel err past the "
                                  "linear-counting regime)")
    fs.integer("spread.capacity", 512, "Spread candidate-table capacity")
    fs.integer("spread.topk", 64, "Spread rows emitted per window")
    fs.string("sketch.admission", "est",
              "Top-K table admission: est (space-saving, CMS-seeded) | "
              "plain (batch-sum merge)")
    fs.boolean("sketch.prefilter", True, "Pre-truncate table-merge "
                                         "candidates to 2 * capacity")
    fs.integer("sketch.capacity", 1024, "Top-K table capacity")
    fs.integer("sketch.topk", 100, "Rows emitted per window")
    fs.integer("window.lateness", 0, "Allowed lateness seconds")
    fs.boolean("archive.raw", False, "Archive full-fidelity rows to "
                                     "flows_raw on sinks that support it")
    fs.integer("feed.prefetch", 2, "Decoded batches fetched ahead of the "
                                   "device step (0 disables)")
    fs.string("ingest.mode", "pipelined",
              "Host dataplane: pipelined (grouping overlaps the device "
              "step, async window flush) | serial (A/B)")
    fs.integer("ingest.shards", 0, "Grouping shards on the ingest pool "
                                   "(0 auto, 1 disables sharding)")
    fs.integer("ingest.depth", 2, "Prepared batches held ahead of the "
                                  "device step")
    fs.integer("ingest.flush_queue", 8, "Max queued background flush jobs")
    fs.integer("ingest.threads", 0,
               "Worker threads inside the native dataplane kernels (fused "
               "pass, sketch engine, lane building, flows_5m fold); the "
               "same result at any count; 0 picks half the cores, at "
               "most 4")
    fs.boolean("ingest.native_group", True,
               "Group with the native radix kernel (built at first use; "
               "a build failure is an error)")
    fs.string("ingest.fused", "auto",
              "Single-pass fused native dataplane (group -> cascade -> "
              "sketch in one C pass) of -sketch.backend host: auto | on "
              "(an error when it cannot serve) | off (the staged engine, "
              "its bit-exact reference)")
    fs.string("checkpoint.path", "", "Snapshot directory")
    fs.integer("flush.count", 50, "Batches between snapshots")
    fs.string("metrics.addr", "127.0.0.1:8081", "host:port for /metrics "
                                                "(empty disables)")
    fs.string("obs.trace", "ring",
              "flowtrace per-chunk span recorder: ring (flight recorder, "
              "<2% overhead — dump via /debug/trace or on worker error) "
              "| always (retain every span; CI/diagnostics only) | off")
    fs.string("obs.audit", "sample",
              "sketchwatch sampled exact shadow audit (sketch accuracy "
              "observability) of the host-grouped pipelines: sample "
              "(deterministic ~1/256 key cohort; error/recall/saturation "
              "metrics per window close) | full (every key; tests and "
              "sweeps) | off")
    fs.string("faults", "", "flowchaos deterministic fault plan, e.g. "
                            "'sink.write:p=0.05;mesh.submit:p=0.02"
                            "@seed=7' (empty disables; seams cost one "
                            "attribute read when off). delay=<s> makes "
                            "a site inject LATENCY instead of failure — "
                            "'sink.write:delay=0.02' stalls every "
                            "write, 'bus.poll:p=0.5:delay=0.1' stalls "
                            "half — the slow-dependency overload shape "
                            "flowguard degrades under",
              env="FLOWTPU_FAULTS")
    fs.integer("sink.retries", 4, "Sink write attempts before a batch "
                                  "is dead-lettered (with "
                                  "-sink.deadletter) or the step fails "
                                  "(without); 1 disables retries")
    fs.string("sink.deadletter", "", "Directory for the replayable "
                                     "dead-letter spill (<dir>/"
                                     "deadletter/); batches that "
                                     "exhaust retries land here "
                                     "instead of crashing the worker; "
                                     "re-ingest with flowtpu-replay "
                                     "(empty = fail the step, the "
                                     "crash-and-replay contract)")
    fs.string("mesh.journal", "", "Coordinator write-ahead journal "
                                  "directory (mesh.role=coordinator): "
                                  "accepted submissions, fences, epoch "
                                  "bumps and merged-window keys become "
                                  "durable; a restarted coordinator "
                                  "recovers its frontier/epoch/ledger "
                                  "(empty = in-memory only)")
    fs.string("mesh.role", "", "flowmesh role: coordinator | member "
                               "(processor command; empty = standalone)")
    fs.string("mesh.coordinator", "", "flowmesh coordinator base URL "
                                      "(member role), e.g. "
                                      "http://coordinator:8090")
    fs.string("mesh.id", "", "flowmesh member id (default host-pid)")
    fs.string("mesh.listen", "", "flowmesh listen host:port — the "
                                 "coordinator's protocol/query HTTP "
                                 "(default :8090), or the member's "
                                 "state endpoint for /topk fan-out "
                                 "(empty disables)")
    fs.number("mesh.heartbeat", 5.0, "flowmesh heartbeat timeout "
                                     "seconds before a member is fenced")
    fs.integer("bus.partitions", 2, "Bus partitions (reference default "
                                    "2; the mesh coordinator's "
                                    "partition-count contract)")
    return fs


def _check_ported(vals, need_input: bool = True) -> None:
    mode = vals["processor.hostassist"]
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"-processor.hostassist must be auto|on|off, got "
                         f"{mode!r}")
    if vals["feed.prefetch"] < 0:
        raise ValueError("-feed.prefetch must be >= 0")
    if vals["sketch.backend"] not in ("device", "host"):
        raise ValueError(f"-sketch.backend must be device|host, got "
                         f"{vals['sketch.backend']!r}")
    if vals["hh.sketch"] not in ("auto", "table", "invertible"):
        raise ValueError(f"-hh.sketch must be auto|table|invertible, got "
                         f"{vals['hh.sketch']!r}")
    if vals["obs.audit"] not in ("off", "sample", "full"):
        raise ValueError(f"-obs.audit must be off|sample|full, got "
                         f"{vals['obs.audit']!r}")
    if need_input and not (vals["in"] or vals["listen.feed"]):
        raise ValueError("-in FILE or -listen.feed HOST:PORT is required "
                         "(Kafka is not ported)")
    if vals["flush.count"] < 0:
        raise ValueError("-flush.count must be >= 0")
    if vals["guard.lag"] < 0:
        raise ValueError("-guard.lag must be >= 0 (0 = disarmed)")


def _build_models(vals, device, plan_device=None) -> dict:
    """The reference's _build_models, in its order: flows_5m, the
    heavy-hitter families, the port tables, the DDoS detector (and with
    -spread.enabled the spread detectors); with -processor.mesh N their
    sharded forms over N shard slots on ``device``'s devices.
    -hh.sketch=auto resolves as in the reference: the cascade families
    (key sets that are strict subsets of another family's) take the
    invertible sketch where the host sketch pipeline serves them, every
    other family (and every family under a mesh) the table.
    ``plan_device`` (default ``device``) is the device that resolution
    assumes: the mesh coordinator builds its models on the CPU for their
    specs alone, resolved as its members' on ``-device``."""
    from .engine import WindowedHeavyHitter
    from .models import (DDoSConfig, DDoSDetector, DenseTopConfig,
                         DenseTopKModel, HeavyHitterConfig, HeavyHitterModel,
                         WindowAggConfig, WindowAggregator)

    batch = vals["processor.batch"]
    mesh = None
    wagg_cls, hh_cls, dense_cls, ddos_cls = (
        WindowAggregator, HeavyHitterModel, DenseTopKModel, DDoSDetector)
    place = {"device": device}
    if vals["processor.mesh"]:
        from .parallel import (ShardedDDoSDetector, ShardedDenseTopK,
                               ShardedHeavyHitter, ShardedWindowAggregator,
                               make_mesh)

        mesh = make_mesh(vals["processor.mesh"], devices=device)
        wagg_cls, hh_cls, dense_cls, ddos_cls = (
            ShardedWindowAggregator, ShardedHeavyHitter, ShardedDenseTopK,
            ShardedDDoSDetector)
        place = {"mesh": mesh}
    models = {}
    if vals["model.flows5m"]:
        models["flows_5m"] = wagg_cls(
            WindowAggConfig(batch_size=batch,
                            allowed_lateness=vals["window.lateness"]),
            **place)
    families = []
    if vals["model.talkers"]:
        families.append(("top_talkers", ("src_addr", "dst_addr", "src_port",
                                         "dst_port", "proto")))
    if vals["model.ips"]:
        families.append(("top_src_ips", ("src_addr",)))
        families.append(("top_dst_ips", ("dst_addr",)))
    def resolve_hh_sketch(key_cols) -> str:
        mode = vals["hh.sketch"]
        if mode != "auto":
            return mode
        if mesh or vals["sketch.backend"] != "host" or \
                not vals["processor.fused"]:
            # no host sketch pipeline: an invertible family would take
            # the per-model path, which auto must never choose
            return "table"
        from .engine.hostfused import HostGroupPipeline

        if not HostGroupPipeline.eligible(vals["processor.hostassist"],
                                          plan_device or device):
            return "table"
        cascade = any(set(key_cols) < set(other) for _, other in families)
        return "invertible" if cascade else "table"

    for name, key_cols in families:
        cfg = HeavyHitterConfig(
            key_cols=key_cols,
            batch_size=batch,
            width=vals["sketch.width"],
            capacity=vals["sketch.capacity"],
            table_prefilter=vals["sketch.prefilter"],
            table_admission=vals["sketch.admission"],
            hh_sketch=resolve_hh_sketch(key_cols),
        )
        if mesh and cfg.hh_sketch == "invertible":
            # the invertible family's exact u64 planes are host numpy:
            # nothing to shard
            raise ValueError(
                "-hh.sketch=invertible does not support -processor.mesh "
                "device sharding (host-resident u64 planes); use flowmesh "
                "workers instead")
        models[name] = WindowedHeavyHitter(cfg, k=vals["sketch.topk"],
                                           model_cls=hh_cls, **place)
    if vals["model.ports"]:
        # exact dense accumulators over the 2^16 port space
        for col, name in (("src_port", "top_src_ports"),
                          ("dst_port", "top_dst_ports")):
            models[name] = WindowedHeavyHitter(
                DenseTopConfig(key_col=col, batch_size=batch),
                k=vals["sketch.topk"], model_cls=dense_cls, **place)
    if vals["model.ddos"]:
        models["ddos_alerts"] = ddos_cls(DDoSConfig(batch_size=batch),
                                         **place)
    if vals["spread.enabled"]:
        # spread state is host-resident u8 register planes, like the
        # invertible family: nothing to shard
        if mesh:
            raise ValueError(
                "-spread.enabled does not support -processor.mesh device "
                "sharding (host-resident u8 register planes); use "
                "flowmesh workers instead")
        from .models.scan import SCAN_MODEL, scan_config, scan_model
        from .models.superspreader import (SUPERSPREADER_MODEL,
                                           superspreader_config,
                                           superspreader_model)

        sizing = dict(depth=vals["spread.depth"], width=vals["spread.width"],
                      registers=vals["spread.regs"],
                      capacity=vals["spread.capacity"], batch_size=batch)
        models[SUPERSPREADER_MODEL] = superspreader_model(
            superspreader_config(**sizing), k=vals["spread.topk"],
            device=device)
        models[SCAN_MODEL] = scan_model(scan_config(**sizing),
                                        k=vals["spread.topk"], device=device)
    return models


def _pg_dsn(dsn: str) -> str:
    """The $POSTGRES_PASSWORD fallback when the DSN has no password (the
    reference inserter's)."""
    import os

    password = os.environ.get("POSTGRES_PASSWORD")
    if password and "password" not in dsn:
        dsn = f"{dsn} password={password}"
    return dsn


def _make_sinks(spec: str, retries: int = 0, deadletter: str = "",
                extra=()):
    """The ``-sink`` sinks, then ``extra`` ones; all wrapped in a
    ResilientSink (bounded backoff, and the dead-letter spill with a
    directory) on the reference's condition, ``retries > 1 or
    deadletter``."""
    from .sink import (ClickHouseSink, PostgresSink, ResilientSink,
                       SQLiteSink, StdoutSink)

    sinks = []
    for part in filter(None, spec.split(",")):
        kind, _, arg = part.partition(":")
        if kind == "stdout":
            sinks.append(StdoutSink())
        elif kind == "sqlite":
            sinks.append(SQLiteSink(arg or ":memory:"))
        elif kind == "postgres":
            sinks.append(PostgresSink(_pg_dsn(arg)))
        elif kind == "clickhouse":
            sinks.append(ClickHouseSink(arg or "http://localhost:8123"))
        else:
            raise ValueError(f"unknown sink {part!r}")
    sinks.extend(extra)
    if retries > 1 or deadletter:
        sinks = [ResilientSink(s, retries=max(1, retries),
                               deadletter_dir=deadletter or None)
                 for s in sinks]
    return sinks


def _host_port(addr: str, default_port: int,
               default_host: str = "127.0.0.1") -> tuple[str, int]:
    """Parse "host:port" / ":port" / "host" / "port"."""
    host, sep, port = addr.rpartition(":")
    if not sep:  # no colon: a bare port number or a bare host name
        if addr.isdigit():
            host, port = "", addr
        else:
            host, port = addr, ""
    if port and not port.isdigit():
        raise ValueError(f"invalid port in address {addr!r}")
    return host or default_host, int(port) if port else default_port


def _start_metrics(addr: str, default_port: int = 8081):
    """host:port -> a started MetricsServer, or None when addr is
    empty."""
    if not addr:
        return None
    from .obs import MetricsServer

    host, port = _host_port(addr, default_port)
    server = MetricsServer(port, host=host).start()
    log.info("metrics on http://%s:%d/metrics", host, server.port)
    return server


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


def _ingest_kwargs(vals) -> dict:
    """StreamWorker's host-grouped pipeline and ingest runtime knobs."""
    return dict(host_assist=vals["processor.hostassist"],
                ingest_mode=vals["ingest.mode"],
                ingest_shards=vals["ingest.shards"],
                ingest_depth=vals["ingest.depth"],
                ingest_flush_queue=vals["ingest.flush_queue"],
                ingest_native_group=vals["ingest.native_group"],
                sketch_backend=vals["sketch.backend"],
                ingest_fused=vals["ingest.fused"],
                ingest_threads=vals["ingest.threads"],
                obs_audit=vals["obs.audit"],
                guard_lag=vals["guard.lag"],
                guard_max_level=vals["guard.max_level"])


def _worker_config(vals):
    """The processor flags as the WorkerConfig of a StreamWorker."""
    from .engine import WorkerConfig

    return WorkerConfig(poll_max=vals["processor.batch"],
                        prefetch=vals["feed.prefetch"],
                        fused=vals["processor.fused"],
                        snapshot_every=vals["flush.count"],
                        checkpoint_path=vals["checkpoint.path"] or None,
                        archive_raw=vals["archive.raw"],
                        **_ingest_kwargs(vals))


def _start_serve_worker(vals, worker):
    """Wire the serving tier onto a worker when -serve.addr is set: the
    publisher into the batch loop and the range-ledger sink, the HTTP
    reader on the requested address. Returns (server, publisher) or
    (None, None)."""
    if not vals["serve.addr"]:
        return None, None
    from .serve import attach_worker

    pub = attach_worker(worker, refresh=vals["serve.refresh"])
    return _serve_server(vals, pub.store).set_guard(worker.guard).start(), \
        pub


def _start_serve_mesh(vals, coordinator):
    """Wire the serving tier onto a mesh coordinator when -serve.addr is
    set: the merged-view publisher thread and the HTTP reader. Returns
    (server, publisher) or (None, None)."""
    if not vals["serve.addr"]:
        return None, None
    from .serve import attach_mesh

    pub = attach_mesh(coordinator, refresh=vals["serve.refresh"])
    return _serve_server(vals, pub.store).start(), pub


def _serve_server(vals, store):
    """The serving tier's HTTP reader over ``store``, not started."""
    from .serve import ServeServer

    host, port = _host_port(vals["serve.addr"], 8083)
    return ServeServer(store, port, host,
                       max_inflight=vals["guard.serve_queue"],
                       deadline=vals["guard.serve_deadline"],
                       feed_bytes=vals["serve.feed_bytes"])


def _run_worker(vals, device, consumer, sinks, on_start, on_finish,
                stop_when_idle: bool = True, feed=None):
    """Build the StreamWorker over ``consumer`` with the processor flags,
    start the metrics server, the serving tier and the query API, restore
    a checkpoint, run the stream and stop every service.
    ``on_start(worker, services)`` runs before the stream (``services``:
    the started servers by name, ``metrics``, ``serve``, ``query`` and
    ``feed``, each None when off, and the serving tier's ``publisher``;
    a live-feed caller stops the run with ``worker.request_stop()``);
    ``on_finish(worker, metrics_server)`` after it, before the servers
    stop."""
    from .engine import StreamWorker

    services = {"metrics": None, "serve": None, "publisher": None,
                "query": None, "feed": feed}
    try:
        services["metrics"] = _start_metrics(vals["metrics.addr"])
        worker = StreamWorker(
            consumer, _build_models(vals, device),
            _make_sinks(vals["sink"], retries=vals["sink.retries"],
                        deadletter=vals["sink.deadletter"], extra=sinks),
            **_worker_config(vals).kwargs())
        services["serve"], services["publisher"] = _start_serve_worker(
            vals, worker)
        if vals["query.addr"]:
            from .engine.query_api import QueryServer

            qhost, qport = _host_port(vals["query.addr"], 8082)
            services["query"] = QueryServer(
                worker, qport, qhost,
                serve=services["publisher"].store
                if services["publisher"] is not None else None).start()
        if vals["checkpoint.path"] and worker.restore():
            log.info("restored checkpoint from %s", vals["checkpoint.path"])
        if on_start is not None:
            on_start(worker, services)
        try:
            worker.run(stop_when_idle=stop_when_idle)
        except KeyboardInterrupt:
            log.info("interrupt: draining")
            worker.finalize()
        if on_finish is not None:
            on_finish(worker, services["metrics"])
    finally:
        # covers set-up failures after a server started, not only the
        # run; the reference's order
        for name in ("query", "serve", "feed", "metrics"):
            if services[name] is not None:
                services[name].stop()
    return worker


def _begin(vals) -> None:
    from .obs.trace import TRACER
    from .utils.faults import FAULTS

    _set_level(vals["loglevel"])
    TRACER.configure(vals["obs.trace"])
    FAULTS.configure(vals["faults"])


def run_processor(argv, sinks=(), on_finish=None, on_start=None):
    """Parse processor flags, run the stream to its end and return the
    finished StreamWorker. ``sinks`` are written besides the ``-sink``
    ones (an embedding caller can capture rows in memory), wrapped alike.
    ``on_start`` and ``on_finish`` are _run_worker's: ``on_finish(worker,
    server)`` runs after the stream ended and before the metrics server
    (None when ``-metrics.addr`` is empty) stops, so a caller can scrape
    it. With ``-listen.feed`` the stream never ends by itself: the run
    lasts until interrupted or until ``worker.request_stop()``."""
    from .device import resolve_device
    from .transport import Consumer, InProcessBus

    fs = _processor_flags(_common_flags(FlagSet("processor")))
    vals = fs.parse(argv)
    _begin(vals)
    _check_ported(vals)
    device = resolve_device(vals["device"])
    t0 = time.perf_counter()
    feed = None
    if vals["in"]:
        bus = _load_frames_bus(vals["in"], vals["kafka.topic"])
    else:
        from .transport.feed import FeedServer

        bus = InProcessBus()
        feed = FeedServer(bus, vals["kafka.topic"],
                          vals["listen.feed"]).start()
    worker = _run_worker(vals, device, Consumer(bus, vals["kafka.topic"]),
                         sinks, on_start, on_finish,
                         stop_when_idle=feed is None, feed=feed)
    log.info("processed %d flows in %d batches on %s (%s) in %.3f s",
             worker.flows_seen, worker.batches_seen, device,
             type(worker.fused).__name__ if worker.fused is not None
             else "per-model", time.perf_counter() - t0)
    return worker


def _parse_processor(argv) -> dict:
    return _processor_flags(_common_flags(FlagSet("processor"))).parse(argv)


def processor_main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[2:]
    role = _parse_processor(argv)["mesh.role"]
    if role == "coordinator":
        return run_coordinator(argv)
    if role == "member":
        return _mesh_member_main(argv)
    if role:
        raise ValueError(f"mesh.role must be coordinator|member, got "
                         f"{role!r}")
    run_processor(argv)
    return 0


def run_coordinator(argv, on_start=None) -> int:
    """``processor -mesh.role coordinator``: the mesh's membership, merge
    barrier and merged query surface as a service (the reference's
    _mesh_coordinator_main). Members in other processes speak the mesh
    protocol to it over HTTP on ``-mesh.listen`` (mesh/server.py); the
    merged rows go to ``-sink``; ``-serve.addr`` and ``-query.addr`` serve
    the merged view. It consumes nothing, and builds its models on the
    CPU for their specs alone (resolved as the members' on ``-device``).
    It runs until interrupted, or with ``on_start(coordinator,
    services)`` until that returns (``services``: the started servers by
    name, ``mesh``, ``metrics``, ``serve``, ``query``, None when off, and
    the merged serving tier's ``publisher``); then it stops its servers
    and closes the coordinator (the journal's final fsync)."""
    import torch

    from .device import resolve_device
    from .mesh import MeshCoordinator, MeshCoordinatorServer, \
        spec_from_models

    vals = _parse_processor(argv)
    _begin(vals)
    _check_ported(vals, need_input=False)
    if vals["bus.partitions"] <= 0:
        raise ValueError("-bus.partitions must be > 0")
    device = resolve_device(vals["device"])
    specs = spec_from_models(_build_models(vals, torch.device("cpu"),
                                           plan_device=device))
    coord = MeshCoordinator(
        specs, vals["bus.partitions"],
        sinks=_make_sinks(vals["sink"], retries=vals["sink.retries"],
                          deadletter=vals["sink.deadletter"]),
        heartbeat_timeout=vals["mesh.heartbeat"],
        journal=vals["mesh.journal"] or None)
    services = {"mesh": None, "metrics": None, "serve": None,
                "publisher": None, "query": None}
    try:
        services["serve"], services["publisher"] = _start_serve_mesh(
            vals, coord)
        host, port = _host_port(vals["mesh.listen"] or ":8090", 8090,
                                default_host="0.0.0.0")
        services["mesh"] = MeshCoordinatorServer(coord, port, host).start()
        services["metrics"] = _start_metrics(vals["metrics.addr"])
        if vals["query.addr"]:
            from .engine.query_api import QueryServer

            qhost, qport = _host_port(vals["query.addr"], 8082)
            services["query"] = QueryServer(None, qport, qhost,
                                            mesh=coord).start()
        log.info("mesh coordinator: %d partitions, models=%s",
                 vals["bus.partitions"], [s.name for s in specs])
        _serve_until(on_start, coord, services)
    finally:
        # the reference's order; the journal's final fsync last
        for name in ("query", "publisher", "serve", "mesh", "metrics"):
            if services[name] is not None:
                services[name].stop()
        coord.close()
    return 0


def _mesh_member_main(argv) -> int:
    """``processor -mesh.role member``: in the reference a
    coordinator-driven worker over Kafka partitions assigned to it. The
    port has no Kafka client, so after the reference's checks it exits
    with code 2, as the reference does without one."""
    vals = _parse_processor(argv)
    _begin(vals)
    if not vals["mesh.coordinator"]:
        log.error("mesh.role=member needs -mesh.coordinator URL")
        return 2
    log.error("mesh member mode needs a Kafka client (the mesh shards a "
              "real partitioned topic); use `pipeline -mesh.workers N` for "
              "the in-process mesh")
    return 2


def _batch_frames(batch):
    """A batch as one bus message per frame."""
    from .schema import wire

    return wire.iter_raw_frames(batch.to_wire())


def run_pipeline(argv, sinks=(), on_finish=None, on_start=None):
    """The single-process run: generate ``-produce.count`` flows into an
    in-process bus of ``-bus.partitions`` partitions (8,192 per produce,
    round-robin), then the processor's worker over it until caught up.
    Returns the finished StreamWorker; the callbacks are run_processor's.
    With ``-mesh.workers N`` the run is _pipeline_mesh's, which returns
    the finished InProcessMesh."""
    from .device import resolve_device
    from .transport import Consumer, InProcessBus

    fs = _processor_flags(_gen_flags(_common_flags(FlagSet("pipeline"))))
    fs.integer("mesh.workers", 0, "Run an in-process mesh of this many "
                                  "workers (0 disables)")
    vals = fs.parse(argv)
    _begin(vals)
    _check_ported(vals, need_input=False)
    if vals["produce.count"] <= 0:
        raise ValueError("-produce.count must be > 0")
    if vals["bus.partitions"] <= 0:
        raise ValueError("-bus.partitions must be > 0")
    if vals["mesh.workers"] < 0:
        raise ValueError("-mesh.workers must be >= 0")
    device = resolve_device(vals["device"])
    if vals["mesh.workers"]:
        return _pipeline_mesh(vals, device, sinks, on_start, on_finish)
    bus = InProcessBus()
    bus.create_topic(vals["kafka.topic"], vals["bus.partitions"])
    gen = _make_generator(vals)
    t0 = time.perf_counter()
    produced = 0
    while produced < vals["produce.count"]:
        n = min(8192, vals["produce.count"] - produced)
        bus.produce_many(vals["kafka.topic"], _batch_frames(gen.batch(n)))
        produced += n
    log.info("produced %d flows in %.2fs", produced,
             time.perf_counter() - t0)
    t0 = time.perf_counter()
    worker = _run_worker(vals, device, Consumer(bus, vals["kafka.topic"]),
                         sinks, on_start, on_finish)
    dt = time.perf_counter() - t0
    log.info("aggregated %d flows in %.2fs (%.0f flows/sec) on %s",
             worker.flows_seen, dt, worker.flows_seen / max(dt, 1e-9),
             device)
    return worker


def _pipeline_mesh(vals, device, sinks, on_start, on_finish):
    """``pipeline -mesh.workers N``: the flows key-hash sharded over the
    bus, N coordinator-driven workers, the network-wide merge at every
    window close (the reference's _pipeline_mesh). ``on_start(mesh,
    services)`` runs before the members start (``services``: the started
    ``metrics``, ``serve`` and ``query`` servers, None when off, and the
    merged serving tier's ``publisher``), ``on_finish(mesh,
    metrics_server)`` after the mesh finalized, before the servers stop.
    Returns the finished InProcessMesh."""
    from .mesh import InProcessMesh, produce_sharded
    from .transport import InProcessBus

    if vals["processor.mesh"]:
        raise ValueError(
            "-mesh.workers is the horizontal (multi-worker) scale-out; "
            "combining it with -processor.mesh device sharding inside "
            "each member is not supported yet")
    n_workers = vals["mesh.workers"]
    partitions = max(vals["bus.partitions"], n_workers)
    bus = InProcessBus()
    bus.create_topic(vals["kafka.topic"], partitions)
    gen = _make_generator(vals)
    t0 = time.perf_counter()
    produced = 0
    while produced < vals["produce.count"]:
        n = min(8192, vals["produce.count"] - produced)
        produced += produce_sharded(bus, vals["kafka.topic"],
                                    gen.batch(n), partitions)
    log.info("produced %d flows (key-hash sharded over %d partitions) "
             "in %.2fs", produced, partitions, time.perf_counter() - t0)
    all_sinks = _make_sinks(vals["sink"], retries=vals["sink.retries"],
                            deadletter=vals["sink.deadletter"], extra=sinks)
    services = {"metrics": None, "serve": None, "publisher": None,
                "query": None}
    try:
        services["metrics"] = _start_metrics(vals["metrics.addr"])
        mesh = InProcessMesh(
            bus, vals["kafka.topic"], n_workers,
            model_factory=lambda: _build_models(vals, device),
            config=_worker_config(vals), sinks=all_sinks,
            member_sinks=all_sinks,
            heartbeat_timeout=vals["mesh.heartbeat"],
            journal=vals["mesh.journal"] or None)
        services["serve"], services["publisher"] = _start_serve_mesh(
            vals, mesh.coordinator)
        if vals["query.addr"]:
            from .engine.query_api import QueryServer

            qhost, qport = _host_port(vals["query.addr"], 8082)
            services["query"] = QueryServer(
                None, qport, qhost, mesh=mesh.coordinator).start()
        if on_start is not None:
            on_start(mesh, services)
        elapsed = mesh.run()
        merged = sum(len(v) for v in mesh.coordinator.merged.values())
        log.info("mesh aggregated %d flows with %d workers in %.2fs "
                 "(%.0f flows/sec, %d merged windows) on %s", produced,
                 n_workers, elapsed, produced / max(elapsed, 1e-9), merged,
                 device)
        if on_finish is not None:
            on_finish(mesh, services["metrics"])
    finally:
        # the reference's order
        for name in ("query", "publisher", "serve", "metrics"):
            if services[name] is not None:
                services[name].stop()
    return mesh


def pipeline_main(argv=None) -> int:
    run_pipeline(argv if argv is not None else sys.argv[2:])
    return 0


def _raw_rows(batch) -> list[dict]:
    """A batch as rows of the ``flows`` table (the reference inserter's)."""
    import datetime

    from .sink.base import _addr_str

    c = batch.columns
    return [
        {
            # a TIMESTAMP column (Postgres) needs a timestamp
            "time_flow": datetime.datetime.fromtimestamp(
                int(c["time_received"][i]), datetime.timezone.utc
            ).strftime("%Y-%m-%d %H:%M:%S"),
            "type": int(c["type"][i]),
            "sampling_rate": int(c["sampling_rate"][i]),
            "src_as": int(c["src_as"][i]),
            "dst_as": int(c["dst_as"][i]),
            "src_ip": _addr_str(c["src_addr"][i]),
            "dst_ip": _addr_str(c["dst_addr"][i]),
            "bytes": int(c["bytes"][i]),
            "packets": int(c["packets"][i]),
            "etype": int(c["etype"][i]),
            "proto": int(c["proto"][i]),
            "src_port": int(c["src_port"][i]),
            "dst_port": int(c["dst_port"][i]),
        }
        for i in range(len(batch))
    ]


def inserter_main(argv=None) -> int:
    """The raw-row sink service: every flow of ``-in`` lands unaggregated
    in the ``flows`` table (SQLite, or Postgres with ``-postgres.dsn``),
    committed per ``-flush.count`` rows."""
    from .sink import PostgresSink, SQLiteSink
    from .transport import Consumer

    fs = _common_flags(FlagSet("inserter"))
    fs.string("in", "", "Read frames from this file")
    fs.string("postgres.dsn", "", "Postgres DSN (enables PostgresSink)")
    fs.string("postgres.pass", "", "Postgres password")
    fs.string("sqlite", "", "SQLite path (default sink)")
    fs.integer("flush.count", 100, "Rows per flush")
    vals = fs.parse(argv if argv is not None else sys.argv[2:])
    _set_level(vals["loglevel"])
    if not vals["in"]:
        log.error("no Kafka client in this environment; use -in FILE")
        return 2
    if vals["postgres.dsn"]:
        dsn = vals["postgres.dsn"]
        if vals["postgres.pass"] and "password" not in dsn:
            dsn += f" password={vals['postgres.pass']}"
        sink = PostgresSink(_pg_dsn(dsn))
    else:
        sink = SQLiteSink(vals["sqlite"] or ":memory:")
    bus = _load_frames_bus(vals["in"], vals["kafka.topic"])
    consumer = Consumer(bus, vals["kafka.topic"], group="postgres-inserter")
    total = 0
    while True:
        batch = consumer.poll(vals["flush.count"])
        if batch is None:
            break
        sink.write("flows", _raw_rows(batch))
        consumer.commit(batch.partition, batch.last_offset + 1)
        total += len(batch)
    log.info("inserted %d raw rows", total)
    return 0


def run_collector(argv, on_start=None) -> int:
    """The UDP collector: sFlow (``-listen.sflow``) and NetFlow v5/v9 and
    IPFIX (``-listen.netflow``) datagrams, decoded and appended as frames
    to ``-out``. It runs ``-run.seconds`` (0: until interrupted), or, with
    ``on_start(collector)`` (an embedding caller that sends datagrams to
    ``collector.ports``), until that returns. Without ``-out`` it needs a
    Kafka client, which is not ported: exit code 2."""
    from .collector import CollectorConfig, CollectorServer
    from .schema import wire

    fs = _common_flags(FlagSet("collector"))
    fs.string("listen.netflow", "0.0.0.0:2055", "NetFlow/IPFIX UDP addr "
                                                "(empty disables)")
    fs.string("listen.sflow", "0.0.0.0:6343", "sFlow UDP addr (empty "
                                              "disables)")
    fs.string("metrics.addr", "127.0.0.1:8080", "host:port for /metrics")
    fs.string("out", "", "Append frames to this file")
    fs.number("run.seconds", 0.0, "Exit after this long (0 = run forever)")
    vals = fs.parse(argv)
    _set_level(vals["loglevel"])
    if not vals["out"]:
        log.error("no Kafka client; use -out FILE")
        return 2

    def parse_addr(a):
        return _host_port(a, 0, default_host="0.0.0.0") if a else None

    out_f = open(vals["out"], "ab")

    class FileProducer:
        def send(self, msg):
            out_f.write(wire.encode_frame(msg))

    server = None
    collector = None
    try:
        server = _start_metrics(vals["metrics.addr"], 8080)
        collector = CollectorServer(
            FileProducer(),
            CollectorConfig(netflow_addr=parse_addr(vals["listen.netflow"]),
                            sflow_addr=parse_addr(vals["listen.sflow"]))
        ).start()
        if on_start is not None:
            on_start(collector)
        elif vals["run.seconds"]:
            time.sleep(vals["run.seconds"])
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if collector is not None:
            collector.stop()
        if server is not None:
            server.stop()
        out_f.close()
    return 0


def collector_main(argv=None) -> int:
    return run_collector(argv if argv is not None else sys.argv[2:])


def replay_main(argv=None) -> int:
    """Re-ingest the batches that exhausted their sink retries
    (``<dir>/deadletter/*.dlq.json``, written by ResilientSink) into a
    sink spec; each file is deleted only after every sink took it, and
    the first failing file stops the replay (spill order kept)."""
    from .sink.resilient import deadletter_files, replay_deadletter

    fs = FlagSet("replay")
    fs.string("loglevel", "info", "Log level")
    fs.string("replay.dir", "", "Sink dead-letter root (the directory "
                                "passed as -sink.deadletter; its "
                                "deadletter/ subdir holds the spill)")
    fs.boolean("replay.delete", True, "Delete each file after every "
                                      "sink accepted it (false = keep, "
                                      "for dry runs)")
    fs.string("sink", "stdout", "stdout | sqlite:PATH | postgres:DSN | "
                                "clickhouse:URL (comma separated)")
    vals = fs.parse(argv if argv is not None else sys.argv[2:])
    _set_level(vals["loglevel"])
    if not vals["replay.dir"]:
        log.error("replay needs -replay.dir (the -sink.deadletter root)")
        return 2
    if not deadletter_files(vals["replay.dir"]):
        log.info("no dead-letter files under %s; nothing to replay",
                 vals["replay.dir"])
        return 0
    files, rows = replay_deadletter(vals["replay.dir"],
                                    _make_sinks(vals["sink"]),
                                    delete=vals["replay.delete"])
    log.info("replayed %d file(s) / %d row(s) into %s", files, rows,
             vals["sink"])
    return 0


def _fmt_lineage(rec: dict) -> str:
    """One line per window and one per contribution: which members built
    the window, from which offset ranges, and by which path."""
    carries = ",".join(rec.get("carries_promoted") or []) or "-"
    members = ",".join(rec.get("members") or
                       sorted({c["member"] for c in rec["contributions"]
                               if c.get("member")})) or "-"
    head = (f"{rec['model']} @ {rec['slot']} [{rec['status']}] "
            f"members={members} contribs={len(rec['contributions'])} "
            f"carries={carries} late={rec.get('late', 0)}")
    if rec["status"] == "merged":
        head += (f" rows={rec.get('rows')} "
                 f"barrier_wait={rec.get('barrier_wait_s')}s "
                 f"merge={rec.get('merge_wall_s')}s")
    lines = [head]
    for c in rec["contributions"]:
        ranges = c.get("ranges")
        rng = " ".join(f"{p}:[{r[0]},{r[1]})"
                       for p, r in sorted((ranges or {}).items(),
                                          key=lambda kv: int(kv[0])))
        lag = ""
        if c.get("accepted") is not None and c.get("submitted") is not None:
            lag = f" xfer={c['accepted'] - c['submitted']:+.3f}s"
        lines.append(f"    {c.get('member') or '?'} sub={c.get('sub')} "
                     f"{c['kind']} chunk={c.get('chunk')} "
                     f"{rng or 'ranges=-'}{lag}")
    return "\n".join(lines)


def lineage_main(argv=None) -> int:
    """Ask a mesh coordinator's ``/debug/lineage`` ledger which members
    built each merged window, from which offset ranges, by which path
    (closed submission, promoted carry, late partial), and how long the
    barrier and the merge took."""
    import json
    import urllib.parse
    import urllib.request

    fs = FlagSet("lineage")
    fs.string("loglevel", "info", "Log level")
    fs.string("mesh.coordinator", "http://127.0.0.1:8090",
              "Mesh coordinator base URL to query")
    fs.string("lineage.model", "", "Restrict to one model (empty = all)")
    fs.integer("lineage.slot", -1, "Restrict to one window slot "
                                   "(epoch seconds; -1 = all)")
    fs.boolean("lineage.raw", False, "Print raw JSON records instead "
                                     "of the summary lines")
    vals = fs.parse(argv if argv is not None else sys.argv[2:])
    _set_level(vals["loglevel"])
    params = {}
    if vals["lineage.model"]:
        params["model"] = vals["lineage.model"]
    if vals["lineage.slot"] >= 0:
        params["slot"] = str(vals["lineage.slot"])
    url = vals["mesh.coordinator"].rstrip("/") + "/debug/lineage"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    with urllib.request.urlopen(url, timeout=10) as resp:
        records = json.loads(resp.read().decode())
    if vals["lineage.raw"]:
        print(json.dumps(records, indent=2, default=str))
        return 0
    if not records:
        print("no lineage records (nothing merged or pending "
              "in the retention window)")
        return 0
    for rec in records:
        print(_fmt_lineage(rec))
    return 0


def _serve_until(on_start, *args) -> None:
    """Block an entry: until ``on_start(*args)`` returns (an embedding
    caller), else until interrupted."""
    if on_start is not None:
        on_start(*args)
        return
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def _serve_admission_flags(fs: FlagSet) -> FlagSet:
    fs.integer("guard.serve_queue", 0,
               "flowguard read-side admission: max concurrently "
               "computing queries; past it + the deadline, 503 with "
               "Retry-After (0 = unbounded)")
    fs.number("guard.serve_deadline", 0.1,
              "flowguard admission deadline seconds a query may wait "
              "for a compute slot before it is shed with 503")
    return fs


def run_gateway(argv, on_start=None) -> int:
    """A gateway replica: mirror the upstream serving tiers'
    ``/sub/snapshot`` streams (``-gateway.upstream``, comma separated,
    the first one served) into a local store and serve ``/query/*`` on
    ``-gateway.listen`` (port 0 picks a free port); with ``-history.dir``
    archive the mirrored stream there and answer time travel too. It
    runs until interrupted, or with ``on_start(gateway, server)`` until
    that returns. Without an upstream: exit code 2."""
    from .gateway import SnapshotGateway
    from .serve import ServeServer
    from .utils.faults import FAULTS

    fs = FlagSet("gateway")
    fs.string("loglevel", "info", "Log level")
    fs.string("gateway.upstream", "",
              "Comma-separated upstream flowserve host:port list to "
              "subscribe to (first = the primary stream this replica "
              "serves)")
    fs.string("gateway.listen", "127.0.0.1:8084",
              "host:port the gateway serves /query/* on")
    fs.number("gateway.poll", 0.25,
              "Subscription poll cadence in seconds (deltas ship "
              "between versions; a gap forces a full resync)")
    fs.string("metrics.addr", "", "host:port for /metrics (empty "
                                  "disables)")
    fs.string("faults", "", "flowchaos deterministic fault plan "
                            "(gateway.poll is the flowgate seam)",
              env="FLOWTPU_FAULTS")
    fs.boolean("gateway.adopt-restart", False,
               "Adopt an upstream RESTART automatically: when the "
               "subscribed stream comes back with a lower version and "
               "kind=full, swap to it (availability) instead of "
               "holding the pre-restart snapshot until the upstream "
               "version catches up (monotone reads, the default)")
    _serve_admission_flags(fs)
    fs.string("history.dir", "",
              "flowhistory archive directory: persist the mirrored "
              "delta chain and answer /query/range past upstream "
              "retention plus ?at=/?version= time travel from this "
              "replica (empty disables)")
    fs.integer("history.keyframe", 64,
               "flowhistory keyframe cadence: full snapshot every N "
               "deltas (smaller = faster reconstruction, bigger "
               "archive)")
    fs.integer("history.retain", 1 << 30,
               "flowhistory archive byte bound; whole oldest keyframe "
               "segments are evicted past it")
    vals = fs.parse(argv)
    _set_level(vals["loglevel"])
    if not vals["gateway.upstream"]:
        log.error("gateway needs -gateway.upstream host:port[,host:port]")
        return 2
    FAULTS.configure(vals["faults"])
    metrics = gw = serve = archive = None
    try:
        metrics = _start_metrics(vals["metrics.addr"])
        if vals["history.dir"]:
            from .history import ArchiveWriter

            archive = ArchiveWriter(vals["history.dir"],
                                    keyframe_every=vals["history.keyframe"],
                                    retain_bytes=vals["history.retain"])
        gw = SnapshotGateway(
            [u.strip() for u in vals["gateway.upstream"].split(",")
             if u.strip()],
            poll=vals["gateway.poll"],
            adopt_restart=vals["gateway.adopt-restart"], archive=archive)
        host, port = _host_port(vals["gateway.listen"], 8084)
        if archive is not None:
            from .history import ArchiveReader, HistoryServer

            serve = HistoryServer(
                ArchiveReader(vals["history.dir"]), store=gw.store,
                port=port, host=host,
                max_inflight=vals["guard.serve_queue"],
                deadline=vals["guard.serve_deadline"]).start()
        else:
            serve = ServeServer(
                gw.store, port, host,
                max_inflight=vals["guard.serve_queue"],
                deadline=vals["guard.serve_deadline"]).start()
        gw.serve_on(serve).start()
        log.info("gateway replica serving %s on http://%s:%d/query",
                 vals["gateway.upstream"], host, serve.port)
        _serve_until(on_start, gw, serve)
    finally:
        # the reference's order: the mirror threads, the server, the
        # archive, the metrics server
        if gw is not None:
            gw.stop()
        if serve is not None:
            serve.stop()
        if archive is not None:
            archive.close()
        if metrics is not None:
            metrics.stop()
    return 0


def gateway_main(argv=None) -> int:
    return run_gateway(argv if argv is not None else sys.argv[2:])


def run_history(argv, on_start=None) -> int:
    """The history tier: subscribe to a serving tier
    (``-history.upstream``: a worker's ``-serve.addr`` or a gateway's
    ``-gateway.listen``), archive its delta chain into ``-history.dir``
    as keyframe segments, and serve ``/query/*`` (the live head, and with
    ``?at=`` or ``?version=`` any archived version), ``/query/range``
    reaching past the upstream's retention and ``/history/index`` on
    ``-history.listen``. It runs until interrupted, or with
    ``on_start(writer, server)`` until that returns. Without an
    upstream: exit code 2."""
    from .history import ArchiveReader, ArchiveWriter, HistoryServer
    from .utils.faults import FAULTS

    fs = FlagSet("history")
    fs.string("loglevel", "info", "Log level")
    fs.string("history.upstream", "",
              "Upstream flowserve host:port whose snapshot stream is "
              "archived (a worker's/coordinator's -serve.addr or a "
              "gateway's -gateway.listen)")
    fs.string("history.listen", "127.0.0.1:8085",
              "host:port the flowhistory tier serves /query/* and "
              "/history/index on")
    fs.string("history.dir", "./flowhistory",
              "Archive directory for keyframe segments")
    fs.integer("history.keyframe", 64,
               "Keyframe cadence: full snapshot every N deltas "
               "(smaller = faster reconstruction, bigger archive)")
    fs.integer("history.retain", 1 << 30,
               "Archive byte bound; whole oldest keyframe segments "
               "are evicted past it")
    fs.number("history.poll", 0.25,
              "Subscription poll cadence in seconds")
    fs.string("metrics.addr", "", "host:port for /metrics (empty "
                                  "disables)")
    fs.string("faults", "", "flowchaos deterministic fault plan",
              env="FLOWTPU_FAULTS")
    _serve_admission_flags(fs)
    vals = fs.parse(argv)
    _set_level(vals["loglevel"])
    if not vals["history.upstream"]:
        log.error("history needs -history.upstream host:port")
        return 2
    FAULTS.configure(vals["faults"])
    metrics = serve = writer = None
    try:
        metrics = _start_metrics(vals["metrics.addr"])
        host, port = _host_port(vals["history.listen"], 8085)
        serve = HistoryServer(
            ArchiveReader(vals["history.dir"]), port=port, host=host,
            max_inflight=vals["guard.serve_queue"],
            deadline=vals["guard.serve_deadline"]).start()
        writer = ArchiveWriter(vals["history.dir"],
                               keyframe_every=vals["history.keyframe"],
                               retain_bytes=vals["history.retain"],
                               upstream=vals["history.upstream"],
                               poll=vals["history.poll"],
                               store=serve.store).start()
        log.info("history archiving %s into %s, serving on "
                 "http://%s:%d/query", vals["history.upstream"],
                 vals["history.dir"], host, serve.port)
        _serve_until(on_start, writer, serve)
    finally:
        if writer is not None:
            writer.stop()
        if serve is not None:
            serve.stop()
        if metrics is not None:
            metrics.stop()
    return 0


def history_main(argv=None) -> int:
    return run_history(argv if argv is not None else sys.argv[2:])


_COMMANDS = {
    "mocker": mocker_main,
    "processor": processor_main,
    "inserter": inserter_main,
    "pipeline": pipeline_main,
    "collector": collector_main,
    "lineage": lineage_main,
    "replay": replay_main,
    "gateway": gateway_main,
    "history": history_main,
}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "-help", "--help"):
        print("usage: flow_pipeline_tpu_torch.cli <mocker|processor|"
              "inserter|pipeline|collector|lineage|replay|gateway|history> "
              "[-flags]\n"
              "Run '<cmd> -help' for flags.")
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
