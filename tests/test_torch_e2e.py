"""Port end to end on the CPU: the JAX processor and the port's processor
run the same seeded Zipf frames file (about 20k flows, windows and DDoS
sub-windows closing mid-stream) and must write identical sqlite rows in
all seven tables, rank included: at CLI defaults (the fused step, native
decode, the prefetch feed; the JAX side with ``-processor.hostassist
off``, which makes it a FusedPipeline on the CPU), and on the per-model
path (``-processor.fused=false`` on both). The port's fused and per-model
runs must agree too. Every sum stays below 2^24 and flows_5m is uint64,
so nothing is excused (tolerance: none).

Also: the import boundary (a port processor run at defaults loads no JAX
and nothing of the JAX package) and the CLI's refusals.
"""

import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu_torch import cli as tcli

REPO = Path(__file__).resolve().parents[1]
TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
# the default set at narrow sizes; prefilter on (1024 > 2*128)
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128"]
SHARED = ["-processor.fused=false", *NARROW]  # the per-model path


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames") / "frames.bin"
    # 20k flows at 40 flows/s span 500 s: two windows close mid-stream
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-produce.count", "20000", "-produce.rate",
                      "40", "-produce.seed", "3"]) == 0
    return path


def _rows(db, table):
    """Every row; ranked tables in rank order, the others sorted whole
    (flows_5m and the alerts carry no rank)."""
    conn = sqlite3.connect(db)
    try:
        if table in ("flows_5m", "ddos_alerts"):
            return sorted(conn.execute(f"SELECT * FROM {table}").fetchall())
        return conn.execute(
            f"SELECT * FROM {table} ORDER BY timeslot, rank").fetchall()
    finally:
        conn.close()


def test_port_processor_matches_reference(frames, tmp_path):
    jdb, tdb = tmp_path / "jax.db", tmp_path / "port.db"
    assert jcli.main(["processor", "-in", str(frames), "-sink",
                      f"sqlite:{jdb}", "-processor.backend", "cpu",
                      "-metrics.addr", "", *SHARED]) == 0
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-sink", f"sqlite:{tdb}", *SHARED])
    assert worker.flows_seen == 20000
    late = [m.late_flows_dropped for name, m in worker.models.items()
            if name != "flows_5m"]
    assert all(n > 0 for n in late)  # two partitions: the reference drops too
    for table in TABLES:
        want = _rows(jdb, table)
        got = _rows(tdb, table)
        assert got == want, table
        if table != "ddos_alerts":
            assert len({r[0] for r in want}) >= 3  # three windows emitted
    assert _rows(jdb, "ddos_alerts")  # the detector fired mid-stream


def test_fused_processor_matches_reference(frames, tmp_path):
    """The port at CLI defaults (fused step, native decode, prefetch 2)
    against the JAX processor's FusedPipeline, and against the port's own
    per-model run."""
    jdb, tdb, pdb = (tmp_path / f"{n}.db" for n in ("jax", "port", "pm"))
    assert jcli.main(["processor", "-in", str(frames), "-sink",
                      f"sqlite:{jdb}", "-processor.backend", "cpu",
                      "-processor.hostassist", "off", "-metrics.addr", "",
                      *NARROW]) == 0
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-sink", f"sqlite:{tdb}", *NARROW])
    assert worker.fused is not None and worker.flows_seen == 20000
    # every fused step is one CMS update of each of the three families
    assert worker.chunk_updates % 3 == 0
    assert worker.chunk_updates > 3 * worker.batches_seen
    # the per-model path, and no prefetch thread: the same rows
    per_model = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                    "-sink", f"sqlite:{pdb}", *SHARED,
                                    "-feed.prefetch", "0"])
    assert per_model.fused is None
    assert type(per_model.consumer).__name__ == "Consumer"
    for table in TABLES:
        want = _rows(jdb, table)
        assert _rows(tdb, table) == want, table
        assert _rows(pdb, table) == want, table
    assert _rows(jdb, "ddos_alerts")


def test_frames_match_reference_mocker(frames, tmp_path):
    """The same seed gives the same flows. The bytes equal the JAX
    package's pure-Python encoding; its native encoder (which the JAX
    mocker prefers when built) omits all-zero addresses, so against that
    file the decoded columns are compared."""
    from flow_pipeline_tpu.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu.schema import wire as jwire
    from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch as TBatch

    gen = FlowGenerator(ZipfProfile(), seed=3, rate=40.0)
    data = frames.read_bytes()
    py_bytes = b"".join(jwire.encode_stream(gen.batch(n).to_messages())
                        for n in [4096] * 4 + [3616])
    assert data == py_bytes
    jpath = tmp_path / "jax_frames.bin"
    assert jcli.main(["mocker", "-out", str(jpath), "-produce.profile",
                      "zipf", "-produce.count", "20000", "-produce.rate",
                      "40", "-produce.seed", "3"]) == 0
    want = JBatch.from_wire(jpath.read_bytes())
    got = TBatch.from_wire(data)
    for name, col in want.columns.items():
        assert (got.columns[name] == col).all(), name


_BOUNDARY = r"""
import sys
from flow_pipeline_tpu_torch import cli
frames, db = sys.argv[1], sys.argv[2]
assert cli.main(["mocker", "-out", frames, "-produce.profile", "zipf",
                 "-produce.count", "3000", "-produce.rate", "40"]) == 0
worker = cli.run_processor(["-device", "cpu", "-in", frames, "-sink",
                            "sqlite:" + db, "-processor.batch", "512",
                            "-sketch.width", "1024", "-sketch.capacity",
                            "32"])
from flow_pipeline_tpu_torch import native
from flow_pipeline_tpu_torch.engine import FusedPipeline, PrefetchConsumer
assert isinstance(worker.fused, FusedPipeline)
assert isinstance(worker.consumer, PrefetchConsumer)
assert native._lib is not None  # frames went through the native decoder
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "flow_pipeline_tpu" or m.startswith("flow_pipeline_tpu."))
assert not bad, bad
print("BOUNDARY_OK")
"""


def test_import_boundary(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _BOUNDARY, str(tmp_path / "f.bin"),
         str(tmp_path / "o.db")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BOUNDARY_OK" in proc.stdout
    for table in TABLES[:-1]:  # the full model set ran (3000 flows at 40
        assert _rows(tmp_path / "o.db", table), table  # flows/s: no alert)


@pytest.mark.parametrize("flag", ["-processor.fused=true",
                                  "-model.flows5m=true", "-model.ports=true",
                                  "-model.ddos=true"])
def test_processor_refuses_unported_parts(frames, flag):
    """The fused engine is ported now: -processor.fused=true runs it
    (with the heavy-hitter families alone), and the host-grouped
    pipeline it would pick with -processor.hostassist=on is refused. The
    flows_5m, port and DDoS flags build their models (each alone beside
    nothing else)."""
    args = [a for a in SHARED if a.split("=")[0] != flag.split("=")[0]]
    if flag == "-processor.fused=true":
        with pytest.raises(ValueError, match="not ported"):
            tcli.run_processor(["-device", "cpu", "-in", str(frames), *args,
                                flag, "-processor.hostassist=on"])
        worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                     *args, flag, "-model.flows5m=false",
                                     "-model.ports=false",
                                     "-model.ddos=false"])
        assert worker.fused is not None
        assert set(worker.models) == {"top_talkers", "top_src_ips",
                                      "top_dst_ips"}
        return
    off = [f"-model.{m}=false" for m in ("flows5m", "talkers", "ips",
                                         "ports", "ddos")
           if f"-model.{m}=" not in flag]
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 *args, *off, flag])
    want = {"-model.flows5m=true": {"flows_5m"},
            "-model.ports=true": {"top_src_ports", "top_dst_ports"},
            "-model.ddos=true": {"ddos_alerts"}}[flag]
    assert set(worker.models) == want


def test_processor_refuses_unknown_flag_and_invertible(frames):
    assert tcli.main(["processor", "-device", "cpu", "-in", str(frames),
                      "-sketch.cms", "pallas", *SHARED]) == 2
    assert tcli.main(["processor", "-device", "cpu", "-in", str(frames),
                      "-hh.sketch", "invertible", *SHARED]) == 2


def test_processor_default_device_is_cuda(frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.run_processor(["-in", str(frames), *SHARED])
