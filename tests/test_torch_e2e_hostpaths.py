"""Port end to end on the CPU, on the host paths: the JAX processor and
the port's processor run the same seeded Zipf frames (the stream and
helpers of tests/test_torch_e2e.py) and must write identical sqlite rows
in all seven tables, rank included (tolerance: none): with the spread
detectors on the host-grouped pipeline (``-spread.enabled`` with
``-processor.hostassist on`` or the CPU's ``auto``, the pipelined ingest
runtime and the native grouping, or the serial runtime and numpy
grouping; the spread rows in the sqlite ``journal`` table too), and with
``-sketch.backend host`` (the host sketch engine, the fused native pass
with ``-ingest.fused auto`` and the staged engine with ``off``, the
cascade families on the invertible sketch).
"""

import pytest

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.engine.hostfused import HostGroupPipeline
from flow_pipeline_tpu_torch.hostsketch import HostSketchPipeline
from test_torch_e2e import NARROW, TABLES, _rows, frames  # noqa: F401
import torch_cpu  # noqa: F401  (one torch thread; see the module)


@pytest.fixture(scope="module")
def spread_frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames") / "spread.bin"
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-zipf.spread", "0.05", "-produce.count",
                      "20000", "-produce.rate", "40", "-produce.seed",
                      "5"]) == 0
    return path


@pytest.mark.parametrize("flags", [
    ("-processor.hostassist", "on"),
    (),  # auto: host grouping on the CPU, in both packages
    ("-processor.hostassist", "on", "-ingest.mode", "serial",
     "-ingest.native_group=false", "-ingest.shards", "2"),
], ids=["hostassist-on", "auto", "serial-numpy"])
def test_spread_hostgroup_processor_matches_reference(spread_frames,
                                                      tmp_path, flags):
    """-spread.enabled on the host-grouped pipeline: the port and the JAX
    processor with the same flags write the same rows in all seven
    tables and the same superspreader and portscan rows."""
    jdb, tdb = tmp_path / "jax.db", tmp_path / "port.db"
    args = ["-spread.enabled", *NARROW, *flags]
    assert jcli.main(["processor", "-in", str(spread_frames), "-sink",
                      f"sqlite:{jdb}", "-processor.backend", "cpu",
                      *args]) == 0
    worker = tcli.run_processor(["-device", "cpu", "-in",
                                 str(spread_frames), "-sink",
                                 f"sqlite:{tdb}", *args])
    assert isinstance(worker.fused, HostGroupPipeline)
    assert (worker.executor is not None) == ("serial" not in flags)
    assert worker.fused._native == ("-ingest.native_group=false"
                                     not in flags)
    assert {"superspreaders", "portscan"} <= set(worker.models)
    for table in (*TABLES, "journal"):
        want = _rows(jdb, table)
        assert want, table
        assert _rows(tdb, table) == want, table
    journal = {r[0] for r in _rows(tdb, "journal")}
    assert journal == {"superspreaders", "portscan"}


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_host_sketch_processor_matches_reference(frames, tmp_path, fused):
    """-sketch.backend host: the port's processor and the JAX processor
    with the same flags write the same rows in all seven tables, with the
    fused native pass (-ingest.fused auto) and with the staged engine
    (off); -hh.sketch auto puts top_src_ips and top_dst_ips on the
    invertible sketch in both. No CMS kernel runs (the heavy-hitter
    families are folded on the host)."""
    jdb, tdb = tmp_path / "jax.db", tmp_path / "port.db"
    args = ["-sketch.backend", "host", "-ingest.fused", fused, *NARROW]
    assert jcli.main(["processor", "-in", str(frames), "-sink",
                      f"sqlite:{jdb}", "-processor.backend", "cpu",
                      *args]) == 0
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-sink", f"sqlite:{tdb}", *args])
    assert type(worker.fused) is HostSketchPipeline
    assert worker.fused._fused == (fused == "auto")
    assert worker.executor is not None and worker.chunk_updates == 0
    assert [worker.models[n].config.hh_sketch for n in TABLES[1:4]] == \
        ["table", "invertible", "invertible"]
    for table in TABLES:
        want = _rows(jdb, table)
        assert want, table
        assert _rows(tdb, table) == want, table
