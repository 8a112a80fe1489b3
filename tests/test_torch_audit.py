"""The sketch audit (``-obs.audit``, flow_pipeline_tpu_torch/obs/audit.py)
against the reference's (flow_pipeline_tpu/obs/audit.py) on the CPU.

- The sampling contract (``_lane_mults``, ``_sample_hash``,
  ``sample_mask``) is bit-equal to the reference's.
- ``audit_report`` gives equal reports on equal states: a table-family and
  an invertible-family state of a JAX HeavyHitterModel, carried into the
  port with interop.py (tolerance: none; the report's numbers are rounded
  the same way from the same integers).
- At CLI defaults (``-obs.audit sample``) the port's host-grouped
  processor and the JAX processor, on one frames file and fresh metric
  registries, publish equal ``sketch_*`` exposition lines (one ``sketch_audit_windows_total`` per
  close per heavy-hitter family; the port used to report 0) and equal
  close reports, on the host-grouped pipeline, the host sketch backend
  (the fused pass with the invertible cascade families, and the staged
  engine) and with the spread detectors.
- The sink rows are bit-equal with the audit on and off.
"""

import sqlite3

import numpy as np
import pytest

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.obs import REGISTRY as JREGISTRY
from flow_pipeline_tpu.obs import audit as jaudit
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch import interop
from flow_pipeline_tpu_torch.obs import audit as taudit
from flow_pipeline_tpu_torch.obs.metrics import REGISTRY as TREGISTRY
import torch_cpu  # noqa: F401  (one torch thread; see the module)

TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts", "journal")
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128", "-metrics.addr", ""]
HH = ("top_talkers", "top_src_ips", "top_dst_ips")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    # 4,000 flows at 8 flows/s span 500 s: two windows close mid-stream;
    # spreader legs so the spread audit has work
    path = tmp_path_factory.mktemp("audit") / "frames.bin"
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-zipf.spread", "0.05", "-produce.count",
                      "4000", "-produce.rate", "8", "-produce.seed",
                      "11"]) == 0
    return path


@pytest.mark.parametrize("width", [1, 4, 11, 20])
def test_sampling_contract_bit_equal(width):
    assert taudit._lane_mults(24) == jaudit._lane_mults(24)
    rng = np.random.default_rng(width)
    lanes = rng.integers(0, 2**32, size=(4096, width), dtype=np.uint32)
    np.testing.assert_array_equal(taudit._sample_hash(lanes),
                                  jaudit._sample_hash(lanes))
    for mode in ("sample", "full"):
        np.testing.assert_array_equal(taudit.sample_mask(lanes, mode),
                                      jaudit.sample_mask(lanes, mode))
    assert 0 < taudit.sample_mask(lanes).sum() < 64  # about 1/256


def _strip(report):
    out = dict(report)
    arrays = {k: out.pop(k) for k in ("_cms_ratios", "_table_ratios")
              if k in out}
    return out, arrays


@pytest.mark.parametrize("hh_sketch", ["table", "invertible"])
def test_audit_report_equal_on_equal_states(hh_sketch):
    """A JAX model's state after three Zipf batches, carried into the
    port: audit_report on a cohort of table keys, absent keys and the
    empty cohort gives the same report, ratios included."""
    from flow_pipeline_tpu.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu.models import heavy_hitter as jhh
    from flow_pipeline_tpu_torch.models import heavy_hitter as thh

    kw = dict(key_cols=("src_addr", "dst_addr"), width=2048, capacity=64,
              batch_size=512, hh_sketch=hh_sketch)
    jcfg = jhh.HeavyHitterConfig(**kw)
    tcfg = thh.HeavyHitterConfig(**kw)
    jm = jhh.HeavyHitterModel(jcfg)
    gen = FlowGenerator(ZipfProfile(n_keys=500, alpha=1.1), seed=5)
    for _ in range(3):
        jm.update(gen.batch(1500))
    fields = {k: np.asarray(v) for k, v in jm.state._asdict().items()}
    if hh_sketch == "table":
        tstate = interop.hh_state_from_reference(
            fields["cms"], fields["table_keys"], fields["table_vals"],
            device="cpu")
        tkeys = fields["table_keys"]
    else:
        tstate = interop.inv_state_from_checkpoint(fields)
        tkeys = jaudit._state_arrays(jm.state, jcfg)[1]
    rng = np.random.default_rng(7)
    real = tkeys[(tkeys != 0xFFFFFFFF).any(axis=1)]
    keys = np.concatenate([real[::3], rng.integers(
        0, 2**32, size=(40, real.shape[1]), dtype=np.uint32)])
    vals = rng.integers(1, 5000, size=(len(keys), 3), dtype=np.uint64)
    for cohort in ((keys, vals), (keys[:0], vals[:0])):
        for scale in (1, 256):
            want, want_arr = _strip(jaudit.audit_report(
                *cohort, jm.state, jcfg, 10, slot=300, scale=scale))
            got, got_arr = _strip(taudit.audit_report(
                *cohort, tstate, tcfg, 10, slot=300, scale=scale))
            assert got == want
            assert want_arr.keys() == got_arr.keys()
            for k in want_arr:
                np.testing.assert_array_equal(got_arr[k], want_arr[k])


def _sketch_lines(registry):
    return [line for line in registry.render().splitlines()
            if line.startswith("sketch_")]


def _windows(registry):
    return {line.split('"')[1]: float(line.split()[-1])
            for line in _sketch_lines(registry)
            if line.startswith("sketch_audit_windows_total{")}


def _collect_reports(monkeypatch, cls):
    seen = []
    evaluate = cls.evaluate

    def recording(self, name, slot, part, state):
        report = evaluate(self, name, slot, part, state)
        seen.append((name, report))
        return report

    monkeypatch.setattr(cls, "evaluate", recording)
    return seen


def _rows(db, table):
    conn = sqlite3.connect(db)
    try:
        return sorted(conn.execute(f"SELECT * FROM {table}").fetchall(),
                      key=repr)
    finally:
        conn.close()


@pytest.mark.parametrize("flags", [
    (),  # -device cpu: host grouping at -processor.hostassist auto
    ("-sketch.backend", "host"),
    ("-sketch.backend", "host", "-ingest.fused", "off"),
    ("-spread.enabled",),
], ids=["hostgroup", "hostsketch-fused", "hostsketch-staged", "spread"])
def test_default_audit_matches_reference(frames, tmp_path, monkeypatch,
                                         flags):
    """The port's default run audits as the reference's: on fresh
    registries (other tests in the process publish into both), the same
    ``sketch_*`` exposition, three audited windows per heavy-hitter
    family (two mid-stream closes and the final forced one), and the
    same close reports in the same order."""
    monkeypatch.setattr(JREGISTRY, "_metrics", {})
    monkeypatch.setattr(TREGISTRY, "_metrics", {})
    jseen = _collect_reports(monkeypatch, jaudit.SketchAudit)
    tseen = _collect_reports(monkeypatch, taudit.SketchAudit)
    args = [*NARROW, *flags]
    assert jcli.main(["processor", "-in", str(frames), "-sink",
                      f"sqlite:{tmp_path / 'j.db'}", "-processor.backend",
                      "cpu", *args]) == 0
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-sink", f"sqlite:{tmp_path / 't.db'}",
                                 *args])
    assert worker.fused.audit is not None
    assert (worker.fused.spread_audit is not None) == bool(
        "-spread.enabled" in flags)
    assert _windows(JREGISTRY) == _windows(TREGISTRY) == {
        fam: 3.0 for fam in HH}
    assert _sketch_lines(TREGISTRY) == _sketch_lines(JREGISTRY)
    assert [n for n, _ in tseen] == [n for n, _ in jseen]
    assert len(tseen) == 3 * len(HH)
    for (_, got), (_, want) in zip(tseen, jseen):
        assert got == want
    assert {n: r["sampled_keys"] for n, r in
            worker.fused.audit.last_reports.items()} == {
        n: r["sampled_keys"] for n, r in jseen[-3:]}


@pytest.mark.parametrize("flags", [
    ("-processor.hostassist", "on"),
    ("-sketch.backend", "host"),
    ("-sketch.backend", "host", "-ingest.fused", "off"),
    ("-spread.enabled", "-ingest.mode", "serial"),
    ("-sketch.backend", "host", "-hh.sketch", "invertible"),
], ids=["hostgroup", "hostsketch-fused", "hostsketch-staged", "spread",
        "invertible"])
def test_rows_equal_with_audit_on_and_off(frames, tmp_path, flags):
    """The audit only reads: every table (and the spread journal) is
    bit-equal at -obs.audit off, sample (the default) and full. The DDoS
    detector, which the audit never reads, is off here: its 10-s
    sub-windows split this slow stream into about a hundred device steps
    per run."""
    rows = {}
    for mode in ("off", "sample", "full"):
        db = tmp_path / f"{mode}.db"
        worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                     "-sink", f"sqlite:{db}", *NARROW,
                                     "-model.ddos=false", *flags,
                                     "-obs.audit", mode])
        assert (worker.fused.audit is None) == (mode == "off")
        rows[mode] = {t: _rows(db, t) for t in TABLES}
    assert all(rows["off"][t] for t in TABLES[:6])
    assert rows["sample"] == rows["off"]
    assert rows["full"] == rows["off"]


def test_audit_refuses_unknown_mode(frames):
    assert tcli.main(["processor", "-device", "cpu", "-in", str(frames),
                      "-obs.audit", "most", *NARROW]) == 2
